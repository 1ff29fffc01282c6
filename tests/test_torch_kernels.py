"""Plain PyTorch kernel versions of the port against the reference kernels.

Every comparison is bit-exact: the same inputs, made with numpy from a
seed, go through ``repro_torch.kernels`` (plain versions, on CPU) and the
reference's ``repro.kernels.ops`` with ``use_pallas=True`` (the Pallas
kernels in interpret mode).  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32_bits(vals):
    return np.asarray(vals, np.float32).view(np.int32)


def _float_lanes(rng, n):
    """float32 bit patterns with NaN payloads, infinities and signed zeros
    but no subnormals (XLA flushes those; see the subnormal test below)."""
    v = (rng.standard_normal(n) * 100).astype(np.float32)
    special = np.array(
        [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 3.0, -3.0], np.float32
    ).view(np.int32)
    special = np.concatenate([special, np.array([0x7FC00001, 0x7F800001], np.int32)])
    out = v.view(np.int32).copy()
    at = rng.choice(n, size=min(n, len(special) * 3), replace=False)
    out[at] = np.resize(special, len(at))
    return out


def _op_case(rng, code, rows):
    """(ids column, p0, p1) cases for one op code, adversarial per op."""
    ints = rng.integers(I32_MIN, I32_MAX, rows, dtype=np.int64).astype(np.int32)
    edge = np.array([I32_MIN, I32_MAX, 0, -1], np.int32)
    ints[: min(rows, 4)] = edge[: min(rows, 4)]
    if code == jref.OP_SIGRID_HASH:
        return [(ints, p0, p1) for p0, p1 in
                ((7, 33), (I32_MAX, I32_MAX - 1), (0, 0), (-5, -1), (123, 2 ** 31 - 3))]
    if code == jref.OP_POSITIVE_MODULUS:
        return [(ints, p0, p1) for p0, p1 in
                ((0, 13), (0, I32_MAX), (0, 2 ** 30 + 7), (0, 0), (0, -7), (0, 1))]
    if code == jref.OP_CLAMP:
        return [(ints, p0, p1) for p0, p1 in
                ((-50, 50), (50, -50), (I32_MIN, I32_MAX), (0, 0))]
    if code == jref.OP_BUCKETIZE:
        return [(ints, p0, p1) for p0, p1 in
                ((-100, 10), (I32_MAX, 1), (I32_MIN, 3), (5, 0), (5, -9),
                 (0, I32_MAX))]
    if code in (jref.OP_CLAMP_F, jref.OP_BUCKETIZE_F):
        f = _float_lanes(rng, rows)
        lo_hi = [(-1.0, 1.0), (1.0, -1.0), (-0.0, 0.0), (0.0, -0.0),
                 (-np.inf, np.inf), (np.nan, 2.0), (-2.0, np.nan)]
        return [(f, int(_f32_bits(lo)), int(_f32_bits(hi))) for lo, hi in lo_hi]
    return [(ints, 0, 0), (ints, 99, -99)]


ALL_CODES = [jref.OP_IDENTITY, jref.OP_SIGRID_HASH, jref.OP_POSITIVE_MODULUS,
             jref.OP_CLAMP, jref.OP_BUCKETIZE, jref.OP_CLAMP_F, jref.OP_BUCKETIZE_F]


def _mixed_wave(seed, rows):
    """A (rows, F) tile holding every op code, each with its adversarial
    parameter sets, plus a per-feature border table."""
    rng = np.random.default_rng(seed)
    cols, codes, p0, p1, brd = [], [], [], [], []
    nb = 7
    for code in ALL_CODES:
        for col, a, b in _op_case(rng, code, rows):
            cols.append(col)
            codes.append(code)
            p0.append(a)
            p1.append(b)
            bd = np.full(nb, np.inf, np.float32)
            k = int(rng.integers(1, nb + 1))
            bd[:k] = np.sort(rng.standard_normal(k) * 50).astype(np.float32)
            if k > 2:
                bd[1] = -0.0
            brd.append(bd)
    ids = np.stack(cols, axis=1).astype(np.int32)
    return (ids, np.array(codes, np.int32), np.array(p0, np.int32),
            np.array(p1, np.int32), np.stack(brd).astype(np.float32))


def test_op_codes_match_reference():
    names = {n for n in vars(jref) if n.startswith("OP_")}
    assert names == {n for n in vars(ref) if n.startswith("OP_")}
    for n in names:
        assert getattr(ref, n) == getattr(jref, n), n
    assert ref.XOR_KEY32 == jref.XOR_KEY32 and ref.NAN_BITS == jref.NAN_BITS


@pytest.mark.parametrize("rows", [3, 37, 64])
def test_fused_transform_matches_pallas_every_op(rows):
    ids, codes, p0, p1, brd = _mixed_wave(rows, rows)
    want = np.asarray(jops.fused_transform(ids, codes, p0, p1, brd, use_pallas=True))
    np.testing.assert_array_equal(
        np.asarray(jref.fused_transform(ids, codes, p0, p1, brd)), want)
    got = ref.fused_transform(_t(ids), _t(codes), _t(p0), _t(p1), _t(brd)).numpy()
    np.testing.assert_array_equal(got, want)
    # the static-codes form in both layouts, and the CPU dispatch of ops
    static = ref.fused_transform_static(
        _t(ids), tuple(codes.tolist()), _t(p0), _t(p1), _t(brd)).numpy()
    np.testing.assert_array_equal(static, want)
    fm = ops.fused_transform(_t(ids.T.copy()), _t(codes), _t(p0), _t(p1), _t(brd),
                             features_major=True).numpy()
    np.testing.assert_array_equal(fm.T, want)


@pytest.mark.parametrize("code", ALL_CODES)
def test_fused_transform_static_single_op_waves(code):
    """Waves of one op code take the static path's single-branch build."""
    ids, codes, p0, p1, brd = _mixed_wave(100 + code, 45)
    keep = codes == code
    ids, codes, p0, p1, brd = ids[:, keep], codes[keep], p0[keep], p1[keep], brd[keep]
    want = np.asarray(jops.fused_transform(ids, codes, p0, p1, brd, use_pallas=True))
    got = ops.fused_transform(_t(ids.T.copy()), _t(codes), _t(p0), _t(p1), _t(brd),
                              features_major=True).numpy().T
    np.testing.assert_array_equal(got, want)


def test_fused_transform_default_borders():
    rng = np.random.default_rng(3)
    ids = rng.integers(I32_MIN, I32_MAX, (33, 4), dtype=np.int64).astype(np.int32)
    codes = np.array([1, 2, 6, 0], np.int32)
    p0 = np.array([3, 0, 0, 0], np.int32)
    p1 = np.array([1000, 17, 0, 0], np.int32)
    want = np.asarray(jops.fused_transform(ids, codes, p0, p1, use_pallas=True))
    got = ref.fused_transform(_t(ids), _t(codes), _t(p0), _t(p1)).numpy()
    np.testing.assert_array_equal(got, want)


def test_subnormals_kept_where_xla_flushes():
    """XLA on CPU flushes subnormal float32 in CLAMP_F; the port's plain
    version (and its CUDA kernel, built without --ftz) keeps them.  The
    engines demote subnormal columns, so batches stay identical."""
    sub = np.array([1e-40, -1e-42, 1.0], np.float32)
    ids = sub.view(np.int32).reshape(-1, 1)
    codes = np.array([jref.OP_CLAMP_F], np.int32)
    p0 = _f32_bits([-np.inf]).astype(np.int32)
    p1 = _f32_bits([np.inf]).astype(np.int32)
    xla = np.asarray(jref.fused_transform(ids, codes, p0, p1)).view(np.float32)
    port = ref.fused_transform(_t(ids), _t(codes), _t(p0), _t(p1)).numpy()
    assert list(xla.ravel()) == [0.0, 0.0, 1.0]
    np.testing.assert_array_equal(port.ravel(), ids.ravel())


def test_hash_matches_numpy_mixer():
    from repro_torch.core.transforms import _mix32

    rng = np.random.default_rng(4)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 2 ** 32 - 1, 2 ** 31]
    got = ref._hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), _mix32(x))


def test_xor_decrypt_matches_pallas():
    rng = np.random.default_rng(0)
    words = rng.integers(I32_MIN, I32_MAX, (16, 128), dtype=np.int64).astype(np.int32)
    want = np.asarray(jops.xor_decrypt(words, use_pallas=True))
    got = ops.xor_decrypt(_t(words)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.frombuffer(got.tobytes(), np.uint8),
        np.frombuffer(words.tobytes(), np.uint8) ^ 0x5A,
    )


@pytest.mark.parametrize("rows", [517, 31, 64, 1])
def test_dense_unpack_matches_pallas(rows):
    rng = np.random.default_rng(rows)
    feats = 6
    words = (-(-rows // 8) + 3) // 4
    bitmap = np.zeros((feats, words), np.int32)
    cap = rows
    values = np.zeros((feats, cap), np.int32)
    for f, density in enumerate((0.0, 0.3, 1.0, 0.5, 0.9, 0.7)):
        present = rng.random(rows) < density
        if f == 5:
            present = np.ones(rows, bool)       # more rows present than values
        packed = np.packbits(present.astype(np.uint8))
        buf = np.zeros(words * 4, np.uint8)
        buf[: len(packed)] = packed
        bitmap[f] = buf.view("<i4")
        n = int(present.sum()) if f != 5 else max(rows // 3, 1)
        vals = _float_lanes(rng, max(n, 1))[:n]
        values[f, :n] = vals
    want = np.asarray(jops.dense_unpack(bitmap, values, use_pallas=True))
    got = ops.dense_unpack(_t(bitmap), _t(values)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dense_unpack_narrow_values_clip():
    """C smaller than the present count: ranks clip to C-1 like the
    reference's take_along_axis clip."""
    bitmap = np.full((2, 2), -1, np.int32)
    values = np.array([[11], [22]], np.int32)
    want = np.asarray(jops.dense_unpack(bitmap, values, use_pallas=True))
    np.testing.assert_array_equal(ops.dense_unpack(_t(bitmap), _t(values)).numpy(), want)


def test_ragged_gather_matches_pallas_every_shift():
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 256, 4 * 128 * 4, dtype=np.uint8)
    src = raw.view("<i4").reshape(4, 128)
    idx = np.zeros((5, 128), np.int32)
    shift = np.zeros((5, 128), np.int32)
    for r, sh in enumerate((0, 8, 16, 24)):
        idx[r] = np.arange(128, dtype=np.int32) + 3 * r
        shift[r] = sh
    # a mixed row: every shift in one row, and the last source word at sh=0
    idx[4] = rng.integers(0, 4 * 128 - 1, 128)
    shift[4] = rng.choice([0, 8, 16, 24], 128)
    idx[4, -1], shift[4, -1] = 4 * 128 - 2, 24
    want = np.asarray(jops.ragged_gather(src, idx, shift, use_pallas=True))
    got = ops.ragged_gather(_t(src), _t(idx), _t(shift)).numpy()
    np.testing.assert_array_equal(got, want)


class _Elsewhere:
    """A stand-in for a tensor on a device that is neither CPU, CUDA nor
    ``meta`` (the dispatchers read only its shape and device)."""

    def __init__(self, t):
        self.shape, self.dtype = t.shape, t.dtype
        self.device = torch.device("xpu")
        self.requires_grad = False


def test_dispatch_refuses_other_devices():
    """No silent fallback: a tensor on neither CPU, CUDA nor ``meta``
    raises, and the CUDA wrappers refuse CPU tensors instead of computing
    them.  A ``meta`` tensor (only a dry run holds one) gets an empty
    result of the kernel's shape and dtype."""
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import fused_transform as kft

    meta = torch.empty((2, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.xor_decrypt(_Elsewhere(meta))
    out = ops.xor_decrypt(meta)
    assert (out.device.type, out.shape, out.dtype) == ("meta", meta.shape, meta.dtype)
    cpu = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kdecode.xor_decrypt(cpu)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kdecode.ragged_gather(cpu, cpu, cpu)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kdecode.dense_unpack(cpu, cpu)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kft.fused_transform(cpu, z, z, z)
    from repro_torch.kernels import embedding_bag as kembag

    table = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kembag.embedding_bag(table, cpu[:, :3].contiguous(), torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.embedding_bag(_Elsewhere(table), meta, meta.float())
    out = ops.embedding_bag(table.to("meta"), meta, meta.float())
    assert (out.device.type, out.shape, out.dtype) == ("meta", (2, 8), torch.float32)


def test_launch_counts():
    from repro_torch.kernels.build import LaunchCounts

    c = LaunchCounts()
    c.add("a")
    c.add("a")
    c.add("b")
    assert c.snapshot() == {"a": 2, "b": 1}
    c.reset()
    assert c.snapshot() == {}


# -- embedding_bag (the trainer slice) ----------------------------------------
#
# The bag shapes of the reference's own differential suite (empty bags,
# single ids, duplicate ids in one bag, the last row, random 0/1 masks).
# With 0/1 masks every product is exact, so the plain version's separate
# multiply and add give the bits of XLA's fused multiply-add: bit-exact.


def _bags(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        v, e, b, l = 16, 8, 4, 5
        ids = rng.integers(0, v, (b, l))
        mask = np.zeros((b, l))
    elif kind == "single":
        v, e, b, l = 32, 16, 6, 4
        ids = rng.integers(0, v, (b, l))
        mask = np.zeros((b, l))
        mask[np.arange(b), np.arange(b) % l] = 1.0
    elif kind == "duplicates":
        v, e = 8, 8
        ids = np.array([[3, 3, 3, 5], [0, 0, 7, 7]])
        mask = np.ones((2, 4))
    elif kind == "last_row":
        v, e = 19, 8
        ids = np.full((3, 4), v - 1)
        mask = np.ones((3, 4))
    else:                                   # random bags, E and L not multiples of 32
        v, e, b, l = 300, 40, 64, 33
        ids = rng.integers(0, v, (b, l))
        mask = (rng.random((b, l)) < 0.5).astype(np.float64)
    table = rng.standard_normal((v, e)).astype(np.float32)
    return table, ids.astype(np.int32), mask.astype(np.float32)


def _same_bits(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.int32),
                                  np.asarray(want, np.float32).view(np.int32))


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("kind", ["empty", "single", "duplicates", "last_row", "random"])
def test_embedding_bag_matches_pallas(kind, mode):
    table, ids, mask = _bags(kind)
    want = np.asarray(jops.embedding_bag(table, ids, mask, mode=mode, use_pallas=True))
    got = ops.embedding_bag(_t(table), _t(ids), _t(mask), mode=mode).numpy()
    _same_bits(got, want)
    if kind == "empty":
        _same_bits(got, np.zeros_like(want))
    if kind == "duplicates":
        want0 = 3 * table[3] + table[5]
        np.testing.assert_allclose(got[0], want0 / 4 if mode == "mean" else want0, rtol=1e-6)


def _separately_rounded(table, ids, mask, mode):
    """numpy: each product and each sum rounded to float32 on its own."""
    out = np.zeros((ids.shape[0], table.shape[1]), np.float32)
    denom = np.zeros((ids.shape[0], 1), np.float32)
    for j in range(ids.shape[1]):
        w = mask[:, j:j + 1]
        out = out + table[ids[:, j]] * w
        denom = denom + w
    return out / np.maximum(denom, np.float32(1)) if mode == "mean" else out


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_embedding_bag_fractional_weights(mode):
    """Fractional mask weights: XLA on the CPU contracts the reference's
    ``out += row * m`` into one FMA, while the port rounds the product and
    the sum apart (as its CUDA kernel does, so the two agree bit for bit on
    the card).  Against the reference the difference is bounded by 1e-6 of
    the bag's sum of magnitudes; against numpy rounding apart it is 0."""
    rng = np.random.default_rng(9)
    table = rng.standard_normal((50, 24)).astype(np.float32)
    ids = rng.integers(0, 50, (20, 17)).astype(np.int32)
    mask = (rng.random((20, 17)) * (rng.random((20, 17)) < 0.8)).astype(np.float32)
    mask[0, :3] = [0.25, 1.5, 3.0]
    got = ops.embedding_bag(_t(table), _t(ids), _t(mask), mode=mode).numpy()
    _same_bits(got, _separately_rounded(table, ids, mask, mode))
    want = np.asarray(jops.embedding_bag(table, ids, mask, mode=mode, use_pallas=True))
    scale = np.einsum("bl,ble->be", np.abs(mask), np.abs(table[ids]))
    if mode == "mean":
        scale = scale / np.maximum(mask.sum(1, keepdims=True), 1.0)
    assert (np.abs(got - want) <= 1e-6 * scale).all()


def test_embedding_bag_nan_inf_rows_and_nan_mask():
    """NaN and inf rows are summed under a mask of 0 (every slot counts,
    as in the TPU kernel), and a NaN mask keeps the mean's denominator
    NaN (jnp.maximum, not fmaxf)."""
    table = np.array([[1, 2, 3, 4], [np.nan, np.inf, -np.inf, 1], [5, 6, 7, 8]],
                     np.float32)
    ids = np.array([[0, 1], [2, 2], [1, 1], [0, 2]], np.int32)
    mask = np.array([[1, 0], [1, 1], [0, 0], [np.nan, 1]], np.float32)
    for mode in ("mean", "sum"):
        want = np.asarray(jops.embedding_bag(table, ids, mask, mode=mode, use_pallas=True))
        got = ops.embedding_bag(_t(table), _t(ids), _t(mask), mode=mode).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
        assert np.isnan(got[0, :3]).all() and np.isnan(got[3]).all()


def test_embedding_bag_subnormals_kept_where_xla_flushes():
    """XLA on the CPU flushes subnormal rows; the port's plain version (and
    its kernel, built without --ftz) keeps them."""
    table = np.array([[1e-40, -1e-42, 1.0]], np.float32)
    ids = np.zeros((1, 2), np.int32)
    mask = np.array([[1.0, 0.0]], np.float32)
    xla = np.asarray(jops.embedding_bag(table, ids, mask, mode="sum", use_pallas=True))
    got = ops.embedding_bag(_t(table), _t(ids), _t(mask), mode="sum").numpy()
    assert list(xla.ravel()) == [0.0, 0.0, 1.0]
    _same_bits(got, table)


def test_embedding_bag_clamps_ids_and_checks_mode():
    table, ids, mask = _bags("random", seed=4)
    wild = ids.copy()
    wild[0, 0], wild[1, 1] = -7, 10 ** 6
    fixed = np.clip(wild, 0, table.shape[0] - 1)
    _same_bits(ops.embedding_bag(_t(table), _t(wild), _t(mask), mode="sum").numpy(),
               ops.embedding_bag(_t(table), _t(fixed), _t(mask), mode="sum").numpy())
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag(_t(table), _t(ids), _t(mask), mode="max")


def test_rowwise_adagrad_plain_route_against_a_loop():
    """``ops.rowwise_adagrad_`` on CPU tensors (the plain route; the
    reference updates its tables with XLA scatters, no kernel) against a
    float64 loop over the occurrences: negative keys skipped, duplicates
    each counted, every accumulator entry complete before any row moves.
    The op returns its operands, updated in place; on ``meta`` it returns
    them untouched."""
    rng = np.random.default_rng(11)
    m, l, e, rows, lr, eps = 6, 5, 8, 10, 0.1, 1e-8
    keys = rng.integers(-2, rows, (m, l)).astype(np.int32)
    keys[0] = 3                                   # one row named by a whole bag
    w = rng.random((m, l)).astype(np.float32)
    w[1, :2] = 0.0
    grad = rng.normal(0, 1, (m, e)).astype(np.float32)
    table = rng.normal(0, 1, (rows, e)).astype(np.float32)
    acc = rng.random(rows).astype(np.float32)
    occ = [(k, float(w[i, j]) * grad[i].astype(np.float64))
           for (i, j), k in np.ndenumerate(keys) if k >= 0]
    want_a, want_t = acc.astype(np.float64), table.astype(np.float64)
    for k, g in occ:
        want_a[k] += np.mean(g * g)
    for k, g in occ:
        want_t[k] -= lr / np.sqrt(want_a[k] + eps) * g
    t, a = _t(table.copy()), _t(acc.copy())
    out = ops.rowwise_adagrad_(t, a, _t(keys), _t(w), _t(grad), lr, eps)
    assert out[0] is t and out[1] is a
    np.testing.assert_allclose(a.numpy(), want_a, rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), want_t, rtol=1e-5, atol=1e-6)
    assert not np.array_equal(t.numpy()[3], table[3])
    untouched = sorted(set(range(rows)) - set(keys[keys >= 0].tolist()))
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
    meta = [x.to("meta") for x in (_t(table), _t(acc), _t(keys), _t(w), _t(grad))]
    got = ops.rowwise_adagrad_(*meta, lr, eps)
    assert got[0] is meta[0] and got[1] is meta[1]
