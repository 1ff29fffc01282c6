"""The port's CUDA kernels against their plain versions on the card.

A CUDA kernel has no CPU mode, so these tests are marked ``cuda`` and
skip where there is no GPU.  They import neither JAX nor the reference
package, so they run on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q

``chip_smoke.py`` holds every kernel to its plain version more widely
(main-path operands and adversarial inputs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro_torch.kernels import bucketize as kbucketize  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import decode as kdecode  # noqa: E402
from repro_torch.kernels import embedding_bag as kbag  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import fused_transform as kft  # noqa: E402
from repro_torch.kernels import sigrid_hash as ksigrid  # noqa: E402
from repro_torch.kernels import ssd_chunk as kssd  # noqa: E402

# the reference's own kernel sweep (tests/test_kernels.py) holds its Pallas
# flash attention to its dense oracle within these, on unit-normal operands
SWEEP_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, dtype):
    """GQA (8 query heads over 2 KV heads), S not a multiple of the
    tiles, T != S, causal and full, within the sweep's tolerance, through
    the route the operands pick (float32: the FMA kernel; bf16 at D=64:
    the tensor-core kernel), counted under that route's name."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 8, 65, 64)).astype(np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 100, 64)).astype(np.float32))
            .to(cuda, dtype) for _ in range(2))
    name = {"sm90": "flash_attention_sm90", "fma": "flash_attention"}[kflash.route(q, k, v)]
    before = build.LAUNCHES.snapshot().get(name, 0)
    tol = SWEEP_TOL[dtype]
    for causal in (True, False):
        got = kflash.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=tol, atol=tol)
    assert build.LAUNCHES.snapshot()[name] == before + 2


@pytest.mark.cuda
def test_flash_kernel_gqa_layout_matches_plain(cuda):
    """The model's (B, S, H, D) / (B, T, KVH, D) tensors passed as
    transposed views, read in place through strides, give what contiguous
    (B, H, S, D) copies give, and the output keeps the model's layout."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 33, 4, 32)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((2, 33, 1, 32)).astype(np.float32)).to(cuda)
            for _ in range(2))
    got = kflash.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=True).transpose(1, 2)
    want = kflash.flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), causal=True).transpose(1, 2)
    torch.cuda.synchronize()
    assert got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [160, 192])
def test_flash_kernel_mla_head_dims_match_plain(cuda, dtype, d):
    """Head dims above 128 (MLA's prefill attends at 192) on the FMA
    route: GQA 8 over 2, S = 65 against T = 100, causal and full, within
    the sweep's tolerance; then MLA's own layout at D = 192: transposed
    (B, S, H, D) views, v's last 64 columns zero as MLA pads them, scale
    1/sqrt(192), the padded output columns exactly 0."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((2, 8, 65, d)).astype(np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 100, d)).astype(np.float32))
            .to(cuda, dtype) for _ in range(2))
    assert kflash.route(q, k, v) == "fma"
    before = build.LAUNCHES.snapshot().get("flash_attention", 0)
    tol = SWEEP_TOL[dtype]
    for causal in (True, False):
        got = kflash.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=tol, atol=tol)
    assert build.LAUNCHES.snapshot()["flash_attention"] == before + 2
    if d != 192:
        return
    qm, km = (torch.from_numpy(rng.standard_normal((2, 70, 4, 192)).astype(np.float32))
              .to(cuda, dtype) for _ in range(2))
    vm = torch.zeros_like(km)
    vm[..., :128] = torch.from_numpy(rng.standard_normal((2, 70, 4, 128))
                                     .astype(np.float32)).to(cuda, dtype)
    views = [x.transpose(1, 2) for x in (qm, km, vm)]
    scale = 1 / np.sqrt(192)
    got = kflash.flash_attention(*views, causal=True, scale=scale)
    want = ref.flash_attention(*views, causal=True, scale=scale)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)
    assert not got[..., 128:].any()


def _bf16(cuda, rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_sm90_tile_products(cuda, d):
    """One tile of the tensor-core kernel's two wgmma products against
    float32 products of the same bf16 operands: s = q.k^T (both operands
    K-major through 128-byte-swizzle descriptors) and o = bf16(s).v (the
    accumulator fragment re-used as the A registers, v N-major).  Each
    product is exact a term in float32 and summed in another order, so
    within 1e-4 of the reference's rms; a wrong descriptor or fragment
    layout moves elements by about the rms itself.  Rows of q are read
    from a wider tensor (a 16-byte-aligned row stride)."""
    rng = np.random.default_rng(3 + d)
    q = _bf16(cuda, rng, (128, d + 64))[:, 32:32 + d]
    k, v = _bf16(cuda, rng, (128, d)), _bf16(cuda, rng, (128, d))
    s, o = kflash.flash_attention_sm90_tile(q, k, v)
    torch.cuda.synchronize()
    want_s = q.float() @ k.float().T
    want_o = s.to(torch.bfloat16).float() @ v.float()
    for got, want in ((s, want_s), (o, want_o)):
        rms = float(want.square().mean().sqrt())
        err = float((got - want).abs().max())
        assert err <= 1e-4 * rms, (err, rms)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,s,t,d,causal", [
    (2, 8, 2, 1000, 1000, 128, True),     # ragged last tiles, GQA 4
    (1, 4, 4, 129, 300, 64, False),       # T != S, full attention, no GQA
    (1, 8, 1, 127, 127, 128, True),       # GQA 8, one partial tile
])
def test_flash_sm90_matches_plain(cuda, b, h, kvh, s, t, d, causal):
    """The tensor-core route, whole, against ``ref.flash_attention`` in bf16
    within the sweep's tolerance."""
    rng = np.random.default_rng(s + t + d)
    q, k, v = _bf16(cuda, rng, (b, h, s, d)), _bf16(cuda, rng, (b, kvh, t, d)), \
        _bf16(cuda, rng, (b, kvh, t, d))
    assert kflash.route(q, k, v) == "sm90"
    got = kflash.flash_attention_sm90(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = SWEEP_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_sm90_model_layout_matches_contiguous(cuda):
    """The main path's transposed (B, S, H, D) / (B, T, KVH, D) bf16 views,
    read in place through the tensor maps' strides, give bit for bit what
    contiguous (B, H, S, D) copies give, and the output keeps the model's
    layout."""
    rng = np.random.default_rng(6)
    q = _bf16(cuda, rng, (2, 200, 16, 128))
    k, v = _bf16(cuda, rng, (2, 200, 4, 128)), _bf16(cuda, rng, (2, 200, 4, 128))
    views = [x.transpose(1, 2) for x in (q, k, v)]
    assert kflash.route(*views) == "sm90"
    got = kflash.flash_attention(*views, causal=True).transpose(1, 2)
    want = kflash.flash_attention(*(x.contiguous() for x in views),
                                  causal=True).transpose(1, 2)
    torch.cuda.synchronize()
    assert got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_route_counts(cuda):
    """bf16 at D=128 launches the tensor-core kernel; float32 and bf16 at
    D=48 launch the FMA kernel; each counts under its own name only.  The
    tensor-core wrapper refuses what its route does not take."""
    rng = np.random.default_rng(8)
    cases = [(torch.bfloat16, 128, "flash_attention_sm90"),
             (torch.float32, 128, "flash_attention"), (torch.bfloat16, 48, "flash_attention")]
    for dtype, d, name in cases:
        q = torch.from_numpy(rng.standard_normal((1, 4, 40, d)).astype(np.float32)).to(cuda, dtype)
        k = torch.from_numpy(rng.standard_normal((1, 2, 40, d)).astype(np.float32)).to(cuda, dtype)
        before = build.LAUNCHES.snapshot()
        kflash.flash_attention(q, k, k)
        torch.cuda.synchronize()
        after = build.LAUNCHES.snapshot()
        moved = {n for n in ("flash_attention", "flash_attention_sm90")
                 if after.get(n, 0) != before.get(n, 0)}
        assert moved == {name}
        assert after[name] == before.get(name, 0) + 1
        if name == "flash_attention":
            with pytest.raises(ValueError, match="flash_attention_sm90: takes bf16"):
                kflash.flash_attention_sm90(q, k, k)


# ssd_chunk_forward against the sequential float32 recurrence, per element
# within atol * rms(want) + rtol * |want|: float32 the reference sweep's
# (5e-4, 1e-3; tests/test_kernels.py); bf16 2e-2 of both, as the
# flash_attention sweep's bf16 bound (m is rounded to bf16 before m.x, a
# 2^-9 relative error a term, and y to bf16 at the end)
SSD_TOL = {torch.float32: (5e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}


def _ssd_close(got, want, dtype):
    atol, rtol = SSD_TOL[dtype]
    got, want = got.float(), want.float()
    rms = float(want.square().mean().sqrt())
    assert bool(((got - want).abs() <= atol * rms + rtol * want.abs()).all()), \
        float((got - want).abs().max()) / rms


def _ssd_operands(cuda, dtype, b, s, h, p, g, n, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn((b, s, h, p), generator=gen) * 0.5).to(cuda, dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen)).to(cuda)
    a = (-torch.exp(torch.randn(h, generator=gen) * 0.3)).to(cuda)
    bm = (torch.randn((b, s, g, n), generator=gen) * 0.5).to(cuda, dtype)
    cm = (torch.randn((b, s, g, n), generator=gen) * 0.5).to(cuda, dtype)
    return x, dt, a, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk,h,p,g,n", [
    (100, 32, 4, 16, 2, 64),         # ragged last chunk, two groups
    (256, 256, 8, 64, 1, 128),       # one full chunk at the model's P and N
    (300, 128, 2, 128, 1, 16),       # P of 128, a short N
])
def test_ssd_kernel_matches_plain(cuda, dtype, s, chunk, h, p, g, n):
    """y and the final state (B, H, P, N) against ``ref.ssd_scan``, from a
    zero and from a given initial state, through the route the operands
    pick (bf16 at P 64, N 128, chunk 256: the tensor-core kernel; the
    others: the FMA kernel), counted under that route's name."""
    x, dt, a, bm, cm = _ssd_operands(cuda, dtype, 2, s, h, p, g, n, s + p)
    init = torch.randn((2, h, p, n), device=cuda)
    name = {"sm90": "ssd_chunk_forward_sm90",
            "fma": "ssd_chunk_forward"}[kssd.route(x, bm, cm, chunk)]
    before = build.LAUNCHES.snapshot().get(name, 0)
    for start in (None, init):
        y, state = kssd.ssd_chunk_forward(x, dt, a, bm, cm, chunk=chunk, initial_state=start)
        want_y, want_state = ref.ssd_scan(x, dt, a, bm, cm, start)
        torch.cuda.synchronize()
        assert y.dtype == dtype and state.dtype == torch.float32
        assert state.shape == (2, h, p, n)
        _ssd_close(y, want_y, dtype)
        _ssd_close(state, want_state, torch.float32)
    assert build.LAUNCHES.snapshot()[name] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("s,chunk,h,p,g,n", [
    (100, 64, 4, 64, 2, 64),         # ragged last chunk, two groups
    (256, 256, 8, 64, 1, 128),       # one full chunk at the model's P and N
    (300, 128, 2, 128, 1, 64),       # P of 128 (two column tiles), N of 64
])
def test_ssd_tensor_core_route_matches_plain(cuda, s, chunk, h, p, g, n):
    """The tensor-core route over the grid above with P and N it takes
    (bf16 only): y within the bf16 bound and the final state within the
    float32 bound of ``ref.ssd_scan``, from a zero and from a given
    initial state; both launches counted as ``ssd_chunk_forward_sm90``,
    none as the FMA route's; and within the same bounds of the FMA route
    on the same operands."""
    x, dt, a, bm, cm = _ssd_operands(cuda, torch.bfloat16, 2, s, h, p, g, n, s + n)
    assert kssd.route(x, bm, cm, chunk) == "sm90"
    init = torch.randn((2, h, p, n), device=cuda)
    before = build.LAUNCHES.snapshot()
    for start in (None, init):
        y, state = kssd.ssd_chunk_forward_sm90(x, dt, a, bm, cm, chunk=chunk,
                                               initial_state=start)
        want_y, want_state = ref.ssd_scan(x, dt, a, bm, cm, start)
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16 and state.shape == (2, h, p, n)
        _ssd_close(y, want_y, torch.bfloat16)
        _ssd_close(state, want_state, torch.float32)
    after = build.LAUNCHES.snapshot()
    assert after["ssd_chunk_forward_sm90"] == before.get("ssd_chunk_forward_sm90", 0) + 2
    assert after.get("ssd_chunk_forward", 0) == before.get("ssd_chunk_forward", 0)
    fma_y, fma_state = kssd.ssd_chunk_forward_fma(x, dt, a, bm, cm, chunk=chunk,
                                                  initial_state=init)
    _ssd_close(y, fma_y, torch.bfloat16)
    _ssd_close(state, fma_state, torch.float32)
    with pytest.raises(ValueError, match="ssd_chunk_forward_sm90: takes bf16"):
        kssd.ssd_chunk_forward_sm90(x.float(), dt, a, bm.float(), cm.float(), chunk=chunk)


@pytest.mark.cuda
def test_ssd_kernel_tpu_layout_and_strided_operands(cuda):
    """The TPU kernel's (BH, S, P) form (H = G = 1, A per row) gives the
    reference oracle's function; operands read through strides (x a slice
    of a wider tensor) give what contiguous copies give."""
    x, dt, a, bm, cm = _ssd_operands(cuda, torch.float32, 1, 64, 6, 32, 6, 16, 3)
    rows = [t[0].transpose(0, 1).contiguous() for t in (x, dt, bm, cm)]
    ab = a.clone()
    y, state = kssd.ssd_chunk_forward(rows[0][:, :, None], rows[1][:, :, None], ab[:, None],
                                      rows[2][:, :, None], rows[3][:, :, None], chunk=16)
    want_y, want_state = ref.ssd_chunk_forward(rows[0], rows[1], ab, rows[2], rows[3])
    _ssd_close(y[:, :, 0], want_y, torch.float32)
    _ssd_close(state[:, 0].transpose(-1, -2), want_state, torch.float32)
    wide = torch.randn((1, 64, 6, 48), device=cuda)
    wide[..., :32] = x
    got, got_state = kssd.ssd_chunk_forward(wide[..., :32], dt, a, bm, cm, chunk=16)
    want, want_s = kssd.ssd_chunk_forward(x.contiguous(), dt, a, bm, cm, chunk=16)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_state, want_s)


@pytest.mark.cuda
def test_sigrid_hash_kernel_bit_exact(cuda):
    """Aligned and unaligned tiles, odd sizes, INT_MIN/-1/0 ids, the extreme
    salts and moduli (remainders above INT_MAX wrap negative)."""
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, 4099, dtype=np.int64)
                           .astype(np.int32)).to(cuda)
    ids[:3] = torch.tensor([-(2 ** 31), -1, 0], dtype=torch.int32)
    before = build.LAUNCHES.snapshot().get("sigrid_hash", 0)
    for t in (ids, ids[1:], ids[:4096].view(64, 64)):
        for salt, mv in ((0, 1), (2 ** 32 - 1, 2 ** 31 - 1), (7, 2 ** 31 + 5),
                         (123, 2 ** 32 - 1), (5, 2_000_000)):
            assert torch.equal(ksigrid.sigrid_hash(t, salt, mv), ref.sigrid_hash(t, salt, mv))
    assert build.LAUNCHES.snapshot()["sigrid_hash"] == before + 15


SIGRID_DIVISORS = (1, 2, 3, 7, 2 ** 16 + 1, 2_000_000, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                   2 ** 31 + 5, 2 ** 32 - 2, 2 ** 32 - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 5, 4 * 1000 + 1, 4 * 1000 + 2, 4 * 1000 + 3, 70_001])
@pytest.mark.parametrize("offset", [0, 1])
def test_sigrid_hash_divisors_and_tails_bit_exact(cuda, n, offset):
    """The kernel against ``ref.sigrid_hash`` over every divisor of the CPU
    mirror's test, INT_MIN/-1/0 ids and both extreme salts, on tiles whose
    n % 4 tail the kernel takes element by element; at offset 1 the tile
    is a view 4 bytes past a 16-byte boundary, which takes no vector at
    all.  One launch a call."""
    rng = np.random.default_rng(n)
    base = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, n + 1, dtype=np.int64)
                            .astype(np.int32)).to(cuda)
    ids = base[offset:offset + n]
    ids[-3:] = torch.tensor([-(2 ** 31), -1, 0], dtype=torch.int32)[-n:]
    assert ids.data_ptr() % 16 == 4 * offset
    before = build.LAUNCHES.snapshot().get("sigrid_hash", 0)
    calls = 0
    for salt in (0, 2 ** 32 - 1):
        for mv in SIGRID_DIVISORS:
            got = ksigrid.sigrid_hash(ids, salt, mv)
            torch.cuda.synchronize()
            assert torch.equal(got, ref.sigrid_hash(ids, salt, mv)), (salt, mv)
            calls += 1
    assert build.LAUNCHES.snapshot()["sigrid_hash"] == before + calls


@pytest.mark.cuda
def test_bucketize_kernel_bit_exact(cuda):
    """NaN, infinite, subnormal and signed-zero values; NaN, unsorted and
    signed-zero borders; sorted borders with ties (runs of equal borders,
    -0.0/+0.0 pairs), searched rather than counted; 0, 1, 63 and 5000
    borders (sorted and not); value tensors 16- and 8-byte aligned with
    even lengths, aligned with a ragged tail, and unaligned."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy((rng.standard_normal(3001) * 3).astype(np.float32)).to(cuda)
    v[:8] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40,
                          -1e-40, 1.0])
    v[8:40] = torch.tensor([-1.0, 0.0, -0.0, 1.0, 2.0, -2.0, 1e-40, 3.0] * 4)   # on the ties
    many = rng.standard_normal(5000).astype(np.float32)
    borders = [torch.zeros(0), torch.tensor([0.0]), torch.linspace(-3, 3, 63),
               torch.tensor([-0.0, 0.0, float("nan"), 2.0, -1.0, 1e-40]),
               torch.tensor([-2.0, -1.0, -1.0, -1.0, -0.0, 0.0, -0.0, 0.0, 1e-40, 1.0, 1.0,
                             2.0, 2.0]),
               torch.from_numpy(np.sort(many).round(1)),
               torch.from_numpy(many)]
    values = (v, v[:3000], v[4:], v[2:3000], v[1:].view(-1, 1000))
    for bd in borders:
        bd = bd.to(cuda)
        for t in values:
            assert torch.equal(kbucketize.bucketize(t, bd), ref.bucketize(t, bd))


def _f32_bits(v):
    return int(np.float32(v).view(np.int32))


def _wave(rng, feats, rows, codes, nb=63, borders=None):
    """A features-major int32 tile with its op codes, params and borders:
    floats (NaN, +-inf, +-0.0, subnormals among them) in CLAMP_F and
    BUCKETIZE_F features, full-range ints in the others."""
    ints = rng.integers(-(2 ** 31), 2 ** 31, (feats, rows), dtype=np.int64).astype(np.int32)
    floats = (rng.standard_normal((feats, rows)) * 3).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 1.0, -1.0][:rows]
    floats[:, : len(special)] = special
    is_f = np.isin(codes, (ref.OP_CLAMP_F, ref.OP_BUCKETIZE_F))[:, None]
    mat = np.where(is_f, floats.view(np.int32), ints)
    p0 = np.where(codes == ref.OP_CLAMP_F, _f32_bits(-1.5), 7).astype(np.int32)
    p1 = np.where(codes == ref.OP_CLAMP_F, _f32_bits(2.0), 1009).astype(np.int32)
    p0[codes == ref.OP_CLAMP] = -50
    p1[codes == ref.OP_CLAMP] = 50
    if borders is None:
        borders = np.tile(np.linspace(-3, 3, nb).astype(np.float32), (feats, 1))
    return mat, codes.astype(np.int32), p0, p1, borders.astype(np.float32)


def _ft_both_routes(cuda, mat, codes, p0, p1, brd):
    """The tile through ``fused_transform``, and through both routes where
    the vec route takes it; each bit-exact against the plain version."""
    m, c, a, b, bd = (torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
                      for x in (mat, codes, p0, p1, brd))
    want = ref.fused_transform(m.T.contiguous(), c, a, b, bd).T
    fns = [kft.fused_transform]
    if kft.route(m, features_major=True) == "vec":
        fns += [kft.fused_transform_vec, kft.fused_transform_scalar]
    for fn in fns:
        got = fn(m, c, a, b, bd, features_major=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__
    return kft.route(m, features_major=True)


@pytest.mark.cuda
@pytest.mark.parametrize("feats,rows,kind", [
    (32, 1024, "hash"),          # wave 0 cut: SigridHash ids
    (21, 512, "dense"),          # wave 1 cut: CLAMP_F and BUCKETIZE_F over 63 borders
    (14, 2048, "every op"),
])
def test_fused_transform_routes_match_plain(cuda, feats, rows, kind):
    """Small versions of the main path's two waves and a tile of every op
    code, features-major with rows a multiple of 4: the vec route the
    engine's tiles take and the general route, bit-exact."""
    rng = np.random.default_rng(feats + rows)
    codes = {"hash": np.full(feats, ref.OP_SIGRID_HASH),
             "dense": np.array([ref.OP_CLAMP_F] * 5 + [ref.OP_BUCKETIZE_F] * (feats - 5)),
             "every op": np.arange(feats) % 8}[kind]
    assert _ft_both_routes(cuda, *_wave(rng, feats, rows, codes)) == "vec"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [37, 38, 39, 40, 1, 4])
def test_fused_transform_ragged_rows_match_plain(cuda, rows):
    """Rows 4k+1..4k+3 take the general route, 4k the vec route; both
    bit-exact on every op code."""
    rng = np.random.default_rng(rows)
    taken = _ft_both_routes(cuda, *_wave(rng, 8, rows, np.arange(8)))
    assert taken == ("vec" if rows % 4 == 0 else "scalar")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1024, 6])
def test_fused_transform_identity_lanes_match_plain(cuda, rows):
    """A wave mixing OP_IDENTITY lanes with real ops (the reference's
    identity-lane differential): both routes bit-exact against the plain
    version (rows 6: the general route alone), the identity columns
    unchanged."""
    rng = np.random.default_rng(rows)
    codes = np.array([ref.OP_IDENTITY, ref.OP_SIGRID_HASH, ref.OP_IDENTITY,
                      ref.OP_POSITIVE_MODULUS, ref.OP_IDENTITY, ref.OP_CLAMP,
                      ref.OP_IDENTITY, ref.OP_BUCKETIZE])
    mat, c, p0, p1, brd = _wave(rng, len(codes), rows, codes)
    assert _ft_both_routes(cuda, mat, c, p0, p1, brd) == ("vec" if rows % 4 == 0 else "scalar")
    m = torch.from_numpy(mat).to(cuda)
    got = kft.fused_transform(m, *(torch.from_numpy(x).to(cuda) for x in (c, p0, p1, brd)),
                              features_major=True).cpu().numpy()
    lanes = codes == ref.OP_IDENTITY
    np.testing.assert_array_equal(got[lanes], mat[lanes])
    assert not np.array_equal(got[~lanes], mat[~lanes])


@pytest.mark.cuda
def test_fused_transform_vec_route_counts_unsorted_and_nan_borders(cuda):
    """BUCKETIZE_F border rows the engine never fuses, in a features-major
    tile the vec route takes: unsorted, tied, signed zeros, +inf inside the
    row, NaN, one NaN border, 300 unsorted borders; the count's bits."""
    inf, nan = np.inf, np.nan
    nb = 300
    rows_b = [[2.0, -1.0, 0.5, -3.0], [-1.0, -1.0, -1.0, 0.0, 0.0, 1.0], [-0.0, 0.0, -0.0],
              [0.0, -0.0], [-1.0, inf, inf], [-1.0, nan, 0.5], [nan], [0.0, 1.0, nan],
              [1e-40, -1e-42, 3e-39]]
    rng = np.random.default_rng(3)
    brd = np.stack([np.pad(np.array(r, np.float32), (0, nb - len(r)), constant_values=inf)
                    for r in rows_b] + [rng.standard_normal(nb).astype(np.float32)])
    feats = brd.shape[0]
    codes = np.full(feats, ref.OP_BUCKETIZE_F)
    assert _ft_both_routes(cuda, *_wave(rng, feats, 1024, codes, borders=brd)) == "vec"


def _bag_operands(cuda, rng, v, e, b, l):
    table = rng.standard_normal((v, e)).astype(np.float32)
    table[1, :2] = [np.nan, np.inf]
    table[2] = 1e-40
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    mask = (rng.random((b, l)) < 0.7).astype(np.float32)
    if l:
        mask[0] *= 0.37                    # fractional weights
        mask[-1] = 0.0                     # an empty bag
        ids[1, 0], ids[-2, -1] = -5, v + 2  # clamped
        ids[2, 0] = 1                      # NaN/inf row ...
        mask[2, 0] = 0.0                   # ... under a mask of 0
    return tuple(torch.from_numpy(x).to(cuda) for x in (table, ids, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("v,e,b,l", [
    (4096, 128, 300, 32),        # the trainer's lookup, cut: E 128, 32 slots
    (64, 4, 40, 1), (200, 124, 33, 31), (300, 128, 50, 33), (150, 132, 20, 32),
    (64, 512, 16, 300), (80, 40, 9, 7),
])
def test_embedding_bag_routes_match_plain(cuda, v, e, b, l):
    """E a multiple of 4 up to 512 takes the warp route; it and the block
    route give the plain version's bits in both modes (L of 1 to 300, E of
    one to four 128-column stripes, NaN/inf rows under a mask of 0,
    subnormal rows, clamped ids, an empty bag)."""
    rng = np.random.default_rng(e + l)
    table, ids, mask = _bag_operands(cuda, rng, v, e, b, l)
    assert kbag.route(table) == "warp"
    for mode in ("mean", "sum"):
        want = ref.embedding_bag(table, ids, mask, mode=mode).view(torch.int32)
        for fn in (kbag.embedding_bag, kbag.embedding_bag_warp, kbag.embedding_bag_block):
            got = fn(table, ids, mask, mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want), (fn.__name__, mode)


@pytest.mark.cuda
def test_fused_transform_and_embedding_bag_route_counts(cuda):
    """Each call counts under its route's name only: a features-major tile
    with rows a multiple of 4 and E of 128 launch the new routes, a
    rows-major tile, 37 rows and E of 42 the general ones; the new routes'
    wrappers refuse what they do not take."""
    rng = np.random.default_rng(9)
    names = ("fused_transform", "fused_transform_vec", "embedding_bag", "embedding_bag_warp")

    def moved(fn):
        before = build.LAUNCHES.snapshot()
        fn()
        torch.cuda.synchronize()
        after = build.LAUNCHES.snapshot()
        return {n: after.get(n, 0) - before.get(n, 0) for n in names
                if after.get(n, 0) != before.get(n, 0)}

    m, c, a, b, bd = (torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
                      for x in _wave(rng, 8, 512, np.arange(8)))
    ragged = m[:, :37].contiguous()
    assert moved(lambda: kft.fused_transform(m, c, a, b, bd, features_major=True)) == \
        {"fused_transform_vec": 1}
    assert moved(lambda: kft.fused_transform(m.T.contiguous(), c, a, b, bd)) == \
        {"fused_transform": 1}
    assert moved(lambda: kft.fused_transform(ragged, c, a, b, bd, features_major=True)) == \
        {"fused_transform": 1}
    with pytest.raises(ValueError, match="fused_transform_vec: takes features-major"):
        kft.fused_transform_vec(ragged, c, a, b, bd, features_major=True)
    table, ids, mask = _bag_operands(cuda, rng, 64, 128, 10, 32)
    narrow, _, _ = _bag_operands(cuda, rng, 64, 42, 10, 32)
    assert moved(lambda: kbag.embedding_bag(table, ids, mask)) == {"embedding_bag_warp": 1}
    assert moved(lambda: kbag.embedding_bag(narrow, ids, mask)) == {"embedding_bag": 1}
    with pytest.raises(ValueError, match="embedding_bag_warp: takes E a multiple of 4"):
        kbag.embedding_bag_warp(narrow, ids, mask)



# -- dense_unpack and ragged_gather, both routes each ----------------------------------

def _moved(fn, names):
    """The launch counts that ``fn`` moved, by name."""
    before = build.LAUNCHES.snapshot()
    fn()
    torch.cuda.synchronize()
    after = build.LAUNCHES.snapshot()
    return {n: after.get(n, 0) - before.get(n, 0) for n in names
            if after.get(n, 0) != before.get(n, 0)}


def _unpack_operands(cuda, rng, w, c, densities=(0.0, 1.0, 0.5, 0.9, 0.05, 0.3)):
    """Features of ``w`` packbits words, one a density (0.0: all absent, 1.0:
    all present); values of C columns, full-range ints with NaN payloads,
    infinities, signed zeros and subnormals at the front."""
    bitmap = np.zeros((len(densities), w), np.int32)
    values = rng.integers(-(2 ** 31), 2 ** 31, (len(densities), c),
                          dtype=np.int64).astype(np.int32)
    special = np.array([0x7FC00001, 0x7F800001, 0xFFC00000, 0x7F800000, 0x80000000, 0,
                        1, 0x807FFFFF], np.uint32).view(np.int32)
    k = min(c, len(special))
    values[:, :k] = special[:k]
    for f, dens in enumerate(densities):
        present = rng.random(32 * w) < dens
        bitmap[f] = np.packbits(present.astype(np.uint8)).view("<i4")
    return torch.from_numpy(bitmap).to(cuda), torch.from_numpy(values).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("w", list(range(1, 33)) + [33, 64, 1250])
def test_dense_unpack_routes_match_plain(cuda, w):
    """W of 1 to 32 takes the warp route, wider bitmaps the block route;
    both give the plain version's bits with C of 1, C fewer than the rows
    present (ranks clipped to C - 1), C of 32 W and C above it (the main
    path's 478 too), on all-absent and all-present features, NaN-payload
    and subnormal value bits."""
    rng = np.random.default_rng(w)
    warp = kdecode.dense_unpack_route(torch.empty((1, w))) == "warp"
    assert warp == (w <= 32)
    fns = [kdecode.dense_unpack, kdecode.dense_unpack_block]
    if warp:
        fns.append(kdecode.dense_unpack_warp)
    for c in sorted({1, 3, 16 * w, 32 * w, 32 * w + 5, 478}):
        bm, vals = _unpack_operands(cuda, rng, w, c)
        want = ref.dense_unpack(bm, vals)
        for fn in fns:
            got = fn(bm, vals)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (fn.__name__, c)


def _gather_operands(cuda, rng, m, n_src_rows=40):
    """idx and shift as the engine lays them out: runs of consecutive source
    words, one shift a run, runs of random even lengths; then pairs of
    non-consecutive indices, a pair that straddles two runs, a pair that
    mixes shifts and the last word pair (idx n - 2, shift 24)."""
    n = n_src_rows * 128
    src = rng.integers(-(2 ** 31), 2 ** 31, (n_src_rows, 128), dtype=np.int64).astype(np.int32)
    idx = np.zeros(m * 128, np.int64)
    shift = np.zeros(m * 128, np.int32)
    at = 0
    while at < m * 128:
        length = min(2 * int(rng.integers(1, 40)), m * 128 - at)
        idx[at: at + length] = int(rng.integers(0, n - length - 1)) + np.arange(length)
        shift[at: at + length] = rng.choice([0, 8, 16, 24])
        at += length
    idx[0:4] = [5, 9, 6, 7]
    shift[4:8] = [8, 8, 16, 8]
    idx[4:8] = [20, 21, 22, 23]
    idx[8:12] = np.arange(n - 5, n - 1)
    shift[8:12] = 24
    idx[13:15] = [idx[13], idx[13] + 40]          # straddles two runs
    idx[-1], shift[-1] = n - 2, 24
    return (torch.from_numpy(src).to(cuda),
            torch.from_numpy(idx.astype(np.int32).reshape(m, 128)).to(cuda),
            torch.from_numpy(shift.reshape(m, 128)).to(cuda))


def _gather_all_routes(src, idx, shift):
    want = ref.ragged_gather(src, idx, shift)
    for fn in (kdecode.ragged_gather, kdecode.ragged_gather_vec, kdecode.ragged_gather_scalar):
        got = fn(src, idx, shift)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 7, 1951])
def test_ragged_gather_routes_match_plain(cuda, m):
    """M of 1 to the main path's 1951 rows of engine-like runs, a pair that
    straddles runs, non-consecutive indices, a pair that mixes shifts and
    the last word pair: the vec route (which takes every one of these
    fresh operands) and the scalar route, bit-exact."""
    src, idx, shift = _gather_operands(cuda, np.random.default_rng(m), m)
    assert kdecode.ragged_gather_route(idx, shift) == "vec"
    _gather_all_routes(src, idx, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("sh", [0, 8, 16, 24])
def test_ragged_gather_every_shift(cuda, sh):
    """One shift throughout: all runs, then random indices (no run)."""
    rng = np.random.default_rng(sh + 1)
    src = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, (9, 128),
                                        dtype=np.int64).astype(np.int32)).to(cuda)
    runs = (torch.arange(8 * 128, dtype=torch.int32, device=cuda) + 3).view(8, 128)
    scattered = torch.from_numpy(rng.integers(0, 9 * 128 - 1, (8, 128)).astype(np.int32)).to(cuda)
    for idx in (runs, scattered):
        _gather_all_routes(src, idx, torch.full_like(idx, sh))


@pytest.mark.cuda
def test_ragged_gather_reads_zero_outside_source(cuda):
    """Indices below 0 or past the end read 0 on both routes: the same
    outputs as the plain version over the source padded with zero rows
    (one before, two after)."""
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, (3, 128),
                                        dtype=np.int64).astype(np.int32)).to(cuda)
    n = src.numel()
    idx = torch.arange(-128, n + 128, dtype=torch.int32, device=cuda).view(-1, 128)
    pad = torch.zeros((1, 128), dtype=torch.int32, device=cuda)
    padded = torch.cat([pad, src, pad, pad])
    for sh in (0, 8, 16, 24):
        shift = torch.full_like(idx, sh)
        shift.view(-1)[1::7] = (sh + 8) % 32                 # pairs that mix shifts
        want = ref.ragged_gather(padded, idx + 128, shift)
        for fn in (kdecode.ragged_gather_vec, kdecode.ragged_gather_scalar):
            got = fn(src, idx, shift)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (fn.__name__, sh)


@pytest.mark.cuda
def test_decode_route_counts(cuda):
    """Each call counts under its route's name only: 16 bitmap words and
    fresh (M, 128) operands launch the new routes, 40 words and a view 4
    bytes in the general ones (bit-exact too); the new routes' wrappers
    refuse what they do not take."""
    rng = np.random.default_rng(11)
    names = ("dense_unpack", "dense_unpack_warp", "ragged_gather", "ragged_gather_vec")
    bm, vals = _unpack_operands(cuda, rng, 16, 478)
    wide, wide_vals = _unpack_operands(cuda, rng, 40, 478)
    assert _moved(lambda: kdecode.dense_unpack(bm, vals), names) == {"dense_unpack_warp": 1}
    assert _moved(lambda: kdecode.dense_unpack(wide, wide_vals), names) == {"dense_unpack": 1}
    assert _moved(lambda: kdecode.dense_unpack_block(bm, vals), names) == {"dense_unpack": 1}
    with pytest.raises(ValueError, match="dense_unpack_warp: takes 1 to 32"):
        kdecode.dense_unpack_warp(wide, wide_vals)
    src, idx, shift = _gather_operands(cuda, rng, 8)
    assert _moved(lambda: kdecode.ragged_gather(src, idx, shift), names) == \
        {"ragged_gather_vec": 1}
    flat_i = torch.cat([idx.view(-1), idx.view(-1)[:1]])
    flat_s = torch.cat([shift.view(-1), shift.view(-1)[:1]])
    view_i, view_s = flat_i[1:].view(8, 128), flat_s[1:].view(8, 128)    # 4 bytes in
    assert kdecode.ragged_gather_route(view_i, view_s) == "scalar"
    want = ref.ragged_gather(src, view_i, view_s)
    got = {}
    assert _moved(lambda: got.update(out=kdecode.ragged_gather(src, view_i, view_s)),
                  names) == {"ragged_gather": 1}
    assert torch.equal(got["out"], want)
    with pytest.raises(ValueError, match="ragged_gather_vec: takes 8-byte aligned"):
        kdecode.ragged_gather_vec(src, view_i, view_s)
