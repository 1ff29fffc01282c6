"""What the port's kernel wrappers decide in Python, on the CPU.

``flash_attention`` picks its route (the tensor-core kernel or the FMA
kernel) from the operands' dtype, head dim, strides and base addresses
before the launch, and computes the TMA tensor maps' byte strides; both
are plain Python and are held here on the main path's views and on views
TMA refuses.  ``bucketize``'s kernel searches sorted, NaN-free borders
instead of counting; its search and its sortedness check are mirrored
here in PyTorch and held to the plain count on the borders that decide
between them.  ``ssd_chunk_forward`` picks its route the same way (bf16,
P and N of 64 or 128, a chunk that is a multiple of 64, views whose rows
16-byte copies read: ``tma_strides``' rule); its tensor-core decomposition
and roundings are
mirrored in plain PyTorch (``ssd_chunk.sm90_form``) and held to the
sequential recurrence and to the Pallas kernel in interpret mode.
``fused_transform`` sends features-major tiles with rows a multiple of 4
and 16-byte aligned bases to its 16-byte-lane route, and
``embedding_bag`` sends E a multiple of 4 up to 512 with a 16-byte
aligned table to its warp route; both rules are held here, with plain
PyTorch mirrors of the vec route's BUCKETIZE_F search and vote and of the
warp route's column and slot order.  ``dense_unpack`` sends bitmaps of 1
to 32 words a feature to its warp route and ``ragged_gather`` sends
8-byte aligned idx and shift of an even count to its vec route; both rules are held here, with plain PyTorch mirrors of the warp
route's popcount prefix and ranks and of the vec route's runs and
pairs, against the plain versions and the Pallas kernels in interpret
mode.  The kernels themselves run in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode as kdecode  # noqa: E402
from repro_torch.kernels import embedding_bag as kbag  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import fused_transform as kft  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as kssd  # noqa: E402

BF16 = torch.bfloat16


def _model_views(b, s, t, h, kvh, d, dtype=BF16):
    """q, k, v as ``blocked_attention`` hands them over: (B, H, S, D) and
    (B, KVH, T, D) transposed views of the model's (B, S, H, D) tensors."""
    q = torch.zeros((b, s, h, d), dtype=dtype).transpose(1, 2)
    k = torch.zeros((b, t, kvh, d), dtype=dtype).transpose(1, 2)
    v = torch.zeros((b, t, kvh, d), dtype=dtype).transpose(1, 2)
    return q, k, v


def test_tma_strides_of_the_main_path_views():
    """qwen3-8b's prefill layout (H 32 over KVH 8, D 128), cut to 2 x 8
    positions: byte strides of (position, head, batch), innermost first
    after D, read in place from the transposed views."""
    q, k, v = _model_views(2, 8, 8, 32, 8, 128)
    assert kflash.tma_strides(q) == (32 * 128 * 2, 128 * 2, 8 * 32 * 128 * 2)
    assert kflash.tma_strides(k) == (8 * 128 * 2, 128 * 2, 8 * 8 * 128 * 2)
    assert kflash.tma_strides(v) == kflash.tma_strides(k)
    assert kflash.route(q, k, v) == "sm90"
    # contiguous (B, H, S, D) operands too
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    assert kflash.tma_strides(qc) == (128 * 2, 8 * 128 * 2, 32 * 8 * 128 * 2)
    assert kflash.route(qc, kc, vc) == "sm90"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("groups", [1, 4, 8])
def test_route_takes_bf16_at_d64_and_d128(d, groups):
    q, k, v = _model_views(1, 130, 70, 8, 8 // groups, d)
    assert kflash.route(q, k, v) == "sm90"


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.float32, 64),
                                     (BF16, 32), (BF16, 48), (BF16, 96), (BF16, 127)])
def test_route_sends_other_types_and_head_dims_to_fma(dtype, d):
    q, k, v = _model_views(1, 16, 16, 4, 2, d, dtype)
    assert kflash.route(q, k, v) == "fma"


def test_tma_strides_refuse_views_tma_cannot_read():
    """A base off 16 bytes, a byte stride that is not a multiple of 16, a
    last dim that is not contiguous and a broadcast (stride 0) dim each
    send the call to the FMA route."""
    q, k, v = _model_views(1, 16, 16, 4, 2, 128)
    wide = torch.zeros((1, 16, 4, 136), dtype=BF16)
    off = wide[..., 8:].transpose(1, 2)             # base +16 bytes, rows 272 bytes
    assert kflash.tma_strides(off) == (4 * 136 * 2, 136 * 2, 16 * 4 * 136 * 2)
    shifted = wide[..., 1:129].transpose(1, 2)      # base +2 bytes
    assert kflash.tma_strides(shifted) is None
    assert kflash.route(shifted, k, v) == "fma"
    padded = torch.zeros((1, 16, 4, 132), dtype=BF16)[..., :128].transpose(1, 2)
    assert kflash.tma_strides(padded) is None       # 264-byte head stride
    assert kflash.route(q, padded[:, :2], v) == "fma"
    strided = torch.zeros((1, 4, 16, 256), dtype=BF16)[..., ::2]
    assert kflash.tma_strides(strided) is None      # last dim not contiguous
    expanded = torch.zeros((1, 1, 16, 128), dtype=BF16).expand(1, 4, 16, 128)
    assert kflash.tma_strides(expanded) is None     # head stride 0
    assert kflash.route(q, k, expanded[:, :2]) == "fma"


def test_tensor_core_wrappers_refuse_cpu_tensors():
    """No silent fallback: each route's wrapper and the tile check take
    CUDA tensors only (the plain version runs through ``kernels.ops``)."""
    q, k, v = _model_views(1, 8, 8, 4, 2, 128)
    for fn in (kflash.flash_attention, kflash.flash_attention_sm90,
               kflash.flash_attention_fma):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(q, k, v)
    tile = torch.zeros((128, 128), dtype=BF16)
    with pytest.raises(ValueError, match="expected a CUDA bf16 tensor"):
        kflash.flash_attention_sm90_tile(tile, tile, tile)


def _sorted_nan_free(b: torch.Tensor) -> bool:
    """The kernel's check: b[k] <= b[k+1] for every pair (false for a NaN),
    b == b for a single border."""
    if b.numel() == 1:
        return bool(b[0] == b[0])
    return bool((b[:-1] <= b[1:]).all())


def _search(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's branch-free search: from the least power of two above
    nb, halve the step and advance while the next count's border is below
    the value and the count stays within nb (no step at all for nb = 0)."""
    nb = b.numel()
    top = 1
    while top <= nb:
        top <<= 1
    c = torch.zeros(v.shape, dtype=torch.int64)
    step = top >> 1
    while step:
        nxt = c + step
        below = v > b[(nxt - 1).clamp(0, nb - 1)]
        c = torch.where((nxt <= nb) & below, nxt, c)
        step >>= 1
    return c.to(torch.int32)


def test_bucketize_search_equals_the_count_on_sorted_borders():
    """On sorted, NaN-free borders (ties, -0.0/+0.0 pairs, infinities,
    subnormals; 0, 1, 63 and 4096 of them) the search gives the count for
    every value, NaN, infinite, signed-zero and subnormal ones included;
    NaN and unsorted borders fail the check, so they keep the count."""
    rng = np.random.default_rng(7)
    v = torch.from_numpy((rng.standard_normal(4000) * 3).astype(np.float32))
    v[:9] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40,
                          -1e-40, 1.0, -1.0])
    ties = torch.tensor([-2.0, -1.0, -1.0, -1.0, -0.0, 0.0, -0.0, 0.0, 1e-40, 1.0, 1.0])
    cases = [torch.zeros(0), torch.tensor([0.0]), torch.tensor([-0.0]),
             torch.linspace(-3, 3, 63), ties,
             torch.tensor([-float("inf"), -float("inf"), 0.0, float("inf"), float("inf")]),
             torch.from_numpy(np.sort(rng.standard_normal(4096).astype(np.float32))
                              .round(1))]
    for b in cases:
        assert _sorted_nan_free(b)
        assert torch.equal(_search(v, b), ref.bucketize(v, b)), b[:12]
    for b in (torch.tensor([float("nan")]), torch.tensor([-1.0, float("nan"), 0.5]),
              torch.tensor([0.0, 1.0, float("nan")]), torch.tensor([2.0, -1.0, 0.0]),
              torch.tensor([0.0, -1e-40])):
        assert not _sorted_nan_free(b)


# -- ssd_chunk_forward's routes --------------------------------------------------------

# chip_smoke.py's SSD_TOL: bf16 y within 2e-2 of rms(want) + 2e-2 |want| per
# element, the float32 state within 5e-4 of its rms + 1e-3 |want|
SSD_TOL = {"y": (2e-2, 2e-2), "state": (5e-4, 1e-3)}


def _ssd_views(b, s, h, p, g, n, dtype=BF16, device="cpu"):
    """x, B and C as ``models/ssm.py``'s ``_mixer`` hands them over: the
    (B, S, d_inner) and (B, S, G*N) activations reshaped to (B, S, H, P)
    and (B, S, G, N)."""
    x = torch.zeros((b, s, h * p), dtype=dtype, device=device).reshape(b, s, h, p)
    bv = torch.zeros((b, s, g * n), dtype=dtype, device=device).reshape(b, s, g, n)
    cv = torch.zeros((b, s, g * n), dtype=dtype, device=device).reshape(b, s, g, n)
    return x, bv, cv


def test_ssd_route_takes_the_main_path_views():
    """mamba2-2.7b's prefill layout (H 80, P 64, G 1, N 128, chunk 256),
    cut to 2 x 16 positions: byte strides of (head or group, position,
    batch), read in place; the route takes them."""
    x, bv, cv = _ssd_views(2, 16, 80, 64, 1, 128)
    assert kflash.tma_strides(x) == (64 * 2, 80 * 64 * 2, 16 * 80 * 64 * 2)
    assert kflash.tma_strides(bv) == (128 * 2, 128 * 2, 16 * 128 * 2)
    assert kflash.tma_strides(cv) == kflash.tma_strides(bv)
    assert kssd.route(x, bv, cv, 256) == "sm90"


@pytest.mark.parametrize("p,n", [(64, 64), (64, 128), (128, 64), (128, 128)])
@pytest.mark.parametrize("groups,chunk", [(1, 64), (2, 128), (8, 256)])
def test_ssd_route_takes_bf16_at_p_and_n_64_and_128(p, n, groups, chunk):
    x, bv, cv = _ssd_views(1, 130, 8, p, groups, n)
    assert kssd.route(x, bv, cv, chunk) == "sm90"


@pytest.mark.parametrize("dtype,p,n,chunk", [
    (torch.float32, 64, 128, 256), (torch.float32, 128, 64, 64),
    (BF16, 16, 128, 256), (BF16, 32, 128, 256), (BF16, 48, 128, 256),
    (BF16, 64, 16, 256), (BF16, 64, 32, 256), (BF16, 64, 48, 256),
    (BF16, 64, 128, 100), (BF16, 64, 128, 32), (BF16, 64, 128, 320),
])
def test_ssd_route_sends_other_types_dims_and_chunks_to_fma(dtype, p, n, chunk):
    x, bv, cv = _ssd_views(1, 16, 4, p, 2, n, dtype)
    assert kssd.route(x, bv, cv, chunk) == "fma"


def test_ssd_route_refuses_views_16_byte_copies_cannot_read():
    """A base off by 2 bytes, an odd stride, a broadcast (stride 0) group
    dim and a last dim that is not contiguous send the call to the FMA
    route; a base off by 16 bytes with 16-byte strides does not."""
    x, bv, cv = _ssd_views(1, 16, 4, 64, 1, 128)
    wide = torch.zeros((1, 16, 4, 72), dtype=BF16)
    off = wide[..., 8:]                              # base +16 bytes, rows 144 bytes
    assert kflash.tma_strides(off) == (72 * 2, 4 * 72 * 2, 16 * 4 * 72 * 2)
    assert kssd.route(off, bv, cv, 256) == "sm90"
    shifted = wide[..., 1:65]                        # base +2 bytes
    assert kssd.route(shifted, bv, cv, 256) == "fma"
    odd = torch.zeros((1, 16, 1, 131), dtype=BF16)[..., :128]     # 262-byte rows
    assert kflash.tma_strides(odd) is None
    assert kssd.route(x, odd, cv, 256) == "fma"
    assert kssd.route(x, bv, odd, 256) == "fma"
    expanded = torch.zeros((1, 16, 1, 128), dtype=BF16).expand(1, 16, 2, 128)
    assert kssd.route(x, expanded, expanded, 256) == "fma"     # group stride 0
    strided = torch.zeros((1, 16, 4, 128), dtype=BF16)[..., ::2]
    assert kssd.route(strided, bv, cv, 256) == "fma"           # last dim not contiguous


def test_ssd_route_decides_the_same_on_any_device():
    """The rule reads dtypes, shapes, strides and base addresses only: the
    same views on the CPU and on the meta device (base address 0) take the
    same route."""
    for dtype, p, n, chunk in ((BF16, 64, 128, 256), (BF16, 128, 64, 64),
                               (torch.float32, 64, 128, 256), (BF16, 32, 128, 256),
                               (BF16, 64, 128, 100)):
        views = [_ssd_views(2, 40, 4, p, 2, n, dtype, device) for device in ("cpu", "meta")]
        routes = {kssd.route(*v, chunk) for v in views}
        assert len(routes) == 1, (dtype, p, n, chunk, routes)


def test_ssd_wrappers_refuse_cpu_tensors():
    """No silent fallback: each route's wrapper takes CUDA tensors only
    (the plain version runs through ``kernels.ops``)."""
    x, bv, cv = _ssd_views(1, 8, 2, 64, 1, 64)
    dt, a = torch.zeros((1, 8, 2)), torch.zeros(2)
    for fn in (kssd.ssd_chunk_forward, kssd.ssd_chunk_forward_sm90,
               kssd.ssd_chunk_forward_fma):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(x, dt, a, bv, cv, chunk=64)


def _ssd_close(got, want, tol):
    """Every element within ``atol * rms(want) + rtol * |want|``; returns
    the largest share of that bound used."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    rms = float(want.square().mean().sqrt())
    share = float(((got - want).abs() / (atol * rms + rtol * want.abs())).max())
    assert share <= 1, share
    return share


def _ssd_bf16_inputs(seed, b, s, h, p, g, n, kind="normal"):
    """bf16 x, B, C and float32 dt, A the way the mixer makes them;
    ``large dt`` puts dt to ~190 and |cs| ~7,400 over a chunk of 256, as at
    the random full-width mamba2-2.7b."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)).to(BF16)
    scale = 50.0 if kind == "large dt" else 1.0
    dt = torch.from_numpy(np.logaddexp(scale * rng.standard_normal((b, s, h)), 0)
                          .astype(np.float32))
    a = torch.from_numpy((-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32))
    bm = torch.from_numpy((rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)).to(BF16)
    cm = torch.from_numpy((rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)).to(BF16)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,kind", [
    (2, 128, 4, 64, 2, 64, 64, "normal"),        # two chunks, two groups
    (1, 200, 4, 64, 1, 128, 128, "normal"),      # a ragged last chunk
    (1, 256, 2, 64, 1, 128, 256, "large dt"),    # |cs| ~ 7,400 over the chunk
])
def test_sm90_form_matches_the_recurrence_and_the_pallas_kernel(b, s, h, p, g, n, chunk,
                                                                 kind):
    """The tensor-core route's decomposition, with its roundings (bf16 m,
    C.state against a bf16 copy of the state, the state update's x*w as
    bf16 hi + lo, m's exponent from float32 hi + lo parts of the float64
    cs * log2(e)), against the sequential float32 recurrence: y within the
    bf16 bound, the state within the float32 bound; its y against the
    Pallas kernel in interpret mode (bf16 operands, one head a row, as
    ``tests/test_torch_ssm.py::test_plain_ssd_matches_pallas_and_ref``
    runs it) within the bf16 bound, where S is a multiple of the chunk
    (the TPU kernel asserts it); and from a given initial state."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops

    x, dt, a, bm, cm = _ssd_bf16_inputs(s + p + n, b, s, h, p, g, n, kind)
    if kind == "large dt":
        assert float(dt.max()) > 150 and float((dt * a).sum(1).min()) < -5000
    y, state = kssd.sm90_form(x, dt, a, bm, cm, chunk)
    want_y, want_state = ref.ssd_scan(x, dt, a, bm, cm)
    assert y.dtype == BF16 and state.dtype == torch.float32
    _ssd_close(y, want_y, SSD_TOL["y"])
    _ssd_close(state, want_state, SSD_TOL["state"])
    init = torch.from_numpy(np.random.default_rng(s).standard_normal((b, h, p, n))
                            .astype(np.float32))
    y0, state0 = kssd.sm90_form(x, dt, a, bm, cm, chunk, init)
    want_y0, want_state0 = ref.ssd_scan(x, dt, a, bm, cm, init)
    _ssd_close(y0, want_y0, SSD_TOL["y"])
    _ssd_close(state0, want_state0, SSD_TOL["state"])
    if s % chunk:
        return
    # the TPU kernel's rows: (batch, head) pairs, each reading its group
    hg = h // g
    rows = lambda t: t.permute(0, 2, 1, 3).reshape(b * h, s, -1)   # noqa: E731
    x_r = rows(x)
    b_r = rows(bm.repeat_interleave(hg, 2))
    c_r = rows(cm.repeat_interleave(hg, 2))
    dt_r = dt.permute(0, 2, 1).reshape(b * h, s)
    a_r = a.repeat(b)
    to_j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == BF16  # noqa: E731
                                 else jnp.float32)
    jy = jops.ssd_chunk_forward(*(to_j(t) for t in (x_r, dt_r, a_r, b_r, c_r)),
                                chunk=chunk, use_pallas=True)
    jy = torch.from_numpy(np.asarray(jy, np.float32)).reshape(b, h, s, p).permute(0, 2, 1, 3)
    _ssd_close(y, jy, SSD_TOL["y"])


# -- fused_transform's and embedding_bag's routes --------------------------------------

def _tile(feats, rows, device="cpu"):
    """An engine wave's packed tile: features-major (F, rows) int32."""
    return torch.zeros((feats, rows), dtype=torch.int32, device=device)


@pytest.mark.parametrize("feats,rows", [(32, 8192), (171, 512), (1, 4), (3, 516)])
def test_fused_transform_route_takes_the_engine_tiles(feats, rows):
    """The main path's two waves (32 x 8192 sparse ids, 171 x 512 dense
    values) and any features-major tile with rows a multiple of 4 take the
    vec route; the same tile handed over rows-major takes the general one."""
    fm = _tile(feats, rows)
    assert kft.route(fm, features_major=True) == "vec"
    assert kft.route(fm.T.contiguous(), features_major=False) == "scalar"
    assert kft.route(fm, features_major=False) == "scalar"


@pytest.mark.parametrize("rows", [8193, 513, 514, 515, 1, 2, 3])
def test_fused_transform_route_sends_ragged_rows_to_scalar(rows):
    assert kft.route(_tile(4, rows), features_major=True) == "scalar"


def test_fused_transform_route_reads_the_base_address():
    """Contiguous views of one buffer: a base 16 or 32 bytes in takes the
    vec route, 4, 8 or 12 bytes in the general one; so do non-contiguous
    and 1-D operands, and more than 65535 features."""
    flat = torch.zeros(4 * 512 + 8, dtype=torch.int32)
    for off, want in ((0, "vec"), (4, "vec"), (8, "vec"), (1, "scalar"), (2, "scalar"),
                      (3, "scalar")):
        view = flat[off: off + 4 * 512].view(4, 512)
        assert view.is_contiguous()
        assert kft.route(view, features_major=True) == want, off
    assert kft.route(_tile(8, 1024)[:, ::2], features_major=True) == "scalar"
    assert kft.route(_tile(8, 1024)[:, :512], features_major=True) == "scalar"
    assert kft.route(flat[:512], features_major=True) == "scalar"
    assert kft.route(_tile(65535, 4), features_major=True) == "vec"
    assert kft.route(_tile(65536, 4), features_major=True) == "scalar"     # grid.y


@pytest.mark.parametrize("e", [4, 40, 124, 128, 132, 512])
def test_embedding_bag_route_takes_e_a_multiple_of_4_up_to_512(e):
    """The trainer's (43008, 128) hot-slot table and every E a multiple of
    4 up to 512 take the warp route."""
    assert kbag.route(torch.empty((43008 if e == 128 else 64, e))) == "warp"


@pytest.mark.parametrize("e", [1, 2, 6, 42, 516, 1000])
def test_embedding_bag_route_sends_other_widths_to_block(e):
    assert kbag.route(torch.empty((64, e))) == "block"


def test_embedding_bag_route_reads_the_table_base():
    """Contiguous tables cut from one buffer: 16 bytes in takes the warp
    route, 4, 8 or 12 bytes in the block route."""
    flat = torch.zeros(64 * 128 + 4)
    for off, want in ((0, "warp"), (4, "warp"), (1, "block"), (2, "block"), (3, "block")):
        table = flat[off: off + 64 * 128].view(64, 128)
        assert kbag.route(table) == want, off


def test_fused_transform_and_embedding_bag_routes_decide_the_same_on_any_device():
    """The rules read layouts, shapes, strides and base addresses only: the
    same operands on the CPU and on the meta device take the same route."""
    for feats, rows, fm in ((32, 8192, True), (171, 512, True), (7, 514, True),
                            (8192, 32, False)):
        routes = {kft.route(_tile(feats, rows, d), features_major=fm) for d in ("cpu", "meta")}
        assert len(routes) == 1, (feats, rows, fm, routes)
    for e in (4, 128, 132, 512, 42, 1000):
        routes = {kbag.route(torch.empty((16, e), device=d)) for d in ("cpu", "meta")}
        assert len(routes) == 1, (e, routes)


def test_fused_transform_and_embedding_bag_wrappers_refuse_cpu_tensors():
    """No silent fallback: each route's wrapper takes CUDA tensors only,
    and a CPU tensor through ``kernels.ops`` reaches the plain version and
    launches nothing."""
    from repro_torch.kernels import build, ops

    tile = _tile(4, 512)
    z = torch.zeros(4, dtype=torch.int32)
    for fn in (kft.fused_transform, kft.fused_transform_vec, kft.fused_transform_scalar):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(tile, z, z, z, features_major=True)
    table = torch.zeros((64, 128))
    ids = torch.zeros((3, 7), dtype=torch.int32)
    for fn in (kbag.embedding_bag, kbag.embedding_bag_warp, kbag.embedding_bag_block):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(table, ids, ids.float())
    before = build.LAUNCHES.snapshot()
    codes = torch.tensor([0, 1, 5, 6], dtype=torch.int32)
    got = ops.fused_transform(tile, codes, z, z + 3, features_major=True)
    assert torch.equal(got, ref.fused_transform(tile.T, codes, z, z + 3).T)
    assert torch.equal(ops.embedding_bag(table, ids, ids.float()),
                       ref.embedding_bag(table, ids, ids.float()))
    assert build.LAUNCHES.snapshot() == before


def _fused_bucketize_mirror(tile: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """The vec route's BUCKETIZE_F in plain PyTorch: every warp of a
    feature's blocks votes on the feature's border row (``_sorted_nan_free``);
    where the vote holds, the branch-free search (``_search``) gives each
    value's bucket, else the count in the borders' order.  tile (F, rows)
    int32 float bits, borders (F, nb) -> (F, rows) int32."""
    rows = []
    for f in range(tile.shape[0]):
        v, b = tile[f].view(torch.float32), borders[f]
        if _sorted_nan_free(b):
            rows.append(_search(v, b))
        else:
            rows.append((v[:, None] > b[None, :]).sum(1, dtype=torch.int32))
    return torch.stack(rows)


def test_fused_bucketize_search_equals_the_count_on_every_border_row():
    """A features-major BUCKETIZE_F wave with the engine's +inf padding, one
    border row a feature: sorted, tied, -0.0/+0.0, +inf inside the row,
    all +inf, -inf, subnormal, NaN and unsorted rows, a single border, 63
    and 300 borders; values NaN, +-inf, +-0.0, subnormal, on the borders
    and random.  The mirror of the vec route equals ``ref.fused_transform``
    bit for bit, and the Pallas kernel in interpret mode; sorted rows pass
    the vote and are searched, NaN and unsorted rows fail it."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops

    inf, nan = float("inf"), float("nan")
    nb = 300
    specials = [
        [-1.0, 0.0, 1.0], [-1.0, -1.0, -1.0, 0.0, 0.0, 1.0, 1.0], [-0.0, 0.0, -0.0, 0.0],
        [0.0, -0.0], [-1.0, inf, inf], [inf], [-inf, -inf, 0.0, inf], [1e-40, 3e-39],
        [-1e-40, 0.0, 1e-40], [0.5], list(np.linspace(-3, 3, 63)),
        [2.0, -1.0, 0.5, -3.0], [-1.0, nan, 0.5], [nan], [0.0, 1.0, nan],
        [1e-40, -1e-42, 3e-39], [0.0, -1e-40],
    ]
    rng = np.random.default_rng(17)
    rows_b = [np.pad(np.array(r, np.float32), (0, nb - len(r)), constant_values=inf)
              for r in specials]
    rows_b.append(np.sort(rng.standard_normal(nb).astype(np.float32)).round(1))
    rows_b.append(rng.standard_normal(nb).astype(np.float32))
    borders = torch.from_numpy(np.stack(rows_b))
    feats = borders.shape[0]
    vals = (rng.standard_normal((feats, 512)) * 3).astype(np.float32)
    edge = np.array([nan, inf, -inf, 0.0, -0.0, 1e-40, -1e-40, 3e-39, -1e-42, 0.5, 1.0,
                     -1.0, 2.0, -3.0, 3.0], np.float32)
    vals[:, : len(edge)] = edge
    vals[:, len(edge): 2 * len(edge)] = edge[::-1]
    tile = torch.from_numpy(vals.view(np.int32))
    votes = [_sorted_nan_free(b) for b in borders]
    assert votes == [True] * 11 + [False] * 6 + [True, False]
    codes = torch.full((feats,), ref.OP_BUCKETIZE_F, dtype=torch.int32)
    z = torch.zeros(feats, dtype=torch.int32)
    want = ref.fused_transform(tile.T.contiguous(), codes, z, z, borders).T
    assert torch.equal(_fused_bucketize_mirror(tile, borders), want)
    # the Pallas kernel on the CPU flushes subnormals in its compares (a
    # known difference: the engine never fuses them), so it is held on the
    # rows and values without them
    tiny = np.finfo(np.float32).tiny
    sub = lambda a: (a != 0) & (np.abs(a) < tiny)             # noqa: E731
    keep = [f for f in range(feats) if not sub(rows_b[f]).any()]
    jvals = np.where(sub(vals), np.float32(0.25), vals)[keep]
    jb = borders.numpy()[keep]
    jz = np.zeros(len(keep), np.int32)
    jwant = jops.fused_transform(jnp.asarray(jvals.view(np.int32).T.copy()),
                                 jnp.asarray(jz + ref.OP_BUCKETIZE_F), jnp.asarray(jz),
                                 jnp.asarray(jz), jnp.asarray(jb), use_pallas=True)
    mirror = _fused_bucketize_mirror(torch.from_numpy(jvals.view(np.int32)), torch.from_numpy(jb))
    assert len(keep) == feats - 4
    np.testing.assert_array_equal(np.asarray(jwant).T, mirror.numpy())


def _warp_bag_mirror(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """The warp route's arithmetic in plain PyTorch: lane j of a bag's warp
    owns columns 4j..4j+3 of each 128-column stripe; slots run in runs of
    32, handed out by lane; each slot's row times its weight is added in
    slot order, and the denominator is summed in the same order."""
    v, e = table.shape
    b, l = ids.shape
    out = torch.empty((b, e))
    for lane in range(32):
        cols = [c for s in range(-(-e // 128)) for c in range(128 * s + 4 * lane,
                                                              128 * s + 4 * lane + 4) if c < e]
        if not cols:
            continue
        acc = torch.zeros((b, len(cols)))
        denom = torch.zeros((b, 1))
        for l0 in range(0, l, 32):
            run_ids = ids[:, l0: l0 + 32].long().clamp(0, v - 1)
            run_w = mask[:, l0: l0 + 32]
            for i in range(run_ids.shape[1]):
                w = run_w[:, i: i + 1]
                acc = acc + table[run_ids[:, i]][:, cols] * w
                denom = denom + w
        if mode == "mean":
            acc = acc / torch.maximum(denom, torch.ones_like(denom))
        out[:, cols] = acc
    return out


@pytest.mark.parametrize("e,l", [(4, 1), (124, 31), (128, 33), (132, 32), (512, 300)])
def test_warp_bag_order_equals_the_plain_version(e, l):
    """The warp route's lanes cover every column once and its runs of 32
    slots add in the plain version's order, so the bits are the same: in
    both modes, with fractional weights, empty bags, clamped ids, NaN and
    inf rows under a mask of 0 and subnormal rows."""
    rng = np.random.default_rng(e + l)
    v, b = 50, 9
    table = rng.standard_normal((v, e)).astype(np.float32)
    table[3, :2] = [np.nan, np.inf]
    table[4] = 1e-40
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    ids[0, 0], ids[1, -1] = -2, v + 3
    ids[2] = 3
    mask = (rng.random((b, l)) < 0.6).astype(np.float32) * rng.random((b, l)).astype(
        np.float32) * 3
    mask[2] = 0.0
    mask[4, 0] = 1.0
    ids[4, 0] = 4
    t, i, m = torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(mask)
    for mode in ("mean", "sum"):
        got = _warp_bag_mirror(t, i, m, mode)
        want = ref.embedding_bag(t, i, m, mode=mode)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), mode
        assert torch.isnan(got[2, :2]).all()


# -- dense_unpack's and ragged_gather's routes -----------------------------------------

def test_dense_unpack_route_takes_up_to_32_words():
    """The main path's (504, 16) bitmap with its (504, 478) values, and any
    bitmap of 1 to 32 words a feature whatever C, take the warp route;
    0 or more than 32 words the block route."""
    assert kdecode.dense_unpack_route(torch.zeros((504, 16), dtype=torch.int32)) == "warp"
    for w in (1, 2, 7, 16, 31, 32):
        assert kdecode.dense_unpack_route(torch.zeros((3, w), dtype=torch.int32)) == "warp", w
    for w in (0, 33, 64, 1250):
        assert kdecode.dense_unpack_route(torch.zeros((3, w), dtype=torch.int32)) == "block", w


def test_ragged_gather_route_reads_layout_and_bases():
    """Fresh (M, 128) operands (the engine's, M = 1951 at the main path) take
    the vec route; views of one buffer 4 or 12 bytes in, a non-contiguous
    view and an odd count take the scalar route (8 and 16 bytes in, the
    vec route); either operand alone off 8 bytes is enough."""
    fresh = lambda m, n=128: torch.zeros((m, n), dtype=torch.int32)   # noqa: E731
    assert kdecode.ragged_gather_route(fresh(1951), fresh(1951)) == "vec"
    assert kdecode.ragged_gather_route(fresh(1), fresh(1)) == "vec"
    assert kdecode.ragged_gather_route(fresh(3, 2), fresh(3, 2)) == "vec"
    flat = torch.zeros(8 * 128 + 8, dtype=torch.int32)
    for off, want in ((0, "vec"), (1, "scalar"), (2, "vec"), (3, "scalar"), (4, "vec")):
        view = flat[off: off + 8 * 128].view(8, 128)
        assert kdecode.ragged_gather_route(view, view) == want, off
        assert kdecode.ragged_gather_route(fresh(8), view) == want, off
        assert kdecode.ragged_gather_route(view, fresh(8)) == want, off
    assert kdecode.ragged_gather_route(fresh(8, 256)[:, ::2], fresh(8)) == "scalar"
    assert kdecode.ragged_gather_route(fresh(3, 5), fresh(3, 5)) == "scalar"


def test_decode_routes_decide_the_same_on_any_device():
    for w in (1, 16, 32, 33):
        routes = {kdecode.dense_unpack_route(torch.zeros((4, w), dtype=torch.int32, device=d))
                  for d in ("cpu", "meta")}
        assert len(routes) == 1, (w, routes)
    for m, n in ((1951, 128), (1, 128), (3, 5)):
        routes = {kdecode.ragged_gather_route(*(torch.zeros((m, n), dtype=torch.int32,
                                                            device=d),) * 2)
                  for d in ("cpu", "meta")}
        assert len(routes) == 1, (m, n, routes)


def test_decode_route_wrappers_refuse_cpu_tensors():
    """No silent fallback: each route's wrapper takes CUDA tensors only, and
    a CPU tensor through ``kernels.ops`` reaches the plain version and
    launches nothing."""
    from repro_torch.kernels import build, ops

    bm = torch.full((3, 2), -1, dtype=torch.int32)
    vals = torch.arange(3 * 70, dtype=torch.int32).view(3, 70)
    for fn in (kdecode.dense_unpack, kdecode.dense_unpack_warp, kdecode.dense_unpack_block):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(bm, vals)
    src = torch.arange(2 * 128, dtype=torch.int32).view(2, 128)
    idx = torch.arange(128, dtype=torch.int32).view(1, 128)
    for fn in (kdecode.ragged_gather, kdecode.ragged_gather_vec,
               kdecode.ragged_gather_scalar):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(src, idx, idx)
    before = build.LAUNCHES.snapshot()
    assert torch.equal(ops.dense_unpack(bm, vals), ref.dense_unpack(bm, vals))
    assert torch.equal(ops.ragged_gather(src, idx, idx & 24),
                       ref.ragged_gather(src, idx, idx & 24))
    assert build.LAUNCHES.snapshot() == before


def _popc(x: torch.Tensor) -> torch.Tensor:
    """__popc of uint32 values held in int64."""
    return sum((x >> b) & 1 for b in range(32))


def _unpack_warp_mirror(bitmap_words: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The warp route's decomposition in plain PyTorch: lane l of each warp
    holds word l in rows order (bit k is row 32 l + k), a scan of the
    words' popcounts gives each word's exclusive prefix, and thread q
    writes rows 4q..4q+3 of word q // 8 (taken from lane q // 8), each
    present row's rank being the word's prefix plus the popcount of its
    word's bits below it, read at min(rank, C - 1); NaN bits where a row is
    absent.  (F, W) and (F, C) -> (F, 32 W)."""
    feats, w = bitmap_words.shape
    c = values.shape[1]
    k = torch.arange(32, dtype=torch.int64)
    packbits_bit = (k & ~7) + 7 - (k & 7)             # row k's bit in the LE word
    word = bitmap_words.to(torch.int64) & 0xFFFFFFFF
    rows = (((word[:, :, None] >> packbits_bit) & 1) << k).sum(-1)   # rows_order
    pop = _popc(rows)
    excl = torch.cumsum(pop, 1) - pop
    q = torch.arange(8 * w, dtype=torch.int64)
    rw, pre = rows[:, q // 8], excl[:, q // 8]        # the shuffles from lane q // 8
    bit = ((q % 8) * 4)[:, None] + torch.arange(4)    # (8 W, 4) rows of the store
    rw, pre = rw[:, :, None], pre[:, :, None]
    present = ((rw >> bit) & 1) == 1
    rank = pre + _popc(rw & ((1 << bit) - 1))
    at = torch.where(present, rank.clamp(max=c - 1), 0).reshape(feats, -1)
    got = torch.gather(values, 1, at)
    return torch.where(present.reshape(feats, -1), got, torch.full_like(got, ref.NAN_BITS))


def _unpack_operands(rng, w, c, densities):
    """Features of ``w`` packbits words, one a density (0.0: all absent, 1.0:
    all present), values of C columns whose present prefix holds NaN
    payloads, infinities, signed zeros and subnormals."""
    rows = 32 * w
    bitmap = np.zeros((len(densities), w), np.int32)
    values = rng.integers(-(2 ** 31), 2 ** 31, (len(densities), c),
                          dtype=np.int64).astype(np.int32)
    special = np.array([0x7FC00001, 0x7F800001, 0xFFC00000, 0x7F800000, 0x80000000, 0,
                        1, 0x807FFFFF], np.uint32).view(np.int32)
    values[:, : min(c, len(special))] = special[: min(c, len(special))]
    for f, dens in enumerate(densities):
        present = rng.random(rows) < dens
        bitmap[f] = np.packbits(present.astype(np.uint8)).view("<i4")
    return torch.from_numpy(bitmap), torch.from_numpy(values)


@pytest.mark.parametrize("w,c", [
    (16, 478),          # the main path's widths
    (1, 1), (1, 32), (3, 40), (7, 5), (32, 1024), (32, 600), (2, 3000),
])
def test_unpack_warp_decomposition_matches_plain_and_pallas(w, c):
    """The warp route's mirror equals ``ref.dense_unpack`` and the Pallas
    kernel in interpret mode, with all-absent and all-present features, C
    of 1 and C fewer than the rows present (ranks clipped to C - 1), C of
    32 W and C above it, NaN-payload and subnormal value bits."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(w * 1000 + c)
    bm, vals = _unpack_operands(rng, w, c, (0.0, 1.0, 0.5, 0.9, 0.05))
    want = ref.dense_unpack(bm, vals)
    assert torch.equal(_unpack_warp_mirror(bm, vals), want)
    jwant = np.asarray(jops.dense_unpack(bm.numpy(), vals.numpy(), use_pallas=True))
    np.testing.assert_array_equal(want.numpy(), jwant)


def _funnel(lo: torch.Tensor, hi: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """__funnelshift_r(lo, hi, sh) on uint32 values held in int64."""
    sh = sh & 31
    return (lo >> sh) | torch.where(sh == 0, 0, (hi << (32 - sh)) & 0xFFFFFFFF)


def _gather_vec_mirror(src: torch.Tensor, idx: torch.Tensor, shift: torch.Tensor):
    """The vec route's decomposition in plain PyTorch: outputs in pairs; a
    pair whose indices are consecutive and whose shifts are equal is a run,
    spliced from the 3 source words it starts at, any other pair from two
    general pairs of words; words outside the source read as 0.  Returns
    the output and which pairs were runs."""
    flat = src.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    n = flat.numel()

    def word(a):
        return torch.where((a >= 0) & (a < n), flat[a.clamp(0, n - 1)], 0)

    a = idx.reshape(-1, 2).to(torch.int64)
    s = shift.reshape(-1, 2).to(torch.int64)
    run = (a[:, 1] == a[:, 0] + 1) & (s[:, 1] == s[:, 0])
    three = word(a[:, :1] + torch.arange(3))
    spliced = _funnel(three[:, :2], three[:, 1:], s[:, :1])
    pairs = _funnel(word(a), word(a + 1), s)
    out = torch.where(run[:, None], spliced, pairs)
    return ((out ^ 0x80000000) - 0x80000000).to(torch.int32).reshape(idx.shape), run


def _engine_gather_operands(rng, n_regions):
    """src, idx and shift as the port's decode engine packs them
    (``TorchDecodeEngine._gather_launch``): payloads of random bytes and
    array regions at random byte offsets and lengths, one run of even word
    slots a region."""
    from repro_torch.core.decode import TorchDecodeEngine

    class Capture(TorchDecodeEngine):
        def __init__(self):
            super().__init__("cpu")
            self.operands = []

        def _to_device(self, a):
            t = super()._to_device(a)
            self.operands.append(t.clone())
            return t

    pool = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(200, 3000, 4)]
    requests = []
    for _ in range(n_regions):
        pi = int(rng.integers(0, len(pool)))
        off = int(rng.integers(0, len(pool[pi]) - 64))
        nb = 4 * int(rng.integers(1, (len(pool[pi]) - off) // 4 + 1))
        requests.append((pi, np.dtype(np.int32), off, nb))
    engine = Capture()
    engine._gather_launch(pool, requests)
    return engine.operands


def test_gather_vec_decomposition_matches_plain_and_pallas():
    """On the engine's own packing (regions at every byte misalignment, each
    one run of even length, so every pair but the padding is a run), then with a pair of
    non-consecutive indices, a pair that straddles two runs, a pair that
    mixes shifts and the last word pair (idx n - 2, shift 24), the vec
    route's mirror equals ``ref.ragged_gather`` and the Pallas kernel in
    interpret mode."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(18)
    src, idx, shift = _engine_gather_operands(rng, 40)
    assert set(torch.unique(shift).tolist()) == {0, 8, 16, 24}
    _, runs = _gather_vec_mirror(src, idx, shift)
    tail = (idx.view(-1, 2) == 0).all(1)          # the padding after the last region
    assert bool((runs | tail).all()) and int(tail.sum()) < 64
    n = src.numel()
    flat_i, flat_s = idx.view(-1), shift.view(-1)
    flat_i[0:2] = torch.tensor([9, 5], dtype=torch.int32)              # not consecutive
    flat_i[2:6] = torch.tensor([30, 31, 70, 71], dtype=torch.int32)
    flat_i[7], flat_s[6:8] = 72, torch.tensor([8, 16], dtype=torch.int32)
    flat_i[6] = 71                                                     # a mixed shift
    flat_i[9], flat_s[8:10] = 44, 0
    flat_i[8] = 3                                                      # straddles two runs
    flat_i[10:12], flat_s[10:12] = torch.tensor([n - 3, n - 2], dtype=torch.int32), 24
    flat_i[-1], flat_s[-1] = n - 2, 24                                 # the last word pair
    got, runs = _gather_vec_mirror(src, idx, shift)
    assert runs[:6].tolist() == [False, True, True, False, False, True]
    want = ref.ragged_gather(src, idx, shift)
    assert torch.equal(got, want)
    jwant = np.asarray(jops.ragged_gather(src.numpy(), idx.numpy(), shift.numpy(),
                                          use_pallas=True))
    np.testing.assert_array_equal(want.numpy(), jwant)


@pytest.mark.parametrize("sh", [0, 8, 16, 24])
def test_gather_vec_runs_match_plain_at_every_shift(sh):
    """Every pair a run at one shift, with the last pairs' words past the
    end of the source read as 0 (the plain version is given the source
    padded with zeros)."""
    rng = np.random.default_rng(sh)
    src = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, (3, 128),
                                        dtype=np.int64).astype(np.int32))
    n = src.numel()
    idx = (torch.arange(2 * 128, dtype=torch.int32) + 37).view(2, 128)
    idx.view(-1)[-4:] = torch.arange(n - 2, n + 2, dtype=torch.int32)   # past the end
    shift = torch.full_like(idx, sh)
    got, runs = _gather_vec_mirror(src, idx, shift)
    assert bool(runs.all())
    padded = torch.cat([src, torch.zeros((1, 128), dtype=torch.int32)])
    assert torch.equal(got, ref.ragged_gather(padded, idx, shift))
