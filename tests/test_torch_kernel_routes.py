"""What the port's kernel wrappers decide in Python, on the CPU.

``flash_attention`` picks its route (the tensor-core kernel or the FMA
kernel) from the operands' dtype, head dim, strides and base addresses
before the launch, and computes the TMA tensor maps' byte strides; both
are plain Python and are held here on the main path's views and on views
TMA refuses.  ``bucketize``'s kernel searches sorted, NaN-free borders
instead of counting; its search and its sortedness check are mirrored
here in PyTorch and held to the plain count on the borders that decide
between them.  The kernels themselves run in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

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
