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

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402

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
    64-row tile, T != S, causal and full, within the sweep's tolerance."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 8, 65, 64)).astype(np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 100, 64)).astype(np.float32))
            .to(cuda, dtype) for _ in range(2))
    before = build.LAUNCHES.snapshot().get("flash_attention", 0)
    tol = SWEEP_TOL[dtype]
    for causal in (True, False):
        got = kflash.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=tol, atol=tol)
    assert build.LAUNCHES.snapshot()["flash_attention"] == before + 2


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
