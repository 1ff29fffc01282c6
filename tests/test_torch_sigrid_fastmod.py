"""``sigrid_hash``'s remainder on the CPU.

The kernel takes ``x % d`` as Lemire, Kaser and Kurz's direct remainder
with a magic number the wrapper computes on the host
(``kernels.sigrid_hash.fastmod_magic``).  ``fastmod_form`` repeats the
kernel's integer arithmetic in plain PyTorch (int64 with products split
into 16-bit halves, as ``ref._mul_lo32`` does), and is held here bit for
bit against ``x % d`` over divisors at every edge of [1, 2**32) and
against the reference's Pallas kernel in interpret mode and its oracle.
The kernel itself runs in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import sigrid_hash as ksigrid  # noqa: E402

EDGE_DIVISORS = [1, 2, 3, 7, 2 ** 16 + 1, 2_000_000, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                 2 ** 31 + 5, 2 ** 32 - 2, 2 ** 32 - 1]
RANDOM_DIVISORS = [int(d) for d in np.random.default_rng(19).integers(1, 2 ** 32, 16)]


def _x(d: int) -> torch.Tensor:
    """2**16 seeded draws over [0, 2**32) and the edges around d and 2**31."""
    draws = np.random.default_rng(d % (2 ** 31)).integers(0, 2 ** 32, 1 << 16, dtype=np.int64)
    edges = np.array([0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1,
                      (2 ** 32 - 1) // d * d], dtype=np.int64)
    x = np.concatenate([draws, edges])
    return torch.from_numpy(x[x < 2 ** 32])


@pytest.mark.parametrize("d", EDGE_DIVISORS + RANDOM_DIVISORS)
def test_fastmod_form_is_the_remainder(d):
    x = _x(d)
    got = ksigrid.fastmod_form(x, ksigrid.fastmod_magic(d), d)
    assert torch.equal(got, x % d)


def test_fastmod_magic_edges():
    """The magic is a uint64; it wraps to 0 for d = 1 and is 2**32 + 2 for
    d = 2**32 - 1, as the kernel's launcher recomputes it."""
    assert ksigrid.fastmod_magic(1) == 0
    assert ksigrid.fastmod_magic(2) == 2 ** 63
    assert ksigrid.fastmod_magic(2 ** 32 - 1) == 2 ** 32 + 2
    for d in EDGE_DIVISORS + RANDOM_DIVISORS:
        assert 0 <= ksigrid.fastmod_magic(d) < 2 ** 64


@pytest.mark.parametrize("salt", [0, 5, 2 ** 32 - 1])
def test_sigrid_hash_form_matches_pallas_and_ref(salt):
    """The hash through the kernel's remainder equals the Pallas kernel
    (interpret mode) and the reference's oracle on a (64, 1344) tile of
    one dlrm-paper batch's width, max_value 2,000,000."""
    rng = np.random.default_rng(salt % 97)
    ids = rng.integers(-(2 ** 31), 2 ** 31, (64, 1344), dtype=np.int64).astype(np.int32)
    ids.flat[:4] = [-(2 ** 31), -1, 0, 2 ** 31 - 1]
    got = ksigrid.sigrid_hash_form(torch.from_numpy(ids), salt, 2_000_000)
    assert got.dtype == torch.int32 and got.shape == ids.shape
    for want in (jops.sigrid_hash(jnp.asarray(ids), salt, 2_000_000, use_pallas=True),
                 jref.sigrid_hash(jnp.asarray(ids), salt, 2_000_000)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_value", [1, 3, 2 ** 31, 2 ** 31 + 5, 2 ** 32 - 1])
def test_sigrid_hash_form_matches_the_plain_version(max_value):
    """Moduli at 1 and above 2**31 (remainders that wrap negative in int32)."""
    ids = torch.from_numpy(np.random.default_rng(max_value % 89).integers(
        -(2 ** 31), 2 ** 31, 5000, dtype=np.int64).astype(np.int32))
    for salt in (0, 2 ** 32 - 1):
        assert torch.equal(ksigrid.sigrid_hash_form(ids, salt, max_value),
                           ref.sigrid_hash(ids, salt, max_value))


@pytest.mark.parametrize("n", [1, 3, 5, 4001, 4002, 4003])
def test_sigrid_hash_form_on_odd_and_unaligned_tiles(n):
    """The lengths whose n % 4 tail the kernel takes element by element,
    whole and as a view one element in (off the 16-byte vectors)."""
    ids = torch.from_numpy(np.random.default_rng(n).integers(
        -(2 ** 31), 2 ** 31, n + 1, dtype=np.int64).astype(np.int32))
    ids[:3] = torch.tensor([-(2 ** 31), -1, 0], dtype=torch.int32)[:n + 1]
    for t in (ids[:n], ids[1:]):
        for salt, mv in ((0, 2 ** 32 - 1), (2 ** 32 - 1, 2 ** 31), (7, 2_000_000)):
            assert torch.equal(ksigrid.sigrid_hash_form(t, salt, mv),
                               ref.sigrid_hash(t, salt, mv))


@pytest.mark.parametrize("view", ["flat", "tile", "unaligned"])
def test_wrapper_refuses_cpu_tensors(view):
    """No silent fallback: the wrapper takes CUDA tensors only (the plain
    version runs through ``kernels.ops``), whatever the layout."""
    ids = torch.zeros(4100, dtype=torch.int32)
    t = {"flat": ids, "tile": ids.view(41, 100), "unaligned": ids[1:]}[view]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ksigrid.sigrid_hash(t, 0, 10)
