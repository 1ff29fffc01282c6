"""The standalone ``sigrid_hash`` and ``bucketize`` plain versions of the
port against the reference kernels, bit for bit.

The same inputs, made with numpy from a seed, go through
``repro_torch.kernels.ops`` (the plain versions, on CPU) and the
reference's ``repro.kernels.ops`` with ``use_pallas=True`` (the Pallas
kernels in interpret mode) and ``repro.kernels.ref``, on adversarial
inputs: INT_MIN, -1 and 0 ids, the extreme salts and moduli above 2^31
(whose remainders wrap negative in int32); NaN and infinite values, signed
zeros tied with borders, NaN and unsorted borders, no border at all.
Subnormal values are kept, where XLA on the CPU flushes them (the
reference's numpy transform keeps them too); they have their own test.  The
CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import bucketize as kbucketize  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sigrid_hash as ksigrid  # noqa: E402

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _ids(seed, shape):
    rng = np.random.default_rng(seed)
    ids = rng.integers(I32_MIN, I32_MAX, shape, dtype=np.int64).astype(np.int32)
    ids.flat[:6] = [I32_MIN, -1, 0, 1, I32_MAX, -2]
    return ids


@pytest.mark.parametrize("salt,max_value", [
    (0, 1), (13, 2_000_000), (2 ** 32 - 1, 2 ** 31 - 1), (0, 2 ** 31 + 5),
    (2 ** 32 - 1, 2 ** 32 - 1), (7, 33),
])
def test_sigrid_hash_matches_pallas_and_ref(salt, max_value):
    ids = _ids(salt % 97 + max_value % 89, (37, 300))
    got = ops.sigrid_hash(torch.from_numpy(ids), salt, max_value)
    assert got.dtype == torch.int32 and got.shape == ids.shape
    for want in (jops.sigrid_hash(jnp.asarray(ids), salt, max_value, use_pallas=True),
                 jref.sigrid_hash(jnp.asarray(ids), salt, max_value)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if max_value == 2 ** 32 - 1:       # half the remainders are above INT_MAX: they wrap
        assert (got < 0).any()
    elif max_value < 2 ** 31:
        assert (got >= 0).all() and (got < max_value).all()


def test_sigrid_hash_any_shape_and_dlrm_tile():
    """Any shape (the reference's oracle takes any; the Pallas kernel a 2-D
    tile), and the data path's (512, 1344) sparse id tile."""
    ids = _ids(1, (3, 5, 7))
    got = ops.sigrid_hash(torch.from_numpy(ids), 99, 1000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.sigrid_hash(
        jnp.asarray(ids), 99, 1000)))
    ids = _ids(2, (512, 1344))
    got = ops.sigrid_hash(torch.from_numpy(ids), 5, 2_000_000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.sigrid_hash(
        jnp.asarray(ids), 5, 2_000_000, use_pallas=True)))


@pytest.mark.parametrize("salt,max_value", [(-1, 10), (2 ** 32, 10), (0, 0), (0, -3),
                                            (0, 2 ** 32)])
def test_sigrid_hash_refuses_what_uint32_cannot_hold(salt, max_value):
    ids = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="sigrid_hash"):
        ops.sigrid_hash(ids, salt, max_value)


def _values(seed, shape):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(shape) * 3).astype(np.float32)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0], np.float32)
    v.flat[: special.size] = special
    return v


BORDERS = {
    "reference": np.linspace(-3, 3, 63).astype(np.float32),
    "zeros": np.array([-0.0, 0.0, 0.0, 1.0], np.float32),
    "nan": np.array([-1.0, np.nan, 0.5, np.nan], np.float32),
    "unsorted": np.array([2.0, -1.0, 0.0, -np.inf, np.inf, 0.5], np.float32),
    "one": np.array([0.0], np.float32),
    "many": np.sort(np.random.default_rng(5).standard_normal(1000).astype(np.float32) * 3),
}


@pytest.mark.parametrize("kind", sorted(BORDERS))
def test_bucketize_matches_pallas_and_ref(kind):
    """The count of borders strictly below v: NaN values give 0, NaN borders
    never count, -0.0 is not above +0.0, unsorted borders count as they
    are."""
    borders = BORDERS[kind]
    v = _values(len(kind), (40, 130))
    got = ops.bucketize(torch.from_numpy(v), torch.from_numpy(borders))
    assert got.dtype == torch.int32 and got.shape == v.shape
    for want in (jops.bucketize(jnp.asarray(v), jnp.asarray(borders), use_pallas=True),
                 jref.bucketize(jnp.asarray(v), jnp.asarray(borders))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[np.isnan(v)] == 0).all()


def test_bucketize_no_borders_and_dlrm_tile():
    """nb = 0 counts nothing (the reference's oracle; the Pallas kernel has
    no block of width 0); the data path's (512, 504) dense tile with the
    reference's bucketize borders, and ``torch.bucketize`` (the library
    call) agreeing on those sorted NaN-free borders where v is not NaN."""
    v = _values(3, (5, 9))
    got = ops.bucketize(torch.from_numpy(v), torch.zeros(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.bucketize(
        jnp.asarray(v), jnp.zeros((0,), jnp.float32))))
    assert (got == 0).all()
    v = _values(4, (512, 504))
    borders = BORDERS["reference"]
    got = ops.bucketize(torch.from_numpy(v), torch.from_numpy(borders))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.bucketize(
        jnp.asarray(v), jnp.asarray(borders), use_pallas=True)))
    lib = torch.bucketize(torch.from_numpy(v), torch.from_numpy(borders), out_int32=True)
    ok = ~np.isnan(v)
    np.testing.assert_array_equal(lib.numpy()[ok], got.numpy()[ok])


def test_bucketize_keeps_subnormals_where_xla_flushes():
    """A subnormal value compares as itself, as numpy's compares (and the
    reference transform's ``np.searchsorted``) and the CUDA kernel's do (built without --ftz); XLA on the CPU flushes it to zero,
    so there the reference kernel counts it as 0."""
    v = np.array([1e-40, -1e-40, 1e-45, 0.0], np.float32)
    borders = np.array([-0.0, 0.0, 1e-42], np.float32)
    got = ops.bucketize(torch.from_numpy(v), torch.from_numpy(borders)).numpy()
    np.testing.assert_array_equal(got, (v[:, None] > borders).sum(-1))
    np.testing.assert_array_equal(got, [3, 0, 2, 0])
    xla = np.asarray(jref.bucketize(jnp.asarray(v), jnp.asarray(borders)))
    assert xla[0] != got[0]


def test_standalone_wrappers_refuse_cpu_and_other_devices():
    """No silent fallback: the kernels' wrappers take CUDA tensors only,
    and the dispatcher refuses a device that is neither CPU nor CUDA."""
    ids = torch.zeros((2, 4), dtype=torch.int32)
    vals = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ksigrid.sigrid_hash(ids, 1, 10)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kbucketize.bucketize(vals, torch.zeros(3))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.sigrid_hash(ids.to("meta"), 1, 10)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.bucketize(vals.to("meta"), torch.zeros(3, device="meta"))


def test_hash_args_check_is_shared():
    """The plain version and the kernel's wrapper refuse the same
    arguments, through one check."""
    assert ksigrid.check_hash_args is ref.check_hash_args
    ref.check_hash_args(0, 1)
    ref.check_hash_args(2 ** 32 - 1, 2 ** 32 - 1)
