"""CUDA kernel: the standalone SigridHash (``csrc/sigrid_hash.cu``).

Counterpart of the reference's Pallas ``repro.kernels.sigrid_hash``:
``hash(ids ^ salt) % max_value`` in uint32 over an int32 tile, the result
reinterpreted as int32.  The wrapper takes a CUDA int32 tensor of any
shape (a non-contiguous one is copied to a contiguous one first), refuses
a salt outside [0, 2**32) and a max_value outside [1, 2**32) as the
reference's ``jnp.uint32`` does, computes the remainder's magic number
here on the host (``fastmod_magic``), launches on the current stream and
counts the launch in ``build.LAUNCHES``.  The plain version is
``kernels.ref.sigrid_hash``; ``fastmod_form`` and ``sigrid_hash_form``
mirror the kernel's integer remainder in plain PyTorch for the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import _M32, _hash_u32, _i32, _u32, check_hash_args

_M64 = (1 << 64) - 1


def fastmod_magic(d: int) -> int:
    """The kernel's magic for divisor d in [1, 2**32): ``(2**64 - 1) // d
    + 1`` as a uint64, which wraps to 0 for d = 1."""
    return ((_M64 // int(d)) + 1) & _M64


def _mul_wide(x: torch.Tensor, c: int):
    """Low and high 32 bits of ``x * c`` for x and c in [0, 2**32), held in
    int64 without overflow: c split into 16-bit halves."""
    a, b = x * (c & 0xFFFF), x * (c >> 16)          # each below 2**48
    s = (a & _M32) + ((b & 0xFFFF) << 16)
    return s & _M32, (a >> 32) + (b >> 16) + (s >> 32)


def fastmod_form(x: torch.Tensor, magic: int, d: int) -> torch.Tensor:
    """``x % d`` for uint32 x held in int64, as the kernel computes it:
    low = magic * x (mod 2**64) from the halves of magic, then the high 32
    bits of ``hi(low) * d + umulhi(lo(low), d)``."""
    m_lo, m_hi = magic & _M32, magic >> 32
    p_lo, p_hi = _mul_wide(x, m_lo)
    low_hi = (p_hi + _mul_wide(x, m_hi)[0]) & _M32
    umulhi = _mul_wide(p_lo, d)[1]
    t_lo, t_hi = _mul_wide(low_hi, d)
    return t_hi + ((t_lo + umulhi) >> 32)


def sigrid_hash_form(ids: torch.Tensor, salt: int, max_value: int) -> torch.Tensor:
    """``ref.sigrid_hash`` with the kernel's remainder (``fastmod_form``)."""
    check_hash_args(salt, max_value)
    hashed = _hash_u32(_u32(ids) ^ int(salt))
    return _i32(fastmod_form(hashed, fastmod_magic(max_value), int(max_value)))


def sigrid_hash(ids: torch.Tensor, salt: int, max_value: int) -> torch.Tensor:
    if ids.device.type != "cuda":
        raise ValueError(f"sigrid_hash ids: expected a CUDA tensor, got {ids.device}")
    if ids.dtype != torch.int32:
        raise ValueError(f"sigrid_hash ids: expected int32, got {ids.dtype}")
    check_hash_args(salt, max_value)
    ids = ids.contiguous()
    out = torch.empty_like(ids)
    lib = build.library()
    with torch.cuda.device(ids.device):
        err = lib.sigrid_hash_launch(ids.data_ptr(), out.data_ptr(), ids.numel(), int(salt),
                                     fastmod_magic(max_value), int(max_value),
                                     torch.cuda.current_stream().cuda_stream)
    build.check("sigrid_hash", err)
    build.LAUNCHES.add("sigrid_hash")
    return out
