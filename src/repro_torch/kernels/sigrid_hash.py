"""CUDA kernel: the standalone SigridHash (``csrc/sigrid_hash.cu``).

Counterpart of the reference's Pallas ``repro.kernels.sigrid_hash``:
``hash(ids ^ salt) % max_value`` in uint32 over an int32 tile, the result
reinterpreted as int32.  The wrapper takes a CUDA int32 tensor of any
shape (a non-contiguous one is copied to a contiguous one first), refuses
a salt outside [0, 2**32) and a max_value outside [1, 2**32) as the
reference's ``jnp.uint32`` does, launches on the current stream and counts
the launch in ``build.LAUNCHES``.  The plain version is
``kernels.ref.sigrid_hash``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import check_hash_args


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
                                     int(max_value), torch.cuda.current_stream().cuda_stream)
    build.check("sigrid_hash", err)
    build.LAUNCHES.add("sigrid_hash")
    return out
