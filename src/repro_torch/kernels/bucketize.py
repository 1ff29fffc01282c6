"""CUDA kernel: the standalone Bucketize (``csrc/bucketize.cu``).

Counterpart of the reference's Pallas ``repro.kernels.bucketize``: for
each float32 value, the count of the float32 borders strictly below it,
as int32.  The wrapper takes a CUDA float32 tensor of values of any shape
and a 1-D float32 tensor of borders (non-contiguous ones are copied to
contiguous ones first), launches on the current stream and counts the
launch in ``build.LAUNCHES``.  The plain version is
``kernels.ref.bucketize``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def bucketize(values: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    for name, t in (("values", values), ("borders", borders)):
        if t.device.type != "cuda":
            raise ValueError(f"bucketize {name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"bucketize {name}: expected float32, got {t.dtype}")
    if borders.dim() != 1:
        raise ValueError(f"bucketize borders: expected a 1-D tensor, got {tuple(borders.shape)}")
    if values.device != borders.device:
        raise ValueError("bucketize: values and borders on different devices")
    if borders.numel() >= 2 ** 31:
        raise ValueError(f"bucketize: {borders.numel()} borders are too many for one launch")
    values, borders = values.contiguous(), borders.contiguous()
    out = torch.empty(values.shape, dtype=torch.int32, device=values.device)
    lib = build.library()
    with torch.cuda.device(values.device):
        err = lib.bucketize_launch(values.data_ptr(), borders.data_ptr(), out.data_ptr(),
                                   values.numel(), borders.numel(),
                                   torch.cuda.current_stream().cuda_stream)
    build.check("bucketize", err)
    build.LAUNCHES.add("bucketize")
    return out
