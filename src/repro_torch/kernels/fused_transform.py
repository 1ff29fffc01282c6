"""CUDA kernel: fused multi-feature transform (``csrc/fused_transform.cu``).

Counterpart of the reference's Pallas ``repro.kernels.fused_transform``:
one launch applies a per-feature op (IDENTITY, SIGRID_HASH,
POSITIVE_MODULUS, CLAMP, BUCKETIZE, CLAMP_F, BUCKETIZE_F) to every column
of a packed int32 tile, float columns riding as float32 bit patterns.
``repro_torch.core.engine.TorchEngine`` launches one wave per call in its
features-major (features, rows) packing, so no transposes are needed.

The wrapper takes CUDA tensors only, checks them, allocates the output,
launches on the current stream and counts the launch in
``build.LAUNCHES``; the plain version lives in ``kernels.ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

MAX_BORDERS = 12288      # nb float32 borders in a block's 48 KB shared memory


def fused_transform(
    ids: torch.Tensor,          # (rows, features) int32, or (features, rows)
    op_codes: torch.Tensor,     # (features,) int32
    param0: torch.Tensor,       # (features,) int32 (float params bitcast)
    param1: torch.Tensor,       # (features,) int32 (float params bitcast)
    borders: Optional[torch.Tensor] = None,   # (features, nb) f32, +inf padded
    *,
    features_major: bool = False,
) -> torch.Tensor:
    if ids.device.type != "cuda":
        raise ValueError(f"fused_transform: expected a CUDA tensor, got {ids.device}")
    if ids.dtype != torch.int32 or ids.dim() != 2 or not ids.is_contiguous():
        raise ValueError(
            "fused_transform: ids must be a contiguous 2-D int32 tensor, got "
            f"{ids.dtype} {tuple(ids.shape)}"
        )
    feats, rows = ids.shape if features_major else ids.shape[::-1]
    if borders is None:
        borders = torch.full((feats, 1), float("inf"), device=ids.device)
    for name, t in (("op_codes", op_codes), ("param0", param0), ("param1", param1)):
        if (t.device != ids.device or t.dtype != torch.int32
                or tuple(t.shape) != (feats,) or not t.is_contiguous()):
            raise ValueError(
                f"fused_transform: {name} must be a contiguous ({feats},) int32 "
                f"tensor on {ids.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if (borders.device != ids.device or borders.dtype != torch.float32
            or borders.dim() != 2 or borders.shape[0] != feats
            or not borders.is_contiguous()):
        raise ValueError(
            f"fused_transform: borders must be a contiguous ({feats}, nb) float32 "
            f"tensor on {ids.device}, got {borders.dtype} {tuple(borders.shape)}"
        )
    nb = borders.shape[1]
    if not 1 <= nb <= MAX_BORDERS:
        raise ValueError(f"fused_transform: nb={nb} outside [1, {MAX_BORDERS}]")
    stride_f, stride_r = (rows, 1) if features_major else (1, feats)
    out = torch.empty_like(ids)
    lib = build.library()
    with torch.cuda.device(ids.device):
        err = lib.fused_transform_launch(
            ids.data_ptr(), op_codes.data_ptr(), param0.data_ptr(),
            param1.data_ptr(), borders.data_ptr(), out.data_ptr(),
            feats, rows, stride_f, stride_r, nb,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("fused_transform", err)
    build.LAUNCHES.add("fused_transform")
    return out
