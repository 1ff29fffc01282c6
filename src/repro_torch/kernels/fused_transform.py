"""CUDA kernels: fused multi-feature transform, two routes
(``csrc/fused_transform.cu``).

Counterpart of the reference's Pallas ``repro.kernels.fused_transform``:
one launch applies a per-feature op (IDENTITY, SIGRID_HASH,
POSITIVE_MODULUS, CLAMP, BUCKETIZE, CLAMP_F, BUCKETIZE_F) to every column
of a packed int32 tile, float columns riding as float32 bit patterns.
``repro_torch.core.engine.TorchEngine`` launches one wave per call in its
features-major (features, rows) packing, so no transposes are needed.

Two kernels compute it; ``route`` picks one from the operands before the
launch:

* ``"vec"``: 16-byte lanes, the ids loaded before anything else, no block
  barrier, and BUCKETIZE_F's sorted border rows searched (unsorted or NaN
  rows counted).  It takes features-major, contiguous tiles whose rows are
  a multiple of 4, whose base is 16-byte aligned and whose features
  number at most 65535: every tile the engine launches.  Counted as
  ``fused_transform_vec``.
* ``"scalar"``: one 4-byte element a thread through any layout's strides.
  It takes every other call (rows-major tiles, the ``ops.fused_transform``
  default; rows that are not a multiple of 4; unaligned bases).  Counted
  as ``fused_transform``.

The rule is a dispatch on the operands, not a fallback: a call that the
vec route takes raises if that kernel fails to build or launch.
``fused_transform_vec`` and ``fused_transform_scalar`` launch one route
each (the former raises on operands it does not take), so the two can be
timed on the same operands.  Both give the plain version's bits.

The wrappers take CUDA tensors only, check them, allocate the output,
launch on the current stream and count the launch in ``build.LAUNCHES``;
the plain version lives in ``kernels.ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

MAX_BORDERS = 12288      # nb float32 borders in a block's 48 KB shared memory
VEC_LANE = 4             # int32 elements in one 16-byte lane
VEC_ALIGN = 16           # bytes: the vec route's base alignment
VEC_MAX_FEATURES = 65535  # the vec route's features: its grid.y


def route(ids: torch.Tensor, *, features_major: bool = False) -> str:
    """``"vec"`` for a features-major, contiguous 2-D tile whose rows are a
    multiple of 4, whose base is 16-byte aligned and whose features number
    at most 65535, else ``"scalar"``.  Reads only the layout, shape,
    strides and base address, so it decides the same on any device."""
    if not features_major or ids.dim() != 2 or not ids.is_contiguous():
        return "scalar"
    if ids.shape[1] % VEC_LANE or ids.data_ptr() % VEC_ALIGN:
        return "scalar"
    if ids.shape[0] > VEC_MAX_FEATURES:
        return "scalar"
    return "vec"


def fused_transform(
    ids: torch.Tensor,          # (rows, features) int32, or (features, rows)
    op_codes: torch.Tensor,     # (features,) int32
    param0: torch.Tensor,       # (features,) int32 (float params bitcast)
    param1: torch.Tensor,       # (features,) int32 (float params bitcast)
    borders: Optional[torch.Tensor] = None,   # (features, nb) f32, +inf padded
    *,
    features_major: bool = False,
) -> torch.Tensor:
    """The transformed tile in ``ids``' layout, through the route ``route``
    picks."""
    borders = _check(ids, op_codes, param0, param1, borders, features_major)
    if route(ids, features_major=features_major) == "vec":
        return _launch_vec(ids, op_codes, param0, param1, borders)
    return _launch_scalar(ids, op_codes, param0, param1, borders, features_major)


def fused_transform_scalar(ids, op_codes, param0, param1, borders=None, *,
                           features_major: bool = False) -> torch.Tensor:
    """The general route, whatever ``route`` would pick."""
    borders = _check(ids, op_codes, param0, param1, borders, features_major)
    return _launch_scalar(ids, op_codes, param0, param1, borders, features_major)


def fused_transform_vec(ids, op_codes, param0, param1, borders=None, *,
                        features_major: bool = False) -> torch.Tensor:
    """The 16-byte-lane route; raises on operands it does not take."""
    borders = _check(ids, op_codes, param0, param1, borders, features_major)
    if route(ids, features_major=features_major) != "vec":
        raise ValueError(
            "fused_transform_vec: takes features-major contiguous tiles with rows a "
            f"multiple of {VEC_LANE}, a {VEC_ALIGN}-byte aligned base and at most "
            f"{VEC_MAX_FEATURES} features, got "
            f"features_major={features_major} {tuple(ids.shape)} strides {ids.stride()} "
            f"base {ids.data_ptr() % VEC_ALIGN} bytes off"
        )
    return _launch_vec(ids, op_codes, param0, param1, borders)


def _check(ids, op_codes, param0, param1, borders, features_major) -> torch.Tensor:
    """Raise on what neither kernel takes; returns the borders (one +inf
    column where none are given)."""
    if ids.device.type != "cuda":
        raise ValueError(f"fused_transform: expected a CUDA tensor, got {ids.device}")
    if ids.dtype != torch.int32 or ids.dim() != 2 or not ids.is_contiguous():
        raise ValueError(
            "fused_transform: ids must be a contiguous 2-D int32 tensor, got "
            f"{ids.dtype} {tuple(ids.shape)}"
        )
    feats = ids.shape[0] if features_major else ids.shape[1]
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
    return borders


def _launch_scalar(ids, op_codes, param0, param1, borders, features_major) -> torch.Tensor:
    feats, rows = ids.shape if features_major else ids.shape[::-1]
    stride_f, stride_r = (rows, 1) if features_major else (1, feats)
    out = torch.empty_like(ids)
    lib = build.library()
    with torch.cuda.device(ids.device):
        err = lib.fused_transform_launch(
            ids.data_ptr(), op_codes.data_ptr(), param0.data_ptr(),
            param1.data_ptr(), borders.data_ptr(), out.data_ptr(),
            feats, rows, stride_f, stride_r, borders.shape[1],
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("fused_transform", err)
    build.LAUNCHES.add("fused_transform")
    return out


def _launch_vec(ids, op_codes, param0, param1, borders) -> torch.Tensor:
    feats, rows = ids.shape
    out = torch.empty_like(ids)       # a fresh allocation: 16-byte aligned
    lib = build.library()
    with torch.cuda.device(ids.device):
        err = lib.fused_transform_vec_launch(
            ids.data_ptr(), op_codes.data_ptr(), param0.data_ptr(),
            param1.data_ptr(), borders.data_ptr(), out.data_ptr(),
            feats, rows, borders.shape[1], torch.cuda.current_stream().cuda_stream,
        )
    build.check("fused_transform_vec", err)
    build.LAUNCHES.add("fused_transform_vec")
    return out
