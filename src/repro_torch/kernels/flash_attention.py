"""CUDA kernels: flash attention forward, two routes.

Counterpart of the reference's Pallas ``repro.kernels.flash_attention``:
blocked online-softmax attention, causal or full, float32 scores and
accumulator, p rounded to the inputs' type before P.V, masking at -2e38,
``out = acc / max(l, 1e-30)``.  ``flash_attention`` keeps the TPU
kernel's (B, H, S, D) signature and adds GQA: k and v are (B, KVH, T, D)
and query head h reads KV head h / (H / KVH).  Every operand is read in
place through its strides, so ``repro_torch.models.attention``'s
``blocked_attention`` passes the (B, S, H, D) / (B, T, KVH, D) tensors
of a prefill as transposed views, once per layer, and neither a
transpose nor the GQA expansion is materialized; the output takes q's
layout.

Two kernels compute it; ``route`` picks one from the operands before the
launch:

* ``"sm90"`` (``csrc/flash_attention_sm90.cu``): wgmma on the tensor
  cores, Q/K/V tiles fed by TMA.  It takes bf16 operands with head dim 64
  or 128 whose views a TMA tensor map accepts (``tma_strides``: the last
  dim contiguous, every other byte stride a positive multiple of 16, the
  base 16-byte aligned).  Counted as ``flash_attention_sm90``.
* ``"fma"`` (``csrc/flash_attention.cu``): float32 FMAs on the CUDA
  cores, any head dim up to 192 (MLA's prefill attends at 128 + 64),
  float32 or bf16, any strides with a contiguous last dim.  It takes
  every other call.  Counted as ``flash_attention``.

The rule is a dispatch on the operands, not a fallback: a call that the
tensor-core route takes raises if that kernel fails to build or launch,
and a head dim above 192 has no route and raises.
``flash_attention_fma`` and ``flash_attention_sm90`` launch one route
each (the latter raises on operands it does not take), so the two can be
timed on the same operands.

The wrappers take CUDA tensors only, check them, allocate the output,
launch on the current stream and count the launch in ``build.LAUNCHES``;
``kernels.ops`` dispatches to ``flash_attention``, and the plain version
lives in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 192            # the FMA route's largest padded tile
SM90_HEAD_DIMS = (64, 128)
TMA_ALIGN = 16                # bytes: TMA's stride and base alignment
_BLOCK_Q = 64                 # FMA route: query rows per block (grid.y counts tiles)
SM90_TILE = 128               # tensor-core route: query rows per block and keys per tile


def tma_strides(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """The byte strides of a (B, H, S, D) view's position, head and batch
    dims, as its tensor map takes them (dims innermost first: D, S, H, B),
    or None where TMA refuses the view: a last dim that is not contiguous,
    a base that is not 16-byte aligned, or a stride that is not a positive
    multiple of 16 bytes."""
    if t.dim() != 4 or t.stride(3) != 1 or t.data_ptr() % TMA_ALIGN:
        return None
    strides = tuple(t.stride(i) * t.element_size() for i in (2, 1, 0))
    if any(s <= 0 or s % TMA_ALIGN for s in strides):
        return None
    return strides


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"sm90"`` for bf16 operands with D in (64, 128) whose views TMA
    accepts, else ``"fma"`` (D up to 192); raises for a head dim outside
    [1, 192], which neither route takes.  Reads only dtypes, shapes,
    strides and base addresses, so it decides the same on any device."""
    d = q.shape[-1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in [1, {MAX_HEAD_DIM}]")
    if q.dtype != torch.bfloat16 or q.shape[-1] not in SM90_HEAD_DIMS:
        return "fma"
    if any(tma_strides(t) is None for t in (q, k, v)):
        return "fma"
    return "sm90"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, S, D), k and v (B, KVH, T, D) with H % KVH == 0, float32
    or bfloat16, any strides with a contiguous last dim -> (B, H, S, D)
    in q's layout (``torch.empty_like``), through the route ``route``
    picks.  The score scale defaults to 1/sqrt(D)."""
    _check(q, k, v)
    launch = _launch_sm90 if route(q, k, v) == "sm90" else _launch_fma
    return launch(q, k, v, causal, scale)


def flash_attention_fma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """The FMA route, whatever ``route`` would pick."""
    _check(q, k, v)
    return _launch_fma(q, k, v, causal, scale)


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """The tensor-core route; raises on operands it does not take."""
    _check(q, k, v)
    if route(q, k, v) != "sm90":
        raise ValueError(f"flash_attention_sm90: takes bf16 with D in {SM90_HEAD_DIMS} and "
                         f"views TMA accepts, got {q.dtype} D={q.shape[-1]} strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    return _launch_sm90(q, k, v, causal, scale)


def flash_attention_sm90_tile(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core route's two products on one tile, for tests: bf16 q,
    k, v of (128, D), D in (64, 128), rows 16-byte aligned -> s = q.k^T
    (128, 128) and o = bf16(s).v (128, D), both float32, with no scale,
    mask or softmax."""
    d = q.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention_sm90_tile {name}: expected a CUDA bf16 "
                             f"tensor, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (SM90_TILE, d) or d not in SM90_HEAD_DIMS:
            raise ValueError(f"flash_attention_sm90_tile {name}: expected "
                             f"({SM90_TILE}, 64 or 128), got {tuple(t.shape)}")
        if tma_strides(t[None, None]) is None:
            raise ValueError(f"flash_attention_sm90_tile {name}: strides {t.stride()} or "
                             "base not 16-byte aligned")
    s = torch.empty((SM90_TILE, SM90_TILE), dtype=torch.float32, device=q.device)
    o = torch.empty((SM90_TILE, d), dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_sm90_tile_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(), d,
            *(t.stride(0) * 2 for t in (q, k, v)),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("flash_attention_sm90_tile", err)
    build.LAUNCHES.add("flash_attention_sm90_tile")
    return s, o


def _launch_fma(q, k, v, causal, scale) -> torch.Tensor:
    b, h, s, d = q.shape
    t, kvh = k.shape[2], k.shape[1]
    out = torch.empty_like(q)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kvh, d,
            *(x.stride(i) for x in (q, k, v, out) for i in (0, 2, 1)),
            int(causal), ctypes.c_float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("flash_attention", err)
    build.LAUNCHES.add("flash_attention")
    return out


def _launch_sm90(q, k, v, causal, scale) -> torch.Tensor:
    b, h, s, d = q.shape
    t, kvh = k.shape[2], k.shape[1]
    out = torch.empty_like(q)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # (position, head, batch) byte strides -> the C order (batch, position, head)
    strides = []
    for x in (q, k, v):
        ss, sh, sb = tma_strides(x)
        strides += [sb, ss, sh]
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kvh, d, *strides,
            *(out.stride(i) for i in (0, 2, 1)),
            int(causal), ctypes.c_float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("flash_attention_sm90", err)
    build.LAUNCHES.add("flash_attention_sm90")
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention {name}: expected a CUDA tensor, got {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention {name}: expected float32 or bfloat16 like "
                             f"q ({q.dtype}), got {t.dtype}")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"flash_attention {name}: expected a 4-D tensor with a "
                             f"contiguous last dim, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: operands on different devices")
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B, H, S, D), (B, KVH, T, D)")
    if kvh < 1 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads over {kvh} KV heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in [1, {MAX_HEAD_DIM}]")
    if b < 1 or s < 1 or t < 1:
        raise ValueError(f"flash_attention: empty operand q {tuple(q.shape)} k {tuple(k.shape)}")
    if b * h >= 2 ** 31 or -(-s // _BLOCK_Q) > 65535 or t >= 2 ** 31:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} too "
                         "large for one launch")
    return b, h, s, d
