"""CUDA kernel: flash attention forward (``csrc/flash_attention.cu``).

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

The wrapper takes CUDA tensors only, checks them, allocates the output,
launches on the current stream and counts the launch in
``build.LAUNCHES``; ``kernels.ops`` dispatches to it, and the plain
version lives in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 128
_BLOCK_Q = 64                 # query rows per block (grid.y counts tiles)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, S, D), k and v (B, KVH, T, D) with H % KVH == 0, float32
    or bfloat16, any strides with a contiguous last dim -> (B, H, S, D)
    in q's layout (``torch.empty_like``).  The score scale defaults to
    1/sqrt(D)."""
    b, h, s, d = _check(q, k, v)
    out = torch.empty_like(q)
    t, kvh = k.shape[2], k.shape[1]
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
