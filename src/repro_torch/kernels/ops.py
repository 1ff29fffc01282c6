"""Public kernel API: dispatch by the device of the tensors.

A CPU tensor runs the plain PyTorch version (``repro_torch.kernels.ref``);
a CUDA tensor launches the hand-written kernel (``kernels.decode``,
``kernels.fused_transform``, ``kernels.embedding_bag``,
``kernels.flash_attention``), which raises on anything it cannot take.
There is no fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode as _decode
from repro_torch.kernels import embedding_bag as _embag
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_transform as _ft
from repro_torch.kernels import ref


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}; expected cpu or cuda")


def fused_transform(ids, op_codes, param0, param1,
                    borders: Optional[torch.Tensor] = None, *,
                    features_major: bool = False) -> torch.Tensor:
    """One op per feature over a packed int32 tile: (rows, features), or
    (features, rows) with ``features_major``."""
    if _on_cpu(ids):
        return ref.fused_transform_static(
            ids, tuple(int(c) for c in op_codes.tolist()), param0, param1,
            borders, features_major=features_major,
        )
    return _ft.fused_transform(ids, op_codes, param0, param1, borders,
                               features_major=features_major)


def xor_decrypt(words: torch.Tensor) -> torch.Tensor:
    if _on_cpu(words):
        return ref.xor_decrypt(words)
    return _decode.xor_decrypt(words)


def dense_unpack(bitmap_words: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    if _on_cpu(bitmap_words):
        return ref.dense_unpack(bitmap_words, values)
    return _decode.dense_unpack(bitmap_words, values)


def ragged_gather(src: torch.Tensor, idx: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    if _on_cpu(src):
        return ref.ragged_gather(src, idx, shift)
    return _decode.ragged_gather(src, idx, shift)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, *,
                  mode: str = "mean") -> torch.Tensor:
    """Pooled bags: table (V, E), ids and mask (B, L) -> (B, E); "mean"
    divides by max(sum(mask), 1)."""
    if _on_cpu(table):
        return ref.embedding_bag(table, ids, mask, mode=mode)
    return _embag.embedding_bag(table, ids, mask, mode=mode)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, S, D) q and (B, KVH, T, D) k, v -> (B, H, S, D):
    the dense plain version on a CPU tensor, the blocked online-softmax
    kernel on a CUDA tensor (any strides, read in place).  The score
    scale defaults to 1/sqrt(D)."""
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)
