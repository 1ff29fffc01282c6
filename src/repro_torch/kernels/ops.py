"""Public kernel API: dispatch by the device of the tensors.

A CPU tensor runs the plain PyTorch version (``repro_torch.kernels.ref``);
a CUDA tensor launches the hand-written kernel (``kernels.decode``,
``kernels.fused_transform``, ``kernels.embedding_bag``,
``kernels.flash_attention``, ``kernels.ssd_chunk``, ``kernels.sigrid_hash``,
``kernels.bucketize``), which raises on anything it cannot take.  There
is no fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import bucketize as _bucketize
from repro_torch.kernels import decode as _decode
from repro_torch.kernels import embedding_bag as _embag
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_transform as _ft
from repro_torch.kernels import ref
from repro_torch.kernels import sigrid_hash as _sigrid
from repro_torch.kernels import ssd_chunk as _ssd


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
    the dense plain version on a CPU tensor, a blocked online-softmax
    kernel on a CUDA tensor (any strides, read in place): the tensor-core
    one for bf16 with D of 64 or 128 and TMA-aligned views, the FMA one
    otherwise (``kernels.flash_attention.route``).  The score scale
    defaults to 1/sqrt(D)."""
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)


def ssd_chunk_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b_: torch.Tensor, c_: torch.Tensor, *, chunk: int = 256,
                      initial_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in the model's layout: x (B, S, H, P), dt (B, S, H),
    a (H,) or (B, H), b_ and c_ (B, S, G, N) -> y (B, S, H, P) in x's dtype
    and the final state (B, H, P, N) float32.  On a CPU tensor the
    sequential float32 recurrence (``ref.ssd_scan``, which has no chunks);
    on a CUDA tensor a chunked kernel, ``chunk`` positions at a time: the
    tensor-core one for bf16 with P and N of 64 or 128, a chunk that is a
    multiple of 64 and 16-byte aligned views, the FMA one otherwise
    (``kernels.ssd_chunk.route``)."""
    if _on_cpu(x):
        return ref.ssd_scan(x, dt, a, b_, c_, initial_state)
    return _ssd.ssd_chunk_forward(x, dt, a, b_, c_, chunk=chunk, initial_state=initial_state)


def sigrid_hash(ids: torch.Tensor, salt: int, max_value: int) -> torch.Tensor:
    """``hash(ids ^ salt) % max_value`` in uint32 over int32 ids -> int32."""
    if _on_cpu(ids):
        return ref.sigrid_hash(ids, salt, max_value)
    return _sigrid.sigrid_hash(ids, salt, max_value)


def bucketize(values: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """The count of borders strictly below each float32 value -> int32."""
    if _on_cpu(values):
        return ref.bucketize(values, borders)
    return _bucketize.bucketize(values, borders)
