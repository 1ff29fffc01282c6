"""Public kernel API: dispatch by the device of the tensors.

A CPU tensor runs the plain PyTorch version (``repro_torch.kernels.ref``);
a CUDA tensor launches the hand-written kernel (``kernels.decode``,
``kernels.fused_transform``, ``kernels.embedding_bag``,
``kernels.flash_attention``, ``kernels.ssd_chunk``, ``kernels.sigrid_hash``,
``kernels.bucketize``, ``kernels.rowwise_adagrad``), which raises on
anything it cannot take.  There is no fallback from a CUDA tensor to the
plain version.  A ``meta`` tensor, which only a caller that asks for it
holds (``launch.dryrun``), gets an empty result of the kernel's shape and
dtype (the in-place ``rowwise_adagrad_`` its operands back): nothing
runs.  Any other device raises.

Each op reports its call to the op-trace analyzer while one traces
(``launch.hlo_analysis.trace``), which counts the kernel's work once
(``launch.roofline.kernel_work``) and none of the plain version's ops, so
a kernel costs the same on every device.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import bucketize as _bucketize
from repro_torch.kernels import decode as _decode
from repro_torch.kernels import embedding_bag as _embag
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_transform as _ft
from repro_torch.kernels import ref
from repro_torch.kernels import rowwise_adagrad as _adagrad
from repro_torch.kernels import sigrid_hash as _sigrid
from repro_torch.kernels import ssd_chunk as _ssd


# the analyzers tracing a step, innermost last (``launch.hlo_analysis``)
TRACERS: list = []


def _kernel_op(fn):
    """``fn``, reported to the innermost tracing analyzer when there is one."""
    name = fn.__name__

    @functools.wraps(fn)
    def op(*args, **kwargs):
        if not TRACERS:
            return fn(*args, **kwargs)
        return TRACERS[-1].kernel_call(name, fn, args, kwargs)

    return op


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type in ("cuda", "meta"):
        return False
    raise ValueError(f"no kernel for device {t.device}; expected cpu, cuda or meta")


def _meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


@_kernel_op
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
    if _meta(ids):
        return torch.empty_like(ids)
    return _ft.fused_transform(ids, op_codes, param0, param1, borders,
                               features_major=features_major)


@_kernel_op
def xor_decrypt(words: torch.Tensor) -> torch.Tensor:
    if _on_cpu(words):
        return ref.xor_decrypt(words)
    if _meta(words):
        return torch.empty_like(words)
    return _decode.xor_decrypt(words)


@_kernel_op
def dense_unpack(bitmap_words: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    if _on_cpu(bitmap_words):
        return ref.dense_unpack(bitmap_words, values)
    if _meta(bitmap_words):
        feats, w = bitmap_words.shape
        return torch.empty((feats, w * 32), dtype=torch.int32, device="meta")
    return _decode.dense_unpack(bitmap_words, values)


@_kernel_op
def ragged_gather(src: torch.Tensor, idx: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    if _on_cpu(src):
        return ref.ragged_gather(src, idx, shift)
    if _meta(src):
        return torch.empty_like(idx)
    return _decode.ragged_gather(src, idx, shift)


@_kernel_op
def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, *,
                  mode: str = "mean") -> torch.Tensor:
    """Pooled bags: table (V, E), ids and mask (B, L) -> (B, E); "mean"
    divides by max(sum(mask), 1)."""
    if _on_cpu(table):
        return ref.embedding_bag(table, ids, mask, mode=mode)
    if _meta(table):
        return torch.empty((ids.shape[0], table.shape[1]), dtype=torch.float32, device="meta")
    return _embag.embedding_bag(table, ids, mask, mode=mode)


@_kernel_op
def rowwise_adagrad_(table: torch.Tensor, acc: torch.Tensor, keys: torch.Tensor,
                     weights: torch.Tensor, grad: torch.Tensor, lr, eps: float = 1e-8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad in place on table (R, E) and acc (R,): occurrence
    (m, l) names row ``keys[m, l]`` (none where it is negative) with
    gradient ``weights[m, l] * grad[m]``; each row's accumulator entry
    adds every occurrence's mean squared gradient, then the row moves by
    -lr/sqrt(acc+eps) times the sum of its gradients.  The plain
    scatter-adds on a CPU tensor; on a CUDA tensor one sorted,
    deduplicated pass with no float atomics and no host synchronisation
    (int32 keys, ``lr`` a float or a 0-d tensor).  Returns (table, acc)."""
    if _on_cpu(table):
        return ref.rowwise_adagrad_(table, acc, keys, weights, grad, lr, eps)
    if _meta(table):
        return table, acc
    return _adagrad.rowwise_adagrad_(table, acc, keys, weights, grad, lr, eps)


@_kernel_op
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
    if _meta(q):
        return torch.empty_like(q)
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)


@_kernel_op
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
    if _meta(x):
        bsz, s, h, p = x.shape
        return (torch.empty((bsz, s, h, p), dtype=x.dtype, device="meta"),
                torch.empty((bsz, h, p, b_.shape[3]), dtype=torch.float32, device="meta"))
    return _ssd.ssd_chunk_forward(x, dt, a, b_, c_, chunk=chunk, initial_state=initial_state)


@_kernel_op
def sigrid_hash(ids: torch.Tensor, salt: int, max_value: int) -> torch.Tensor:
    """``hash(ids ^ salt) % max_value`` in uint32 over int32 ids -> int32."""
    if _on_cpu(ids):
        return ref.sigrid_hash(ids, salt, max_value)
    if _meta(ids):
        return torch.empty_like(ids)
    return _sigrid.sigrid_hash(ids, salt, max_value)


@_kernel_op
def bucketize(values: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """The count of borders strictly below each float32 value -> int32."""
    if _on_cpu(values):
        return ref.bucketize(values, borders)
    if _meta(values):
        return torch.empty(values.shape, dtype=torch.int32, device="meta")
    return _bucketize.bucketize(values, borders)
