"""Frozen counts of a step's work: the operations and bytes the algorithm
needs, counted from the shapes and the batch, whatever code runs it.

* ``lm_step_flops``: model FLOPs of one LM training step, 6 x the matrix
  products' parameters (every layer's projections and MLP, and the
  output head; not the token table, a gather, nor the norms) x the
  tokens, plus the causal attention, 6 B H S^2 D a layer (forward QK^T
  and PV over the lower triangle, 2 B H S^2 D, and twice that backward).
  No recomputed operation is counted.
* ``dlrm_step_flops``: the MLPs (forward 2 B din dout a layer, backward
  twice that, less the bottom MLP's first input gradient, which no one
  needs) and the pairwise interaction (2 B (T+1)^2 E forward, the same
  backward).
* ``dlrm_step_bytes``: for each unique (table, row) among the batch's
  live slots, the row read for pooling, read and written for the update,
  and its accumulator entry read and written; the batch's ids, mask,
  dense features and labels read once; the MLPs' parameters, gradients
  and AdamW moments each read and written once.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from dsibench.weights import dlrm_mlp_dims

F32 = 4


def lm_matmul_params(m: Dict[str, Any]) -> int:
    d, h, kvh, hd, ff, v = (m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"],
                            m["d_ff"], m["vocab_size"])
    layer = d * h * hd * 2 + d * kvh * hd * 2 + 3 * d * ff
    return m["num_layers"] * layer + d * v


def lm_step_flops(m: Dict[str, Any], rows: int, seq: int) -> int:
    attn = 6 * m["num_layers"] * rows * m["num_heads"] * seq * seq * m["head_dim"]
    return 6 * lm_matmul_params(m) * rows * seq + attn


def dlrm_mlp_params(m: Dict[str, Any]) -> int:
    return sum(a * b + b for dims in dlrm_mlp_dims(m) for a, b in zip(dims[:-1], dims[1:]))


def dlrm_step_flops(m: Dict[str, Any], batch: int) -> int:
    bottom, top = dlrm_mlp_dims(m)
    macs = sum(a * b for dims in (bottom, top) for a, b in zip(dims[:-1], dims[1:]))
    mlp = 6 * batch * macs - 2 * batch * bottom[0] * bottom[1]
    inter = 4 * batch * (m["num_tables"] + 1) ** 2 * m["embed_dim"]
    return mlp + inter


def unique_live_rows(ids: np.ndarray, mask: np.ndarray, vocab: int) -> int:
    """The number of distinct (table, row) pairs among the live slots of
    a (B, T, L) batch."""
    t = ids.shape[1]
    flat = (ids.astype(np.int64) + np.arange(t, dtype=np.int64)[None, :, None] * vocab)
    return int(np.unique(flat[mask > 0]).size)


def dlrm_step_bytes(m: Dict[str, Any], batch: Dict[str, np.ndarray]) -> int:
    e = m["embed_dim"]
    rows = unique_live_rows(batch["sparse_ids"], batch["sparse_mask"], m["vocab_per_table"])
    per_row = 3 * e * F32 + 2 * F32
    inputs = sum(int(np.asarray(batch[k]).nbytes)
                 for k in ("sparse_ids", "sparse_mask", "dense", "label"))
    return rows * per_row + inputs + 8 * F32 * dlrm_mlp_params(m)


def least_seconds(flops: float, nbytes: float, flops_per_s: float, bytes_per_s: float
                  ) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / flops_per_s, nbytes / bytes_per_s)
