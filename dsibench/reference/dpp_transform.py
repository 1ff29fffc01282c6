"""Plain reference of the DPP session's transform and load: the raw
partition's features through the transform plan, batched into the DLRM
tensors (dense (B, D) float32, sparse_ids (B, T, L) int32, sparse_mask
(B, T, L) float32, label (B,) float32).

The ops, as the plan states them:

* BoxCox (lambda 0.5), Logit (eps 1e-6), Clamp (lo, hi) on a dense
  column, absent values (NaN) read as 0 (Logit: 0.5), in float32;
* FirstX: a row's first x ids; SigridHash: each id's low 32 bits XOR the
  salt, through the 32-bit multiply-xor-shift mixer (0x7FEB352D,
  0x846CA68B), modulo max_value;
* NGram (n = 2): each pair of neighbouring ids folded as
  ``a * 1000003 + b`` in wrapping uint64, through the 64-bit mixer
  (splitmix64's finaliser), modulo ``mod``; Cartesian: every (a, b) of
  two rows' ids folded the same way, a major; Bucketize: a dense value's
  bucket among the borders (left side, float32);
* load: a row's first L ids and a mask of 1 over them, zero-padded.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

Ragged = Tuple[np.ndarray, np.ndarray]      # (offsets, values)
PRIME = np.uint64(1000003)


def mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
    return x


def mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint64(30))
        x = x * np.uint64(0xBF58476D1CE4E5B9)
        x = x ^ (x >> np.uint64(27))
        x = x * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def _within(lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(each element's row, its index within the row) for rows of
    ``lengths`` elements laid end to end."""
    rows = np.repeat(np.arange(len(lengths)), lengths)
    starts = np.cumsum(lengths) - lengths
    return rows, np.arange(int(lengths.sum())) - np.repeat(starts, lengths)


def _offsets(lengths: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def firstx(col: Ragged, x: int) -> Ragged:
    off, val = col
    lengths = np.minimum(np.diff(off), x)
    rows, j = _within(lengths)
    return _offsets(lengths), val[off[rows] + j]


def sigrid_hash(col: Ragged, salt: int, max_value: int) -> Ragged:
    off, val = col
    h = mix32(val.astype(np.uint32) ^ np.uint32(salt & 0xFFFFFFFF))
    return off, (h % np.uint32(max_value)).astype(np.int64)


def ngram(col: Ragged, n: int, mod: int) -> Ragged:
    off, val = col
    lengths = np.maximum(np.diff(off) - (n - 1), 0)
    rows, j = _within(lengths)
    acc = np.zeros(len(rows), np.uint64)
    with np.errstate(over="ignore"):
        for k in range(n):
            acc = acc * PRIME + val[off[rows] + j + k].astype(np.uint64)
    return _offsets(lengths), (mix64(acc) % np.uint64(mod)).astype(np.int64)


def cartesian(a: Ragged, b: Ragged, mod: int) -> Ragged:
    (oa, va), (ob, vb) = a, b
    la, lb = np.diff(oa), np.diff(ob)
    lengths = la * lb
    rows, j = _within(lengths)
    lb_r = np.maximum(lb[rows], 1)
    x = va[oa[rows] + j // lb_r].astype(np.int64)
    y = vb[ob[rows] + j % lb_r].astype(np.int64)
    with np.errstate(over="ignore"):
        folded = (x * np.int64(1000003) + y).astype(np.uint64)
    return _offsets(lengths), (mix64(folded) % np.uint64(mod)).astype(np.int64)


def bucketize(col: np.ndarray, borders) -> Ragged:
    v = np.nan_to_num(col, nan=0.0).astype(np.float32)
    idx = np.searchsorted(np.asarray(borders, np.float32), v).astype(np.int64)
    return np.arange(len(col) + 1, dtype=np.int64), idx


def boxcox(col: np.ndarray) -> np.ndarray:
    x = np.maximum(np.nan_to_num(col, nan=0.0), 0.0) + 1.0
    return ((x ** 0.5 - 1.0) / 0.5).astype(np.float32)


def logit(col: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    p = np.clip(np.nan_to_num(col, nan=0.5), eps, 1.0 - eps)
    return np.log(p / (1.0 - p)).astype(np.float32)


def clamp(col: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return np.clip(np.nan_to_num(col, nan=0.0), lo, hi).astype(np.float32)


def load(col: Ragged, rows: int, max_ids: int) -> Tuple[np.ndarray, np.ndarray]:
    off, val = col
    lengths = np.minimum(np.diff(off), max_ids)
    r, j = _within(lengths)
    ids = np.zeros((rows, max_ids), np.int64)
    mask = np.zeros((rows, max_ids), np.float32)
    ids[r, j] = val[off[r] + j]
    mask[r, j] = 1.0
    return ids, mask


def transform(raw: Dict[str, Any], plan: List, dense_keys, sparse_keys, max_ids: int
              ) -> Dict[str, np.ndarray]:
    """The batch the plan makes of one raw partition."""
    env: Dict[str, Any] = {f"f{f}": c for f, c in raw["dense"].items()}
    env.update({f"f{f}": (o, v) for f, (o, v, _) in raw["sparse"].items()})
    for op, ins, out, params in plan:
        kw = dict(params)
        args = [env[i] for i in ins]
        if op == "BoxCox":
            env[out] = boxcox(*args)
        elif op == "Logit":
            env[out] = logit(*args)
        elif op == "Clamp":
            env[out] = clamp(*args, kw["lo"], kw["hi"])
        elif op == "FirstX":
            env[out] = firstx(*args, kw["x"])
        elif op == "SigridHash":
            env[out] = sigrid_hash(*args, kw["salt"], kw["max_value"])
        elif op == "NGram":
            env[out] = ngram(*args, kw["n"], kw["mod"])
        elif op == "Cartesian":
            env[out] = cartesian(*args, kw["mod"])
        elif op == "Bucketize":
            env[out] = bucketize(*args, kw["borders"])
        else:
            raise ValueError(f"no reference for transform {op}")
    rows = len(raw["labels"])
    dense = np.stack([np.nan_to_num(np.asarray(env[k], np.float32), nan=0.0)
                      for k in dense_keys], axis=1)
    loaded = [load(env[k], rows, max_ids) for k in sparse_keys]
    return {"dense": dense.astype(np.float32),
            "sparse_ids": np.stack([i for i, _ in loaded], axis=1).astype(np.int32),
            "sparse_mask": np.stack([m for _, m in loaded], axis=1),
            "label": raw["labels"].astype(np.float32)}
