"""Online preprocessing transformations (Table 11) + the per-feature DAG.

These are the CPU (numpy) implementations DPP Workers execute — the
production path of §6.3/§6.4.  The CUDA kernels in ``repro_torch.kernels``
are the accelerated-DSI exploration of §7.2 and are validated against
these semantics.

Transform classes (§6.4): dense normalization (Logit, BoxCox, Onehot,
Clamp, GetLocalHour), sparse normalization (SigridHash, FirstX,
PositiveModulus, MapId, Enumerate, ComputeScore), and feature generation
(Bucketize, NGram, Cartesian, IdListTransform) — the latter being the
~75%-of-cycles class.  Sampling is row-level.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.schema import ColumnBatch, SparseColumn

Column = Union[np.ndarray, SparseColumn]


# ---------------------------------------------------------------------------
# Hashing (SigridHash) — 32-bit multiply-xor-shift mix, vectorized
# ---------------------------------------------------------------------------


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def _mix32(x: np.ndarray) -> np.ndarray:
    """The canonical SigridHash mixer: two multiply-xor-shift rounds on
    uint32 lanes.  Bit-for-bit identical to ``repro_torch.kernels.ref._hash_u32``
    and the CUDA kernel's ``hash_u32`` — kernel lanes are 32-bit, so the
    numpy reference and the fused kernel share one hash so engines can
    produce byte-identical batches (and TensorCache entries stay
    engine-agnostic)."""
    x = x.astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def sigrid_hash(col: SparseColumn, salt: int, max_value: int) -> SparseColumn:
    """Hash-normalize a sparse id list into [0, max_value).

    Ids and salt are truncated to their low 32 bits before mixing (the
    lane-width contract shared with ``kernels.fused_transform``);
    ``max_value`` must be in ``[1, 2**32)``.
    """
    h = _mix32(col.values.astype(np.uint32) ^ np.uint32(salt & 0xFFFFFFFF))
    return SparseColumn(
        offsets=col.offsets,
        values=(h % np.uint32(max_value)).astype(np.int64),
        scores=col.scores,
    )


# ---------------------------------------------------------------------------
# Dense normalization
# ---------------------------------------------------------------------------


def boxcox(col: np.ndarray, lmbda: float = 0.5) -> np.ndarray:
    x = np.maximum(np.nan_to_num(col, nan=0.0), 0.0) + 1.0
    if abs(lmbda) < 1e-9:
        return np.log(x).astype(np.float32)
    return ((x ** lmbda - 1.0) / lmbda).astype(np.float32)


def logit(col: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    p = np.clip(np.nan_to_num(col, nan=0.5), eps, 1.0 - eps)
    return np.log(p / (1.0 - p)).astype(np.float32)


def clamp(col: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return np.clip(np.nan_to_num(col, nan=0.0), lo, hi).astype(np.float32)


def onehot(col: np.ndarray, borders: np.ndarray) -> np.ndarray:
    """Dense value -> one-hot over len(borders)+1 buckets: (rows, bins)."""
    idx = np.searchsorted(borders, np.nan_to_num(col, nan=0.0))
    out = np.zeros((len(col), len(borders) + 1), np.float32)
    out[np.arange(len(col)), idx] = 1.0
    return out


def get_local_hour(col: np.ndarray, tz_offset_s: int = 0) -> np.ndarray:
    ts = np.nan_to_num(col, nan=0.0).astype(np.int64) + tz_offset_s
    return ((ts // 3600) % 24).astype(np.float32)


def bucketize(col: np.ndarray, borders: np.ndarray) -> SparseColumn:
    """Feature generation: dense value -> categorical bucket id (sparse).

    Comparisons happen in float32 (borders and values are both cast), the
    pipeline-wide dense precision — and the lane dtype of the fused CUDA
    kernel, which must reproduce these semantics bit-for-bit.
    """
    b32 = np.asarray(borders, np.float32)
    v32 = np.nan_to_num(col, nan=0.0).astype(np.float32)
    idx = np.searchsorted(b32, v32).astype(np.int64)
    n = len(col)
    return SparseColumn(
        offsets=np.arange(n + 1, dtype=np.int64), values=idx, scores=None
    )


# ---------------------------------------------------------------------------
# Sparse normalization / generation
# ---------------------------------------------------------------------------


def firstx(col: SparseColumn, x: int) -> SparseColumn:
    lengths = np.minimum(np.diff(col.offsets), x)
    new_off = np.zeros(len(col.offsets), np.int64)
    np.cumsum(lengths, out=new_off[1:])
    idx = _ragged_gather(col.offsets[:-1], lengths)
    return SparseColumn(
        offsets=new_off,
        values=col.values[idx],
        scores=col.scores[idx] if col.scores is not None else None,
    )


def _ragged_gather(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Indices selecting, for each row i, ``lengths[i]`` consecutive source
    elements beginning at ``starts[i]``."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(lengths)
    within = np.arange(total) - np.repeat(ends - lengths, lengths)
    return np.repeat(starts, lengths) + within


def positive_modulus(col: SparseColumn, m: int) -> SparseColumn:
    v = np.mod(np.mod(col.values, m) + m, m)
    return SparseColumn(offsets=col.offsets, values=v, scores=col.scores)


def map_id(col: SparseColumn, mapping: Dict[int, int], default: int = 0) -> SparseColumn:
    keys = np.asarray(sorted(mapping), np.int64)
    vals = np.asarray([mapping[k] for k in sorted(mapping)], np.int64)
    idx = np.searchsorted(keys, col.values)
    idx = np.clip(idx, 0, len(keys) - 1)
    hit = keys[idx] == col.values if len(keys) else np.zeros(len(col.values), bool)
    out = np.where(hit, vals[idx] if len(keys) else 0, default)
    return SparseColumn(offsets=col.offsets, values=out.astype(np.int64), scores=col.scores)


def enumerate_ids(col: SparseColumn) -> SparseColumn:
    """Python enumerate(): replace each id with its position in the list."""
    lengths = np.diff(col.offsets)
    total = int(lengths.sum())
    pos = np.arange(total) - np.repeat(col.offsets[:-1], lengths)
    return SparseColumn(offsets=col.offsets, values=pos.astype(np.int64), scores=col.scores)


def compute_score(col: SparseColumn, scale: float = 1.0, bias: float = 0.0) -> SparseColumn:
    sc = col.scores if col.scores is not None else np.ones(len(col.values), np.float32)
    return SparseColumn(
        offsets=col.offsets, values=col.values,
        scores=(sc * scale + bias).astype(np.float32),
    )


def id_list_intersection(a: SparseColumn, b: SparseColumn) -> SparseColumn:
    """IdListTransform: per-row intersection of two id lists."""
    rows = a.rows
    out_vals: List[np.ndarray] = []
    lengths = np.zeros(rows, np.int64)
    for i in range(rows):
        inter = np.intersect1d(a.row(i), b.row(i), assume_unique=False)
        out_vals.append(inter)
        lengths[i] = len(inter)
    off = np.zeros(rows + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    vals = np.concatenate(out_vals) if out_vals else np.zeros(0, np.int64)
    return SparseColumn(offsets=off, values=vals.astype(np.int64), scores=None)


def cartesian(a: SparseColumn, b: SparseColumn, mod: int = 1 << 31) -> SparseColumn:
    """Cartesian product of two sparse features, ids combined by hashing."""
    rows = a.rows
    la = np.diff(a.offsets)
    lb = np.diff(b.offsets)
    lengths = la * lb
    off = np.zeros(rows + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    total = int(off[-1])
    vals = np.zeros(total, np.int64)
    p = 0
    for i in range(rows):
        va, vb = a.row(i), b.row(i)
        if len(va) and len(vb):
            prod = (va[:, None] * np.int64(1000003) + vb[None, :]).reshape(-1)
            vals[p: p + len(prod)] = prod
            p += len(prod)
    h = _mix64(vals.astype(np.uint64)) % np.uint64(mod)
    return SparseColumn(offsets=off, values=h.astype(np.int64), scores=None)


def ngram(col: SparseColumn, n: int = 2, mod: int = 1 << 31) -> SparseColumn:
    """n-grams over each row's id list (feature generation)."""
    rows = col.rows
    lengths = np.maximum(np.diff(col.offsets) - (n - 1), 0)
    off = np.zeros(rows + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    total = int(off[-1])
    vals = np.zeros(total, np.uint64)
    starts = np.repeat(col.offsets[:-1], lengths)
    within = np.arange(total) - np.repeat(off[:-1], lengths)
    base = starts + within
    acc = np.zeros(total, np.uint64)
    with np.errstate(over="ignore"):
        for j in range(n):
            acc = acc * np.uint64(1000003) + col.values[base + j].astype(np.uint64)
    h = _mix64(acc) % np.uint64(mod)
    return SparseColumn(offsets=off, values=h.astype(np.int64), scores=None)


def sampling(batch: ColumnBatch, rate: float, seed: int = 0) -> ColumnBatch:
    """Row-level random sampling."""
    rng = np.random.default_rng(seed)
    keep = np.where(rng.random(batch.num_rows) < rate)[0]
    # build a contiguous subset via repeated row slicing on sorted indices
    dense = {k: v[keep] for k, v in batch.dense.items()}
    sparse = {}
    for k, c in batch.sparse.items():
        lengths = np.diff(c.offsets)[keep]
        off = np.zeros(len(keep) + 1, np.int64)
        np.cumsum(lengths, out=off[1:])
        idx = _ragged_gather(c.offsets[keep], lengths)
        sparse[k] = SparseColumn(
            offsets=off,
            values=c.values[idx],
            scores=c.scores[idx] if c.scores is not None else None,
        )
    return ColumnBatch(
        num_rows=len(keep),
        dense=dense,
        sparse=sparse,
        labels=batch.labels[keep] if batch.labels is not None else None,
    )


# ---------------------------------------------------------------------------
# Transform DAG ("compiled PyTorch module" analogue)
# ---------------------------------------------------------------------------

OP_CLASS = {
    "Logit": "dense_norm", "BoxCox": "dense_norm", "Onehot": "dense_norm",
    "Clamp": "dense_norm", "GetLocalHour": "dense_norm",
    "SigridHash": "sparse_norm", "FirstX": "sparse_norm",
    "PositiveModulus": "sparse_norm", "MapId": "sparse_norm",
    "Enumerate": "sparse_norm", "ComputeScore": "sparse_norm",
    "Bucketize": "feature_gen", "NGram": "feature_gen",
    "Cartesian": "feature_gen", "IdListTransform": "feature_gen",
    "Sampling": "row",
}


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    op: str
    inputs: Tuple[str, ...]          # env keys (feature ids are "f<id>")
    output: str
    params: Tuple[Tuple[str, Any], ...] = ()

    @property
    def kwargs(self) -> Dict[str, Any]:
        return dict(self.params)


_OPS: Dict[str, Callable[..., Column]] = {
    "SigridHash": sigrid_hash,
    "BoxCox": boxcox,
    "Logit": logit,
    "Clamp": clamp,
    "Onehot": onehot,
    "GetLocalHour": get_local_hour,
    "Bucketize": bucketize,
    "FirstX": firstx,
    "PositiveModulus": positive_modulus,
    "MapId": map_id,
    "Enumerate": enumerate_ids,
    "ComputeScore": compute_score,
    "IdListTransform": id_list_intersection,
    "Cartesian": cartesian,
    "NGram": ngram,
}


class TransformPipeline:
    """Topologically-ordered transform DAG over a ColumnBatch.

    The "session spec" a DPP Master ships to Workers: feature projection +
    per-feature transform DAGs + output materialization plan.
    """

    def __init__(self, specs: Sequence[TransformSpec]):
        self.specs = list(specs)

    def required_features(self) -> List[int]:
        fids = set()
        produced = {s.output for s in self.specs}
        for s in self.specs:
            for inp in s.inputs:
                if inp.startswith("f") and inp not in produced:
                    fids.add(int(inp[1:]))
        return sorted(fids)

    def __call__(self, batch: ColumnBatch) -> Dict[str, Column]:
        env: Dict[str, Column] = {}
        for fid, col in batch.dense.items():
            env[f"f{fid}"] = col
        for fid, col in batch.sparse.items():
            env[f"f{fid}"] = col
        for s in self.specs:
            fn = _OPS[s.op]
            args = [env[i] for i in s.inputs]
            env[s.output] = fn(*args, **s.kwargs)
        return env

    def op_class_histogram(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.specs:
            c = OP_CLASS.get(s.op, "other")
            out[c] = out.get(c, 0) + 1
        return out


def materialize_dlrm_batch(
    env: Dict[str, Column],
    dense_keys: Sequence[str],
    sparse_keys: Sequence[str],
    max_ids: int,
    labels: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Batch transformed features into the DLRM tensor format (load phase)."""
    rows = None
    dense_cols = []
    for k in dense_keys:
        c = np.nan_to_num(np.asarray(env[k], np.float32), nan=0.0)
        if c.ndim > 1:
            c = c[:, 0]
        rows = len(c)
        dense_cols.append(c)
    dense = (
        np.stack(dense_cols, axis=1) if dense_cols else np.zeros((rows or 0, 0), np.float32)
    )

    sp_ids = []
    sp_mask = []
    for k in sparse_keys:
        col: SparseColumn = env[k]  # type: ignore
        rows = col.rows
        ids = np.zeros((rows, max_ids), np.int64)
        mask = np.zeros((rows, max_ids), np.float32)
        lengths = np.minimum(np.diff(col.offsets), max_ids)
        take = _ragged_gather(col.offsets[:-1], lengths)
        r_idx = np.repeat(np.arange(rows), lengths)
        c_idx = np.arange(len(take)) - np.repeat(
            np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths
        )
        ids[r_idx, c_idx] = col.values[take]
        mask[r_idx, c_idx] = 1.0
        sp_ids.append(ids)
        sp_mask.append(mask)

    out = {
        "dense": dense.astype(np.float32),
        "sparse_ids": (
            np.stack(sp_ids, axis=1) if sp_ids else np.zeros((rows or 0, 0, max_ids), np.int64)
        ).astype(np.int32),
        "sparse_mask": (
            np.stack(sp_mask, axis=1) if sp_mask else np.zeros((rows or 0, 0, max_ids), np.float32)
        ),
    }
    if labels is not None:
        out["label"] = labels.astype(np.float32)
    return out


def default_dlrm_pipeline(
    dense_fids: Sequence[int],
    sparse_fids: Sequence[int],
    hash_size: int = 100_000,
    firstx: int = 32,
    n_derived: int = 0,
) -> TransformPipeline:
    """A production-shaped pipeline: normalize every dense + sparse feature,
    derive ``n_derived`` generated features (NGram / Cartesian / Bucketize —
    the expensive class)."""
    specs: List[TransformSpec] = []
    for i, fid in enumerate(dense_fids):
        op = ["BoxCox", "Logit", "Clamp"][i % 3]
        params = (("lo", -10.0), ("hi", 10.0)) if op == "Clamp" else ()
        specs.append(TransformSpec(op, (f"f{fid}",), f"d{fid}", params))
    for fid in sparse_fids:
        specs.append(
            TransformSpec("FirstX", (f"f{fid}",), f"t{fid}", (("x", firstx),))
        )
        specs.append(
            TransformSpec(
                "SigridHash", (f"t{fid}",), f"s{fid}",
                (("salt", fid), ("max_value", hash_size)),
            )
        )
    sf = list(sparse_fids)
    for j in range(n_derived):
        if j % 3 == 0 and len(sf) >= 1:
            specs.append(
                TransformSpec(
                    "NGram", (f"s{sf[j % len(sf)]}",), f"g{j}",
                    (("n", 2), ("mod", hash_size)),
                )
            )
        elif j % 3 == 1 and len(sf) >= 2:
            specs.append(
                TransformSpec(
                    "Cartesian",
                    (f"s{sf[j % len(sf)]}", f"s{sf[(j + 1) % len(sf)]}"),
                    f"g{j}",
                    (("mod", hash_size),),
                )
            )
        elif dense_fids:
            d = dense_fids[j % len(dense_fids)]
            specs.append(
                TransformSpec(
                    "Bucketize", (f"f{d}",), f"g{j}",
                    (("borders", np.linspace(-3, 3, 63)),),
                )
            )
    return TransformPipeline(specs)
