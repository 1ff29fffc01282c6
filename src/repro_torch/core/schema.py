"""Feature schema and lifecycle for recommendation training tables.

Mirrors the paper's data model (§3.1, §4.3):
  * samples are structured rows of dense + sparse (+ scored) features,
  * tables hold tens of thousands of features, > 99% of bytes in features,
  * features move through a lifecycle (beta -> experimental -> active ->
    deprecated, Table 2) with hundreds added/removed monthly,
  * each feature has a coverage (fraction of rows logging it) and, for
    sparse features, an average list length (Table 5).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class FeatureType(enum.Enum):
    DENSE = "dense"
    SPARSE = "sparse"          # id list
    SPARSE_SCORED = "scored"   # id list + float score per id


class FeatureStatus(enum.Enum):
    BETA = "beta"                # not logged; injectable for exploration
    EXPERIMENTAL = "experimental"
    ACTIVE = "active"
    DEPRECATED = "deprecated"    # still written until reaped


@dataclasses.dataclass
class FeatureDef:
    fid: int
    name: str
    ftype: FeatureType
    status: FeatureStatus = FeatureStatus.ACTIVE
    coverage: float = 0.45            # Table 5: avg coverage 0.29-0.45
    avg_length: float = 26.0          # Table 5: avg sparse length ~20-26
    cardinality: int = 100_000        # id space for sparse values
    popularity: float = 1.0           # read-popularity weight (drives Fig.7)

    @property
    def logged(self) -> bool:
        return self.status != FeatureStatus.BETA


@dataclasses.dataclass
class TableSchema:
    name: str
    features: Dict[int, FeatureDef]

    @property
    def dense_ids(self) -> List[int]:
        return sorted(
            f.fid for f in self.features.values()
            if f.ftype == FeatureType.DENSE and f.logged
        )

    @property
    def sparse_ids(self) -> List[int]:
        return sorted(
            f.fid for f in self.features.values()
            if f.ftype != FeatureType.DENSE and f.logged
        )

    @property
    def logged_ids(self) -> List[int]:
        return sorted(f.fid for f in self.features.values() if f.logged)

    def feature(self, fid: int) -> FeatureDef:
        return self.features[fid]

    def add(self, fdef: FeatureDef) -> None:
        assert fdef.fid not in self.features
        self.features[fdef.fid] = fdef

    def evolve(
        self,
        rng: np.random.Generator,
        n_new: int,
        promote_frac: float = 0.1,
        deprecate_frac: float = 0.05,
    ) -> None:
        """One engineering cycle (§4.3): add experimental features, promote
        some to active, deprecate some old ones."""
        next_id = max(self.features) + 1 if self.features else 0
        for i in range(n_new):
            self.add(_random_feature(rng, next_id + i, FeatureStatus.EXPERIMENTAL))
        for f in list(self.features.values()):
            if f.status == FeatureStatus.EXPERIMENTAL and rng.random() < promote_frac:
                f.status = FeatureStatus.ACTIVE
            elif f.status == FeatureStatus.ACTIVE and rng.random() < deprecate_frac:
                f.status = FeatureStatus.DEPRECATED

    def status_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.features.values():
            out[f.status.value] = out.get(f.status.value, 0) + 1
        return out


def _random_feature(rng: np.random.Generator, fid: int, status: FeatureStatus) -> FeatureDef:
    is_dense = rng.random() < 0.87   # Table 5: ~12k float vs ~1.8k sparse
    f = _random_feature_inner(rng, fid, status, is_dense)
    f.popularity = float((rng.pareto(1.2) + 0.05) * (0.3 + f.coverage) *
                         (1.0 + np.log1p(f.avg_length)))
    return f


def _random_feature_inner(rng, fid, status, is_dense) -> FeatureDef:
    return FeatureDef(
        fid=fid,
        name=f"f{fid}",
        ftype=FeatureType.DENSE if is_dense else (
            FeatureType.SPARSE_SCORED if rng.random() < 0.2 else FeatureType.SPARSE
        ),
        status=status,
        coverage=float(np.clip(rng.beta(2.0, 2.5), 0.02, 1.0)),
        avg_length=float(np.clip(rng.lognormal(2.6, 0.8), 1, 200)),
        cardinality=int(rng.choice([1_000, 10_000, 100_000, 1_000_000])),
        # Zipf-ish popularity so a small set of features dominates reads.
        # Popularity correlates with coverage & length: engineers favor
        # features with stronger signal, which also carry more bytes (§5.1:
        # read bytes % > read features %).
        popularity=0.0,
    )


def make_schema(
    name: str,
    n_dense: int,
    n_sparse: int,
    seed: int = 0,
) -> TableSchema:
    """Synthesize a production-like schema (Table 5 scale knobs)."""
    rng = np.random.default_rng(seed)
    feats: Dict[int, FeatureDef] = {}
    fid = 0
    for _ in range(n_dense):
        f = _random_feature(rng, fid, FeatureStatus.ACTIVE)
        f.ftype = FeatureType.DENSE
        feats[fid] = f
        fid += 1
    for _ in range(n_sparse):
        f = _random_feature(rng, fid, FeatureStatus.ACTIVE)
        f.ftype = FeatureType.SPARSE_SCORED if rng.random() < 0.2 else FeatureType.SPARSE
        feats[fid] = f
        fid += 1
    return TableSchema(name=name, features=feats)


# ---------------------------------------------------------------------------
# Columnar in-memory sample batches (what flows through the pipeline)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseColumn:
    """CSR-style variable-length id lists (+ optional scores)."""

    offsets: np.ndarray          # (rows+1,) int64
    values: np.ndarray           # (nnz,) int64
    scores: Optional[np.ndarray] = None  # (nnz,) float32

    @property
    def rows(self) -> int:
        return len(self.offsets) - 1

    def row(self, i: int) -> np.ndarray:
        return self.values[self.offsets[i]: self.offsets[i + 1]]

    def nbytes(self) -> int:
        n = self.offsets.nbytes + self.values.nbytes
        if self.scores is not None:
            n += self.scores.nbytes
        return n


def concat_sparse_columns(cols: Sequence[SparseColumn]) -> SparseColumn:
    """Row-concatenate CSR columns, rebasing offsets; scores are zero-padded
    when only some columns carry them."""
    if len(cols) == 1:
        return cols[0]
    offs = [np.zeros(1, np.int64)]
    vals: List[np.ndarray] = []
    has_scores = any(c.scores is not None for c in cols)
    scs: List[np.ndarray] = []
    base = 0
    for c in cols:
        offs.append(c.offsets[1:] + base)
        vals.append(c.values)
        if has_scores:
            scs.append(
                c.scores if c.scores is not None
                else np.zeros(len(c.values), np.float32)
            )
        base += len(c.values)
    return SparseColumn(
        offsets=np.concatenate(offs),
        values=np.concatenate(vals) if vals else np.zeros(0, np.int64),
        scores=np.concatenate(scs) if has_scores else None,
    )


@dataclasses.dataclass
class ColumnBatch:
    """A batch of rows in columnar layout: feature id -> column."""

    num_rows: int
    dense: Dict[int, np.ndarray]           # fid -> (rows,) float32 (NaN = missing)
    sparse: Dict[int, SparseColumn]        # fid -> CSR column
    labels: Optional[np.ndarray] = None    # (rows,) float32

    def nbytes(self) -> int:
        n = sum(a.nbytes for a in self.dense.values())
        n += sum(c.nbytes() for c in self.sparse.values())
        if self.labels is not None:
            n += self.labels.nbytes
        return n

    def select(self, feature_ids: Sequence[int]) -> "ColumnBatch":
        fset = set(feature_ids)
        return ColumnBatch(
            num_rows=self.num_rows,
            dense={k: v for k, v in self.dense.items() if k in fset},
            sparse={k: v for k, v in self.sparse.items() if k in fset},
            labels=self.labels,
        )

    def slice_rows(self, start: int, stop: int) -> "ColumnBatch":
        dense = {k: v[start:stop] for k, v in self.dense.items()}
        sparse = {}
        for k, c in self.sparse.items():
            off = c.offsets[start: stop + 1]
            vals = c.values[off[0]: off[-1]]
            sc = c.scores[off[0]: off[-1]] if c.scores is not None else None
            sparse[k] = SparseColumn(offsets=(off - off[0]), values=vals, scores=sc)
        return ColumnBatch(
            num_rows=stop - start,
            dense=dense,
            sparse=sparse,
            labels=self.labels[start:stop] if self.labels is not None else None,
        )


def concat_batches(batches: List[ColumnBatch]) -> ColumnBatch:
    assert batches
    dense_keys = set().union(*[set(b.dense) for b in batches])
    sparse_keys = set().union(*[set(b.sparse) for b in batches])
    total = sum(b.num_rows for b in batches)
    dense = {}
    for k in dense_keys:
        parts = [
            b.dense.get(k, np.full(b.num_rows, np.nan, np.float32)) for b in batches
        ]
        dense[k] = np.concatenate(parts)
    sparse = {}
    for k in sparse_keys:
        cols = []
        for b in batches:
            col = b.sparse.get(k)
            if col is None:    # feature absent in this batch: all-empty rows
                col = SparseColumn(
                    offsets=np.zeros(b.num_rows + 1, np.int64),
                    values=np.zeros(0, np.int64),
                )
            cols.append(col)
        sparse[k] = concat_sparse_columns(cols)
    labels = (
        np.concatenate([b.labels for b in batches])
        if all(b.labels is not None for b in batches)
        else None
    )
    return ColumnBatch(num_rows=total, dense=dense, sparse=sparse, labels=labels)
