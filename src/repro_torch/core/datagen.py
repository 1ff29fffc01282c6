"""Offline data generation: the ETL path of Fig. 3, synthesized.

Serving-time feature/event logs -> streaming join + label -> partitioned
training tables.  We synthesize statistically-calibrated samples: per-feature
coverage, Zipf-distributed categorical ids, log-normal list lengths, and a
label rate typical of CTR tasks.  The generator is deterministic per
(seed, partition) so tests and benchmarks are reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.schema import (
    ColumnBatch,
    FeatureType,
    SparseColumn,
    TableSchema,
)


@dataclasses.dataclass(frozen=True)
class DataGenConfig:
    rows_per_partition: int = 4096
    label_rate: float = 0.03            # positive-event rate
    zipf_a: float = 1.3                 # categorical id skew
    seed: int = 0
    labeled: bool = True                # False: label stream not yet joined


def generate_partition(
    schema: TableSchema, partition_index: int, cfg: DataGenConfig
) -> ColumnBatch:
    """Generate one (e.g. hourly) partition of labeled samples."""
    rng = np.random.default_rng((cfg.seed, partition_index))
    n = cfg.rows_per_partition
    dense: Dict[int, np.ndarray] = {}
    sparse: Dict[int, SparseColumn] = {}

    for f in schema.features.values():
        if not f.logged:
            continue
        present = rng.random(n) < f.coverage
        if f.ftype == FeatureType.DENSE:
            col = rng.normal(0.0, 1.0, n).astype(np.float32)
            col[~present] = np.nan
            dense[f.fid] = col
        else:
            lengths = np.where(
                present,
                np.clip(rng.poisson(f.avg_length, n), 1, 4 * int(f.avg_length) + 4),
                0,
            ).astype(np.int64)
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum(lengths, out=offsets[1:])
            nnz = int(offsets[-1])
            # Zipf ids bounded by the feature's cardinality
            vals = rng.zipf(cfg.zipf_a, nnz).astype(np.int64) % f.cardinality
            scores = (
                rng.random(nnz).astype(np.float32)
                if f.ftype == FeatureType.SPARSE_SCORED
                else None
            )
            sparse[f.fid] = SparseColumn(offsets=offsets, values=vals, scores=scores)

    labels = (
        (rng.random(n) < cfg.label_rate).astype(np.float32)
        if cfg.labeled else None
    )
    return ColumnBatch(num_rows=n, dense=dense, sparse=sparse, labels=labels)


def stream_partitions(
    schema: TableSchema, n_partitions: int, cfg: DataGenConfig
) -> Iterator[ColumnBatch]:
    for p in range(n_partitions):
        yield generate_partition(schema, p, cfg)
