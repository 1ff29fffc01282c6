"""Preprocessed-tensor cache (§7.5: "we are also exploring ... caching
preprocessed tensors and balancing transformations between offline and
online ETL").

Keyed by (table, partition, split range, pipeline fingerprint) — exactly
the determinism boundary of a DPP split.  Because combo-window jobs share
the production-model baseline (§5.2), their feature projections and
transform DAGs overlap heavily; a warm cache converts repeated splits'
extract+transform cost into a memory copy.

``CacheStats`` quantifies the offline/online trade: bytes stored vs
CPU-seconds saved, the currency of the paper's power argument.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dpp.master import SessionSpec, Split
from repro_torch.obs import counter, gauge


def pipeline_fingerprint(spec: SessionSpec) -> str:
    h = hashlib.sha1()
    h.update(repr(sorted(spec.feature_ids)).encode())
    for t in spec.transform_specs:
        h.update(repr((t.op, t.inputs, t.output, t.params)).encode())
    h.update(repr((spec.batch_size, spec.max_ids_per_feature)).encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class CacheStats:
    hits: int = counter()
    misses: int = counter()
    bytes_stored: int = gauge()    # current occupancy: evictions shrink it
    cpu_s_saved: float = counter(0.0)
    evictions: int = counter()
    rejected: int = counter()      # inserts larger than the whole cache

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class TensorCache:
    """Bounded LRU of materialized split outputs (lists of tensor batches)."""

    def __init__(self, capacity_bytes: int = 256 * 1024 * 1024):
        self.capacity_bytes = capacity_bytes
        self._lock = threading.Lock()
        self._data: "OrderedDict[Tuple, Tuple[List[Dict[str, np.ndarray]], float]]" = OrderedDict()
        self.stats = CacheStats()

    @staticmethod
    def key(spec: SessionSpec, split: Split, generation: int = 0) -> Tuple:
        """A split's determinism boundary: (table, partition, row range,
        pipeline fingerprint) **plus the partition generation** — the
        warehouse bumps it on every ``rewrite_partition``, so rewritten
        bytes can never be served stale preprocessed tensors (the cached
        entries for the old generation simply age out of the LRU)."""
        return (spec.table, split.partition, generation,
                split.row_start, split.row_end, pipeline_fingerprint(spec))

    def get(self, key: Tuple) -> Optional[List[Dict[str, np.ndarray]]]:
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                self.stats.misses += 1
                return None
            self._data.move_to_end(key)
            self.stats.hits += 1
            self.stats.cpu_s_saved += entry[1]
            return entry[0]

    def put(self, key: Tuple, batches: List[Dict[str, np.ndarray]], cpu_s: float) -> None:
        """Insert a split's batches.  Idempotent on key: a split key fully
        determines its content (table, partition, row range, pipeline
        fingerprint), so concurrent workers racing on the same split may
        each call ``put`` — the first stored entry wins and later inserts
        only refresh its LRU recency instead of re-storing equal bytes."""
        nbytes = sum(sum(a.nbytes for a in b.values()) for b in batches)
        with self._lock:
            if nbytes > self.capacity_bytes:
                # an oversized insert would evict the entire cache and
                # still leave bytes_stored > capacity — refuse it instead
                self.stats.rejected += 1
                return
            if key in self._data:
                self._data.move_to_end(key)
                return
            while self.stats.bytes_stored + nbytes > self.capacity_bytes and self._data:
                _, (old, _) = self._data.popitem(last=False)
                self.stats.bytes_stored -= sum(
                    sum(a.nbytes for a in b.values()) for b in old
                )
                self.stats.evictions += 1
            self._data[key] = (batches, cpu_s)
            self.stats.bytes_stored += nbytes
