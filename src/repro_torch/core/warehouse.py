"""Hive-like data warehouse: partitioned tables of DWRF files on Tectonic.

Training jobs filter along two dimensions (§5.1): a set of partitions
(row filter) and a feature projection (column filter).  The warehouse also
maintains the feature-popularity statistics that drive feature reordering.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import dwrf
from repro_torch.core.datagen import DataGenConfig, generate_partition
from repro_torch.core.popularity import PopularityTracker
from repro_torch.core.schema import ColumnBatch, TableSchema
from repro_torch.core.tectonic import TectonicFS


@dataclasses.dataclass
class PartitionMeta:
    index: int
    path: str
    num_rows: int
    nbytes: int
    footer: dwrf.DwrfFooter
    # bumped on every rewrite_partition: keys derived data (e.g. the
    # preprocessed-tensor cache) to one file version, independently of
    # whether a stripe cache is attached
    generation: int = 0


class Table:
    def __init__(self, name: str, schema: TableSchema, fs: TectonicFS):
        self.name = name
        self.schema = schema
        self.fs = fs
        self.partitions: Dict[int, PartitionMeta] = {}
        self.popularity = PopularityTracker()

    def _encode(
        self, batch: ColumnBatch, opts: Optional[dwrf.DwrfWriterOptions]
    ) -> dwrf.DwrfFile:
        opts = opts or dwrf.DwrfWriterOptions()
        if opts.feature_order is None and self.popularity.total_reads > 0:
            # feature reordering: order streams by recent read popularity
            opts = dataclasses.replace(
                opts, feature_order=self.popularity.feature_order()
            )
        return dwrf.write_dwrf(batch, opts)

    def write_partition(
        self,
        index: int,
        batch: ColumnBatch,
        opts: Optional[dwrf.DwrfWriterOptions] = None,
    ) -> PartitionMeta:
        return self.write_partition_encoded(index, self._encode(batch, opts))

    def write_partition_encoded(
        self, index: int, f: dwrf.DwrfFile
    ) -> PartitionMeta:
        """Install an already-encoded DWRF file as a partition — the hook
        for ingestion paths that assemble files out-of-band (e.g.
        ``dwrf.concat_dwrf`` merging differently-labeled halves, the
        fault-injection surface for poisoned-split testing)."""
        path = f"warehouse/{self.name}/part-{index:05d}.dwrf"
        self.fs.create(path, f.data)
        self._register_stripes(path, f.footer, f.data)
        meta = PartitionMeta(
            index=index, path=path, num_rows=f.footer.num_rows,
            nbytes=f.nbytes, footer=f.footer,
        )
        self.partitions[index] = meta
        return meta

    def rewrite_partition(
        self,
        index: int,
        batch: ColumnBatch,
        opts: Optional[dwrf.DwrfWriterOptions] = None,
    ) -> PartitionMeta:
        """Replace an existing partition's bytes (continuous feature
        engineering, §4).  ``TectonicFS.rewrite`` invalidates the attached
        cache's path entries and bumps the dedup generation *before* the
        new bytes land; the new stripes are then re-registered, so readers
        switch to the new content atomically and are never served a stale
        cached stripe."""
        old = self.partitions[index]
        f = self._encode(batch, opts)
        self.fs.rewrite(old.path, f.data)
        self._register_stripes(old.path, f.footer, f.data)
        meta = PartitionMeta(
            index=index, path=old.path, num_rows=batch.num_rows,
            nbytes=f.nbytes, footer=f.footer, generation=old.generation + 1,
        )
        self.partitions[index] = meta
        return meta

    def generate(
        self,
        n_partitions: int,
        gen_cfg: Optional[DataGenConfig] = None,
        opts: Optional[dwrf.DwrfWriterOptions] = None,
    ) -> None:
        gen_cfg = gen_cfg or DataGenConfig()
        for p in range(n_partitions):
            self.write_partition(p, generate_partition(self.schema, p, gen_cfg), opts)

    def _register_stripes(
        self, path: str, footer: dwrf.DwrfFooter, data: bytes
    ) -> None:
        """Content-hash every encoded stripe into the attached cache's dedup
        index so byte-identical stripes across partitions/tables collapse to
        one cache entry (RecD-style)."""
        cache = getattr(self.fs, "cache", None)
        if cache is None:
            return
        for st in footer.stripes:
            cache.dedup.register(
                path, st.offset, st.length, data[st.offset: st.offset + st.length]
            )

    @property
    def total_bytes(self) -> int:
        return sum(m.nbytes for m in self.partitions.values())

    @property
    def total_rows(self) -> int:
        return sum(m.num_rows for m in self.partitions.values())

    def select_partitions(self, indices: Optional[Sequence[int]] = None) -> List[PartitionMeta]:
        if indices is None:
            return [self.partitions[i] for i in sorted(self.partitions)]
        return [self.partitions[i] for i in indices]


class Warehouse:
    """A region's central warehouse: many models' tables on shared storage."""

    def __init__(self, fs: Optional[TectonicFS] = None):
        self.fs = fs or TectonicFS()
        self.tables: Dict[str, Table] = {}

    def create_table(self, schema: TableSchema) -> Table:
        t = Table(schema.name, schema, self.fs)
        self.tables[schema.name] = t
        return t

    def table(self, name: str) -> Table:
        return self.tables[name]

    def attach_cache(self, cache) -> None:
        """Install a shared ``StripeCache`` on this warehouse's filesystem
        and back-register the stripes of every partition already written, so
        a cache attached after ingestion still content-dedups old data."""
        self.fs.attach_cache(cache)
        for t in self.tables.values():
            for meta in t.partitions.values():
                data = self.fs.peek(meta.path)
                for st in meta.footer.stripes:
                    cache.dedup.register(
                        meta.path, st.offset, st.length,
                        data[st.offset: st.offset + st.length],
                    )
