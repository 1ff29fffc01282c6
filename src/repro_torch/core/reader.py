"""Selective table reader: feature projection -> I/O plan -> decoded columns.

Implements the read-path co-design ladder of Table 12:
  * map files: whole-stripe reads (baseline; massive over-read),
  * flattened files: per-feature stream reads (tiny I/Os, HDD seek cliff),
  * **coalesced reads (CR)**: merge selected stream extents whose gap keeps
    the merged I/O within ``coalesce_window`` bytes (1.25 MiB, §7.5) —
    over-reading the skipped bytes to amortize seeks,
  * feature reordering (FR) happens at write time (warehouse) and shows up
    here as fewer over-read bytes inside each coalesced window.

Every read returns both the decoded columns and an I/O accounting record
(bytes used vs read, I/O size distribution — Tables 5 and 6).

Reads are **split-scoped**: ``plan_reads`` takes an optional row range and
prunes to the stripes that overlap it, so a DPP split only fetches and
decodes its own stripes instead of re-reading the whole partition.
``TableReader.iter_stripes`` streams one stripe at a time for
producer/consumer pipelines; ``read_rows`` materializes an exact row range.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import dwrf
from repro_torch.core.decode import make_decode_engine
from repro_torch.core.schema import ColumnBatch
from repro_torch.core.tectonic import ExtentRead, IOStats, TectonicFS
from repro_torch.core.warehouse import PartitionMeta, Table
from repro_torch.obs import NULL_TRACER

COALESCE_WINDOW = int(1.25 * 1024 * 1024)   # §7.5


@dataclasses.dataclass
class ReadPlan:
    extents: List[Tuple[int, int]]                      # (offset, len) I/Os
    wanted: List[Tuple[int, int, dwrf.StreamInfo]]      # (stripe_idx, fid, stream)
    bytes_wanted: int
    bytes_planned: int
    stripe_indices: List[int] = dataclasses.field(default_factory=list)
    stripes_total: int = 0
    bytes_cached_planned: int = 0      # planned bytes the stripe cache holds

    @property
    def over_read_ratio(self) -> float:
        return self.bytes_planned / max(self.bytes_wanted, 1)


@dataclasses.dataclass
class ReadResult:
    batch: ColumnBatch
    bytes_read: int
    bytes_used: int
    io_sizes: List[int]
    feature_bytes: Dict[int, int]
    stripes_read: int = 0
    stripes_total: int = 0
    rows_decoded: int = 0
    bytes_from_cache: int = 0    # of bytes_read, served by the stripe cache
    bytes_from_storage: int = 0


@dataclasses.dataclass
class StripeRead:
    """One decoded stripe, trimmed to the requested row range."""

    stripe_index: int
    row_start: int               # absolute rows covered after trimming
    row_end: int
    batch: ColumnBatch
    bytes_read: int
    bytes_used: int
    rows_decoded: int            # stripe rows decoded (>= row_end - row_start)
    bytes_from_cache: int = 0    # of bytes_read, served by the stripe cache
    bytes_from_storage: int = 0
    # per-extent I/O sizes of this stripe's fetch (Table 6 distribution —
    # previously only read_rows reported these, so streaming consumers
    # lost the size histogram entirely)
    io_sizes: List[int] = dataclasses.field(default_factory=list)


def _trim_stripe(
    part: ColumnBatch, stripe: dwrf.StripeInfo, lo: int, hi: int
) -> Tuple[ColumnBatch, int, int]:
    """Drop stripe-edge rows outside [lo, hi); returns the trimmed batch and
    the kept row range relative to the stripe."""
    t0 = max(lo - stripe.row_start, 0)
    t1 = min(hi - stripe.row_start, stripe.num_rows)
    if t0 > 0 or t1 < stripe.num_rows:
        part = part.slice_rows(t0, t1)
    return part, t0, t1


def stripes_overlapping(
    footer: dwrf.DwrfFooter,
    row_start: Optional[int] = None,
    row_end: Optional[int] = None,
) -> List[int]:
    """Indices of stripes intersecting [row_start, row_end)."""
    lo = 0 if row_start is None else row_start
    hi = footer.num_rows if row_end is None else row_end
    return [
        si for si, st in enumerate(footer.stripes)
        if st.row_start < hi and st.row_start + st.num_rows > lo
    ]


def _coalesce_extents(
    streams: Sequence[dwrf.StreamInfo], coalesce_window: int
) -> List[Tuple[int, int]]:
    """Merge offset-sorted stream extents whose span fits the window."""
    extents: List[Tuple[int, int]] = []
    for s in streams:
        if (
            coalesce_window
            and extents
            and s.offset + s.length - extents[-1][0] <= coalesce_window
        ):
            off, ln = extents[-1]
            extents[-1] = (off, max(ln, s.offset + s.length - off))
        else:
            extents.append((s.offset, s.length))
    return extents


def plan_reads(
    footer: dwrf.DwrfFooter,
    feature_ids: Sequence[int],
    coalesce_window: int = 0,
    include_labels: bool = True,
    row_start: Optional[int] = None,
    row_end: Optional[int] = None,
    cache=None,
    path: Optional[str] = None,
) -> ReadPlan:
    """Build the extent list for a feature projection over one file.

    With a row range, only the stripes overlapping [row_start, row_end)
    are planned — the split-scoped read path.  With a ``StripeCache`` and
    the file's ``path``, each planned extent is probed (non-mutating) and
    ``bytes_cached_planned`` reports how much the cache would serve —
    extent reads then only hit storage on miss.
    """
    want_f = set(feature_ids)
    stripe_idx = stripes_overlapping(footer, row_start, row_end)
    wanted: List[Tuple[int, int, dwrf.StreamInfo]] = []
    for si in stripe_idx:
        stripe = footer.stripes[si]
        if footer.flattened:
            for s in stripe.streams:
                if s.fid in want_f or (include_labels and s.kind == "labels"):
                    wanted.append((si, s.fid, s))
        else:
            # map encoding: must read the monolithic map streams; labels
            # streams still follow the projection flag, like the
            # flattened branch (they were unconditionally planned before,
            # inflating bytes_wanted for label-free projections)
            for s in stripe.streams:
                if not include_labels and s.kind == "labels":
                    continue
                wanted.append((si, s.fid, s))

    streams = sorted((s for _, _, s in wanted), key=lambda s: s.offset)
    bytes_wanted = sum(s.length for s in streams)
    extents = _coalesce_extents(streams, coalesce_window)
    bytes_planned = sum(l for _, l in extents)
    bytes_cached = 0
    if cache is not None and path is not None:
        # probe at stripe-segment granularity — the cache's storage unit —
        # so window-coalesced extents still report their cached portions
        for off, ln in extents:
            for seg_off, seg_len in cache.dedup.segments(path, off, ln):
                if cache.peek(cache.resolve(path, seg_off, seg_len)):
                    bytes_cached += seg_len
    return ReadPlan(
        extents=extents, wanted=wanted,
        bytes_wanted=bytes_wanted, bytes_planned=bytes_planned,
        stripe_indices=stripe_idx, stripes_total=len(footer.stripes),
        bytes_cached_planned=bytes_cached,
    )


class TableReader:
    """Reads a feature projection from a table's partitions with accounting."""

    def __init__(
        self,
        table: Table,
        feature_ids: Sequence[int],
        coalesce_window: int = COALESCE_WINDOW,
        record_popularity: bool = True,
        tenant: Optional[str] = None,
        tracer=NULL_TRACER,
        decode_engine=None,
        double_buffer: bool = False,
    ):
        self.table = table
        self.feature_ids = list(feature_ids)
        self.coalesce_window = coalesce_window
        self.record_popularity = record_popularity
        # job identity for the stripe cache's per-tenant shares/accounting
        self.tenant = tenant
        self.tracer = tracer
        # stripe decode strategy (name / instance / factory — see
        # repro_torch.core.decode); engines are byte-compatible, so this never
        # changes the batches, only how they are produced
        self.decode = make_decode_engine(decode_engine)
        # overlap stripe N+1's extent fetch with stripe N's decode in
        # iter_stripes (the producer half of the DPP worker)
        self.double_buffer = double_buffer
        self._job_feature_bytes: Dict[int, float] = {}

    def _fetch_streams(
        self, meta: PartitionMeta, plan: ReadPlan
    ) -> Tuple[Dict[int, Dict[Tuple[int, str], bytes]], Dict[int, int], "ExtentRead"]:
        """Execute a plan: fetch extents, slice each wanted stream back out
        of its (possibly merged) extent.  Returns per-stripe raw stream bytes,
        per-feature byte counts, and the cache/storage source accounting."""
        io = self.table.fs.read_extents_ex(
            meta.path, plan.extents, tenant=self.tenant
        )
        extent_map: List[Tuple[int, bytes]] = [
            (off, blob) for (off, _), blob in zip(plan.extents, io.blobs)
        ]
        extent_offsets = np.array([e[0] for e in extent_map])

        per_stripe: Dict[int, Dict[Tuple[int, str], bytes]] = {}
        feature_bytes: Dict[int, int] = {}
        for si, fid, s in plan.wanted:
            ei = int(np.searchsorted(extent_offsets, s.offset, "right") - 1)
            off0, blob = extent_map[ei]
            raw = blob[s.offset - off0: s.offset - off0 + s.length]
            per_stripe.setdefault(si, {})[(s.fid, s.kind)] = raw
            if fid >= 0:
                feature_bytes[fid] = feature_bytes.get(fid, 0) + s.length
        return per_stripe, feature_bytes, io

    def _record_feature_bytes(self, feature_bytes: Dict[int, int]) -> None:
        for fid, nb in feature_bytes.items():
            self._job_feature_bytes[fid] = self._job_feature_bytes.get(fid, 0) + nb

    def read_rows(
        self,
        meta: PartitionMeta,
        row_start: Optional[int] = None,
        row_end: Optional[int] = None,
    ) -> ReadResult:
        """Read exactly [row_start, row_end), fetching only overlapping
        stripes (one coalesced extent batch across those stripes)."""
        footer = meta.footer
        lo = 0 if row_start is None else max(0, row_start)
        hi = footer.num_rows if row_end is None else min(row_end, footer.num_rows)
        plan = plan_reads(
            footer, self.feature_ids, self.coalesce_window,
            row_start=lo, row_end=hi,
            cache=self.table.fs.cache, path=meta.path,
        )
        per_stripe, feature_bytes, io = self._fetch_streams(meta, plan)

        from repro_torch.core.schema import concat_batches

        parts: List[ColumnBatch] = []
        rows_decoded = 0
        for si in sorted(per_stripe):
            stripe = footer.stripes[si]
            with self.tracer.span(
                "extract.decode", tenant=self.tenant or "",
                path=meta.path, stripe=si, engine=self.decode.name,
            ) as sp:
                part = self.decode.decode_stripe(
                    stripe, per_stripe[si], self.feature_ids
                )
                sp.set(rows=part.num_rows)
            rows_decoded += part.num_rows
            part, _, _ = _trim_stripe(part, stripe, lo, hi)
            parts.append(part)
        batch = (
            concat_batches(parts) if parts
            else ColumnBatch(num_rows=0, dense={}, sparse={})
        )

        self._record_feature_bytes(feature_bytes)
        return ReadResult(
            batch=batch,
            bytes_read=plan.bytes_planned,
            bytes_used=plan.bytes_wanted,
            io_sizes=[l for _, l in plan.extents],
            feature_bytes=feature_bytes,
            stripes_read=len(plan.stripe_indices),
            stripes_total=plan.stripes_total,
            rows_decoded=rows_decoded,
            bytes_from_cache=io.cache_bytes,
            bytes_from_storage=io.storage_bytes,
        )

    def iter_stripes(
        self,
        meta: PartitionMeta,
        row_start: Optional[int] = None,
        row_end: Optional[int] = None,
    ) -> Iterator[StripeRead]:
        """Stream one stripe at a time: fetch + decode each overlapping
        stripe's coalesced extents independently instead of materializing
        the whole range.  The producer half of a producer/consumer split."""
        footer = meta.footer
        lo = 0 if row_start is None else max(0, row_start)
        hi = footer.num_rows if row_end is None else min(row_end, footer.num_rows)
        # one footer pass for the whole range, then per-stripe coalescing
        full = plan_reads(footer, self.feature_ids, 0, row_start=lo, row_end=hi)
        by_stripe: Dict[int, List[Tuple[int, int, dwrf.StreamInfo]]] = {}
        for si, fid, s in full.wanted:
            by_stripe.setdefault(si, []).append((si, fid, s))
        plans: List[Tuple[int, ReadPlan]] = []
        for si in full.stripe_indices:
            wanted = by_stripe.get(si, [])
            streams = sorted((s for _, _, s in wanted), key=lambda s: s.offset)
            extents = _coalesce_extents(streams, self.coalesce_window)
            plans.append((si, ReadPlan(
                extents=extents, wanted=wanted,
                bytes_wanted=sum(s.length for s in streams),
                bytes_planned=sum(l for _, l in extents),
                stripe_indices=[si], stripes_total=len(footer.stripes),
            )))

        def _start_fetch(k: int):
            """Kick off plan k's extent fetch on a daemon thread (the
            double-buffer slot: stripe N+1's I/O overlaps stripe N's
            decode).  Errors surface at join time, on the caller."""
            import threading

            slot: Dict[str, object] = {}

            def run():
                try:
                    slot["res"] = self._fetch_streams(meta, plans[k][1])
                except BaseException as exc:
                    slot["err"] = exc

            th = threading.Thread(
                target=run, name=f"stripe-prefetch-{plans[k][0]}", daemon=True
            )
            th.start()
            return slot, th

        pending = _start_fetch(0) if self.double_buffer and plans else None
        for k, (si, plan) in enumerate(plans):
            if pending is not None:
                slot, th = pending
                th.join()
                # start stripe k+1's fetch before decoding stripe k
                pending = (
                    _start_fetch(k + 1) if k + 1 < len(plans) else None
                )
                if "err" in slot:
                    raise slot["err"]
                per_stripe, feature_bytes, io = slot["res"]
            else:
                per_stripe, feature_bytes, io = self._fetch_streams(meta, plan)
            stripe = footer.stripes[si]
            with self.tracer.span(
                "extract.decode", tenant=self.tenant or "",
                path=meta.path, stripe=si, engine=self.decode.name,
            ) as sp:
                part = self.decode.decode_stripe(
                    stripe, per_stripe.get(si, {}), self.feature_ids
                )
                sp.set(rows=part.num_rows)
            rows_decoded = part.num_rows
            part, t0, t1 = _trim_stripe(part, stripe, lo, hi)
            self._record_feature_bytes(feature_bytes)
            yield StripeRead(
                stripe_index=si,
                row_start=stripe.row_start + t0,
                row_end=stripe.row_start + t1,
                batch=part,
                bytes_read=plan.bytes_planned,
                bytes_used=plan.bytes_wanted,
                rows_decoded=rows_decoded,
                bytes_from_cache=io.cache_bytes,
                bytes_from_storage=io.storage_bytes,
                io_sizes=[l for _, l in plan.extents],
            )

    def read_partition(
        self, meta: PartitionMeta, row_limit: Optional[int] = None
    ) -> ReadResult:
        return self.read_rows(meta, 0, row_limit if row_limit else None)

    def finish_job(self) -> None:
        """Record this job's feature-read footprint into table popularity."""
        if self.record_popularity and self._job_feature_bytes:
            self.table.popularity.record_job(self._job_feature_bytes)
            self._job_feature_bytes = {}

    # -- dataset-level accounting (Tables 3 & 5) ----------------------------

    def projection_stats(self, partitions: Optional[Sequence[int]] = None) -> Dict[str, float]:
        metas = self.table.select_partitions(partitions)
        bytes_total = sum(m.nbytes for m in metas)
        bytes_used = 0
        feats_total = len(self.table.schema.logged_ids)
        for m in metas:
            plan = plan_reads(m.footer, self.feature_ids, 0, include_labels=False)
            bytes_used += plan.bytes_wanted
        return {
            "pct_features_used": 100.0 * len(self.feature_ids) / max(feats_total, 1),
            "pct_bytes_used": 100.0 * bytes_used / max(bytes_total, 1),
            "bytes_total": float(bytes_total),
            "bytes_used": float(bytes_used),
        }
