"""Client-side prefetch of uncached segments.

Table 7's data-stall metric is dominated by cold reads at the head of a
session and whenever a worker's extract falls behind the trainer.  The
planner overlaps that warehouse I/O with training: it peeks at the
Master's upcoming (not-yet-leased) splits, plans their reads, and — using
``plan_reads``' ``bytes_cached_planned`` — starts background fills for
**only the segments the shared ``StripeCache`` does not already hold**.
By the time a worker leases the split, its stripes are DRAM hits and the
storage latency has been paid off the critical path.

Fills fan out over a small thread pool (one split per thread), mirroring
how a production client keeps several storage round-trips in flight.
``DPPClient.get_batch`` pokes the planner whenever it stalls, so a
starving trainer immediately accelerates warming instead of waiting for
the next poll tick.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.dpp.master import DPPMaster, Split
from repro_torch.core.reader import COALESCE_WINDOW, plan_reads
from repro_torch.core.warehouse import Table
from repro_torch.obs import counter


@dataclasses.dataclass
class PrefetchMetrics:
    plans: int = counter()                # splits planned
    splits_warmed: int = counter()        # splits with at least one fill started
    bytes_fetched: int = counter()        # storage bytes pulled ahead of workers
    bytes_already_cached: int = counter() # planned bytes the cache already held
    pokes: int = counter()                # stall-triggered wakeups from clients


class PrefetchPlanner:
    """Background cache warmer for a session's upcoming splits."""

    # deliberately lock-free (REPRO-R001 / racedep allowlist): `depth` is
    # a GIL-atomic int the monitor thread retunes while the planner loop
    # reads it per iteration (a stale read costs one tick of lag, never
    # correctness); `_thread` is written once by the launching thread
    _unshared = ("depth", "_thread")

    def __init__(
        self,
        table: Table,
        master: DPPMaster,
        feature_ids: Sequence[int],
        tenant: Optional[str] = None,
        depth: int = 4,
        fanout: int = 4,
        coalesce_window: int = COALESCE_WINDOW,
        interval_s: float = 0.01,
    ):
        self.table = table
        self.master = master
        self.feature_ids = list(feature_ids)
        self.tenant = tenant
        self.depth = max(1, depth)
        self.fanout = max(1, fanout)
        self.coalesce_window = coalesce_window
        self.interval_s = interval_s
        self.metrics = PrefetchMetrics()
        # split id -> path generation at warm time: a partition rewrite
        # bumps the generation and invalidates the cached bytes, so its
        # splits must become warmable again, not skipped forever
        self._warmed: dict = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread:
            self._thread.join(timeout)

    def poke(self) -> None:
        """A client stalled: warm the next splits now, not at the next tick."""
        self.metrics.pokes += 1
        self._wake.set()

    def set_depth(self, depth: int) -> None:
        """Autoscale knob: how many upcoming splits to keep
        cache-warm.  Deeper under stall pressure, shallower when the
        trainer is saturated and warming ahead only wastes cache space."""
        self.depth = max(1, int(depth))

    # -- planning ------------------------------------------------------------

    def _uncached_extents(self, split: Split) -> Tuple[str, List[Tuple[int, int]]]:
        """The (offset, length) segments of ``split``'s planned reads that
        the stripe cache does not hold — the only bytes worth fetching."""
        meta = self.table.partitions[split.partition]
        cache = self.table.fs.cache
        plan = plan_reads(
            meta.footer, self.feature_ids, self.coalesce_window,
            row_start=split.row_start, row_end=split.row_end,
            cache=cache, path=meta.path,
        )
        self.metrics.plans += 1
        self.metrics.bytes_already_cached += plan.bytes_cached_planned
        if plan.bytes_cached_planned >= plan.bytes_planned:
            return meta.path, []
        uncached: List[Tuple[int, int]] = []
        for off, ln in plan.extents:
            for seg_off, seg_len in cache.dedup.segments(meta.path, off, ln):
                if not cache.peek(cache.resolve(meta.path, seg_off, seg_len)):
                    uncached.append((seg_off, seg_len))
        return meta.path, uncached

    def prefetch_once(self) -> int:
        """Warm up to ``depth`` upcoming splits; returns bytes fetched.
        Safe to call synchronously (tests) or from the planner thread."""
        cache = self.table.fs.cache
        if cache is None:
            return 0
        work: List[Tuple[str, List[Tuple[int, int]]]] = []
        for split in self.master.peek_pending(self.depth):
            if self._stop.is_set():
                continue
            gen = cache.dedup.generation(self.table.partitions[split.partition].path)
            if self._warmed.get(split.split_id) == gen:
                continue
            self._warmed[split.split_id] = gen
            path, uncached = self._uncached_extents(split)
            if uncached:
                work.append((path, uncached))
        if not work:
            return 0
        fetched = [0] * len(work)

        def _fill(i: int, path: str, extents: List[Tuple[int, int]]) -> None:
            # read_extents_ex admits every missed segment into the shared
            # cache; hits (someone else fetched first) cost nothing
            io = self.table.fs.read_extents_ex(path, extents, tenant=self.tenant)
            fetched[i] = io.storage_bytes

        threads = [
            threading.Thread(target=_fill, args=(i, p, ex), daemon=True)
            for i, (p, ex) in enumerate(work)
        ]
        for group in range(0, len(threads), self.fanout):
            chunk = threads[group: group + self.fanout]
            for t in chunk:
                t.start()
            for t in chunk:
                t.join()
        total = sum(fetched)
        self.metrics.bytes_fetched += total
        self.metrics.splits_warmed += sum(1 for f in fetched if f > 0)
        return total

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self.master.finished:
                return
            if self.prefetch_once() == 0:
                self._wake.wait(self.interval_s)
                self._wake.clear()
