"""Tectonic-like append-only distributed filesystem with a storage-node
performance/power model.

Files are split into fixed-size blocks (8 MB, the paper's chunk size),
replicated 3x across storage nodes.  Reads are served by extents
(offset, length); the node model charges seek + rotational + transfer time
per I/O, which is what makes small coalesced-read experiments (Table 6,
Table 12) reproduce the paper's HDD IOPS cliff.

Media constants follow §7.1/§7.2: HDDs have an ~8x throughput-to-storage
gap; SSD nodes give 326% IOPS/W at 9% capacity/W relative to HDD.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import NULL_TRACER, counter, merge_metrics

BLOCK_BYTES = 8 * 1024 * 1024         # Tectonic chunk size (§7.5)
REPLICATION = 3


@dataclasses.dataclass(frozen=True)
class MediaSpec:
    name: str
    seek_ms: float                    # average positioning latency per I/O
    transfer_MBps: float              # sequential bandwidth
    capacity_TB: float
    power_W: float

    def io_time_s(self, nbytes: int) -> float:
        return self.seek_ms / 1e3 + nbytes / (self.transfer_MBps * 1e6)

    @property
    def max_iops(self) -> float:
        return 1e3 / self.seek_ms


# Calibrated so SSD/HDD IOPS-per-watt = ~3.26x and capacity-per-watt = ~9%
# of HDD (§7.2 figures), with plausible absolute magnitudes.
HDD = MediaSpec(name="hdd", seek_ms=8.0, transfer_MBps=180.0, capacity_TB=18.0, power_W=8.0)
SSD = MediaSpec(name="ssd", seek_ms=0.08, transfer_MBps=2800.0, capacity_TB=3.84, power_W=262.0)


@dataclasses.dataclass
class IOStats:
    num_ios: int = counter()
    bytes_read: int = counter()
    seek_time_s: float = counter(0.0)
    transfer_time_s: float = counter(0.0)
    io_sizes: List[int] = counter(factory=list)

    @property
    def total_time_s(self) -> float:
        return self.seek_time_s + self.transfer_time_s

    def record(self, nbytes: int, media: MediaSpec) -> None:
        self.num_ios += 1
        self.bytes_read += nbytes
        self.seek_time_s += media.seek_ms / 1e3
        self.transfer_time_s += nbytes / (media.transfer_MBps * 1e6)
        self.io_sizes.append(nbytes)

    def merge(self, other: "IOStats") -> None:
        merge_metrics(self, other)

    def percentiles(self) -> Dict[str, float]:
        if not self.io_sizes:
            return {}
        a = np.asarray(self.io_sizes)
        return {
            "mean": float(a.mean()),
            "std": float(a.std()),
            "p5": float(np.percentile(a, 5)),
            "p25": float(np.percentile(a, 25)),
            "p50": float(np.percentile(a, 50)),
            "p75": float(np.percentile(a, 75)),
            "p95": float(np.percentile(a, 95)),
        }

    @property
    def effective_throughput_MBps(self) -> float:
        t = self.total_time_s
        return (self.bytes_read / 1e6 / t) if t > 0 else 0.0


@dataclasses.dataclass
class StorageNode:
    node_id: int
    media: MediaSpec
    used_bytes: int = 0
    stats: IOStats = dataclasses.field(default_factory=IOStats)

    def read(self, nbytes: int) -> None:
        self.stats.record(nbytes, self.media)


@dataclasses.dataclass
class ExtentRead:
    """Extent payloads plus which tier served each byte."""
    blobs: List[bytes]
    storage_bytes: int = 0
    dram_bytes: int = 0
    flash_bytes: int = 0

    @property
    def cache_bytes(self) -> int:
        return self.dram_bytes + self.flash_bytes


@dataclasses.dataclass
class _BlockRef:
    node_ids: Tuple[int, ...]      # replica placements
    data_off: int                  # offset into the file byte string


class TectonicFS:
    """In-memory append-only FS with byte-accurate files + an I/O cost model."""

    def __init__(
        self,
        num_nodes: int = 12,
        media: MediaSpec = HDD,
        seed: int = 0,
        io_latency_scale: float = 0.0,
    ):
        self.nodes = [StorageNode(i, media) for i in range(num_nodes)]
        self.media = media
        # > 0: storage reads sleep io_time_s * scale, so device latency is
        # felt in wall-clock (cache hits stay instant) — what makes the
        # prefetch-overlap benchmark measure real stall reduction
        self.io_latency_scale = io_latency_scale
        self._files: Dict[str, bytes] = {}
        self._blocks: Dict[str, List[_BlockRef]] = {}
        self._rng = np.random.default_rng(seed)
        self.stats = IOStats()
        self.cache = None                  # optional StripeCache (attach_cache)
        self.tracer = NULL_TRACER          # optional span Tracer (attach_tracer)
        # many sessions' worker threads read one fs: keep the fleet/node
        # accounting consistent (the payload path itself is immutable bytes)
        self._stats_lock = threading.Lock()
        # serializes file-table mutation (append/rewrite) against the read
        # path's (data, blocks, generation) snapshot, so a reader never
        # observes the transient popped state mid-rewrite (RLock: rewrite
        # and append re-enter through create)
        self._mutate_lock = threading.RLock()

    def attach_cache(self, cache) -> None:
        """Install a shared ``StripeCache``: subsequent ``read_extents``
        calls are served from it on hit and admit into it on miss."""
        with self._mutate_lock:
            # published under the mutate lock so an in-flight read's
            # (data, blocks, generation) snapshot can never straddle the
            # cache swap
            self.cache = cache

    def attach_tracer(self, tracer) -> None:
        """Install a span ``Tracer``: subsequent extent reads record
        ``storage.read`` / ``cache.fill`` spans and ``cache.hit`` /
        ``cache.miss`` instants, labeled with tenant/path/tier/bytes."""
        with self._mutate_lock:
            self.tracer = tracer

    # -- write path ---------------------------------------------------------

    def create(self, path: str, data: bytes) -> None:
        with self._mutate_lock:
            assert path not in self._files, f"append-only: {path} exists"
            refs = []
            for off in range(0, max(len(data), 1), BLOCK_BYTES):
                nodes = tuple(
                    int(i) for i in self._rng.choice(len(self.nodes), REPLICATION, replace=False)
                )
                refs.append(_BlockRef(node_ids=nodes, data_off=off))
                for nid in nodes:
                    self.nodes[nid].used_bytes += min(BLOCK_BYTES, len(data) - off)
            # publish blocks before bytes: a reader snapshots both under
            # _mutate_lock, so it never sees one without the other
            self._blocks[path] = refs
            self._files[path] = data

    def _release_placement_locked(self, path: str) -> None:
        """Drop a file's block placement and cached stripes before its
        bytes change; otherwise per-node used_bytes double-counts and the
        cache can serve stale data."""
        base = self._files.get(path, b"")
        for ref in self._blocks.get(path, ()):
            nbytes = min(BLOCK_BYTES, len(base) - ref.data_off)
            for nid in ref.node_ids:
                self.nodes[nid].used_bytes -= nbytes
        self._files.pop(path, None)
        self._blocks.pop(path, None)
        if self.cache is not None:
            self.cache.invalidate_path(path)

    def append(self, path: str, data: bytes) -> None:
        with self._mutate_lock:
            base = self._files.get(path, b"")
            self._release_placement_locked(path)
            self.create(path, base + data)

    def rewrite(self, path: str, data: bytes) -> None:
        """Replace a file's bytes in place (partition churn: the §4
        feature-engineering pipelines continuously rewrite partitions).
        Invalidates the path in the attached cache — dropping its
        path-addressed entries and bumping its dedup generation — before
        the new bytes land, so no reader can be served the old content."""
        with self._mutate_lock:
            assert path in self._files, f"rewrite of non-existent file: {path}"
            self._release_placement_locked(path)
            self.create(path, data)

    def exists(self, path: str) -> bool:
        return path in self._files

    def peek(self, path: str) -> bytes:
        """Accounting-free access to a file's bytes (write-side plumbing,
        e.g. dedup registration) — never use on the training read path."""
        return self._files[path]

    def size(self, path: str) -> int:
        return len(self._files[path])

    def list(self) -> List[str]:
        return sorted(self._files)

    @property
    def used_bytes(self) -> int:
        return sum(len(d) for d in self._files.values())

    # -- read path ----------------------------------------------------------

    def _simulate_latency(self, media: MediaSpec, nbytes: int) -> None:
        if self.io_latency_scale > 0:
            time.sleep(media.io_time_s(nbytes) * self.io_latency_scale)

    def read_extents(
        self, path: str, extents: Sequence[Tuple[int, int]]
    ) -> List[bytes]:
        """Read (offset, length) extents; each extent is one I/O charged to
        the primary replica node of its first block."""
        return self.read_extents_ex(path, extents).blobs

    def read_extents_ex(
        self,
        path: str,
        extents: Sequence[Tuple[int, int]],
        tenant: Optional[str] = None,
    ) -> "ExtentRead":
        """``read_extents`` plus per-source accounting.  With a cache
        attached, each extent is first resolved (content-addressed where the
        dedup index knows the stripe) and looked up; only misses touch a
        storage node, and missed bytes are admitted for the next job.
        ``tenant`` identifies the requesting job for the cache's per-tenant
        capacity shares and accounting."""
        with self._mutate_lock:
            # atomic snapshot vs append/rewrite: bytes, placement, and the
            # path's dedup generation all belong to one file version —
            # and vs attach_cache/attach_tracer: `cache`/`tracer` are
            # published under this lock, so testing `cache` again
            # outside it would be double-checked locking (REPRO-R002)
            data = self._files[path]
            refs = self._blocks[path]
            cache = self.cache
            tracer = self.tracer
            gen0 = (
                cache.dedup.generation(path)
                if cache is not None else 0
            )
        out: List[bytes] = []
        storage_b = dram_b = flash_b = 0
        for off, length in extents:
            assert off + length <= len(data), (off, length, len(data))
            if cache is None:
                block_idx = off // BLOCK_BYTES
                node = self.nodes[refs[min(block_idx, len(refs) - 1)].node_ids[0]]
                with tracer.span(
                    "storage.read", tenant=tenant or "", path=path,
                    bytes=length,
                ):
                    with self._stats_lock:
                        node.read(length)
                        self.stats.record(length, node.media)
                    self._simulate_latency(node.media, length)
                storage_b += length
                out.append(data[off: off + length])
                continue
            # cut the extent at registered stripe boundaries so cache units
            # are content-addressable even when coalescing spans stripes;
            # contiguous missed segments merge back into single storage I/Os
            parts: List[bytes] = []
            pending_off = pending_len = 0

            def _flush_storage() -> None:
                nonlocal pending_off, pending_len, storage_b
                if pending_len == 0:
                    return
                block_idx = pending_off // BLOCK_BYTES
                node = self.nodes[refs[min(block_idx, len(refs) - 1)].node_ids[0]]
                # cache.fill: the storage I/O behind a merged miss run —
                # the fill cost the cache tier pays on behalf of this read
                with tracer.span(
                    "cache.fill", tenant=tenant or "", path=path,
                    bytes=pending_len,
                ):
                    with self._stats_lock:
                        node.read(pending_len)
                        self.stats.record(pending_len, node.media)
                    self._simulate_latency(node.media, pending_len)
                storage_b += pending_len
                pending_len = 0

            for seg_off, seg_len in cache.dedup.segments(path, off, length):
                key = cache.resolve(path, seg_off, seg_len)
                # single-flight get: concurrent sessions missing the same
                # stripe wait for one fill instead of re-reading storage
                hit = cache.get_or_claim(key, tenant=tenant)
                if hit is not None:
                    _flush_storage()
                    if hit.tier == "dram":
                        dram_b += seg_len
                    else:
                        flash_b += seg_len
                    if tracer.enabled:
                        tracer.instant(
                            "cache.hit", tenant=tenant or "", tier=hit.tier,
                            bytes=seg_len,
                        )
                    parts.append(hit.payload)
                    continue
                if tracer.enabled:
                    tracer.instant(
                        "cache.miss", tenant=tenant or "", bytes=seg_len,
                    )
                try:
                    blob = data[seg_off: seg_off + seg_len]
                except BaseException:
                    cache.abort(key)
                    raise
                if cache.dedup.generation(path) != gen0:
                    # a rewrite landed after our snapshot: ``key`` now
                    # describes the NEW file version while ``blob`` holds
                    # the old bytes — admitting would poison post-rewrite
                    # readers.  Serve our (consistent, pre-rewrite) bytes
                    # but leave the cache alone.
                    cache.abort(key)
                else:
                    cache.admit(key, blob, tenant=tenant)  # releases claim
                parts.append(blob)
                if pending_len == 0:
                    pending_off = seg_off
                pending_len += seg_len
            _flush_storage()
            out.append(b"".join(parts))
        return ExtentRead(
            blobs=out, storage_bytes=storage_b,
            dram_bytes=dram_b, flash_bytes=flash_b,
        )

    def read_all(self, path: str) -> bytes:
        return self.read_extents(path, [(0, len(self._files[path]))])[0]

    # -- fleet metrics (Fig. 1 / §7.1 style) --------------------------------

    def reset_stats(self) -> None:
        # a reset racing a concurrent read's stats.record would lose the
        # in-flight I/O or resurrect the pre-reset counters
        with self._stats_lock:
            self.stats = IOStats()
            for n in self.nodes:
                n.stats = IOStats()

    def power_W(self) -> float:
        return sum(n.media.power_W for n in self.nodes)

    def throughput_to_storage_gap(self, demand_MBps: float) -> float:
        """How many x more capacity we must provision to meet IOPS demand
        (the paper's ~8x observation for HDD)."""
        per_node_MBps = self.media.transfer_MBps
        nodes_for_bw = demand_MBps / per_node_MBps
        bytes_needed = self.used_bytes * REPLICATION
        nodes_for_cap = bytes_needed / (self.media.capacity_TB * 1e12)
        if nodes_for_cap == 0:
            return 0.0
        return nodes_for_bw / nodes_for_cap
