"""Two-tier shared stripe cache: DRAM + simulated flash (the "DSI cache
tier" of §7.2).

Concurrent training jobs re-read the same popular partitions (§5.2/§6);
serving that re-read traffic from HDD forces the ~8x
throughput-to-storage overprovisioning of §7.2.  This cache sits between
``TectonicFS`` and the DPP fleet and turns cross-job stripe overlap into
DRAM/flash hits:

  * **DRAM tier** — small, recency-managed (LRU).  Every miss is admitted
    here; a byte served from DRAM costs (nearly) nothing.
  * **Flash tier** — large victim cache built on ``MediaSpec``/``IOStats``
    from ``tectonic.py``.  Admission is *popularity-aware*: a DRAM
    eviction victim is written to flash only once its content has been
    read at least ``flash_admit_reads`` times (tracked with a
    ``PopularityTracker``), so one-touch scan traffic cannot wash the
    flash tier (the classic cache-pollution failure for training scans).

The tier is **multi-tenant**: every lookup/admission carries the
requesting job's tenant id.  A ``TenantPolicy`` gives each job a
guaranteed capacity share per tier — eviction prefers victims owned by
tenants over their guarantee, admission stays unconditional
(borrow-when-idle) — and per-tenant ``TierStats`` charge hits, bytes,
admissions, and evictions to the owning job.

Correctness under churn: entries carry an optional TTL, and partition
rewrites (``TectonicFS.rewrite``/``append``) invalidate the path —
dropping its path-addressed entries and bumping the ``DedupIndex``
generation so keys resolved before the rewrite can never be re-served
after it.

Keys come from ``DedupIndex.resolve`` and are content-addressed where
possible, so byte-identical stripes across partitions/tables occupy one
entry (RecD-style dedup).  Per-tier hit/eviction/byte counters plus the
flash ``IOStats`` make the §7.2 IOPS/W comparison directly computable via
``iops_per_watt``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.cache.dedup import CacheKey, DedupIndex
from repro_torch.core.cache.tenancy import TenantPolicy
from repro_torch.core.popularity import PopularityTracker
from repro_torch.core.tectonic import IOStats, MediaSpec
from repro_torch.obs import counter, gauge

# Cache-tier device models.  DRAM is effectively seek-free; FLASH is a
# single NVMe cache device (drive-level power, unlike the SSD *node* spec
# in tectonic.py), keeping the §7.2 IOPS/W ordering HDD < flash < DRAM.
DRAM_TIER = MediaSpec(name="dram", seek_ms=0.001, transfer_MBps=20_000.0,
                      capacity_TB=0.000256, power_W=5.0)
FLASH_TIER = MediaSpec(name="flash", seek_ms=0.02, transfer_MBps=3_500.0,
                       capacity_TB=1.92, power_W=25.0)

# Tenant id used for accounting when a caller does not identify itself,
# so per-tenant byte sums always equal the tier totals.
ANON_TENANT = "_anon"


def iops_per_watt(num_ios: int, time_s: float, power_W: float) -> float:
    """Served IOPS per watt for a tier/fleet that spent ``time_s`` of
    device time serving ``num_ios`` I/Os at ``power_W`` draw."""
    if time_s <= 0 or power_W <= 0:
        return 0.0
    return (num_ios / time_s) / power_W


@dataclasses.dataclass
class TierStats:
    name: str                      # identity label, not a metric: never merged
    hits: int = counter()
    bytes_served: int = counter()
    admitted: int = counter()
    bytes_stored: int = gauge()    # current occupancy: evictions shrink it
    evictions: int = counter()
    expired: int = counter()       # TTL expiries (counted apart from evictions)
    rejected: int = counter()      # flash admissions refused (unpopular)
    io: IOStats = counter(factory=IOStats)


@dataclasses.dataclass
class TenantStats:
    """Per-job view of the shared tier: reads charged to the reading
    tenant, storage/evictions charged to the owning (admitting) tenant."""

    tenant: str                    # identity label, not a metric: never merged
    dram: TierStats = counter(factory=lambda: TierStats("dram"))
    flash: TierStats = counter(factory=lambda: TierStats("flash"))
    misses: int = counter()

    @property
    def hits(self) -> int:
        return self.dram.hits + self.flash.hits

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    @property
    def bytes_stored(self) -> int:
        return self.dram.bytes_stored + self.flash.bytes_stored


@dataclasses.dataclass
class CacheLookup:
    payload: bytes
    tier: str                      # "dram" | "flash"


@dataclasses.dataclass
class _Entry:
    payload: bytes
    tenant: str                    # owning (admitting) tenant
    expires: float                 # absolute clock() deadline; inf = no TTL


class StripeCache:
    """Shared, thread-safe, two-tier, multi-tenant extent cache."""

    def __init__(
        self,
        dram_capacity_bytes: int = 64 * 1024 * 1024,
        flash_capacity_bytes: int = 512 * 1024 * 1024,
        dram_media: MediaSpec = DRAM_TIER,
        flash_media: MediaSpec = FLASH_TIER,
        flash_admit_reads: int = 2,
        dedup: Optional[DedupIndex] = None,
        tenancy: Optional[TenantPolicy] = None,
        ttl_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.dedup = dedup or DedupIndex()
        self.dram_capacity_bytes = dram_capacity_bytes
        self.flash_capacity_bytes = flash_capacity_bytes
        self.dram_media = dram_media
        self.flash_media = flash_media
        self.flash_admit_reads = flash_admit_reads
        self.tenancy = tenancy or TenantPolicy()
        self.ttl_s = ttl_s
        self._clock = clock
        self.popularity = PopularityTracker()
        self._lock = threading.Lock()
        self._dram: "OrderedDict[CacheKey, _Entry]" = OrderedDict()
        self._flash: "OrderedDict[CacheKey, _Entry]" = OrderedDict()
        # (kind, ident) -> stored keys of that stripe/path, for sub-range
        # serving: a narrower projection of an already-cached range hits
        self._groups: Dict[Tuple, set] = {}
        # single-flight: keys one reader is currently filling; concurrent
        # readers of the same stripe wait for the fill instead of issuing
        # a duplicate storage I/O (request coalescing)
        self._inflight: Dict[CacheKey, threading.Event] = {}
        self.dram = TierStats("dram")
        self.flash = TierStats("flash")
        self.tenants: Dict[str, TenantStats] = {}
        self.misses = 0

    # -- key resolution ------------------------------------------------------

    def resolve(self, path: str, offset: int, length: int) -> CacheKey:
        return self.dedup.resolve(path, offset, length)

    def invalidate_path(self, path: str) -> None:
        """The file at ``path`` was rewritten: drop its content mapping,
        bump the path generation (so pre-rewrite keys cannot be re-served),
        and purge any path-addressed entries (content entries stay valid —
        they are addressed by the bytes themselves)."""
        with self._lock:
            self.dedup.invalidate(path)
            for store, stats, tier in (
                (self._dram, self.dram, "dram"), (self._flash, self.flash, "flash")
            ):
                stale = [k for k in store if k[0] == "p" and k[1][0] == path]
                for k in stale:
                    e = store.pop(k)
                    self._charge_removal_locked(stats, tier, e, expired=False)
                    self._note_locked(k)

    # -- per-tenant accounting ----------------------------------------------

    def _tenant_locked(self, tenant: Optional[str]) -> TenantStats:
        name = tenant if tenant is not None else ANON_TENANT
        ts = self.tenants.get(name)
        if ts is None:
            ts = self.tenants[name] = TenantStats(name)
        return ts

    def _tenant_tier_locked(self, tenant: Optional[str], tier: str) -> TierStats:
        return getattr(self._tenant_locked(tenant), tier)

    def _charge_removal_locked(
        self, stats: TierStats, tier: str, e: _Entry, expired: bool
    ) -> None:
        owner = self._tenant_tier_locked(e.tenant, tier)
        for s in (stats, owner):
            s.bytes_stored -= len(e.payload)
            if expired:
                s.expired += 1
            else:
                s.evictions += 1

    # -- read path -----------------------------------------------------------

    def _record_read_locked(self, key: CacheKey, nbytes: int) -> None:
        # popularity is tracked per content identity: one "job read" of
        # nbytes against the key's stable integer id
        self.popularity.record_job({hash(key): float(nbytes)})

    def _expired(self, e: _Entry) -> bool:
        return e.expires <= self._clock()

    def _purge_expired_locked(self, group: Tuple) -> None:
        """Reclaim expired entries of one stripe/path group (TTL sweep on
        touch — there is no background reaper thread)."""
        for k in list(self._groups.get(group, ())):
            for store, stats, tier in (
                (self._dram, self.dram, "dram"), (self._flash, self.flash, "flash")
            ):
                e = store.get(k)
                if e is not None and self._expired(e):
                    store.pop(k)
                    self._charge_removal_locked(stats, tier, e, expired=True)
            self._note_locked(k)

    def _containing_key_locked(self, key: CacheKey) -> Optional[CacheKey]:
        """A stored key of the same stripe/path whose range covers ``key``'s
        (the key itself included); DRAM copies preferred.  Expired entries
        never serve."""
        off, ln = key[2], key[3]
        best = None
        for k in self._groups.get(key[:2], ()):
            if k[2] <= off and off + ln <= k[2] + k[3]:
                e = self._dram.get(k)
                if e is not None and not self._expired(e):
                    return k
                e = self._flash.get(k)
                if e is not None and not self._expired(e):
                    best = k
        return best

    def _note_locked(self, key: CacheKey) -> None:
        """Sync ``key``'s group-index membership with the tier stores."""
        g = key[:2]
        if key in self._dram or key in self._flash:
            self._groups.setdefault(g, set()).add(key)
        else:
            s = self._groups.get(g)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._groups[g]

    def _lookup_locked(
        self, key: CacheKey, tenant: Optional[str]
    ) -> Optional[CacheLookup]:
        if self.ttl_s is not None:
            self._purge_expired_locked(key[:2])
        k = self._containing_key_locked(key)
        if k is None:
            return None
        entry = self._dram.get(k)
        if entry is not None:
            store, stats, media, tier = (
                self._dram, self.dram, self.dram_media, "dram"
            )
        else:
            entry = self._flash[k]
            store, stats, media, tier = (
                self._flash, self.flash, self.flash_media, "flash"
            )
        stored = entry.payload
        payload = (
            stored if k == key
            else stored[key[2] - k[2]: key[2] - k[2] + key[3]]
        )
        store.move_to_end(k)
        self._record_read_locked(key, len(payload))
        for s in (stats, self._tenant_tier_locked(tenant, tier)):
            s.hits += 1
            s.bytes_served += len(payload)
        stats.io.record(len(payload), media)
        if tier == "flash":
            # promote the whole entry so the next read is a DRAM hit; the
            # admitting tenant keeps ownership of the promoted copy
            self._admit_dram_locked(k, stored, entry.tenant)
        return CacheLookup(payload, tier)

    def _miss_locked(self, key: CacheKey, tenant: Optional[str]) -> None:
        self.misses += 1
        self._tenant_locked(tenant).misses += 1
        self._record_read_locked(key, 0)   # a miss still counts one read

    def get(
        self, key: CacheKey, tenant: Optional[str] = None
    ) -> Optional[CacheLookup]:
        with self._lock:
            hit = self._lookup_locked(key, tenant)
            if hit is None:
                self._miss_locked(key, tenant)
            return hit

    def get_or_claim(
        self, key: CacheKey, timeout_s: float = 10.0, tenant: Optional[str] = None
    ) -> Optional[CacheLookup]:
        """``get`` with single-flight fills: on a cold key the first caller
        claims the fill (returns ``None``; it MUST ``admit`` or ``abort``
        the key), and concurrent callers block until the fill lands, then
        hit — one storage I/O per stripe no matter how many overlapping
        sessions miss it simultaneously."""
        while True:
            with self._lock:
                hit = self._lookup_locked(key, tenant)
                if hit is not None:
                    return hit
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    self._miss_locked(key, tenant)
                    return None
            ev.wait(timeout_s)   # filled or aborted; re-check either way

    def peek(self, key: CacheKey) -> bool:
        """Non-mutating membership probe (used by read planning and the
        prefetch planner); an expired entry does not count as present."""
        with self._lock:
            return self._containing_key_locked(key) is not None

    # -- admission / eviction ------------------------------------------------

    def admit(
        self, key: CacheKey, payload: bytes, tenant: Optional[str] = None
    ) -> None:
        """Admit a freshly-read extent (and release any single-flight claim
        on it).  Always enters DRAM; DRAM victims spill to flash only if
        their content has proven popular.  The entry is charged to
        ``tenant`` until evicted."""
        with self._lock:
            if self.ttl_s is not None:
                self._purge_expired_locked(key[:2])
            k = self._containing_key_locked(key)
            if k is None or k == key:
                self._admit_dram_locked(key, payload, tenant)
            # else: a wider stored range already serves this key
            self._release_locked(key)

    def abort(self, key: CacheKey) -> None:
        """Release a single-flight claim without filling it (the claiming
        read failed); blocked readers re-race for the claim."""
        with self._lock:
            self._release_locked(key)

    def _release_locked(self, key: CacheKey) -> None:
        ev = self._inflight.pop(key, None)
        if ev is not None:
            ev.set()

    def _expiry(self) -> float:
        return self._clock() + self.ttl_s if self.ttl_s is not None else float("inf")

    def _pick_victim_locked(
        self, store: "OrderedDict[CacheKey, _Entry]", tier: str, capacity: int
    ) -> CacheKey:
        """LRU among tenants over their guaranteed share; a tenant whose
        resident bytes fit its guarantee is never evicted by others (the
        borrow-when-idle flip side: only borrowed bytes are reclaimed)."""
        if not self.tenancy.shares:
            return next(iter(store))   # no guarantees: plain O(1) LRU
        # with shares set, protected entries cluster at the MRU end (they
        # are the ones being re-read), so this scan normally stops at the
        # first few LRU entries; worst case is bounded by the protected
        # tenants' resident entry count
        for k, e in store.items():   # OrderedDict iterates LRU-first
            owner = self._tenant_tier_locked(e.tenant, tier)
            if owner.bytes_stored > self.tenancy.guaranteed_bytes(
                e.tenant, tier, capacity
            ):
                return k
        return next(iter(store))    # everyone within guarantee: plain LRU

    def _admit_dram_locked(
        self, key: CacheKey, payload: bytes, tenant: Optional[str]
    ) -> None:
        if len(payload) > self.dram_capacity_bytes:
            self._admit_flash_locked(key, payload, tenant)
            return
        if key in self._dram:
            # freshly re-read bytes: refresh recency and the TTL deadline
            self._dram.move_to_end(key)
            self._dram[key].expires = self._expiry()
            return
        self._dram[key] = _Entry(
            payload, tenant if tenant is not None else ANON_TENANT, self._expiry()
        )
        for s in (self.dram, self._tenant_tier_locked(tenant, "dram")):
            s.admitted += 1
            s.bytes_stored += len(payload)
        self._note_locked(key)
        while self.dram.bytes_stored > self.dram_capacity_bytes and len(self._dram) > 1:
            vk = self._pick_victim_locked(
                self._dram, "dram", self.dram_capacity_bytes
            )
            ve = self._dram.pop(vk)
            self._charge_removal_locked(self.dram, "dram", ve, expired=False)
            self._admit_flash_locked(vk, ve.payload, ve.tenant)
            self._note_locked(vk)

    def _is_popular(self, key: CacheKey) -> bool:
        return self.popularity.read_count_by_feature.get(
            hash(key), 0
        ) >= self.flash_admit_reads

    def _admit_flash_locked(
        self, key: CacheKey, payload: bytes, tenant: Optional[str]
    ) -> None:
        if key in self._flash:
            self._flash.move_to_end(key)
            self._flash[key].expires = self._expiry()
            return
        if len(payload) > self.flash_capacity_bytes or not self._is_popular(key):
            self.flash.rejected += 1
            self._tenant_tier_locked(tenant, "flash").rejected += 1
            return
        self._flash[key] = _Entry(
            payload, tenant if tenant is not None else ANON_TENANT, self._expiry()
        )
        for s in (self.flash, self._tenant_tier_locked(tenant, "flash")):
            s.admitted += 1
            s.bytes_stored += len(payload)
        self._note_locked(key)
        # flash admission is a device write: charge it to the tier's I/O model
        self.flash.io.record(len(payload), self.flash_media)
        while self.flash.bytes_stored > self.flash_capacity_bytes and len(self._flash) > 1:
            vk = self._pick_victim_locked(
                self._flash, "flash", self.flash_capacity_bytes
            )
            ve = self._flash.pop(vk)
            self._charge_removal_locked(self.flash, "flash", ve, expired=False)
            self._note_locked(vk)

    # -- reporting -----------------------------------------------------------

    @property
    def hits(self) -> int:
        return self.dram.hits + self.flash.hits

    @property
    def bytes_served(self) -> int:
        return self.dram.bytes_served + self.flash.bytes_served

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def tier_iops_per_watt(self) -> Dict[str, float]:
        return {
            "dram": iops_per_watt(self.dram.io.num_ios, self.dram.io.total_time_s,
                                  self.dram_media.power_W),
            "flash": iops_per_watt(self.flash.io.num_ios, self.flash.io.total_time_s,
                                   self.flash_media.power_W),
        }

    def summary(self) -> Dict[str, float]:
        return {
            "hit_rate": self.hit_rate,
            "dram_hits": float(self.dram.hits),
            "flash_hits": float(self.flash.hits),
            "misses": float(self.misses),
            "bytes_served": float(self.bytes_served),
            "dram_bytes_stored": float(self.dram.bytes_stored),
            "flash_bytes_stored": float(self.flash.bytes_stored),
            "dedup_ratio": self.dedup.stats.dedup_ratio,
            "unique_stripes": float(self.dedup.unique_stripes),
            "expired": float(self.dram.expired + self.flash.expired),
            "tenants": float(len(self.tenants)),
        }

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-job accounting: the attribution view of the shared tier."""
        return {
            name: {
                "hit_rate": ts.hit_rate,
                "hits": float(ts.hits),
                "misses": float(ts.misses),
                "dram_bytes_stored": float(ts.dram.bytes_stored),
                "flash_bytes_stored": float(ts.flash.bytes_stored),
                "dram_evictions": float(ts.dram.evictions),
                "flash_evictions": float(ts.flash.evictions),
                "bytes_served": float(ts.dram.bytes_served + ts.flash.bytes_served),
            }
            for name, ts in self.tenants.items()
        }
