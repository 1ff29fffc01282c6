"""Frequency-aware tiered embedding store (closes the training loop).

DLRM embedding tables dwarf device memory (MTrainS, PAPERS.md), but RecD's
observation — id traffic is heavily Zipf-skewed — means a small device-side
*hot* tier absorbs most lookups.  This store generalizes the ``StripeCache``
tiering machinery to embedding rows:

  * **Hot tier (device HBM)** — a fixed-capacity per-table slot array holding
    exact copies of the most frequently accessed rows.  Fully-hot bags can be
    served by the ``embedding_bag`` CUDA kernel over the compact slot table
    (``pooled(..., use_kernel=True)``), one launch per lookup on the store's
    ``device``; on ``device="cpu"`` the kernel's plain version runs.
  * **Host tier (DRAM + flash)** — the authoritative full tables.  A cold row
    fetch is charged to host DRAM when the row is in the host-DRAM working
    set (LRU over ``host_dram_rows``), else to flash — the same
    ``MediaSpec``/``IOStats`` device models the stripe cache uses, so the
    modeled fetch cost lands in the Table-7 style step breakdown.
  * **Admission/eviction** are *frequency-driven*: row access counts are
    tracked with the same ``PopularityTracker`` the storage path uses
    (``core/popularity.py``, one "job" per lookup batch).  A row becomes
    hot-resident once it has been touched in at least ``admit_reads``
    distinct batches; when the hot tier is full the least-popular resident
    is evicted, and only for a strictly more popular newcomer (no thrash
    between equally-warm rows) — the embedding-row analog of the stripe
    cache's ``flash_admit_reads`` pollution guard.
  * **Generation-aware invalidation** mirrors the cache tier's partition
    rewrite semantics: ``bump_generation()`` (call it whenever the
    underlying data generation moves, e.g. a warehouse partition rewrite)
    makes every resident slot stale; a stale slot is never served — the
    next lookup refreshes it from the host copy in place.  Training writes
    (``apply_sparse_update``) update the host tier and refresh resident hot
    copies in the same critical section, so the invariant *hot row bytes ==
    host row bytes* holds at every lock release.

Because hot rows are exact copies and the pooling formula is shared, the
default lookup path is **byte-identical** to a flat single-tier table — the
hot/cold split is a pure optimization (proved by ``tests/test_train_e2e.py``).
The kernel path (``use_kernel=True``) is tolerance-tested instead (the
kernel sums a bag's slots one at a time, numpy in its own order).

Accounting units: ``hot_hits`` / ``dram_fetches`` / ``flash_fetches`` count
*masked id accesses* (so ``hot_rate`` is traffic-weighted, the quantity the
Zipf skew improves), while the per-tier ``IOStats`` charge one modeled I/O
per *unique* row per lookup batch (a batch fetches each missing row once).

A port of the reference's ``repro.train.embedding_cache``: the numpy
bookkeeping is a copy, and only the kernel path (``_kernel_pooled_locked``)
is new.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.popularity import PopularityTracker
from repro_torch.core.tectonic import IOStats, MediaSpec
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.obs import counter, gauge

# Cache-tier device models, copied from the reference's
# ``repro.core.cache.stripe_cache`` (the stripe-cache tier is not ported
# yet).  DRAM is effectively seek-free; FLASH is a single NVMe cache device.
DRAM_TIER = MediaSpec(name="dram", seek_ms=0.001, transfer_MBps=20_000.0,
                      capacity_TB=0.000256, power_W=5.0)
FLASH_TIER = MediaSpec(name="flash", seek_ms=0.02, transfer_MBps=3_500.0,
                       capacity_TB=1.92, power_W=25.0)

# Device-memory model for the hot tier: HBM-class bandwidth, tiny capacity.
HBM_TIER = MediaSpec(name="hbm", seek_ms=0.0002, transfer_MBps=1_200_000.0,
                     capacity_TB=0.000032, power_W=150.0)


@dataclasses.dataclass
class EmbedCacheStats:
    """Tier traffic + residency for the embedding store (REPRO-M001/M002
    contract: counters only grow, gauges are levels)."""

    lookups: int = counter()           # pooled-bag lookup calls
    hot_hits: int = counter()          # masked accesses served from HBM
    dram_fetches: int = counter()      # masked accesses fetched from host DRAM
    flash_fetches: int = counter()     # masked accesses fetched from host flash
    kernel_bags: int = counter()       # fully-hot bags served by the kernel
    admitted: int = counter()          # rows promoted into the hot tier
    evicted: int = counter()           # rows demoted (capacity pressure)
    refreshed: int = counter()         # hot copies rewritten after a host write
    stale_refreshes: int = counter()   # stale-generation slots refreshed on lookup
    generation: int = counter()        # invalidation epoch (bump-only)
    hot_rows: int = gauge()            # resident rows across all tables
    hot_bytes: int = gauge()           # resident bytes across all tables
    hbm_io: IOStats = counter(factory=IOStats)
    dram_io: IOStats = counter(factory=IOStats)
    flash_io: IOStats = counter(factory=IOStats)

    @property
    def hot_rate(self) -> float:
        """Fraction of masked id accesses served from the device tier."""
        n = self.hot_hits + self.dram_fetches + self.flash_fetches
        return self.hot_hits / n if n else 0.0


class TieredEmbeddingStore:
    """Hot(HBM)/cold(host DRAM+flash) embedding tables with frequency-driven
    admission and generation-aware invalidation.  Thread-safe: every public
    method owns ``self._lock`` for its full critical section.

    ``hot_rows_per_table=0`` degenerates to a flat single-tier table (every
    lookup served from host DRAM) — the reference the differential tests
    compare against.

    The tiers' bookkeeping and the host tables are numpy on the host; the
    kernel path uploads the hot-slot table to ``device`` and launches there
    (``device="cuda"`` raises where there is no CUDA).
    """

    def __init__(
        self,
        tables: np.ndarray,                  # (T, V, E) f32 — copied, authoritative
        hot_rows_per_table: int,
        *,
        admit_reads: int = 2,
        host_dram_rows: int = 0,             # 0 = every cold fetch is DRAM-resident
        hot_media: MediaSpec = HBM_TIER,
        dram_media: MediaSpec = DRAM_TIER,
        flash_media: MediaSpec = FLASH_TIER,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve(device, "TieredEmbeddingStore")
        tables = np.asarray(tables, np.float32)
        if tables.ndim != 3:
            raise ValueError(f"tables must be (T, V, E), got {tables.shape}")
        self._lock = threading.Lock()
        t, v, e = tables.shape
        self.num_tables, self.vocab, self.embed_dim = t, v, e
        self.hot_capacity = int(hot_rows_per_table)
        self.admit_reads = int(admit_reads)
        self.row_bytes = e * 4
        self._hot_media = hot_media
        self._dram_media = dram_media
        self._flash_media = flash_media
        self.stats = EmbedCacheStats()

        self._host = tables.copy()                        # authoritative rows
        self._acc = np.zeros((t, v), np.float32)          # row-wise AdaGrad state
        h = max(self.hot_capacity, 1)
        self._hot = np.zeros((t, h, e), np.float32)       # device-side slot table
        self._slot_map = np.full((t, v), -1, np.int32)    # row -> slot (-1 cold)
        self._row_of = np.full((t, h), -1, np.int32)      # slot -> row
        self._slot_gen = np.zeros((t, h), np.int64)       # generation at admit
        self._resident = np.zeros(t, np.int32)            # slots in use per table
        self._generation = 0
        # id-frequency stats: one PopularityTracker "job" per lookup batch,
        # feature id = flat row id (t * V + row) — core/popularity.py reused
        # as the admission signal, exactly like flash_admit_reads.
        self._popularity = PopularityTracker()
        # host-DRAM working set over flat row ids (LRU); rows outside it
        # charge the flash MediaSpec on a cold fetch.
        self._host_dram: "OrderedDict[int, None]" = OrderedDict()
        self._host_dram_rows = int(host_dram_rows)

    # -- introspection ----------------------------------------------------

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def host_tables(self) -> np.ndarray:
        """Copy of the authoritative (T, V, E) tables."""
        with self._lock:
            return self._host.copy()

    def adagrad_state(self) -> np.ndarray:
        with self._lock:
            return self._acc.copy()

    def hot_residency(self) -> Dict[int, np.ndarray]:
        """Per-table sorted array of current-generation hot row ids."""
        with self._lock:
            out = {}
            for ti in range(self.num_tables):
                slots = np.nonzero(self._row_of[ti] >= 0)[0]
                fresh = slots[self._slot_gen[ti, slots] == self._generation]
                out[ti] = np.sort(self._row_of[ti, fresh])
            return out

    def row_count(self, ti: int, row: int) -> int:
        """Popularity count (lookup batches that touched the row)."""
        with self._lock:
            return self._count_locked(ti, row)

    def _count_locked(self, ti: int, row: int) -> int:
        return self._popularity.read_count_by_feature.get(
            ti * self.vocab + int(row), 0
        )

    # -- invalidation ------------------------------------------------------

    def bump_generation(self) -> int:
        """Partition-rewrite analog: every resident slot becomes stale and
        is refreshed from the host copy before its next serve."""
        with self._lock:
            self._generation += 1
            self.stats.generation += 1
            return self._generation

    def load_tables(self, tables: np.ndarray) -> int:
        """Replace the authoritative host tables and bump the generation in
        one critical section — the embedding-side partition rewrite (table
        reload after an upstream rewrite, or a checkpoint restore).  A
        lookup racing this call sees either the old tables or the new ones
        in full, never a mix, and no lookup after the bump can be served a
        pre-reload hot copy."""
        tables = np.asarray(tables, np.float32)
        if tables.shape != self._host.shape:
            raise ValueError(
                f"tables shape {tables.shape} != {self._host.shape}"
            )
        with self._lock:
            self._host[...] = tables
            self._acc[...] = 0.0
            self._generation += 1
            self.stats.generation += 1
            return self._generation

    # -- lookup ------------------------------------------------------------

    def pooled(self, ids: np.ndarray, mask: np.ndarray, *,
               use_kernel: bool = False) -> np.ndarray:
        """Mean-pooled bags: (B, T, L) ids/mask -> (B, T, E) f32.

        Default path is byte-identical to pooling over a flat table; with
        ``use_kernel=True`` fully-hot bags go through the ``embedding_bag``
        kernel on the compact hot-slot table instead.
        """
        ids = np.asarray(ids)
        mask = np.asarray(mask, np.float32)
        if ids.shape != mask.shape or ids.ndim != 3:
            raise ValueError(f"ids/mask must both be (B, T, L), got "
                             f"{ids.shape} vs {mask.shape}")
        with self._lock:
            self.stats.lookups += 1
            rows, slot = self._gather_locked(ids, mask > 0.0)
            denom = np.maximum(mask.sum(axis=2), 1.0)
            pooled = (
                (rows * mask[..., None]).sum(axis=2) / denom[..., None]
            ).astype(np.float32)
            if use_kernel and self.hot_capacity > 0:
                pooled = self._kernel_pooled_locked(pooled, slot, mask)
            return pooled

    def _gather_locked(self, ids: np.ndarray,
                       m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Serve (B, T, L) ids from hot/host tiers; refresh stale slots,
        account traffic and run frequency-driven admission.  Returns the
        row tensor (B, T, L, E) and per-position hot slot (-1 = cold)."""
        b, t, l = ids.shape
        ids = np.clip(ids, 0, self.vocab - 1).astype(np.int64)
        rows = np.empty((b, t, l, self.embed_dim), np.float32)
        slot_out = np.full((b, t, l), -1, np.int32)
        job_bytes: Dict[int, float] = {}
        cold_unique: Dict[int, np.ndarray] = {}
        for ti in range(t):
            idt = ids[:, ti, :]
            slot = self._slot_map[ti, idt]                       # (B, L)
            fresh = slot >= 0
            if fresh.any():
                stale = fresh.copy()
                stale[fresh] = (
                    self._slot_gen[ti, slot[fresh]] != self._generation
                )
                if stale.any():
                    self._refresh_stale_locked(ti, np.unique(idt[stale]))
            rows[:, ti] = self._host[ti, idt]
            if fresh.any():
                rows[:, ti][fresh] = self._hot[ti, slot[fresh]]
            slot_out[:, ti] = np.where(fresh, slot, -1)

            mt = m[:, ti, :]
            self.stats.hot_hits += int((fresh & mt).sum())
            cold = ~fresh & mt
            u_rows, u_counts = np.unique(idt[cold], return_counts=True)
            cold_unique[ti] = u_rows
            for r, n in zip(u_rows, u_counts):
                tier = self._host_fetch_locked(ti * self.vocab + int(r))
                if tier == "dram":
                    self.stats.dram_fetches += int(n)
                else:
                    self.stats.flash_fetches += int(n)
            all_rows, all_counts = np.unique(idt[mt], return_counts=True)
            for r, n in zip(all_rows, all_counts):
                flat = ti * self.vocab + int(r)
                job_bytes[flat] = (
                    job_bytes.get(flat, 0.0) + int(n) * self.row_bytes
                )
        if job_bytes:
            self._popularity.record_job(job_bytes)
        if self.hot_capacity > 0:
            for ti, u_rows in cold_unique.items():
                for r in u_rows:
                    self._maybe_admit_locked(ti, int(r))
        return rows, slot_out

    def _refresh_stale_locked(self, ti: int, stale_rows: np.ndarray) -> None:
        """Re-copy stale-generation hot rows from the host tier in place —
        a stale slot is never served (the generation invariant)."""
        slots = self._slot_map[ti, stale_rows]
        self._hot[ti, slots] = self._host[ti, stale_rows]
        self._slot_gen[ti, slots] = self._generation
        n = len(stale_rows)
        self.stats.stale_refreshes += n
        self.stats.hbm_io.record(n * self.row_bytes, self._hot_media)

    def _host_fetch_locked(self, flat_row: int) -> str:
        """Model one host-tier row fetch; returns the serving tier name."""
        if self._host_dram_rows <= 0 or flat_row in self._host_dram:
            if self._host_dram_rows > 0:
                self._host_dram.move_to_end(flat_row)
            self.stats.dram_io.record(self.row_bytes, self._dram_media)
            return "dram"
        self.stats.flash_io.record(self.row_bytes, self._flash_media)
        self._host_dram[flat_row] = None
        if len(self._host_dram) > self._host_dram_rows:
            self._host_dram.popitem(last=False)
        return "flash"

    def _maybe_admit_locked(self, ti: int, row: int) -> None:
        """Admit ``row`` into the hot tier once its popularity count crosses
        ``admit_reads``; under capacity pressure the least-popular resident
        is evicted, and only for a strictly more popular newcomer."""
        if self._slot_map[ti, row] >= 0:
            return
        count = self._count_locked(ti, row)
        if count < self.admit_reads:
            return
        if self._resident[ti] < self.hot_capacity:
            slot = int(np.nonzero(self._row_of[ti] < 0)[0][0])
            self._resident[ti] += 1
        else:
            res_rows = self._row_of[ti, :self.hot_capacity]
            counts = np.array(
                [self._count_locked(ti, int(r)) for r in res_rows]
            )
            victim_slot = int(np.argmin(counts))
            if counts[victim_slot] >= count:
                return                    # newcomer is not strictly hotter
            self._slot_map[ti, res_rows[victim_slot]] = -1
            self.stats.evicted += 1
            self.stats.hot_rows -= 1
            self.stats.hot_bytes -= self.row_bytes
            slot = victim_slot
        self._hot[ti, slot] = self._host[ti, row]
        self._slot_map[ti, row] = slot
        self._row_of[ti, slot] = row
        self._slot_gen[ti, slot] = self._generation
        self.stats.admitted += 1
        self.stats.hot_rows += 1
        self.stats.hot_bytes += self.row_bytes
        self.stats.hbm_io.record(self.row_bytes, self._hot_media)

    def _kernel_pooled_locked(self, pooled: np.ndarray, slot: np.ndarray,
                              mask: np.ndarray) -> np.ndarray:
        """Re-serve fully-hot bags through ``embedding_bag`` over the
        flattened (T*H, E) hot-slot table: one launch per lookup over the
        (n_ok, L) fully-hot bags only, with slot ids offset by t*H.  (The
        reference launches once per table over padded (B, L) bags so that
        its kernel compiles once; each bag's result is the same function
        either way.)"""
        m = mask > 0.0
        ok = np.all((slot >= 0) | ~m, axis=2) & m.any(axis=2)    # (B, T)
        n_ok = int(ok.sum())
        if n_ok == 0:
            return pooled
        t = slot.shape[1]
        h = self._hot.shape[1]
        offs = (np.arange(t, dtype=np.int32) * h)[None, :, None]
        slot_ids = np.where(m & (slot >= 0), slot, 0) + offs          # (B, T, L)
        pooled[ok] = self._bag_launch(
            self._hot.reshape(t * h, self.embed_dim),
            slot_ids[ok].astype(np.int32),
            np.asarray(mask[ok], np.float32),
        )
        self.stats.kernel_bags += n_ok
        return pooled

    def _bag_launch(self, table: np.ndarray, ids: np.ndarray,
                    mask: np.ndarray) -> np.ndarray:
        """Copy the operands to the store's device, run ``embedding_bag``
        there (the kernel on CUDA, its plain version on the CPU) and bring
        the (bags, E) result back."""
        dev = self.device
        out = ops.embedding_bag(
            torch.from_numpy(table).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(mask).to(dev), mode="mean",
        )
        return out.cpu().numpy()

    # -- training writes ---------------------------------------------------

    def apply_sparse_update(self, dpooled: np.ndarray, ids: np.ndarray,
                            mask: np.ndarray, lr: float,
                            eps: float = 1e-8) -> None:
        """Row-wise AdaGrad on the host tier — the numpy mirror of
        ``DLRM.sparse_table_update`` — then refresh resident hot copies of
        every touched row inside the same critical section (write
        invalidation: the hot tier can never serve a pre-update row)."""
        dpooled = np.asarray(dpooled, np.float32)        # (B, T, E)
        mask = np.asarray(mask, np.float32)              # (B, T, L)
        with self._lock:
            ids = np.clip(
                np.asarray(ids), 0, self.vocab - 1
            ).astype(np.int64)                           # (B, T, L)
            denom = np.maximum(mask.sum(axis=2), 1.0)    # (B, T)
            w = mask / denom[..., None]                  # (B, T, L)
            rg = (
                dpooled[:, :, None, :] * w[..., None]
            ).reshape(-1, self.embed_dim).astype(np.float32)
            flat = (
                ids + np.arange(self.num_tables)[None, :, None] * self.vocab
            ).reshape(-1)
            g2 = np.mean(np.square(rg), axis=-1)
            acc_flat = self._acc.reshape(-1)
            np.add.at(acc_flat, flat, g2)
            scale = (lr / np.sqrt(acc_flat[flat] + eps)).astype(np.float32)
            host_flat = self._host.reshape(-1, self.embed_dim)
            np.add.at(host_flat, flat, -scale[:, None] * rg)
            for ti in range(self.num_tables):
                touched = np.unique(ids[:, ti][mask[:, ti] > 0.0])
                slots = self._slot_map[ti, touched]
                res = touched[slots >= 0]
                if res.size:
                    rs = self._slot_map[ti, res]
                    self._hot[ti, rs] = self._host[ti, res]
                    self._slot_gen[ti, rs] = self._generation
                    self.stats.refreshed += int(res.size)
                    self.stats.hbm_io.record(
                        int(res.size) * self.row_bytes, self._hot_media
                    )


def init_tables(model_cfg, seed: int = 0) -> np.ndarray:
    """Freshly initialized (T, V, E) f32 tables for a ``DLRMConfig``:
    normal(0, 0.01), the embedding init scale.  Drawn table by table from
    one generator, which gives the bytes of the reference's one-call draw
    without its (T, V, E) float64 temporary."""
    rng = np.random.default_rng(seed)
    t, v, e = model_cfg.num_tables, model_cfg.vocab_per_table, model_cfg.embed_dim
    tables = np.empty((t, v, e), np.float32)
    for ti in range(t):
        tables[ti] = rng.normal(0.0, 0.01, (v, e))
    return tables


def make_store_for_model(model_cfg, hot_rows_per_table: int, *,
                         seed: int = 0, **kwargs) -> TieredEmbeddingStore:
    """Build a store with freshly initialized tables matching a
    ``DLRMConfig`` (``init_tables``)."""
    return TieredEmbeddingStore(init_tables(model_cfg, seed),
                                hot_rows_per_table, **kwargs)
