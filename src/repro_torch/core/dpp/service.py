"""In-process DPP session runner: Master + Workers + Clients + monitor.

The fully-managed-service behavior of §3.2.1 in one process: launches the
Master and an initial worker fleet, monitors health (restarting dead
Workers without checkpoint restore — they are stateless), runs the
auto-scaling controller, and wires Clients for the training side.

``DPPService`` is the multi-tenant front-end: it runs many concurrent
sessions over one warehouse behind a single shared ``StripeCache``
handle, so combo-window jobs re-reading the same partitions (§5.2) hit
DRAM/flash instead of HDD.

The port's sessions run their workers' extract and transform on the
session's ``device`` through the torch engines by default.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.cache import StripeCache
from repro_torch.core.dpp.autoscale import (
    ElasticController, ElasticPolicy, observation_from_delta,
)
from repro_torch.core.dpp.client import ClientMetrics, DPPClient, SessionFailed
from repro_torch.core.dpp.master import DPPMaster, SessionSpec
from repro_torch.core.dpp.prefetch import PrefetchPlanner
from repro_torch.core.dpp.worker import DPPWorker, WorkerMetrics
from repro_torch.core.warehouse import Table, Warehouse
from repro_torch.obs import NULL_TRACER, MetricsRegistry, merge_metrics


class DPPSession:
    # deliberately lock-free (REPRO-R001 / racedep allowlist): `_wid` is
    # only bumped by _launch_worker, which runs in __init__ and then only
    # ever on the single monitor thread; `_monitor` is written once by
    # the thread calling start()
    _unshared = ("_wid", "_monitor")

    def __init__(
        self,
        spec: SessionSpec,
        table: Table,
        n_workers: int = 2,
        n_clients: int = 1,
        auto_scale: bool = False,
        monitor_interval_s: float = 0.2,
        lease_s: float = 5.0,
        max_workers: int = 16,
        tensor_cache=None,
        name: str = "session",
        prefetch: bool = False,
        prefetch_depth: int = 4,
        on_stop=None,
        dispatch_budget: int = 3,
        elastic_policy: Optional[ElasticPolicy] = None,
        engine: str = "torch",
        decode_engine: str = "torch",
        double_buffer: bool = True,
        clock: Callable[[], float] = time.time,
        tracer=NULL_TRACER,
        device: str = "cuda",
    ):
        self.spec = spec
        self.table = table
        self.name = name                   # tenant id for the stripe cache
        self._on_stop = on_stop            # e.g. release the tenant's share
        self.engine = engine               # TransformEngine for every worker
        self.decode_engine = decode_engine # DecodeEngine for every worker
        self.device = device               # where "torch" engines run
        self.double_buffer = double_buffer # fetch/decode overlap in extract
        self.tracer = tracer
        if tracer.enabled and not table.fs.tracer.enabled:
            # storage/cache spans come from the shared fs: attach once,
            # never downgrade a real tracer someone else installed
            table.fs.attach_tracer(tracer)
        # injected clock (REPRO-C001): deadlines/scale-event timestamps are
        # testable without wall-clock sleeps; shared with the master
        self._clock = clock
        partition_rows = {p: table.partitions[p].num_rows for p in spec.partitions}
        # stripe-aligned splits: the writer emits uniform stripes, so the
        # first stripe's row count is the partition's stripe size
        partition_stripe_rows = {
            p: (table.partitions[p].footer.stripes[0].num_rows
                if table.partitions[p].footer.stripes else 0)
            for p in spec.partitions
        }
        self.master = DPPMaster(
            spec, partition_rows, lease_s=lease_s,
            partition_stripe_rows=partition_stripe_rows,
            dispatch_budget=dispatch_budget,
            clock=clock,
        )
        # feedback-driven elastic scaling: stall rate + queue depth drive
        # worker count and prefetch depth, with hysteresis
        self.controller = ElasticController(
            elastic_policy
            or ElasticPolicy(max_workers=max_workers),
            prefetch_depth=prefetch_depth,
        )
        self.tensor_cache = tensor_cache
        # background cache warmer for upcoming splits: fetches
        # only the segments plan_reads reports uncached, off-thread
        self.prefetcher: Optional[PrefetchPlanner] = (
            PrefetchPlanner(
                table, self.master, spec.feature_ids,
                tenant=name, depth=prefetch_depth,
            )
            if prefetch else None
        )
        self.workers: List[DPPWorker] = []
        # removed workers (crashed-and-replaced, drained scale-downs) keep
        # contributing to the session's byte/cycle accounting
        self._graveyard: List[DPPWorker] = []
        self._wid = 0
        for _ in range(n_workers):
            self._launch_worker()
        self.clients = [
            DPPClient(f"client{i}", self.workers, prefetcher=self.prefetcher,
                      master=self.master, tenant=name, tracer=tracer)
            for i in range(n_clients)
        ]
        # unified metrics registry: every signal the monitor (and the
        # Table-7 stall report) consumes comes from one snapshot/delta API
        self.registry = MetricsRegistry()
        self.registry.register("worker", self.worker_metrics)
        self.registry.register("client", self._client_metrics)
        self.registry.register_value(
            "fleet.buffered_batches",
            lambda: sum(w.buffered for w in self.workers), kind="gauge",
        )
        self.registry.register_value(
            "fleet.active_workers",
            lambda: sum(1 for w in self.workers if not w.retired),
            kind="gauge",
        )
        # one computed counter, not per-worker values: a single sum keeps
        # the float accumulation order identical to the old inline monitor
        # arithmetic, so controller decisions stay byte-for-byte the same
        self.registry.register_value(
            "fleet.busy_s",
            lambda: sum(
                w.metrics.busy_s for w in self.workers + self._graveyard
            ),
            kind="counter",
        )
        self.auto_scale = auto_scale
        self.monitor_interval_s = monitor_interval_s
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.scale_events: List[Dict] = []
        self.restart_events: List[str] = []

    # -- lifecycle ------------------------------------------------------------

    def _launch_worker(self, fail_after: Optional[int] = None) -> DPPWorker:
        w = DPPWorker(
            f"w{self._wid}", self.master, self.table,
            fail_after_splits=fail_after, tensor_cache=self.tensor_cache,
            tenant=self.name, engine=self.engine,
            decode_engine=self.decode_engine, double_buffer=self.double_buffer,
            tracer=self.tracer, device=self.device,
        )
        self._wid += 1
        self.workers.append(w)
        return w

    def start(self) -> None:
        if self.prefetcher is not None:
            self.prefetcher.start()
        for w in self.workers:
            if w._thread is None:
                w.start()
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True)
        self._monitor.start()

    def stop(self) -> None:
        self._stop.set()
        if self.prefetcher is not None:
            self.prefetcher.stop()
        # join the monitor BEFORE snapshotting the fleet: it is the only
        # thread that launches workers, so afterwards no worker can be
        # born unseen and leak past the stop/join below
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        fleet = list(self.workers)
        for w in fleet:
            w.stop()
        for w in fleet:
            w.join(timeout=2.0)
        if self.prefetcher is not None:
            self.prefetcher.join(timeout=2.0)
        if self._on_stop is not None:
            self._on_stop()

    # -- monitor: health + autoscaling -----------------------------------------

    def _monitor_loop(self) -> None:
        prev = None                    # previous registry Snapshot
        while not self._stop.is_set() and not self.master.finished:
            time.sleep(self.monitor_interval_s)
            # health: restart dead workers (stateless -> no restore needed);
            # retired (drained) workers exited on purpose — remove them once
            # their buffers are empty instead of "restarting" the scale-down
            for w in list(self.workers):
                if w._thread is None or w._thread.is_alive():
                    continue
                if w.retired:
                    if w.buffered == 0:
                        self.workers.remove(w)
                        self._graveyard.append(w)
                        for c in self.clients:
                            c.rebind(self.workers)
                elif not w.alive and not self.master.finished:
                    self.master.forget_worker(w.worker_id)
                    # keep the corpse in the fleet until clients drain its
                    # buffer — batches of splits the Master already counted
                    # done must not vanish with the worker.  The retired
                    # branch above removes it once empty.
                    w.retired = True
                    nw = self._launch_worker()
                    nw.start()
                    self.restart_events.append(w.worker_id)
                    for c in self.clients:
                        c.rebind(self.workers)
            if not self.auto_scale:
                continue
            # observation via the registry: counters (stalls, waits, busy)
            # arrive as per-tick deltas, gauges (queue depth, active
            # workers) as levels — the arithmetic lives with the
            # controller in autoscale.observation_from_delta
            snap = self.registry.snapshot()
            delta = snap.delta(prev)
            prev = snap
            decision = self.controller.observe(
                observation_from_delta(delta, self.monitor_interval_s)
            )
            if decision.prefetch_depth is not None and self.prefetcher is not None:
                self.prefetcher.set_depth(decision.prefetch_depth)
            if decision.worker_delta > 0:
                for _ in range(decision.worker_delta):
                    w = self._launch_worker()
                    w.start()
                for c in self.clients:
                    c.rebind(self.workers)
            elif decision.worker_delta < 0:
                active = [w for w in self.workers if not w.retired]
                victims = active[decision.worker_delta:]
                for v in victims:
                    # graceful drain: finish + deliver the in-flight split,
                    # stop pulling new ones, retire without a health restart
                    v.retired = True
                    v.drain()
            if decision.worker_delta != 0:
                self.scale_events.append({
                    "t": self._clock(), "delta": decision.worker_delta,
                    "reason": decision.reason,
                })

    # -- state + aggregate metrics ------------------------------------------------

    @property
    def state(self) -> str:
        """``SessionState``: RUNNING / COMPLETED / DEGRADED / FAILED."""
        return self.master.state

    def failure_report(self):
        """Quarantined splits with their exception chains."""
        return self.master.failure_report()

    def worker_metrics(self) -> WorkerMetrics:
        total = WorkerMetrics()
        for w in list(self.workers) + list(self._graveyard):
            total.merge(w.metrics)
        return total

    def _client_metrics(self) -> ClientMetrics:
        total = ClientMetrics()
        for c in self.clients:
            merge_metrics(total, c.metrics)
        return total

    def run_to_completion(
        self, max_batches: Optional[int] = None, timeout_s: float = 120.0
    ) -> List[Dict[str, np.ndarray]]:
        """Drive client 0 until the dataset is exhausted (one epoch, §5.1).

        A DEGRADED session drains normally — every healthy split's batches
        are delivered and the quarantine is left for ``failure_report()``.
        A FAILED session raises ``SessionFailed`` (from the client) with
        the offending splits attached; the fleet is stopped either way.
        """
        self.start()
        out = []
        deadline = self._clock() + timeout_s
        try:
            # session.run bounds the tenant's wall clock: the stall report
            # divides every other span's time by this one's duration
            with self.tracer.span("session.run", tenant=self.name) as sp:
                while self._clock() < deadline:
                    # short poll: the post-exhaustion drain check costs one
                    # poll interval, not a whole client timeout (which would
                    # be billed as trainer stall time and swamp the Table-7
                    # metric)
                    batch = self.clients[0].get_batch(timeout=0.25)
                    if batch is not None:
                        out.append(batch)
                        if max_batches and len(out) >= max_batches:
                            break
                        continue
                    if self.master.finished and all(
                        w.buffered == 0 for w in self.workers
                    ):
                        break
                sp.set(batches=len(out))
        finally:
            self.stop()
        return out


class DPPService:
    """Multi-tenant DPP front-end: concurrent sessions over one warehouse
    sharing a single ``StripeCache`` (and optional ``TensorCache``).

    Production DPP is a fleet serving many training jobs at once; the
    cross-job locality the paper measures (§5.2: jobs in a combo window
    re-read the same partitions) only pays off if the cache handle is
    shared *across* sessions, which is exactly what this class wires up.
    """

    def __init__(
        self,
        warehouse: Warehouse,
        stripe_cache: Optional[StripeCache] = None,
        tensor_cache=None,
        enable_stripe_cache: bool = True,
        clock: Callable[[], float] = time.time,
        tracer=NULL_TRACER,
    ):
        self.warehouse = warehouse
        self._clock = clock
        self.tracer = tracer
        if tracer.enabled:
            warehouse.fs.attach_tracer(tracer)
        self.stripe_cache = stripe_cache or (
            StripeCache() if enable_stripe_cache else None
        )
        if self.stripe_cache is not None:
            warehouse.attach_cache(self.stripe_cache)
        self.tensor_cache = tensor_cache
        self.sessions: Dict[str, DPPSession] = {}
        self.session_errors: Dict[str, SessionFailed] = {}

    def create_session(
        self,
        name: str,
        spec: SessionSpec,
        dram_share: float = 0.0,
        flash_share: float = 0.0,
        **kw,
    ) -> DPPSession:
        """Register a session; its ``name`` is the cache tenant id.  A
        non-zero ``dram_share``/``flash_share`` reserves that fraction of
        the shared tier for this job (borrow-when-idle: unreserved and
        idle capacity stays usable by everyone).  The reservation lapses
        automatically when the session stops, so sequential jobs can each
        claim large shares without exhausting the 1.0 budget and a dead
        job's resident bytes stop being eviction-protected.

        ``engine``, ``decode_engine`` and ``device`` are forwarded to every
        worker: ``engine="torch"`` (the default) runs the transform stage
        wave-fused through ``kernels.fused_transform`` on ``device``
        (``cuda`` unless asked for ``cpu``) instead of per-feature numpy;
        ``decode_engine="torch"`` does the same for the extract stage
        (whole-stripe batched decode via ``kernels.decode``, see
        ``repro_torch.core.decode``) and ``double_buffer`` overlaps stripe
        N+1's extent fetch with stripe N's decode.  All engines produce
        byte-identical batches, so mixed-engine fleets can share one
        ``TensorCache``."""
        reserve = (dram_share or flash_share) and self.stripe_cache is not None
        if reserve:
            # validate the share up front (so an over-committed request
            # fails before any session machinery spins up) ...
            self.stripe_cache.tenancy.set_share(name, dram_share, flash_share)
        kw.setdefault("tracer", self.tracer)
        try:
            sess = DPPSession(
                spec, self.warehouse.table(spec.table), name=name,
                on_stop=(
                    (lambda: self.stripe_cache.tenancy.clear_share(name))
                    if reserve else None
                ),
                tensor_cache=kw.pop("tensor_cache", self.tensor_cache), **kw,
            )
        except BaseException:
            if reserve:
                # ... but never leak the reservation if construction fails:
                # on_stop only runs for sessions that actually exist
                self.stripe_cache.tenancy.clear_share(name)
            raise
        self.sessions[name] = sess
        return sess

    def run_all(
        self, max_batches: Optional[int] = None, timeout_s: float = 120.0
    ) -> Dict[str, List[Dict[str, np.ndarray]]]:
        """Run every registered session to completion concurrently —
        the combo-window workload whose overlapping reads the shared
        cache collapses."""
        results: Dict[str, List[Dict[str, np.ndarray]]] = {}
        self.session_errors: Dict[str, SessionFailed] = {}

        def _drive(name: str, sess: DPPSession) -> None:
            try:
                results[name] = sess.run_to_completion(max_batches, timeout_s)
            except SessionFailed as e:
                # one tenant's poisoned data must not take down the fleet:
                # record the structured failure, keep the other sessions
                results[name] = []
                self.session_errors[name] = e

        threads = [
            threading.Thread(target=_drive, args=(n, s), daemon=True)
            for n, s in self.sessions.items()
        ]
        for t in threads:
            t.start()
        deadline = self._clock() + timeout_s
        for t in threads:
            t.join(max(0.0, deadline - self._clock()))
        # a wedged session past the deadline reports empty rather than
        # silently dropping its key
        for name in self.sessions:
            results.setdefault(name, [])
        return results

    def fleet_metrics(self) -> WorkerMetrics:
        total = WorkerMetrics()
        for s in self.sessions.values():
            total.merge(s.worker_metrics())
        return total

    def cache_summary(self) -> Dict[str, float]:
        return self.stripe_cache.summary() if self.stripe_cache else {}

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-job cache accounting (hits, resident bytes, evictions)."""
        return self.stripe_cache.tenant_summary() if self.stripe_cache else {}
