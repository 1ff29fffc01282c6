"""DPP control plane: the Master (§3.2.1).

Responsibilities (paper-faithful):
  * break the preprocessing workload into self-contained **splits**
    (successive row ranges of the dataset) and serve them to Workers,
  * track split progress; re-dispatch splits whose lease expired
    (worker failure / straggler mitigation),
  * periodic **checkpoints** of reader state for restore-on-failure,
  * worker health monitoring (heartbeats) with automatic restart hooks.

Fleet sizing is NOT the Master's job here: the hysteresis-aware
feedback controller lives in ``repro_torch.core.dpp.autoscale`` and is
actuated by the ``DPPSession`` monitor.

Failure domains: every split carries a **dispatch budget**.
Completions are typed (``ok`` / ``worker_lost`` / ``data_error``) so the
Master can tell a preempted worker from poisoned data; a split that
exhausts its budget is **quarantined** instead of re-dispatched forever,
and the session reaches a terminal state (``COMPLETED`` / ``DEGRADED`` /
``FAILED``) that surfaces the offending split and its exception chain.
DSI jobs run for days across preemptible fleets — without budgets a
single bad split (e.g. mixed labeled/unlabeled stripes) livelocks the
whole session on worker restarts.

The Master itself is replicated in production; here `checkpoint()` /
`DPPMaster.restore()` provide the equivalent failover path.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.transforms import TransformPipeline, TransformSpec


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """The PyTorch-DataSet analogue shipped by FBLearner Flow."""

    table: str
    partitions: Tuple[int, ...]
    feature_ids: Tuple[int, ...]
    transform_specs: Tuple[TransformSpec, ...]
    batch_size: int = 512
    rows_per_split: int = 2048
    dense_keys: Tuple[str, ...] = ()
    sparse_keys: Tuple[str, ...] = ()
    max_ids_per_feature: int = 32

    def pipeline(self) -> TransformPipeline:
        return TransformPipeline(list(self.transform_specs))


@dataclasses.dataclass
class Split:
    split_id: int
    partition: int
    row_start: int
    row_end: int


@dataclasses.dataclass
class _Lease:
    worker_id: str
    deadline: float


# -- typed completion reports + failure domains --------------------

REPORT_OK = "ok"
REPORT_WORKER_LOST = "worker_lost"    # lease expiry / dead worker
REPORT_DATA_ERROR = "data_error"      # extract/transform raised on the data

REPORT_STATUSES = (REPORT_OK, REPORT_WORKER_LOST, REPORT_DATA_ERROR)


class SessionState:
    """Session-level states.  ``RUNNING`` is the only non-terminal one."""

    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"    # every split done
    DEGRADED = "DEGRADED"      # some splits quarantined, the rest done
    FAILED = "FAILED"          # every split quarantined — nothing produced

    TERMINAL = (COMPLETED, DEGRADED, FAILED)


@dataclasses.dataclass
class FailureReport:
    """One failed dispatch of a split."""

    status: str          # REPORT_WORKER_LOST | REPORT_DATA_ERROR
    worker_id: str
    error: str           # human-readable cause (traceback for data errors)


@dataclasses.dataclass
class SplitFailure:
    """A quarantined split: its identity plus the full exception chain."""

    split_id: int
    partition: int
    row_start: int
    row_end: int
    dispatches: int
    reports: List[FailureReport]

    @property
    def last_error(self) -> str:
        return self.reports[-1].error if self.reports else ""

    @property
    def statuses(self) -> List[str]:
        return [r.status for r in self.reports]


class DPPMaster:
    def __init__(
        self,
        spec: SessionSpec,
        partition_rows: Dict[int, int],
        lease_s: float = 30.0,
        partition_stripe_rows: Optional[Dict[int, int]] = None,
        dispatch_budget: int = 3,
        clock: Callable[[], float] = time.time,
    ):
        self.spec = spec
        self.lease_s = lease_s
        # injected clock (REPRO-C001): lease expiry / heartbeat tests can
        # drive time deterministically instead of sleeping
        self._clock = clock
        self.dispatch_budget = max(1, dispatch_budget)
        self._lock = threading.Lock()
        self._splits: Dict[int, Split] = {}
        self._pending: List[int] = []
        self._leased: Dict[int, _Lease] = {}
        self._done: set = set()
        self._dispatches: Dict[int, int] = {}     # split -> times leased
        self._failures: Dict[int, List[FailureReport]] = {}
        self._quarantined: Dict[int, SplitFailure] = {}
        self._workers: Dict[str, float] = {}      # worker_id -> last heartbeat
        self._restarts: List[str] = []
        self._stripe_rows = dict(partition_stripe_rows or {})
        self._build_splits(partition_rows)

    def _build_splits(self, partition_rows: Dict[int, int]) -> None:
        """Emit stripe-aligned splits: rows_per_split is rounded up to a
        multiple of the partition's stripe size so a split's row range maps
        onto whole stripes and a worker never decodes rows it throws away."""
        sid = 0
        for p in self.spec.partitions:
            rows = partition_rows[p]
            step = self.spec.rows_per_split
            stripe = self._stripe_rows.get(p, 0)
            if stripe > 0:
                step = max(1, -(-step // stripe)) * stripe
            for start in range(0, rows, step):
                end = min(start + step, rows)
                self._splits[sid] = Split(sid, p, start, end)
                self._pending.append(sid)
                sid += 1

    # -- work distribution ---------------------------------------------------

    def get_split(self, worker_id: str) -> Optional[Split]:
        with self._lock:
            self._workers[worker_id] = self._clock()
            self._reclaim_expired_locked()
            if not self._pending:
                return None
            sid = self._pending.pop(0)
            self._dispatches[sid] = self._dispatches.get(sid, 0) + 1
            self._leased[sid] = _Lease(worker_id, self._clock() + self.lease_s)
            return self._splits[sid]

    def peek_pending(self, n: int) -> List[Split]:
        """The next ``n`` not-yet-leased splits, in dispatch order — the
        prefetch planner's window onto upcoming work (read-only: peeking
        does not lease)."""
        with self._lock:
            return [self._splits[sid] for sid in self._pending[:n]]

    def complete_split(
        self,
        worker_id: str,
        split_id: int,
        status: str = REPORT_OK,
        error: Optional[str] = None,
    ) -> None:
        """Typed completion report.  ``ok`` marks the split done;
        ``data_error`` (the worker's extract/transform raised on the
        split's bytes — deterministic, so retrying on another worker only
        helps against transient corruption) and ``worker_lost`` charge the
        split's dispatch budget and either re-queue or quarantine it.

        Reports are validated against lease ownership: a failure report
        from a *superseded* dispatch (its lease already expired and was
        charged ``worker_lost`` at reclaim) is ignored rather than
        double-charging the budget and cancelling the current holder's
        lease.  A late ``ok`` is always accepted — the work is done,
        whoever finished it."""
        if status not in REPORT_STATUSES:
            raise ValueError(f"unknown completion status: {status!r}")
        with self._lock:
            lease = self._leased.get(split_id)
            owns = lease is not None and lease.worker_id == worker_id
            if status == REPORT_OK:
                if owns:
                    del self._leased[split_id]
                # a late ok un-quarantines: the split's batches WERE
                # produced and delivered (e.g. a worker that out-slept its
                # budget's worth of lease expiries but finished anyway), so
                # reporting it failed would mislabel delivered data
                self._quarantined.pop(split_id, None)
                self._done.add(split_id)
                if split_id in self._pending:
                    self._pending.remove(split_id)
                return
            if split_id in self._done or split_id in self._quarantined:
                if owns:
                    del self._leased[split_id]
                return
            if not owns:
                return
            del self._leased[split_id]
            self._record_failure_locked(
                split_id, status, worker_id, error or status
            )

    def _record_failure_locked(
        self, sid: int, status: str, worker_id: str, error: str
    ) -> None:
        """Charge one failed dispatch; re-queue under budget, else
        quarantine (never re-dispatched — the anti-livelock invariant)."""
        self._failures.setdefault(sid, []).append(
            FailureReport(status=status, worker_id=worker_id, error=error)
        )
        if self._dispatches.get(sid, 0) >= self.dispatch_budget:
            sp = self._splits[sid]
            self._quarantined[sid] = SplitFailure(
                split_id=sid, partition=sp.partition,
                row_start=sp.row_start, row_end=sp.row_end,
                dispatches=self._dispatches.get(sid, 0),
                reports=list(self._failures[sid]),
            )
            if sid in self._pending:
                self._pending.remove(sid)
        elif sid not in self._pending:
            self._pending.insert(0, sid)

    def _reclaim_expired_locked(self) -> None:
        now = self._clock()
        expired = [sid for sid, l in self._leased.items() if l.deadline < now]
        for sid in expired:
            # straggler mitigation / failure handling: a silent lease expiry
            # is a lost worker — typed so it charges the dispatch budget
            lease = self._leased.pop(sid)
            if sid not in self._done:
                self._record_failure_locked(
                    sid, REPORT_WORKER_LOST, lease.worker_id,
                    f"lease expired after {self.lease_s}s "
                    f"(worker {lease.worker_id} lost or straggling)",
                )

    @property
    def progress(self) -> Tuple[int, int]:
        with self._lock:
            return len(self._done), len(self._splits)

    @property
    def finished(self) -> bool:
        """Terminal: every split is either done or quarantined.  (Without
        counting quarantine a poisoned split would keep ``finished`` False
        forever — the livelock this redesign removes.)"""
        with self._lock:
            return (
                len(self._done) + len(self._quarantined) >= len(self._splits)
            )

    # -- session state + failure surfacing -------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            total = len(self._splits)
            if len(self._done) + len(self._quarantined) < total:
                return SessionState.RUNNING
            if not self._quarantined:
                return SessionState.COMPLETED
            return (
                SessionState.FAILED if not self._done else SessionState.DEGRADED
            )

    @property
    def quarantined(self) -> Dict[int, SplitFailure]:
        with self._lock:
            return dict(self._quarantined)

    def failure_report(self) -> List[SplitFailure]:
        """Quarantined splits with their full per-dispatch exception chain,
        in split order — what ``SessionFailed`` carries to the trainer."""
        with self._lock:
            return [self._quarantined[s] for s in sorted(self._quarantined)]

    # -- health / fault tolerance ---------------------------------------------

    def heartbeat(self, worker_id: str) -> None:
        """Liveness signal from a worker mid-ETL.  Extends the worker's
        lease deadlines: a slow-but-alive worker (long split, back-pressured
        buffer) must not be charged ``worker_lost`` against its split's
        dispatch budget.  A genuinely lost worker stops heartbeating, so
        straggler re-dispatch still fires on real failures.  (``get_split``
        deliberately does NOT extend leases — only active processing does.)"""
        now = self._clock()
        with self._lock:
            self._workers[worker_id] = now
            for l in self._leased.values():
                if l.worker_id == worker_id:
                    l.deadline = now + self.lease_s

    def dead_workers(self, timeout_s: float = 10.0) -> List[str]:
        now = self._clock()
        with self._lock:
            return [w for w, t in self._workers.items() if now - t > timeout_s]

    def forget_worker(self, worker_id: str) -> None:
        """Worker died: release its leases immediately (stateless workers —
        no checkpoint restore needed, §3.2.1).  Each released lease is a
        typed ``worker_lost`` failure charged to the split's budget."""
        with self._lock:
            self._workers.pop(worker_id, None)
            for sid, l in list(self._leased.items()):
                if l.worker_id == worker_id:
                    del self._leased[sid]
                    if sid not in self._done:
                        self._record_failure_locked(
                            sid, REPORT_WORKER_LOST, worker_id,
                            f"worker {worker_id} died holding the lease",
                        )
            self._restarts.append(worker_id)

    # -- checkpointing -----------------------------------------------------------

    def checkpoint(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "spec": self.spec,
                "done": sorted(self._done),
                "n_splits": len(self._splits),
                "stripe_rows": dict(self._stripe_rows),
                "dispatches": dict(self._dispatches),
                "quarantined": [
                    dataclasses.asdict(f) for f in self._quarantined.values()
                ],
                # failure history of splits still under budget: a restored
                # Master must quarantine with the FULL report chain, not
                # just the reports accumulated after failover
                "failures": {
                    sid: [dataclasses.asdict(r) for r in reports]
                    for sid, reports in self._failures.items()
                    if sid not in self._quarantined
                },
            }

    @classmethod
    def restore(
        cls,
        ckpt: Dict[str, Any],
        partition_rows: Dict[int, int],
        lease_s: float = 30.0,
        dispatch_budget: int = 3,
        clock: Callable[[], float] = time.time,
    ) -> "DPPMaster":
        m = cls(
            ckpt["spec"], partition_rows, lease_s=lease_s,
            partition_stripe_rows=ckpt.get("stripe_rows"),
            dispatch_budget=dispatch_budget,
            clock=clock,
        )
        with m._lock:
            for sid in ckpt["done"]:
                m._done.add(sid)
                if sid in m._pending:
                    m._pending.remove(sid)
            m._dispatches.update(ckpt.get("dispatches", {}))
            for sid, reports in ckpt.get("failures", {}).items():
                m._failures[sid] = [FailureReport(**r) for r in reports]
            for f in ckpt.get("quarantined", ()):
                sf = SplitFailure(
                    split_id=f["split_id"], partition=f["partition"],
                    row_start=f["row_start"], row_end=f["row_end"],
                    dispatches=f["dispatches"],
                    reports=[FailureReport(**r) for r in f["reports"]],
                )
                m._quarantined[sf.split_id] = sf
                m._failures[sf.split_id] = list(sf.reports)
                if sf.split_id in m._pending:
                    m._pending.remove(sf.split_id)
        return m
