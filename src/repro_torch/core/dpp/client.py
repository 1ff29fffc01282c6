"""DPP Clients: trainer-side data plane (§3.2.1).

One Client per training node.  Exposes ``get_batch()`` (the hook the
training runtime calls); requests are routed to Workers with partitioned
round-robin so the number of connections per Client and per Worker stays
capped, and data-stall time (waiting on an empty buffer) is accounted —
the trainer-side metric behind Table 7.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.dpp.master import SessionState
from repro_torch.obs import NULL_TRACER, counter


@dataclasses.dataclass
class ClientMetrics:
    batches: int = counter()
    rx_bytes: int = counter()
    stall_s: float = counter(0.0)
    stalls: int = counter()
    wait_calls: int = counter()


class SessionFailed(RuntimeError):
    """The session reached a terminal ``FAILED`` state: every split was
    quarantined, so no batch will ever arrive.  Carries the Master's
    per-split failure reports (exception chains included) so the trainer
    logs the *cause* — a poisoned partition, a dead fleet — instead of a
    generic timeout."""

    def __init__(self, state: str, failures: Sequence) -> None:
        self.state = state
        self.failures = list(failures)     # List[SplitFailure]
        head = self.failures[0] if self.failures else None
        detail = (
            f"; first: split {head.split_id} (partition {head.partition}, "
            f"rows [{head.row_start}, {head.row_end})) after "
            f"{head.dispatches} dispatches — {head.last_error.strip().splitlines()[-1]}"
            if head else ""
        )
        super().__init__(
            f"DPP session {state}: {len(self.failures)} split(s) "
            f"quarantined{detail}"
        )


class DPPClient:
    def __init__(
        self,
        client_id: str,
        workers: Sequence,                 # List[DPPWorker]
        fanout: int = 4,                   # partitioned round-robin cap
        prefetcher=None,                   # optional PrefetchPlanner to poke
        master=None,                       # optional DPPMaster for state checks
        tenant: Optional[str] = None,      # owning session (span label)
        tracer=NULL_TRACER,                # span Tracer (obs layer)
    ):
        self.client_id = client_id
        self._all_workers = list(workers)
        self.fanout = fanout
        self.prefetcher = prefetcher
        self.master = master
        self.tenant = tenant
        self.tracer = tracer
        self.metrics = ClientMetrics()
        self._rr = 0
        # stable digest, NOT hash(): str hashing is randomized per process
        # by PYTHONHASHSEED, which would scramble the client->worker
        # partitioning across runs/restarts of the same trainer
        self._partition_offset = (
            zlib.crc32(client_id.encode()) % max(len(workers), 1)
        )

    def rebind(self, workers: Sequence) -> None:
        """Auto-scaling / worker restarts change the worker set."""
        self._all_workers = list(workers)

    def _my_workers(self) -> List:
        live = [w for w in self._all_workers if w.alive or w.buffered > 0]
        if not live:
            return []
        k = min(self.fanout, len(live))
        start = self._partition_offset % len(live)
        return [live[(start + i) % len(live)] for i in range(k)]

    def _note_stall(self) -> None:
        if self.prefetcher is not None:
            # starving trainer: accelerate cache warming immediately
            self.prefetcher.poke()

    def _check_failed(self) -> None:
        """A terminally-FAILED session will never produce another batch:
        raise the structured error now rather than burning the timeout.
        (DEGRADED sessions keep serving — their healthy splits drain.)
        Only called on the stall path, so the Master's lock is not taken
        on every hot-path sweep."""
        if self.master is None:
            return
        if self.master.state == SessionState.FAILED and not any(
            w.buffered for w in self._all_workers
        ):
            raise SessionFailed(
                SessionState.FAILED, self.master.failure_report()
            )

    def get_batch(
        self, timeout: float = 10.0
    ) -> Optional[Dict[str, np.ndarray]]:
        """Round-robin poll over this client's worker partition."""
        t0 = time.perf_counter()
        deadline = t0 + timeout
        stalled = False
        self.metrics.wait_calls += 1
        while time.perf_counter() < deadline:
            mine = self._my_workers()
            if not mine:
                time.sleep(0.005)
                stalled = True
                self._check_failed()
                self._note_stall()
                continue
            for i in range(len(mine)):
                w = mine[(self._rr + i) % len(mine)]
                batch = w.get_batch(timeout=0.0) if w.buffered else None
                if batch is None and w.alive:
                    batch = w.get_batch(timeout=0.002)
                if batch is not None:
                    self._rr = (self._rr + i + 1) % max(len(mine), 1)
                    self.metrics.batches += 1
                    self.metrics.rx_bytes += sum(a.nbytes for a in batch.values())
                    # data-stall time (Table 7) accrues ONLY when the
                    # trainer actually waited; a batch served on the first
                    # sweep is a zero-stall call, not stall time
                    if stalled:
                        self.metrics.stalls += 1
                        t_now = time.perf_counter()
                        self.metrics.stall_s += t_now - t0
                        if self.tracer.enabled:
                            self.tracer.record(
                                "client.stall", t0, t_now,
                                tenant=self.tenant or "",
                                client=self.client_id,
                            )
                    return batch
            stalled = True
            self._check_failed()
            self._note_stall()
        t_now = time.perf_counter()
        self.metrics.stall_s += t_now - t0
        self.metrics.stalls += 1
        if self.tracer.enabled:
            self.tracer.record(
                "client.stall", t0, t_now,
                tenant=self.tenant or "", client=self.client_id,
            )
        self._check_failed()
        return None
