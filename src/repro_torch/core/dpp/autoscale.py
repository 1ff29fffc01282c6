"""Feedback-driven elastic scaling for the DPP fleet.

InTune's core observation (Nagrecha et al., 2023): static preprocessing
provisioning either starves the trainer (data stalls) or wastes fleet
CPU, because the right worker count depends on the *observed* balance
between produce and consume rates.  The controller closes that loop:

  * **signal** — the clients' stall *rate* (stalled ``get_batch`` calls
    per wait call since the last tick) plus the fleet's buffered-batch
    queue depth.  Stall rate is the trainer-side truth (Table 7);
    queue depth is the leading indicator (an empty buffer means the next
    call stalls).
  * **knobs** — the worker count (launch / drain) and the
    ``PrefetchPlanner`` depth (how many upcoming splits are cache-warmed
    ahead of the workers), so scale-ups both add transform capacity and
    pull storage I/O further off the critical path.
  * **hysteresis** — a knob only moves after ``hysteresis_ticks``
    consecutive ticks of pressure (or idleness), and every action is
    followed by ``cooldown_ticks`` of no-ops so the fleet settles before
    being measured again.  A single transient stall therefore never
    thrashes the pool.

The controller is deliberately pure/deterministic given its observation
stream — the ``DPPSession`` monitor owns the clock and actuation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Thresholds + gains for the feedback loop."""

    stall_rate_high: float = 0.05    # stalled fraction that means pressure
    queue_low: int = 2               # buffered batches: below = pressure
    queue_high: int = 32             # above (plus idle CPU) = over-provisioned
    util_low: float = 0.3            # drain only when workers are this idle
    scale_up_frac: float = 0.5       # grow by 50% of the fleet (min 1)
    scale_down_frac: float = 0.25    # shrink by 25% of the fleet (min 1)
    min_workers: int = 1
    max_workers: int = 16
    hysteresis_ticks: int = 2        # consecutive ticks before acting
    cooldown_ticks: int = 3          # settle time after every action
    prefetch_depth_min: int = 2
    prefetch_depth_max: int = 32


@dataclasses.dataclass(frozen=True)
class Observation:
    """One monitor tick's view of the session."""

    n_workers: int
    buffered_batches: int
    stall_rate: float                # stalled get_batch fraction this tick
    cpu_util: float                  # fleet busy_s / wall


@dataclasses.dataclass(frozen=True)
class Decision:
    worker_delta: int                # +launch / -drain / 0
    prefetch_depth: Optional[int]    # None = leave the planner alone
    reason: str


def observation_from_delta(delta: Dict[str, float],
                           interval_s: float) -> Observation:
    """Build one tick's ``Observation`` from a registry snapshot delta
    (``Snapshot.delta(prev)``) — counters arrive as per-tick differences,
    gauges as current levels.

    The formulas are exactly the session monitor's original inline
    polling arithmetic, so a controller fed registry deltas emits
    byte-for-byte the same decisions as the PR-4 heuristics (regression
    test in ``tests/test_obs.py``).  Expected names: counters
    ``client.stalls`` / ``client.wait_calls`` / ``fleet.busy_s``, gauges
    ``fleet.buffered_batches`` / ``fleet.active_workers``.
    """
    active = int(delta.get("fleet.active_workers", 0))
    d_waits = max(int(delta.get("client.wait_calls", 0)), 1)
    stall_rate = max(int(delta.get("client.stalls", 0)), 0) / d_waits
    wall = max(interval_s, 1e-6) * max(active, 1)
    cpu_util = min(max(delta.get("fleet.busy_s", 0.0), 0.0) / wall, 1.0)
    return Observation(
        n_workers=active,
        buffered_batches=int(delta.get("fleet.buffered_batches", 0)),
        stall_rate=stall_rate,
        cpu_util=cpu_util,
    )


class ElasticController:
    """Hysteresis-aware scaler: consumes ``Observation``s, emits
    ``Decision``s.  Stateful (tick counters + current prefetch depth) but
    side-effect free — actuation belongs to the session monitor."""

    # single-threaded by contract: only the session monitor thread calls
    # observe(); other threads at most read `depth` (GIL-atomic int), so
    # none of this state takes a lock (REPRO-R001 / racedep allowlist)
    _unshared = ("depth", "_pressure_ticks", "_idle_ticks", "_cooldown")

    def __init__(self, policy: Optional[ElasticPolicy] = None,
                 prefetch_depth: int = 4):
        self.policy = policy or ElasticPolicy()
        self.depth = max(self.policy.prefetch_depth_min,
                         min(prefetch_depth, self.policy.prefetch_depth_max))
        self._pressure_ticks = 0
        self._idle_ticks = 0
        self._cooldown = 0
        self.decisions: List[Decision] = []    # audit trail for benchmarks

    # -- signal classification -------------------------------------------------

    def _under_pressure(self, obs: Observation) -> bool:
        return (
            obs.stall_rate > self.policy.stall_rate_high
            or obs.buffered_batches < self.policy.queue_low
        )

    def _over_provisioned(self, obs: Observation) -> bool:
        return (
            obs.stall_rate == 0.0
            and obs.buffered_batches > self.policy.queue_high
            and obs.cpu_util < self.policy.util_low
            and obs.n_workers > self.policy.min_workers
        )

    # -- the loop --------------------------------------------------------------

    def observe(self, obs: Observation) -> Decision:
        p = self.policy
        if self._under_pressure(obs):
            self._pressure_ticks += 1
            self._idle_ticks = 0
        elif self._over_provisioned(obs):
            self._idle_ticks += 1
            self._pressure_ticks = 0
        else:
            self._pressure_ticks = self._idle_ticks = 0

        if self._cooldown > 0:
            # settle after the last action; signals keep accumulating so a
            # persistent stall acts the tick the cooldown expires
            self._cooldown -= 1
            return self._emit(Decision(0, None, "cooldown"))

        if self._pressure_ticks >= p.hysteresis_ticks:
            self._pressure_ticks = 0
            self._cooldown = p.cooldown_ticks
            delta = min(
                max(1, int(p.scale_up_frac * obs.n_workers)),
                p.max_workers - obs.n_workers,
            )
            self.depth = min(self.depth * 2, p.prefetch_depth_max)
            return self._emit(Decision(
                max(delta, 0), self.depth,
                f"pressure: stall_rate={obs.stall_rate:.3f} "
                f"buffered={obs.buffered_batches}",
            ))

        if self._idle_ticks >= p.hysteresis_ticks:
            self._idle_ticks = 0
            self._cooldown = p.cooldown_ticks
            delta = min(
                max(1, int(p.scale_down_frac * obs.n_workers)),
                obs.n_workers - p.min_workers,
            )
            self.depth = max(self.depth // 2, p.prefetch_depth_min)
            return self._emit(Decision(
                -max(delta, 0), self.depth,
                f"idle: buffered={obs.buffered_batches} "
                f"util={obs.cpu_util:.2f}",
            ))

        return self._emit(Decision(0, None, "steady"))

    def _emit(self, d: Decision) -> Decision:
        if d.worker_delta != 0:
            self.decisions.append(d)
        return d
