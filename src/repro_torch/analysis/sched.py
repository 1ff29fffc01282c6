"""Deterministic interleaving explorer ("sched") for the port's DPP control
plane.

``lockdep`` proves lock *orderings* are consistent and ``racedep``
proves shared attributes *have* a lockset — but a controller can hold
every lock correctly and still be wrong under an unlucky schedule:
check-then-act windows (read under the lock, act after dropping it),
lost updates, a lease expiring between a worker's delivery and its
completion report.  Those are *atomicity* bugs; finding them requires
actually running the interesting interleavings, deterministically.

Mechanism: a cooperative scheduler serializes a small set of scenario
threads at **sync points** — lock acquire/release (``threading.Lock`` /
``RLock`` constructed by repo modules are swapped for cooperative
:class:`SchedLock`\\ s, reusing lockdep's construction-site naming),
``queue.Queue.put``/``get``, and explicit :func:`yield_point` markers.
Between sync points exactly one thread runs; at each point the
scheduler picks which thread proceeds.  Exhaustively enumerating those
picks (depth-first over the decision tree, replaying a forced prefix
each run against a fresh ``scenario.setup()``) visits every bounded
interleaving, and ``scenario.check`` asserts the subsystem invariant
after each one.  A schedule in which no runnable thread exists is a
real deadlock and is reported with the full decision trace.

DPOR-lite: schedules that only reorder *commuting* operations (ops on
different locks/queues/yield tags) are pruned with Godefroid-style
**sleep sets** — after exploring thread ``t`` first at a decision
point, sibling branches keep ``t`` asleep until some executed op
conflicts with ``t``'s pending op; a branch that completes with a
thread still uselessly asleep is a Mazurkiewicz-equivalent replay of an
explored schedule and is abandoned (counted in ``Exploration.pruned``).
The reduction is sound: every equivalence class of schedules is still
visited.

Writing scenarios (see the subclasses below and
``docs/static_analysis.md``):

  * ``setup()`` builds fresh subsystem state on ``self.device`` — runs
    uncontrolled on the main thread, once per schedule;
  * ``threads(state)`` returns 2–3 argless callables, each a few sync
    points long (schedules grow exponentially in sync-point count);
  * plain attribute reads/writes are invisible to the scheduler — mark
    a racy window explicitly with ``yield_point("tag")``; ops sharing a
    tag are treated as conflicting, ops on distinct tags commute;
  * ``check(state)`` asserts the invariant; an ``AssertionError``
    (there, or in a thread body) surfaces as :class:`ScheduleError`
    carrying the exact schedule that broke it;
  * avoid blocking waits the scheduler cannot see (``Event.wait``,
    timeout-ful queue gets) — the scheduler aborts a run whose thread
    stays off a sync point for 10s.

CLI gate (wired into ``scripts/ci_torch.sh`` with ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.analysis.sched            # on the card
    PYTHONPATH=src python -m repro_torch.analysis.sched --device cpu
    PYTHONPATH=src python -m repro_torch.analysis.sched --list
    PYTHONPATH=src python -m repro_torch.analysis.sched -k lease --device cpu

The device defaults to ``cuda``, as every entry point of the port does,
and never falls back: without a card and without ``--device cpu`` the
run fails.
"""
from __future__ import annotations

import _thread
import argparse
import dataclasses
import queue as queue_mod
import sys
import threading
import traceback
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

Op = Tuple[str, str]   # (kind, resource-name)

# Construction sites whose locks become cooperative SchedLocks (the same
# file set the sanitizer fixtures track): repo modules only —
# threading/queue internals must stay real locks.
_REPO_LOCK_FILES = (
    "stripe_cache.py", "tectonic.py", "master.py", "worker.py",
    "service.py", "client.py", "prefetch.py", "tensor_cache.py",
    "dedup.py", "warehouse.py", "autoscale.py", "engine.py", "trainer.py",
)

_STDLIB_LOCK_FILES = ("threading.py", "queue.py")


class ScheduleError(AssertionError):
    """A schedule deadlocked, broke an invariant, or wedged the scheduler."""


class _AbortRun(BaseException):
    """Unwinds controlled threads when a schedule is abandoned."""


class _Gate:
    """One-shot handoff on a raw ``_thread`` lock (immune to patching)."""

    def __init__(self) -> None:
        self._lk = _thread.allocate_lock()
        self._lk.acquire()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            self._lk.acquire()
            return True
        return self._lk.acquire(timeout=timeout)

    def set(self) -> None:
        try:
            self._lk.release()
        except RuntimeError:
            pass   # already open (benign during abort teardown)


@dataclasses.dataclass
class _CThread:
    name: str
    gate: _Gate
    pending: Optional[Op] = None
    finished: bool = False
    error: Optional[BaseException] = None
    tb: str = ""
    thread: Optional[threading.Thread] = None


class SchedLock:
    """Cooperative stand-in for ``threading.Lock``/``RLock``.

    Needs no real mutual exclusion: controlled threads run one at a
    time between sync points, and uncontrolled phases (setup / check on
    the main thread) are single-threaded by construction.  ``acquire``
    from a controlled thread syncs first — the scheduler only schedules
    it once the lock is free — so the actual take never contends.
    """

    _MAIN = object()   # owner sentinel for uncontrolled (setup) phases

    def __init__(self, sched: "Scheduler", name: str, reentrant: bool):
        self._sched = sched
        self.name = name
        self.reentrant = reentrant
        self.owner: Optional[object] = None
        self.count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = self._sched._current() or SchedLock._MAIN
        if self.reentrant and self.owner is me:
            self.count += 1
            return True
        if not blocking and self.owner is not None:
            return False
        if me is SchedLock._MAIN:
            if self.owner is not None:
                raise ScheduleError(
                    f"sched: lock {self.name} acquired from outside the "
                    "scheduler while a controlled thread holds it"
                )
        else:
            self._sched.sync(("acquire", self.name))
        self.owner = me
        self.count = 1
        return True

    def release(self) -> None:
        if self.count <= 0:
            raise RuntimeError(f"release of unheld SchedLock {self.name}")
        self.count -= 1
        if self.count == 0:
            self.owner = None
            if self._sched._current() is not None:
                self._sched.sync(("release", self.name))

    def locked(self) -> bool:
        return self.owner is not None

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@dataclasses.dataclass
class _Node:
    """One decision point on the DFS trail."""

    enabled: Tuple[str, ...]             # thread names enabled here
    sleep_entry: frozenset               # sleep set on entry to the node
    explored: List[str]                  # choices already fully explored
    choice: str                          # choice for the current branch


def _resource(op: Optional[Op]) -> Optional[Tuple[str, str]]:
    if op is None:
        return None
    kind, name = op
    if kind in ("acquire", "release"):
        return ("lock", name)
    if kind in ("queue.put", "queue.get"):
        return ("queue", name)
    if kind == "yield":
        return ("yield", name)
    return None                           # "start": touches nothing shared


def _independent(a: Optional[Op], b: Optional[Op]) -> bool:
    ra, rb = _resource(a), _resource(b)
    return ra is None or rb is None or ra != rb


class Scheduler:
    """Drives controlled threads one sync-point step at a time."""

    def __init__(self) -> None:
        self._threads: List[_CThread] = []
        self._control = _Gate()
        self._tls = threading.local()
        self._locks: Dict[str, SchedLock] = {}
        self._lockseq = 0
        self._queues: Dict[str, "queue_mod.Queue"] = {}
        self._queue_names: Dict[int, str] = {}
        self._aborting = False
        self.trace: List[Tuple[str, Op]] = []

    # -- controlled-thread side ----------------------------------------------

    def _current(self) -> Optional[_CThread]:
        return getattr(self._tls, "me", None)

    def sync(self, op: Op) -> None:
        me = self._current()
        me.pending = op
        self._control.set()
        me.gate.wait()
        me.pending = None
        if self._aborting:
            raise _AbortRun()

    def spawn(self, name: str, fn: Callable[[], None]) -> None:
        ct = _CThread(name=name, gate=_Gate())

        def wrapper() -> None:
            self._tls.me = ct
            ct.gate.wait()
            try:
                if not self._aborting:
                    fn()
            except _AbortRun:
                pass
            except BaseException as e:   # surfaced by the scheduler
                ct.error = e
                ct.tb = traceback.format_exc()
            finally:
                ct.finished = True
                self._control.set()

        ct.pending = ("start", name)
        ct.thread = threading.Thread(target=wrapper, name=name, daemon=True)
        self._threads.append(ct)
        ct.thread.start()

    # -- lock / queue registration -------------------------------------------

    def make_lock(self, site: str, reentrant: bool) -> SchedLock:
        self._lockseq += 1
        lk = SchedLock(self, f"{site}#{self._lockseq}", reentrant)
        self._locks[lk.name] = lk
        return lk

    def queue_id(self, q: "queue_mod.Queue") -> str:
        name = self._queue_names.get(id(q))
        if name is None:
            name = f"queue#{len(self._queue_names)}"
            self._queue_names[id(q)] = name
            self._queues[name] = q
        return name

    # -- scheduler side -------------------------------------------------------

    def _enabled(self, op: Optional[Op]) -> bool:
        if op is None:
            return False
        kind, name = op
        if kind == "acquire":
            return self._locks[name].owner is None
        if kind == "queue.put":
            q = self._queues[name]
            return q.maxsize <= 0 or q.qsize() < q.maxsize
        if kind == "queue.get":
            return self._queues[name].qsize() > 0
        return True

    def _by_name(self, name: str) -> Optional[_CThread]:
        for t in self._threads:
            if t.name == name:
                return t
        return None

    def _fmt_trace(self) -> str:
        return "\n".join(f"    {i:3d}. {name}: {op[0]}({op[1]})"
                         for i, (name, op) in enumerate(self.trace))

    def drive(self, trail: List[_Node], max_steps: int) -> str:
        """Run one schedule; extends ``trail`` past the forced prefix.
        Returns ``"completed"`` or ``"redundant"`` (sleep-set pruned)."""
        d = 0
        sleep: Set[str] = set()
        while True:
            live = [t for t in self._threads if not t.finished]
            if not live:
                return "completed"
            enabled = [t for t in live if self._enabled(t.pending)]
            if not enabled:
                waits = "; ".join(
                    f"{t.name} blocked at {t.pending[0]}({t.pending[1]})"
                    for t in live)
                raise ScheduleError(
                    "sched: DEADLOCK — no runnable thread: "
                    f"{waits}\n  schedule so far:\n{self._fmt_trace()}")
            if d >= max_steps:
                raise ScheduleError(
                    f"sched: schedule exceeded max_steps={max_steps} "
                    f"(livelock?)\n{self._fmt_trace()}")
            if d < len(trail):               # replay the forced prefix
                node = trail[d]
                sleep = set(node.sleep_entry) | set(node.explored)
                t = self._by_name(node.choice)
                if t is None or t not in enabled:
                    raise ScheduleError(
                        "sched: nondeterministic replay — thread "
                        f"{node.choice} not enabled at step {d}; scenario "
                        "setup/threads must be deterministic")
            else:
                candidates = [t for t in enabled if t.name not in sleep]
                if not candidates:
                    return "redundant"       # equivalent schedule explored
                t = candidates[0]
                trail.append(_Node(
                    enabled=tuple(x.name for x in enabled),
                    sleep_entry=frozenset(sleep),
                    explored=[], choice=t.name,
                ))
            op = t.pending
            self.trace.append((t.name, op))
            # a sleeping thread wakes when a conflicting op executes
            sleep = {s for s in sleep
                     if not self._woken_by(s, op)}
            t.gate.set()
            if not self._control.wait(timeout=10.0):
                raise ScheduleError(
                    f"sched: thread {t.name} did not reach a sync point "
                    "within 10s — blocking wait the scheduler cannot see? "
                    f"(Event.wait, timeout queue get)\n{self._fmt_trace()}")
            d += 1

    def _woken_by(self, sleeper: str, op: Op) -> bool:
        t = self._by_name(sleeper)
        if t is None or t.finished:
            return True
        return not _independent(t.pending, op)

    def abort_run(self) -> None:
        """Unwind remaining threads of an abandoned schedule."""
        self._aborting = True
        for _ in range(1000):
            live = [t for t in self._threads if not t.finished]
            if not live:
                return
            for t in live:
                t.gate.set()
            self._control.wait(timeout=0.5)


_ACTIVE: Optional[Scheduler] = None


def yield_point(tag: str = "yield") -> None:
    """Explicit sync point marking a shared access the scheduler cannot
    otherwise see.  No-op outside a controlled run or on the main thread,
    so production code *could* carry permanent yield points for free."""
    s = _ACTIVE
    if s is not None and s._current() is not None:
        s.sync(("yield", tag))


def _default_name_filter(site: str) -> bool:
    return site.startswith(_REPO_LOCK_FILES)


@contextmanager
def controlled(name_filter: Optional[Callable[[str], bool]] = None):
    """Patch ``threading.Lock``/``RLock`` and ``queue.Queue.put``/``get``
    so repo-constructed locks and all queue traffic from controlled
    threads become scheduler sync points.  Yields the :class:`Scheduler`."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("sched.controlled() does not nest")
    sched = Scheduler()
    flt = name_filter or _default_name_filter
    real_lock, real_rlock = threading.Lock, threading.RLock
    orig_put, orig_get = queue_mod.Queue.put, queue_mod.Queue.get

    def _factory(reentrant: bool, real):
        def make():
            f = sys._getframe(1)
            fname = Path(f.f_code.co_filename).name
            site = f"{fname}:{f.f_lineno}"
            # threading/queue internals (Event, Condition, Queue.mutex)
            # must stay real whatever the filter says: they synchronize
            # thread bootstrap, which runs outside scheduler control
            if fname in _STDLIB_LOCK_FILES or not flt(site):
                return real()
            return sched.make_lock(site, reentrant)
        return make

    def put(self, item, block=True, timeout=None):
        s = _ACTIVE
        if s is not None and s._current() is not None:
            s.sync(("queue.put", s.queue_id(self)))
            return orig_put(self, item, block=False)
        return orig_put(self, item, block, timeout)

    def get(self, block=True, timeout=None):
        s = _ACTIVE
        if s is not None and s._current() is not None:
            s.sync(("queue.get", s.queue_id(self)))
            return orig_get(self, block=False)
        return orig_get(self, block, timeout)

    threading.Lock = _factory(False, real_lock)     # type: ignore[misc]
    threading.RLock = _factory(True, real_rlock)    # type: ignore[misc]
    queue_mod.Queue.put = put                       # type: ignore[assignment]
    queue_mod.Queue.get = get                       # type: ignore[assignment]
    _ACTIVE = sched
    try:
        yield sched
    finally:
        _ACTIVE = None
        threading.Lock = real_lock                  # type: ignore[misc]
        threading.RLock = real_rlock                # type: ignore[misc]
        queue_mod.Queue.put = orig_put              # type: ignore[assignment]
        queue_mod.Queue.get = orig_get              # type: ignore[assignment]


# -- exploration --------------------------------------------------------------


class Scenario:
    """A bounded interleaving scenario: fresh state, 2–3 short threads,
    one invariant checked after every schedule.  ``device`` is where the
    scenario's engines run (``cuda`` or ``cpu``)."""

    name = "unnamed scenario"

    def __init__(self, device: str = "cuda"):
        self.device = device

    def setup(self):
        raise NotImplementedError

    def threads(self, state) -> Sequence[Callable[[], None]]:
        raise NotImplementedError

    def check(self, state) -> None:
        pass


@dataclasses.dataclass
class Exploration:
    scenario: str
    schedules: int        # distinct (non-equivalent) schedules checked
    pruned: int           # sleep-set-abandoned redundant branches
    exhausted: bool       # False iff max_schedules stopped us early


def _run_once(scenario: Scenario, trail: List[_Node], max_steps: int,
              name_filter) -> str:
    with controlled(name_filter) as sched:
        state = scenario.setup()
        fns = scenario.threads(state)
        for i, fn in enumerate(fns):
            sched.spawn(f"T{i}", fn)
        try:
            status = sched.drive(trail, max_steps)
        except ScheduleError:
            sched.abort_run()
            raise
        if status == "redundant":
            sched.abort_run()
            return status
        bad = next((t for t in sched._threads if t.error is not None), None)
        if bad is not None:
            raise ScheduleError(
                f"sched: thread {bad.name} raised in scenario "
                f"'{scenario.name}' under schedule:\n{sched._fmt_trace()}\n"
                f"{bad.tb}")
        try:
            scenario.check(state)
        except AssertionError as e:
            raise ScheduleError(
                f"sched: invariant broken in scenario '{scenario.name}' "
                f"under schedule:\n{sched._fmt_trace()}\n  {e}") from e
    return "completed"


def explore(scenario: Scenario, max_schedules: int = 2000,
            max_steps: int = 500, name_filter=None) -> Exploration:
    """Exhaustively explore ``scenario``'s bounded interleavings, checking
    the invariant after each.  Raises :class:`ScheduleError` on the first
    schedule that deadlocks or breaks the invariant."""
    trail: List[_Node] = []
    schedules = pruned = 0
    while True:
        status = _run_once(scenario, trail, max_steps, name_filter)
        if status == "completed":
            schedules += 1
        else:
            pruned += 1
        if schedules + pruned >= max_schedules:
            return Exploration(scenario.name, schedules, pruned,
                               exhausted=False)
        while trail:   # backtrack to the deepest node with untried options
            node = trail[-1]
            node.explored.append(node.choice)
            nxt = [n for n in node.enabled
                   if n not in node.sleep_entry and n not in node.explored]
            if nxt:
                node.choice = nxt[0]
                break
            trail.pop()
        if not trail:
            return Exploration(scenario.name, schedules, pruned,
                               exhausted=True)


# -- the gate's scenario set --------------------------------------------------
#
# Each targets one coordination seam the control plane depends on; all
# must hold under EVERY bounded interleaving. Keep thread bodies short:
# schedules grow exponentially with sync-point count.


class CompleteVsLeaseExpiry(Scenario):
    """``complete_split`` racing a lease-expiry reclaim + redispatch.

    The split was leased to w1 and the lease has expired.  w1's (late)
    ``ok`` report races w2's ``get_split`` which reclaims the lease and
    may redispatch.  Whatever the order: the session must end COMPLETED
    with the split done exactly once and nothing quarantined."""

    name = "master: complete_split vs lease-expiry redispatch"

    def setup(self):
        from repro_torch.core.dpp.master import DPPMaster, SessionSpec

        now = [100.0]
        spec = SessionSpec(table="t", partitions=(0,), feature_ids=(0,),
                           transform_specs=(), rows_per_split=64)
        m = DPPMaster(spec, {0: 64}, lease_s=1.0, clock=lambda: now[0])
        s = m.get_split("w1")
        assert s is not None and s.split_id == 0
        now[0] += 10.0                      # w1's lease is now expired
        return m

    def threads(self, m):
        def late_finisher():
            m.complete_split("w1", 0)

        def redispatcher():
            s = m.get_split("w2")            # reclaims the expired lease
            if s is not None:
                yield_point("w2-processing")
                m.complete_split("w2", s.split_id)

        return [late_finisher, redispatcher]

    def check(self, m):
        assert m.finished, f"split lost: state={m.state} progress={m.progress}"
        assert m.state == "COMPLETED", m.state
        assert not m.quarantined, m.quarantined
        done, total = m.progress
        assert (done, total) == (1, 1), (done, total)


class AdmitVsInvalidate(Scenario):
    """``StripeCache.admit`` of a pre-rewrite read racing
    ``invalidate_path`` for the rewrite.

    A reader resolved a path-addressed key, went to storage, and admits
    the (stale) bytes while the rewriter invalidates the path.  Whatever
    the order: post-rewrite resolution must yield a new-generation key
    that can never hit the stale entry."""

    name = "stripe-cache: admit vs invalidate_path after rewrite"

    def setup(self):
        from repro_torch.core.cache.stripe_cache import StripeCache

        cache = StripeCache(dram_capacity_bytes=1 << 20)
        state = {
            "cache": cache,
            "old_key": cache.resolve("/part0", 0, 64),
            "payload": b"s" * 64,
        }
        return state

    def threads(self, state):
        cache = state["cache"]

        def stale_admitter():
            cache.admit(state["old_key"], state["payload"], tenant="a")

        def rewriter():
            cache.invalidate_path("/part0")

        return [stale_admitter, rewriter]

    def check(self, state):
        cache = state["cache"]
        new_key = cache.resolve("/part0", 0, 64)
        assert new_key != state["old_key"], "generation did not advance"
        assert not cache.peek(new_key), "post-rewrite key hits stale bytes"


class TensorCachePutVsGenerationBump(Scenario):
    """``TensorCache`` put of generation-0 tensors racing a reader that
    switches to the generation-1 key mid-flight (partition rewrite).

    Generation is part of the key, so the post-bump reader must miss in
    every schedule — a hit would serve pre-rewrite tensors."""

    name = "tensor-cache: put/get vs generation bump"

    def setup(self):
        import numpy as np

        from repro_torch.core.dpp.master import SessionSpec, Split
        from repro_torch.core.dpp.tensor_cache import TensorCache

        tc = TensorCache(capacity_bytes=1 << 20)
        spec = SessionSpec(table="t", partitions=(0,), feature_ids=(0,),
                           transform_specs=(), rows_per_split=64)
        split = Split(split_id=0, partition=0, row_start=0, row_end=64)
        state = {
            "tc": tc,
            "k0": TensorCache.key(spec, split, generation=0),
            "k1": TensorCache.key(spec, split, generation=1),
            "batches": [{"d": np.zeros(4, dtype=np.float32)}],
            "gen1_hit": "unset",
        }
        return state

    def threads(self, state):
        tc = state["tc"]

        def writer():
            tc.put(state["k0"], state["batches"], cpu_s=0.01)

        def bumped_reader():
            tc.get(state["k0"])
            yield_point("generation-bump")   # rewrite lands here
            state["gen1_hit"] = tc.get(state["k1"])

        return [writer, bumped_reader]

    def check(self, state):
        assert state["gen1_hit"] is None, (
            "generation-1 key served generation-0 tensors")


class ScaleDownVsDelivery(Scenario):
    """Elastic scale-down racing a worker's in-flight delivery.

    The worker has one split leased and is about to deliver its batch
    and report ``ok`` when the monitor retires it (``drain()``).  In
    every schedule the delivered batch must stay in the buffer and the
    split must be reported — graceful scale-down loses nothing."""

    name = "elastic: scale-down vs in-flight delivery"

    def setup(self):
        import numpy as np

        from repro_torch.core.dpp.master import DPPMaster, SessionSpec
        from repro_torch.core.dpp.worker import DPPWorker

        spec = SessionSpec(table="t", partitions=(0,), feature_ids=(0,),
                           transform_specs=(), rows_per_split=64)
        m = DPPMaster(spec, {0: 64})
        # never started: the threads below play its delivery path
        w = DPPWorker("w0", m, table=None, device=self.device)
        s = m.get_split("w0")
        assert s is not None
        state = {"m": m, "w": w,
                 "batch": {"d": np.zeros(2, dtype=np.float32)}}
        return state

    def threads(self, state):
        m, w = state["m"], state["w"]

        def delivery():
            w.buffer.put(state["batch"])
            yield_point("scale-down")    # retire window mid-delivery
            m.complete_split("w0", 0)

        def monitor():
            yield_point("scale-down")
            w.retired = True
            w.drain()

        return [delivery, monitor]

    def check(self, state):
        m, w = state["m"], state["w"]
        assert m.finished, "delivered split never reported done"
        assert w.buffered == 1, "scale-down dropped a delivered batch"
        assert w.retired and w._drain.is_set()


SCENARIOS: Tuple[type, ...] = (
    CompleteVsLeaseExpiry,
    AdmitVsInvalidate,
    TensorCachePutVsGenerationBump,
    ScaleDownVsDelivery,
)


def scenarios(device: str = "cuda") -> List[Scenario]:
    """The gate's scenario set, each on ``device``."""
    return [cls(device) for cls in SCENARIOS]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.sched",
        description="Deterministic interleaving explorer: run every "
                    "control-plane scenario of the port under all bounded "
                    "schedules.")
    ap.add_argument("-k", metavar="SUBSTR", default=None,
                    help="only scenarios whose name contains SUBSTR")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("--max-schedules", type=int, default=2000)
    ap.add_argument("--device", default="cuda",
                    help="where the scenarios' engines run: cuda (default) or cpu")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    picked = [s for s in SCENARIOS
              if args.k is None or args.k.lower() in s.name.lower()]
    if args.list:
        for s in picked:
            print(s.name)
        return 0
    if not picked:
        print(f"sched: no scenario matches {args.k!r}", file=sys.stderr)
        return 2
    from repro_torch.device import resolve

    try:   # no fallback: a missing card fails the run
        resolve(args.device, "python -m repro_torch.analysis.sched")
    except (RuntimeError, ValueError) as e:
        print(f"sched: {e}", file=sys.stderr)
        return 2
    picked = [cls(args.device) for cls in picked]

    total = pruned = 0
    for s in picked:
        try:
            res = explore(s, max_schedules=args.max_schedules)
        except ScheduleError as e:
            print(f"sched: FAIL — {s.name}\n{e}", file=sys.stderr)
            return 1
        total += res.schedules
        pruned += res.pruned
        if not args.quiet:
            tail = "" if res.exhausted else "  (TRUNCATED by --max-schedules)"
            print(f"sched: ok — {s.name}: {res.schedules} schedule(s), "
                  f"{res.pruned} pruned{tail}")
    if not args.quiet:
        print(f"sched: ok — {len(picked)} scenario(s), {total} schedules "
              f"explored, {pruned} pruned as equivalent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
