"""Runtime lockset data-race detector ("racedep", after Eraser).

The lock-order sanitizer (``lockdep``) proves that locks nest
consistently; what it cannot see is state that is touched with **no**
lock at all — an unlocked read of a flag another thread writes, or two
threads guarding one field with *different* locks.  Those are the races
that schedule-dependent controller bugs hide behind, and no
amount of static lock-discipline lint can find them: the lint proves
each class takes *its own* lock, not that every shared access does.

Mechanism (the Eraser lockset algorithm, adapted to attribute
granularity): :func:`instrument` wraps the core threaded classes'
``__setattr__`` / ``__getattribute__`` so every instance-attribute
access is observed together with the set of :class:`~.lockdep.TrackedLock`
names the accessing thread currently holds (read off the shared
:class:`~.lockdep.LockGraph`).  Per ``(object, attribute)`` a small state
machine runs:

  * **exclusive** — accessed by a single thread so far: no constraint
    (thread-confined state is fine, and publication hand-offs — build in
    thread A, use only in thread B — never false-positive);
  * **shared** — a second thread touched it: the *candidate lockset*
    starts as the locks held at that access and is intersected at every
    later access;
  * **shared-modified** — some access in the shared phase was a write:
    if the candidate lockset is (or becomes) empty, no single lock
    protects the attribute — a data race is reported with both access
    sites, the accessing threads, and the acquisition stacks of the
    locks involved.

Exemptions:

  * ``__init__`` publication — accesses made while the object's own
    ``__init__`` frame is still running are ignored: construction-time
    state is pre-publication by definition;
  * ``_unshared`` allowlist — a class-level
    ``_unshared = ("alive", ...)`` tuple names attributes that are
    *deliberately* unlocked (GIL-atomic single-word flags, single-writer
    telemetry).  REPRO-R001 (``checks_races.py``) statically enforces
    that every unlocked non-``__init__`` assignment on an instrumented
    class is either lock-guarded or declared here, so the allowlist can
    never drift silently;
  * lock attributes themselves (``_lock``-style names) — reading the
    lock in order to take it is inherently a pre-lock access.

Usage (the ``raced`` fixture of ``tests/test_torch_sanitizers.py`` and
``chip_smoke.py``'s sanitizer phase)::

    with lockdep.patched(name_filter=...) as graph:
        with instrument(graph) as det:
            ...build caches/masters/workers inside the block...
    det.assert_no_races()

Like lockdep, detection needs no actual unfortunate timing: one
unlocked write plus one access from a second thread is enough, however
the schedule landed.  (Schedule-dependent *atomicity* violations —
check-then-act windows under correct locking — are the sibling tool's
job: see ``repro_torch.analysis.sched``.)
"""
from __future__ import annotations

import _thread
import dataclasses
import re
import sys
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.lockdep import LockGraph, _stack_summary


class RaceError(AssertionError):
    """An attribute is shared across threads with an empty lockset."""


READ = "read"
WRITE = "write"

_LOCK_ATTR_RE = re.compile(r"^_\w*lock$")

# module path -> instrumented class names; single source of truth shared
# with the REPRO-R001/R002 static rules (checks_races.py) and the default
# class set of instrument().
INSTRUMENTED_CLASSES: Dict[str, Tuple[str, ...]] = {
    "src/repro_torch/core/dpp/master.py": ("DPPMaster",),
    "src/repro_torch/core/dpp/worker.py": ("DPPWorker",),
    "src/repro_torch/core/dpp/service.py": ("DPPSession",),
    "src/repro_torch/core/dpp/tensor_cache.py": ("TensorCache",),
    "src/repro_torch/core/dpp/prefetch.py": ("PrefetchPlanner",),
    "src/repro_torch/core/dpp/autoscale.py": ("ElasticController",),
    "src/repro_torch/core/cache/stripe_cache.py": ("StripeCache",),
    "src/repro_torch/core/cache/dedup.py": ("DedupIndex",),
    "src/repro_torch/core/tectonic.py": ("TectonicFS",),
}

_IN_INIT_FLAG = "_racedep_in_init"


def core_classes() -> Tuple[type, ...]:
    """The default instrumentation set: every core threaded class."""
    from repro_torch.core.cache.dedup import DedupIndex
    from repro_torch.core.cache.stripe_cache import StripeCache
    from repro_torch.core.dpp.autoscale import ElasticController
    from repro_torch.core.dpp.master import DPPMaster
    from repro_torch.core.dpp.prefetch import PrefetchPlanner
    from repro_torch.core.dpp.service import DPPSession
    from repro_torch.core.dpp.tensor_cache import TensorCache
    from repro_torch.core.dpp.worker import DPPWorker
    from repro_torch.core.tectonic import TectonicFS

    return (DPPMaster, DPPWorker, DPPSession, StripeCache, DedupIndex,
            TensorCache, PrefetchPlanner, ElasticController, TectonicFS)


def _unshared_of(cls: type) -> frozenset:
    """Union of ``_unshared`` declarations across the MRO (a subclass
    extends, never hides, its base's allowlist)."""
    names: Set[str] = set()
    for c in cls.__mro__:
        names.update(c.__dict__.get("_unshared", ()))
    return frozenset(names)


def _stack() -> Tuple[str, ...]:
    return tuple(fr for fr in _stack_summary()
                 if "racedep.py" not in fr and "lockdep.py" not in fr)


def _access_site() -> str:
    """``file.py:lineno in func`` of the nearest caller frame outside the
    sanitizer machinery — cheap enough to capture on the hot path."""
    f = sys._getframe(1)
    while f is not None:
        name = Path(f.f_code.co_filename).name
        if name not in ("racedep.py", "lockdep.py"):
            return f"{name}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return "<unknown>"


@dataclasses.dataclass
class _Access:
    """One sampled access (transition into sharing, or a shared write)."""

    thread: str
    kind: str                            # READ | WRITE
    site: str
    locks: Tuple[str, ...]               # lock names held
    lock_stacks: Tuple[Tuple[str, Tuple[str, ...]], ...]  # (name, stack)
    stack: Tuple[str, ...]


@dataclasses.dataclass
class _AttrState:
    obj: object                          # strong ref: pins id() stability
    cls: str
    attr: str
    owner: str                           # first post-__init__ thread
    owner_site: str                      # its most recent access site
    lockset: Optional[Set[str]] = None   # None = still exclusive
    threads: Set[str] = dataclasses.field(default_factory=set)
    shared_write: bool = False
    sharing: Optional[_Access] = None    # the access that broke exclusivity
    write: Optional[_Access] = None      # first write in the shared phase


@dataclasses.dataclass
class Race:
    """One reported data race, aggregated per (class, attribute)."""

    cls: str
    attr: str
    threads: Tuple[str, ...]
    instances: int
    owner_site: str
    sharing: _Access
    write: _Access


class RaceDetector:
    """Shared lockset state machine fed by the instrumented classes."""

    def __init__(self, graph: Optional[LockGraph] = None):
        self.graph = graph if graph is not None else LockGraph()
        # a REAL lock: note() runs while threading.Lock may be patched
        self._mu = _thread.allocate_lock()
        self._state: Dict[Tuple[int, str], _AttrState] = {}

    # -- hot path ------------------------------------------------------------

    def note(self, obj: object, cls: type, attr: str, kind: str) -> None:
        held = self.graph._held()
        tname = threading.current_thread().name
        key = (id(obj), attr)
        with self._mu:
            st = self._state.get(key)
            if st is None:
                self._state[key] = _AttrState(
                    obj=obj, cls=cls.__name__, attr=attr,
                    owner=tname, owner_site=_access_site(),
                )
                return
            if st.lockset is None:                     # exclusive phase
                if tname == st.owner:
                    st.owner_site = _access_site()
                    return
                # second thread: start lockset refinement at this access
                locks = tuple(sorted({h.name for h in held}))
                acc = _Access(
                    thread=tname, kind=kind, site=_access_site(),
                    locks=locks,
                    lock_stacks=tuple((h.name, h.stack) for h in held),
                    stack=_stack(),
                )
                st.lockset = set(locks)
                st.threads = {st.owner, tname}
                st.sharing = acc
                if kind == WRITE:
                    st.shared_write = True
                    st.write = acc
                return
            # shared phase: intersect, record the first write sample
            st.threads.add(tname)
            locks = {h.name for h in held}
            st.lockset &= locks
            if kind == WRITE:
                if not st.shared_write or (st.write is not None
                                           and st.write.locks
                                           and not (set(st.write.locks)
                                                    & st.lockset)):
                    # (re)sample so the report shows a write that is
                    # actually unprotected under the final lockset
                    st.write = _Access(
                        thread=tname, kind=kind, site=_access_site(),
                        locks=tuple(sorted(locks)),
                        lock_stacks=tuple((h.name, h.stack) for h in held),
                        stack=_stack(),
                    )
                st.shared_write = True

    # -- analysis ------------------------------------------------------------

    def observed(self) -> Tuple[int, int]:
        """(object, attribute) pairs seen after ``__init__``, and of those
        the ones a second thread touched (the shared phase)."""
        with self._mu:
            states = list(self._state.values())
        return len(states), sum(st.lockset is not None for st in states)

    def races(self) -> List[Race]:
        """Shared-modified attributes whose candidate lockset is empty,
        aggregated per (class, attribute) across instances."""
        with self._mu:
            states = list(self._state.values())
        grouped: Dict[Tuple[str, str], List[_AttrState]] = {}
        for st in states:
            if st.lockset is not None and st.shared_write and not st.lockset:
                grouped.setdefault((st.cls, st.attr), []).append(st)
        out: List[Race] = []
        for (cls, attr), sts in sorted(grouped.items()):
            threads: Set[str] = set()
            for st in sts:
                threads.update(st.threads)
            pick = sts[0]
            out.append(Race(
                cls=cls, attr=attr, threads=tuple(sorted(threads)),
                instances=len(sts), owner_site=pick.owner_site,
                sharing=pick.sharing, write=pick.write or pick.sharing,
            ))
        return out

    def report(self) -> str:
        races = self.races()
        with self._mu:
            n_attrs = len(self._state)
        if not races:
            return (f"racedep: ok — {n_attrs} shared-attribute site(s) "
                    "observed, no empty-lockset access")
        lines = [f"racedep: {len(races)} data race(s) — attribute(s) "
                 "accessed by >=2 threads with an empty lockset:"]
        for r in races:
            lines.append(
                f"  {r.cls}.{r.attr} — threads {', '.join(r.threads)} "
                f"({r.instances} instance(s))"
            )
            lines.append(f"    first (exclusive) access: {r.owner_site} "
                         f"[thread {'/'.join(t for t in r.threads)}]")
            lines.append(f"    sharing {r.sharing.kind}: {r.sharing.site} "
                         f"[thread {r.sharing.thread}] holding "
                         f"{list(r.sharing.locks) or 'no locks'}")
            for fr in r.sharing.stack[-4:]:
                lines.append(f"      {fr}")
            if r.write is not r.sharing:
                lines.append(f"    unprotected write: {r.write.site} "
                             f"[thread {r.write.thread}] holding "
                             f"{list(r.write.locks) or 'no locks'}")
                for fr in r.write.stack[-4:]:
                    lines.append(f"      {fr}")
            for name, stack in (r.sharing.lock_stacks + r.write.lock_stacks):
                lines.append(f"      (lock {name} acquired at "
                             f"{stack[-1] if stack else '?'})")
            lines.append(
                f"    fix: guard {r.cls}.{r.attr} with one lock on every "
                f"access, or declare it in {r.cls}._unshared with a comment "
                "explaining why unlocked access is safe (REPRO-R001)"
            )
        return "\n".join(lines)

    def assert_no_races(self) -> None:
        if self.races():
            raise RaceError(self.report())


# -- class instrumentation ----------------------------------------------------


def _should_track(name: str, unshared: frozenset, inst_dict: dict) -> bool:
    if name.startswith("__") or name.startswith("_racedep"):
        return False
    if name in unshared or _LOCK_ATTR_RE.match(name):
        return False
    if _IN_INIT_FLAG in inst_dict:
        return False                      # __init__ publication exemption
    return name in inst_dict              # instance data only, not methods


@contextmanager
def instrument(
    graph: Optional[LockGraph] = None,
    classes: Optional[Sequence[type]] = None,
):
    """Wrap ``classes``' (default: every core threaded class) attribute
    protocol so a :class:`RaceDetector` observes each instance-attribute
    access with the current thread's held-lock set.  Yields the detector;
    callers run ``det.assert_no_races()`` after the workload.

    Compose with :func:`~.lockdep.patched` (pass its graph) so the held
    set reflects the repo's locks::

        with lockdep.patched(name_filter=...) as g:
            with racedep.instrument(g) as det:
                ...workload...
        det.assert_no_races()
    """
    det = RaceDetector(graph)
    targets = tuple(classes) if classes is not None else core_classes()
    saved: List[Tuple[type, Dict[str, Optional[object]]]] = []

    for cls in targets:
        unshared = _unshared_of(cls)
        orig_get = cls.__getattribute__
        orig_set = cls.__setattr__
        orig_init = cls.__init__

        def make(cls=cls, unshared=unshared, orig_get=orig_get,
                 orig_set=orig_set, orig_init=orig_init):
            def __getattribute__(self, name):
                value = orig_get(self, name)
                if name != "__dict__" and _should_track(
                    name, unshared, orig_get(self, "__dict__")
                ):
                    det.note(self, cls, name, READ)
                return value

            def __setattr__(self, name, value):
                orig_set(self, name, value)
                if _should_track(name, unshared,
                                 orig_get(self, "__dict__")):
                    det.note(self, cls, name, WRITE)

            def __init__(self, *a, **kw):
                d = orig_get(self, "__dict__")
                d[_IN_INIT_FLAG] = True
                try:
                    orig_init(self, *a, **kw)
                finally:
                    orig_get(self, "__dict__").pop(_IN_INIT_FLAG, None)

            return __getattribute__, __setattr__, __init__

        wrapped_get, wrapped_set, wrapped_init = make()
        saved.append((cls, {
            "__getattribute__": cls.__dict__.get("__getattribute__"),
            "__setattr__": cls.__dict__.get("__setattr__"),
            "__init__": cls.__dict__.get("__init__"),
        }))
        cls.__getattribute__ = wrapped_get      # type: ignore[assignment]
        cls.__setattr__ = wrapped_set           # type: ignore[assignment]
        cls.__init__ = wrapped_init             # type: ignore[assignment]

    try:
        yield det
    finally:
        for cls, originals in reversed(saved):
            for name, fn in originals.items():
                if fn is None:
                    # the class inherited it: drop our override entirely
                    if name in cls.__dict__:
                        delattr(cls, name)
                else:
                    setattr(cls, name, fn)
