"""Runtime lock-order sanitizer ("lockdep", after the Linux kernel's).

Static rules prove each class takes *its own* lock; what they cannot see
is the **order** different classes' locks nest in at run time.  The cache
read path routinely holds ``TectonicFS._mutate_lock`` while entering
``StripeCache._lock`` (read -> admit); if any other path ever nests them
the other way around, two threads can deadlock — the classic A->B / B->A
inversion, and exactly the failure shape of a rewrite racing a read.

Mechanism: :func:`patched` monkeypatches ``threading.Lock``/``RLock`` so
every lock constructed inside the ``with`` block is a :class:`TrackedLock`
named after its construction site (``file.py:123``).  Each acquisition
records edges *held-lock -> new-lock* into a shared :class:`LockGraph`
with the acquisition stacks of both ends.  A cycle in that graph means
there exists a schedule where the involved threads deadlock — no actual
deadlock needs to occur for detection, so single-threaded tests catch
inversions too.

Usage (as ``tests/test_torch_sanitizers.py`` and ``chip_smoke.py``'s
sanitizer phase use it)::

    with patched(name_filter=...) as graph:
        ...build caches/masters/workers inside the block...
    graph.assert_no_cycles()

Locks are aggregated by construction site, not instance: two
``StripeCache`` instances share one node.  That is the useful
granularity for ordering rules (and the kernel's choice too); per-
instance ordering schemes (e.g. address-ordered lock ladders) would need
a suppression via ``LockGraph(ignore=...)``.
"""
from __future__ import annotations

import _thread
import dataclasses
import threading
import traceback
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple


class LockOrderError(AssertionError):
    """A cycle in the lock acquisition graph: potential deadlock."""


def _site(depth: int = 1) -> str:
    """``file.py:lineno`` of the frame ``depth`` levels above the caller —
    with the default, whoever called the caller (the ``threading.Lock()``
    construction site when called from the patched factory)."""
    frame = traceback.extract_stack(limit=depth + 2)[0]
    return f"{Path(frame.filename).name}:{frame.lineno}"


def _stack_summary(limit: int = 8) -> Tuple[str, ...]:
    frames = traceback.extract_stack()
    out = []
    for fr in frames:
        name = Path(fr.filename).name
        if name in ("lockdep.py",):
            continue
        out.append(f"{name}:{fr.lineno} in {fr.name}")
    return tuple(out[-limit:])


@dataclasses.dataclass
class _Held:
    name: str
    count: int                      # reentrant acquisitions (RLock)
    stack: Tuple[str, ...]          # where it was first acquired


@dataclasses.dataclass
class _Edge:
    src: str
    dst: str
    src_stack: Tuple[str, ...]      # acquisition stack of the held lock
    dst_stack: Tuple[str, ...]      # acquisition stack of the new lock
    thread: str


class LockGraph:
    """Thread-safe acquisition-order graph with sample stacks per edge."""

    def __init__(self, ignore: Iterable[str] = ()):
        # a REAL lock: the graph must work while threading.Lock is patched
        self._mu = _thread.allocate_lock()
        self._edges: Dict[Tuple[str, str], _Edge] = {}
        self._nodes: Set[str] = set()
        self._ignore = set(ignore)
        self._tls = threading.local()

    # -- per-thread held-lock bookkeeping (called by TrackedLock) ----------

    def _held(self) -> List[_Held]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def note_acquire(self, name: str) -> None:
        held = self._held()
        for h in held:
            if h.name == name:          # reentrant re-acquire: no new edge
                h.count += 1
                return
        stack = _stack_summary()
        with self._mu:
            self._nodes.add(name)
            for h in held:
                key = (h.name, name)
                if h.name != name and key not in self._edges \
                        and h.name not in self._ignore \
                        and name not in self._ignore:
                    self._edges[key] = _Edge(
                        h.name, name, h.stack, stack,
                        threading.current_thread().name,
                    )
        held.append(_Held(name, 1, stack))

    def note_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].name == name:
                held[i].count -= 1
                if held[i].count == 0:
                    del held[i]
                return

    # -- analysis ----------------------------------------------------------

    def edges(self) -> List[Tuple[str, str]]:
        with self._mu:
            return sorted(self._edges)

    def nodes(self) -> List[str]:
        """The lock sites acquired at least once."""
        with self._mu:
            return sorted(self._nodes)

    def cycles(self) -> List[List[str]]:
        """Elementary cycles via iterative DFS over the edge set (the graph
        is small: nodes are lock construction sites)."""
        with self._mu:
            adj: Dict[str, List[str]] = {}
            for a, b in self._edges:
                adj.setdefault(a, []).append(b)
        found: List[List[str]] = []
        seen_keys: Set[Tuple[str, ...]] = set()
        for start in sorted(adj):
            stack = [(start, iter(adj.get(start, ())))]
            path = [start]
            on_path = {start}
            while stack:
                node, it = stack[-1]
                nxt = next(it, None)
                if nxt is None:
                    stack.pop()
                    path.pop()
                    on_path.discard(node)
                    continue
                if nxt == start:
                    cyc = path + [start]
                    # canonical key: rotation-invariant
                    key = tuple(sorted(cyc[:-1]))
                    if key not in seen_keys:
                        seen_keys.add(key)
                        found.append(list(cyc))
                elif nxt not in on_path and nxt >= start:
                    # only explore nodes >= start: each cycle is reported
                    # from its smallest node exactly once
                    stack.append((nxt, iter(adj.get(nxt, ()))))
                    path.append(nxt)
                    on_path.add(nxt)
        return found

    def report(self) -> str:
        cycles = self.cycles()
        if not cycles:
            return (f"lockdep: ok — {len(self._nodes)} lock site(s), "
                    f"{len(self._edges)} ordered edge(s), no cycles")
        lines = [f"lockdep: {len(cycles)} lock-order cycle(s) — "
                 "potential deadlock:"]
        with self._mu:
            edges = dict(self._edges)
        for cyc in cycles:
            lines.append("  cycle: " + " -> ".join(cyc))
            for a, b in zip(cyc, cyc[1:]):
                e = edges.get((a, b))
                if e is None:
                    continue
                lines.append(f"    {a} held, then acquired {b} "
                             f"[thread {e.thread}]")
                lines.append(f"      {a} acquired at:")
                lines.extend(f"        {fr}" for fr in e.src_stack[-4:])
                lines.append(f"      {b} acquired at:")
                lines.extend(f"        {fr}" for fr in e.dst_stack[-4:])
        return "\n".join(lines)

    def assert_no_cycles(self) -> None:
        if self.cycles():
            raise LockOrderError(self.report())


class TrackedLock:
    """Wrapper around a real ``Lock``/``RLock`` feeding a LockGraph.

    Exposes the full lock protocol plus the private hooks
    ``threading.Condition`` uses (``_is_owned``, ``_release_save``,
    ``_acquire_restore``) so wrapped locks keep working as Condition /
    Queue / Event internals.
    """

    def __init__(self, graph: LockGraph, name: str, inner, reentrant: bool):
        self._graph = graph
        self._name = name
        self._inner = inner
        self._reentrant = reentrant

    # -- core protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph.note_acquire(self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._graph.note_release(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"<TrackedLock {self._name} wrapping {self._inner!r}>"

    # -- Condition integration --------------------------------------------

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock: owned iff this thread has it in its held list
        return any(
            h.name == self._name for h in self._graph._held()
        ) and self._inner.locked()

    def _release_save(self):
        held = self._graph._held()
        count = next((h.count for h in held if h.name == self._name), 1)
        if hasattr(self._inner, "_release_save"):
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        for _ in range(count):
            self._graph.note_release(self._name)
        return (state, count)

    def _acquire_restore(self, saved) -> None:
        state, count = saved
        if state is not None and hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        # re-entering after a wait() is a real acquisition ordering event
        self._graph.note_acquire(self._name)
        for _ in range(count - 1):
            self._graph.note_acquire(self._name)


@contextmanager
def patched(
    graph: Optional[LockGraph] = None,
    name_filter: Optional[Callable[[str], bool]] = None,
):
    """Patch ``threading.Lock``/``RLock`` so locks born inside the block
    are tracked in ``graph`` (a fresh one by default).  Yields the graph.

    ``name_filter(site) -> bool`` limits tracking to interesting sites
    (e.g. ``lambda s: s.startswith(("stripe_cache", "tectonic"))``) —
    unfiltered runs also track stdlib ``queue``/``Condition`` internals,
    which is harmless for cycle detection but noisier to read.
    """
    g = graph if graph is not None else LockGraph()
    real_lock, real_rlock = threading.Lock, threading.RLock

    def make_lock():
        site = _site()
        inner = real_lock()
        if name_filter is not None and not name_filter(site):
            return inner
        return TrackedLock(g, site, inner, reentrant=False)

    def make_rlock():
        site = _site()
        inner = real_rlock()
        if name_filter is not None and not name_filter(site):
            return inner
        return TrackedLock(g, site, inner, reentrant=True)

    threading.Lock = make_lock
    threading.RLock = make_rlock
    try:
        yield g
    finally:
        threading.Lock = real_lock
        threading.RLock = real_rlock
