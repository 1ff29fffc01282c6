"""Span tracing for the DSI pipeline: nested, attributed, exportable.

A :class:`Tracer` records spans (``storage.read``, ``cache.fill``,
``extract.decode``, ``transform.fused``, ``load.materialize``,
``client.stall``, ``train.step``, ``session.run``, ...) with arbitrary
labels (tenant/session/split/worker), a per-thread parent stack for
nesting, and an injected ``clock=`` (REPRO-C001 style) so duration math
is testable without wall-clock sleeps.

Three ways to record:

  * ``with tracer.span("extract.decode", tenant=t) as sp:`` — the only
    form allowed inside ``src/repro/core/**`` (rule REPRO-S001): the
    context manager guarantees the span closes on every exit path;
  * ``tracer.record(name, t0, t1, **labels)`` — an atomic, already-timed
    span (the worker's transform/load intervals are measured with
    ``perf_counter`` for the metrics anyway; ``record`` reuses those
    endpoints instead of double-clocking);
  * ``tracer.instant(name, **labels)`` — a zero-duration marker
    (``cache.hit`` / ``cache.miss``).

Tracing is **disabled by default**: every traced component takes
``tracer=NULL_TRACER``, whose span handle is a shared singleton — no
allocation, no clock read, no lock (overhead asserted in
``benchmarks/bench_obs.py``).

``chrome_trace()`` exports the span list as Chrome-trace/Perfetto JSON
(complete ``"X"`` events, microsecond timestamps normalized to the
earliest span) so a whole ``run_to_completion`` loads in
https://ui.perfetto.dev — see docs/observability.md.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional


class _TraceLocal(threading.local):
    """Per-thread span stack; ``__init__`` re-runs in every thread that
    touches the tracer, so ``stack`` always exists without the tracer
    ever mutating shared state to create it."""

    def __init__(self):
        self.stack: List[str] = []


class Span:
    """One completed span. ``t0``/``t1`` are in the tracer's clock domain."""

    __slots__ = ("name", "t0", "t1", "labels", "tid", "parent")

    def __init__(self, name: str, t0: float, t1: float,
                 labels: Dict[str, Any], tid: int, parent: Optional[str]):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.labels = labels
        self.tid = tid
        self.parent = parent

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _SpanHandle:
    """Context manager returned by ``Tracer.span``: opens on ``__enter__``,
    appends the completed span on ``__exit__``."""

    __slots__ = ("_tracer", "name", "labels", "t0")

    def __init__(self, tracer: "Tracer", name: str, labels: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.labels = labels
        self.t0 = 0.0

    def set(self, **labels: Any) -> "_SpanHandle":
        """Attach labels discovered mid-span (byte counts, row counts)."""
        self.labels.update(labels)
        return self

    def __enter__(self) -> "_SpanHandle":
        tr = self._tracer
        stack = tr._stack()
        stack.append(self.name)
        with tr._lock:
            tr._open += 1
        self.t0 = tr._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._tracer
        t1 = tr._clock()
        stack = tr._stack()
        stack.pop()
        parent = stack[-1] if stack else None
        with tr._lock:
            tr._open -= 1
            tr._append_locked(Span(
                self.name, self.t0, t1, self.labels,
                threading.get_ident(), parent,
            ))
        return False


class Tracer:
    """Thread-safe span recorder with an injected clock.

    ``max_spans`` bounds memory: past it, new spans are counted as
    dropped instead of stored (the drop count rides in the export's
    ``otherData`` so a truncated trace is never mistaken for a short run).
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_spans: int = 200_000):
        self._clock = clock
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._open = 0
        self._dropped = 0
        self._local = _TraceLocal()

    # -- recording ----------------------------------------------------------

    def _stack(self) -> List[str]:
        return self._local.stack

    def now(self) -> float:
        """The tracer's clock — use for ``record()`` endpoints."""
        return self._clock()

    def span(self, name: str, **labels: Any) -> _SpanHandle:
        return _SpanHandle(self, name, labels)

    def record(self, name: str, t0: float, t1: float, **labels: Any) -> None:
        """Append an already-timed span (atomic: opened and closed in one
        call, so it can never orphan — exempt from REPRO-S001)."""
        parent_stack = self._stack()
        parent = parent_stack[-1] if parent_stack else None
        with self._lock:
            self._append_locked(Span(
                name, t0, t1, labels, threading.get_ident(), parent,
            ))

    def instant(self, name: str, **labels: Any) -> None:
        t = self._clock()
        self.record(name, t, t, **labels)

    def _append_locked(self, span: Span) -> None:
        if len(self._spans) >= self.max_spans:
            self._dropped += 1
            return
        self._spans.append(span)

    # -- inspection ---------------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def open_spans(self) -> int:
        """Spans entered but not yet exited; 0 after a complete run —
        anything else is an orphan and fails ``report --check``."""
        with self._lock:
            return self._open

    def dropped_spans(self) -> int:
        with self._lock:
            return self._dropped

    # -- export -------------------------------------------------------------

    def chrome_trace(self, metrics: Optional[Dict[str, Any]] = None) -> Dict:
        """Chrome-trace/Perfetto JSON document: ``traceEvents`` holds
        complete ``"X"`` events (ts/dur in µs, normalized so the earliest
        span starts at 0), ``otherData`` the span accounting, and
        ``metrics`` an optional registry-snapshot payload the
        stall-attribution report consumes alongside the spans."""
        spans = self.spans()
        base = min((s.t0 for s in spans), default=0.0)
        events = []
        for s in sorted(spans, key=lambda s: (s.t0, s.t1)):
            args = dict(s.labels)
            if s.parent:
                args["parent"] = s.parent
            events.append({
                "name": s.name,
                "cat": s.name.split(".", 1)[0],
                "ph": "X",
                "ts": (s.t0 - base) * 1e6,
                "dur": max(s.t1 - s.t0, 0.0) * 1e6,
                "pid": 1,
                "tid": s.tid,
                "args": args,
            })
        doc: Dict[str, Any] = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "open_spans": self.open_spans(),
                "dropped_spans": self.dropped_spans(),
                "num_spans": len(events),
            },
        }
        if metrics is not None:
            doc["metrics"] = metrics
        return doc

    def write(self, path, metrics: Optional[Dict[str, Any]] = None) -> Path:
        """Serialize ``chrome_trace()`` to ``path``; the file opens
        directly in Perfetto / ``chrome://tracing``."""
        p = Path(path)
        p.write_text(json.dumps(self.chrome_trace(metrics)) + "\n")
        return p


class _NullSpan:
    """Shared no-op span handle: entering, exiting, and labeling cost a
    method call on a singleton — no allocation, no clock read, no lock."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **labels: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled-by-default tracer: every operation is a no-op
    returning shared singletons, so instrumented hot paths pay only the
    call dispatch (asserted ≤ 2% of bench_dpp throughput in
    ``benchmarks/bench_obs.py``)."""

    __slots__ = ()

    enabled = False

    def now(self) -> float:
        return 0.0

    def span(self, name: str, **labels: Any) -> _NullSpan:
        return _NULL_SPAN

    def record(self, name: str, t0: float, t1: float, **labels: Any) -> None:
        return None

    def instant(self, name: str, **labels: Any) -> None:
        return None

    def spans(self) -> List[Span]:
        return []

    def open_spans(self) -> int:
        return 0

    def dropped_spans(self) -> int:
        return 0

    def chrome_trace(self, metrics: Optional[Dict[str, Any]] = None) -> Dict:
        return {"traceEvents": [], "otherData": {
            "open_spans": 0, "dropped_spans": 0, "num_spans": 0,
        }}


NULL_TRACER = NullTracer()
