"""MetricsRegistry: the metric dataclasses behind one snapshot/delta API.

Each layer registers its metrics source once (a metric dataclass, a
callable returning one, or a callable returning a plain number with an
explicit kind); ``snapshot()`` flattens everything into one
``{dotted.name: value}`` mapping with per-name counter/gauge typing taken
from the field metadata (:mod:`repro_torch.obs.meta`).

``Snapshot.delta(prev)`` is the consumer contract the ``DPPSession``
monitor runs on: counters diff against the previous snapshot (a missing
previous value reads as 0, matching a from-zero start), gauges pass
through their current level.  ``ElasticController`` observations are
rebuilt from exactly these deltas (``autoscale.observation_from_delta``),
replacing the monitor's ad-hoc polling while keeping its decisions
byte-for-byte identical.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs.meta import flatten_metrics


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Immutable point-in-time view: flat values + per-name kinds."""

    values: Dict[str, float]
    kinds: Dict[str, str]          # name -> "counter" | "gauge"

    def get(self, name: str, default: float = 0.0) -> float:
        return self.values.get(name, default)

    def delta(self, prev: Optional["Snapshot"] = None) -> Dict[str, float]:
        """Per-name change since ``prev``: counters are diffed (missing
        previous = 0), gauges report their current level."""
        pv = prev.values if prev is not None else {}
        out: Dict[str, float] = {}
        for name, v in self.values.items():
            if self.kinds.get(name) == "gauge":
                out[name] = v
            else:
                out[name] = v - pv.get(name, 0)
        return out


EMPTY_SNAPSHOT = Snapshot(values={}, kinds={})


class MetricsRegistry:
    """Named metric sources, snapshotted on demand.

    Sources are re-read on every ``snapshot()`` call, so registering a
    getter (``registry.register("worker", sess.worker_metrics)``) always
    reflects the live fleet — including workers that crashed into the
    graveyard since the last tick.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> zero-arg callable returning a metric dataclass
        self._sources: List[Tuple[str, Callable[[], Any]]] = []
        # dotted name -> (kind, zero-arg callable returning a number)
        self._values: List[Tuple[str, str, Callable[[], float]]] = []

    def register(self, name: str, source: Any) -> None:
        """Register a metric dataclass (or a zero-arg callable returning
        one) under ``name``; its declared fields snapshot as
        ``name.field`` (nested metrics as ``name.outer.inner``)."""
        fn = source if callable(source) else (lambda s=source: s)
        with self._lock:
            self._sources.append((name, fn))

    def register_value(self, name: str, fn: Callable[[], float],
                       kind: str = "gauge") -> None:
        """Register one computed scalar under a dotted name — for derived
        signals no dataclass owns (fleet queue depth, active workers)."""
        if kind not in ("counter", "gauge"):
            raise ValueError(f"bad metric kind {kind!r}")
        with self._lock:
            self._values.append((name, kind, fn))

    def snapshot(self) -> Snapshot:
        with self._lock:
            sources = list(self._sources)
            values = list(self._values)
        flat: Dict[str, float] = {}
        kinds: Dict[str, str] = {}
        for name, fn in sources:
            obj = fn()
            if not dataclasses.is_dataclass(obj):
                raise TypeError(
                    f"source {name!r} returned {type(obj).__name__}, "
                    "expected a metric dataclass"
                )
            for field_name, kind, v in flatten_metrics(obj, f"{name}."):
                flat[field_name] = v
                kinds[field_name] = kind
        for name, kind, fn in values:
            flat[name] = fn()
            kinds[name] = kind
        return Snapshot(values=flat, kinds=kinds)
