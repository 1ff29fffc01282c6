"""Per-field metric metadata: counter vs gauge, declared at the field.

Every metric dataclass in the repo (``WorkerMetrics``, ``TierStats``,
``IOStats``, ...) declares each numeric field through :func:`counter` or
:func:`gauge` instead of a bare default.  That single declaration drives:

  * **merge semantics** — :func:`merge_metrics` sums counters, applies the
    gauge's declared ``merge`` policy (``"sum"`` for occupancy that adds
    across disjoint instances, ``"last"``/``"max"`` otherwise), extends
    list-valued samples, recurses into nested metric dataclasses, and
    leaves non-metric fields (names, labels) alone — the blind
    add-every-field merge corrupted exactly those;
  * **registry typing** — ``MetricsRegistry`` snapshots counters and
    gauges differently (counters delta, gauges pass through);
  * **REPRO-M002** — the monotonicity rule's counter/gauge split is
    auto-discovered from these declarations instead of a hand-kept
    exemption list (see ``repro_torch.analysis.checks_metrics``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

METRIC_KEY = "metric"        # field metadata key: "counter" | "gauge"
MERGE_KEY = "merge"          # gauge merge policy: "sum" | "last" | "max"


def counter(default: Any = 0, *,
            factory: Optional[Callable[[], Any]] = None) -> Any:
    """A monotonically-increasing cumulative field (work done, bytes
    moved).  List-valued counters (``factory=list``) accumulate samples
    and merge by extension."""
    meta = {METRIC_KEY: "counter"}
    if factory is not None:
        return dataclasses.field(default_factory=factory, metadata=meta)
    return dataclasses.field(default=default, metadata=meta)


def gauge(default: Any = 0, *, merge: str = "sum",
          factory: Optional[Callable[[], Any]] = None) -> Any:
    """A point-in-time level (occupancy, last-seen value).  Gauges may
    shrink (REPRO-M002 exempts them); ``merge`` declares how aggregation
    across instances combines them."""
    if merge not in ("sum", "last", "max"):
        raise ValueError(f"bad gauge merge policy {merge!r}")
    meta = {METRIC_KEY: "gauge", MERGE_KEY: merge}
    if factory is not None:
        return dataclasses.field(default_factory=factory, metadata=meta)
    return dataclasses.field(default=default, metadata=meta)


def metric_kind(f: dataclasses.Field) -> Optional[str]:
    """``"counter"`` / ``"gauge"`` for declared metric fields, else None."""
    return f.metadata.get(METRIC_KEY) if f.metadata else None


def metric_fields(obj: Any):
    """Yield ``(field, kind)`` for the declared metric fields of a metric
    dataclass (instance or class)."""
    for f in dataclasses.fields(obj):
        kind = metric_kind(f)
        if kind is not None:
            yield f, kind


def merge_metrics(dst: Any, src: Any) -> Any:
    """Merge ``src`` into ``dst`` field-by-field, driven by the metadata.

    Counters sum (lists extend); gauges combine per their declared
    policy; nested metric dataclasses recurse; fields with no metric
    declaration (identity strings, labels) are left untouched.  Returns
    ``dst`` for chaining.
    """
    if type(dst) is not type(src):
        raise TypeError(
            f"cannot merge {type(src).__name__} into {type(dst).__name__}"
        )
    for f, kind in metric_fields(dst):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if dataclasses.is_dataclass(a):
            merge_metrics(a, b)
        elif isinstance(a, list):
            a.extend(b)
        elif kind == "counter":
            setattr(dst, f.name, a + b)
        else:
            policy = f.metadata.get(MERGE_KEY, "sum")
            if policy == "sum":
                setattr(dst, f.name, a + b)
            elif policy == "max":
                setattr(dst, f.name, max(a, b))
            else:                       # "last": newest observation wins
                setattr(dst, f.name, b)
    return dst


def flatten_metrics(obj: Any, prefix: str = ""):
    """Yield ``(dotted_name, kind, value)`` for every numeric metric field,
    descending into nested metric dataclasses (``io.num_ios``).  Lists and
    non-numeric fields are skipped — snapshots carry scalars only."""
    for f, kind in metric_fields(obj):
        v = getattr(obj, f.name)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            yield from flatten_metrics(v, prefix=name + ".")
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield name, kind, v
