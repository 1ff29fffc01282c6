"""Observability layer for the DSI pipeline.

Three stdlib-only pieces, threaded through every DSI stage:

  * :mod:`repro_torch.obs.trace` — thread-safe span tracing with clock
    injection and a Chrome-trace/Perfetto exporter.  Disabled by default
    (``NULL_TRACER``), zero-cost when off.
  * :mod:`repro_torch.obs.meta` — per-field counter/gauge metadata for the
    metric dataclasses; one source of truth shared by ``merge`` methods,
    the registry, and the REPRO-M002 monotonicity rule.
  * :mod:`repro_torch.obs.registry` — a ``MetricsRegistry`` unifying the metric
    dataclasses behind one snapshot/delta API; the ``ElasticController``
    observations are rebuilt on these deltas.

A copy of ``repro.obs`` (the reference package) without its report and
smoke entry points, which are not ported yet.
"""
from repro_torch.obs.meta import counter, gauge, merge_metrics, metric_fields
from repro_torch.obs.registry import MetricsRegistry, Snapshot
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "counter", "gauge", "merge_metrics", "metric_fields",
    "MetricsRegistry", "Snapshot",
    "Tracer", "NullTracer", "NULL_TRACER",
]
