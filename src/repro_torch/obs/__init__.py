"""Observability layer for the DSI pipeline.

Three stdlib-only pieces (torch is looked up, never imported), threaded
through every DSI stage:

  * :mod:`repro_torch.obs.trace` — thread-safe span tracing with clock
    injection and a Chrome-trace/Perfetto exporter; while a torch
    profiler records, each span is also a profiler annotation.  Disabled
    by default (``NULL_TRACER``: no clock read, no span object); the cost
    of a ``Tracer`` on the card is measured by ``python3 -m
    dsibench.tracer_cost``.
  * :mod:`repro_torch.obs.meta` — per-field counter/gauge metadata for the
    metric dataclasses; one source of truth shared by ``merge`` methods,
    the registry, and the REPRO-M002 monotonicity rule.
  * :mod:`repro_torch.obs.registry` — a ``MetricsRegistry`` unifying the metric
    dataclasses behind one snapshot/delta API; the ``ElasticController``
    observations are rebuilt on these deltas.

``python -m repro_torch.obs.report`` turns a trace + registry snapshot
into the paper's Table-7/Table-9 stall-attribution breakdown;
``python -m repro_torch.obs.smoke --device {cuda,cpu}`` produces a traced
two-tenant artifact whose workers run on that device.
"""
from repro_torch.obs.meta import counter, gauge, merge_metrics, metric_fields
from repro_torch.obs.registry import MetricsRegistry, Snapshot
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "counter", "gauge", "merge_metrics", "metric_fields",
    "MetricsRegistry", "Snapshot",
    "Tracer", "NullTracer", "NULL_TRACER",
]
