"""raft_tpu_torch.obs — the observability substrate (counterpart of
``raft_tpu.obs``): metrics, spans, events and cost, queryable with no
profiler attached.

- :mod:`~raft_tpu_torch.obs.registry` — process-wide thread-safe metrics
  (counters, gauges, labeled histograms with fixed bucket ladders and a
  label-cardinality cap).
- :mod:`~raft_tpu_torch.obs.spans` — structured spans fed by
  ``core.trace.trace_range`` / ``@traced`` on every public entry point.
- :mod:`~raft_tpu_torch.obs.device_events` — kernel builds, kernel-library
  loads and host↔device copies, attributed to the enclosing span (the
  counterpart of raft_tpu's ``xla_events``).
- :mod:`~raft_tpu_torch.obs.export` — Prometheus / OpenMetrics text and
  JSON snapshots.
- :mod:`~raft_tpu_torch.obs.slowlog` — slow-query log.
- :mod:`~raft_tpu_torch.obs.events` — the typed event bus.
- :mod:`~raft_tpu_torch.obs.cost` — work, time and roofline share of one
  call from its kernels' notes; per-version memory gauges.

The rest of raft_tpu's ``obs`` (quality, health, flight, slo, incidents,
perf, autotune, explain, profiler, gateway) is serving observability:
those names raise ``NotImplementedError`` (ROADMAP Queue 1 item 5).

Quick start::

    from raft_tpu_torch import obs
    obs.install()
    ... build / search ...
    print(obs.to_prometheus())
"""

from raft_tpu_torch.obs import cost, device_events, events, export, registry, slowlog, spans
from raft_tpu_torch.obs.cost import (
    CostReport,
    analyze_callable,
    record_cost,
    refresh_live_buffer_gauges,
    refresh_page_gauges,
)
from raft_tpu_torch.obs.events import (
    Event,
    EventBus,
    default_bus,
    events_snapshot,
    publish,
    subscribe,
)
from raft_tpu_torch.obs.export import (
    OPENMETRICS_CONTENT_TYPE,
    PROMETHEUS_CONTENT_TYPE,
    negotiate_content_type,
    snapshot_json,
    to_openmetrics,
    to_prometheus,
    write_snapshot,
)
from raft_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    LabelCardinalityError,
    MetricsRegistry,
    default_registry,
)
from raft_tpu_torch.obs.slowlog import slowlog_snapshot
from raft_tpu_torch.obs.spans import (
    Span,
    current_span,
    finish_span,
    open_span,
    recent_spans,
    set_enabled,
    span,
    spans_snapshot,
)

registry = default_registry  # `obs.registry()` reads as the obvious accessor, as in raft_tpu


def install() -> None:
    """Merge the span and slow-query sections into registry snapshots and
    create the default event bus.  Idempotent.  (Device events need no
    listener: the kernels and ``core.resources`` record them as they
    happen.)"""
    reg = default_registry()
    reg.register_provider("spans", spans_snapshot)
    reg.register_provider("slow_queries", slowlog_snapshot)
    events.default_bus()


def snapshot():
    """JSON-safe snapshot of the process registry (counters, gauges,
    histograms, plus every registered provider section)."""
    return default_registry().snapshot()


#: raft_tpu.obs names of the serving layer's observability (ROADMAP Queue 1 item 5)
_NOT_PORTED = frozenset({
    "AlertPolicy", "Autotuner", "ExplainPlan", "FlightRecorder", "FrontierModel",
    "FrontierPoint", "GatewayConfig", "Incident", "IncidentManager", "OperationalGateway",
    "PerfLedger", "QualityAuditor", "QueryArchive", "SloEngine", "SloSpec", "TailSampler",
    "analyze_compiled", "autotune", "capture_async", "default_archive", "default_ledger",
    "default_recorder", "explain", "explain_snapshot", "flight", "flight_snapshot", "gateway",
    "health", "incidents", "incidents_snapshot", "last_capture", "ledger_snapshot",
    "next_request_id", "perf", "profile", "profiler", "quality", "slo", "xla_events",
})


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"obs.{name}: raft_tpu's serving observability is not ported yet "
            "(ROADMAP Queue 1 item 5)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CostReport", "Counter", "Event", "EventBus", "Gauge", "Histogram",
    "LabelCardinalityError", "MetricsRegistry", "OPENMETRICS_CONTENT_TYPE",
    "PROMETHEUS_CONTENT_TYPE", "Span", "analyze_callable", "cost", "current_span",
    "default_bus", "default_registry", "device_events", "events", "events_snapshot", "export",
    "finish_span", "install", "negotiate_content_type", "open_span", "publish",
    "recent_spans", "record_cost", "refresh_live_buffer_gauges", "refresh_page_gauges",
    "registry", "set_enabled", "slowlog", "slowlog_snapshot", "snapshot", "snapshot_json",
    "span", "spans", "spans_snapshot", "subscribe", "to_openmetrics", "to_prometheus",
    "write_snapshot",
]
