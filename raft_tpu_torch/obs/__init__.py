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
- :mod:`~raft_tpu_torch.obs.flight` — always-on flight recorder of recent
  served batches, dumped (JSON + Chrome trace) on incident triggers.
- :mod:`~raft_tpu_torch.obs.perf` — measured device time by executable
  key, hotspots, and a per-key regression detector.
- :mod:`~raft_tpu_torch.obs.explain` — per-query EXPLAIN plans and the
  tail-sampled query archive.
- :mod:`~raft_tpu_torch.obs.health` — OK / DEGRADED / UNHEALTHY verdicts
  behind ``SearchService.healthz()``.
- :mod:`~raft_tpu_torch.obs.incidents` — correlated incident timelines.
- :mod:`~raft_tpu_torch.obs.profiler` — ``obs.profile(dir)`` and the
  unattended ``capture_async`` over ``torch.profiler``.

raft_tpu's quality auditor, SLO engine, autotuner and operational gateway
(``obs.quality`` / ``slo`` / ``autotune`` / ``gateway``) are not ported
yet: those names raise ``NotImplementedError`` (ROADMAP Queue 1 item 5b).

Quick start::

    from raft_tpu_torch import obs
    obs.install()
    ... build / search ...
    print(obs.to_prometheus())
"""

from raft_tpu_torch.obs import (
    cost,
    device_events,
    events,
    explain,
    export,
    flight,
    health,
    incidents,
    perf,
    profiler,
    registry,
    slowlog,
    spans,
)
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
from raft_tpu_torch.obs.explain import (
    ExplainPlan,
    QueryArchive,
    TailSampler,
    default_archive,
    explain_snapshot,
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
from raft_tpu_torch.obs.flight import (
    FlightRecorder,
    default_recorder,
    flight_snapshot,
    next_request_id,
)
from raft_tpu_torch.obs.incidents import Incident, IncidentManager, incidents_snapshot
from raft_tpu_torch.obs.perf import PerfLedger, default_ledger, ledger_snapshot
from raft_tpu_torch.obs.profiler import capture_async, last_capture, profile
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
    """Merge the span, slow-query, flight, perf and explain sections into
    registry snapshots and create the default event bus (whose creation
    wires the flight dumper, the perf capture, the incident manager and
    the query-archive dumper).  Idempotent.  (Device events need no
    listener: the kernels and ``core.resources`` record them as they
    happen.)"""
    reg = default_registry()
    reg.register_provider("spans", spans_snapshot)
    reg.register_provider("slow_queries", slowlog_snapshot)
    reg.register_provider("flight", flight_snapshot)
    reg.register_provider("perf", ledger_snapshot)
    reg.register_provider("explain", explain_snapshot)
    events.default_bus()


def snapshot():
    """JSON-safe snapshot of the process registry (counters, gauges,
    histograms, plus every registered provider section)."""
    return default_registry().snapshot()


#: raft_tpu.obs names not ported yet (ROADMAP Queue 1 item 5b); XLA's
#: compiled-executable analysis and event listeners have no counterpart
#: (the port's are ``obs.cost.analyze_callable`` and ``obs.device_events``)
_NOT_PORTED = {
    **{name: "ROADMAP Queue 1 item 5b" for name in (
        "AlertPolicy", "Autotuner", "FrontierModel", "FrontierPoint", "GatewayConfig",
        "OperationalGateway", "QualityAuditor", "SloEngine", "SloSpec", "autotune",
        "gateway", "quality", "slo")},
    "analyze_compiled": "XLA only; see obs.cost.analyze_callable",
    "xla_events": "XLA only; see obs.device_events",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"obs.{name} is not ported ({_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CostReport", "Counter", "Event", "EventBus", "ExplainPlan", "FlightRecorder", "Gauge",
    "Histogram", "Incident", "IncidentManager", "LabelCardinalityError", "MetricsRegistry",
    "OPENMETRICS_CONTENT_TYPE", "PROMETHEUS_CONTENT_TYPE", "PerfLedger", "QueryArchive",
    "Span", "TailSampler", "analyze_callable", "capture_async", "cost", "current_span",
    "default_archive", "default_bus", "default_ledger", "default_recorder",
    "default_registry", "device_events", "events", "events_snapshot", "explain",
    "explain_snapshot", "export", "finish_span", "flight", "flight_snapshot", "health",
    "incidents", "incidents_snapshot", "install", "last_capture", "ledger_snapshot",
    "negotiate_content_type", "next_request_id", "open_span", "perf", "profile", "profiler",
    "publish", "recent_spans", "record_cost", "refresh_live_buffer_gauges",
    "refresh_page_gauges", "registry", "set_enabled", "slowlog", "slowlog_snapshot",
    "snapshot", "snapshot_json", "span", "spans", "spans_snapshot", "subscribe",
    "to_openmetrics", "to_prometheus", "write_snapshot",
]
