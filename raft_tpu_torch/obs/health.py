"""Aggregated health verdicts (counterpart of ``raft_tpu.obs.health``):
one answer to "should this replica serve?".

Folds the signals the serve stack already produces — warmup state, kernel
builds on the dispatch thread after warmup, queue depth, the pipeline
window, audited recall, compaction and overload state, the card's memory
headroom, the page budget — into per-index and overall ``OK`` /
``DEGRADED`` / ``UNHEALTHY`` verdicts, published as the ``raft_tpu_health``
gauge (0/1/2) and returned by ``SearchService.healthz()``.

Thresholds are raft_tpu's documented constants: any hot-path build after
warmup is DEGRADED and ``COMPILE_STORM`` of them UNHEALTHY; queue depth past
``QUEUE_DEGRADED_FACTOR`` / ``QUEUE_UNHEALTHY_FACTOR`` x max_batch; recall
EWMA under the auditor's threshold (half of it: UNHEALTHY); device memory
past ``MEM_DEGRADED_FRAC`` / ``MEM_UNHEALTHY_FRAC`` of the card
(:func:`device_memory_check` reads ``torch.cuda.mem_get_info``; no card
reads as unknown → OK).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from raft_tpu_torch.obs import events, flight
from raft_tpu_torch.obs.registry import MetricsRegistry, default_registry

OK = "OK"
DEGRADED = "DEGRADED"
UNHEALTHY = "UNHEALTHY"

#: gauge encoding (and severity order) of the verdicts
VERDICT_VALUES = {OK: 0, DEGRADED: 1, UNHEALTHY: 2}

COMPILE_STORM = 5            # hot-path kernel builds → UNHEALTHY at this many
QUEUE_DEGRADED_FACTOR = 4    # queue depth in units of max_batch
QUEUE_UNHEALTHY_FACTOR = 16
MEM_DEGRADED_FRAC = 0.90
MEM_UNHEALTHY_FRAC = 0.98


def worst(*verdicts: str) -> str:
    return max(verdicts, key=lambda v: VERDICT_VALUES[v], default=OK)


@dataclass
class IndexProbe:
    """Raw signals for one served index, gathered by the service."""

    warm: bool
    recompiles: int                         # kernel builds / library loads after warmup
    queue_depth: int
    max_batch: int
    pipeline_depth: int = 1                 # in-flight window bound (1=serial)
    inflight: int = 0                       # device batches currently in flight
    recall_ewma: Optional[float] = None     # None: auditor off / no audits yet
    recall_threshold: Optional[float] = None
    # compaction signals (None throughout: no compactor attached)
    compaction_backlog: Optional[int] = None   # pending deletes + side rows
    compaction_trigger: Optional[int] = None   # rows at which a pass fires
    compaction_last_abort: Optional[str] = None  # unresolved abort reason
    # overload actuators (None: no admission controller / degraded manager)
    admission_level: Optional[int] = None      # current shed pressure level
    degraded_level: Optional[int] = None       # current reduced-effort level
    # closed-loop autotuner (None: no autotuner attached)
    autotune_level: Optional[int] = None       # controller's effort level
    autotune_pinned_min: bool = False          # burning with no effort left


def _check(status: str, detail: str) -> Dict[str, str]:
    return {"status": status, "detail": detail}


def index_health(probe: IndexProbe) -> Dict[str, object]:
    """Fold one index's probe into {"status", "checks": {...}}."""
    checks: Dict[str, Dict[str, str]] = {}

    checks["warmup"] = (
        _check(OK, "bucket ladder warmed")
        if probe.warm
        else _check(DEGRADED, "warmup not run; first queries will build kernels")
    )

    if probe.recompiles >= COMPILE_STORM:
        checks["compiles"] = _check(
            UNHEALTHY,
            f"{probe.recompiles} kernel builds on the dispatch thread (compile storm)",
        )
    elif probe.recompiles > 0:
        checks["compiles"] = _check(
            DEGRADED, f"{probe.recompiles} kernel builds on the dispatch thread after warmup"
        )
    else:
        checks["compiles"] = _check(OK, "0 kernel builds after warmup")

    depth, cap = probe.queue_depth, max(probe.max_batch, 1)
    if depth > QUEUE_UNHEALTHY_FACTOR * cap:
        checks["queue"] = _check(
            UNHEALTHY, f"queue depth {depth} >> max_batch {cap}"
        )
    elif depth > QUEUE_DEGRADED_FACTOR * cap:
        checks["queue"] = _check(
            DEGRADED, f"queue depth {depth} > {QUEUE_DEGRADED_FACTOR}x max_batch"
        )
    else:
        checks["queue"] = _check(OK, f"queue depth {depth}")

    # the pipeline's one invariant: in-flight batches never exceed the
    # configured window.  An overrun means the semaphore bound broke —
    # live device memory is no longer bounded — which is a bug, not load.
    if probe.inflight > probe.pipeline_depth:
        checks["pipeline"] = _check(
            UNHEALTHY,
            f"{probe.inflight} batches in flight > pipeline_depth "
            f"{probe.pipeline_depth} (window invariant broken)",
        )
    else:
        checks["pipeline"] = _check(
            OK,
            f"in-flight {probe.inflight} / depth {probe.pipeline_depth}",
        )

    if probe.recall_ewma is None or probe.recall_threshold is None:
        checks["recall"] = _check(OK, "no audited recall yet")
    elif probe.recall_ewma < probe.recall_threshold * 0.5:
        checks["recall"] = _check(
            UNHEALTHY,
            f"recall ewma {probe.recall_ewma:.3f} < half of threshold "
            f"{probe.recall_threshold:.3f}",
        )
    elif probe.recall_ewma < probe.recall_threshold:
        checks["recall"] = _check(
            DEGRADED,
            f"recall ewma {probe.recall_ewma:.3f} < threshold "
            f"{probe.recall_threshold:.3f}",
        )
    else:
        checks["recall"] = _check(
            OK, f"recall ewma {probe.recall_ewma:.3f}"
        )

    # compaction: an unresolved abort means maintenance is wedged (the
    # backlog keeps growing until an operator looks), and a backlog far
    # past the trigger means the compactor cannot keep up with churn —
    # both are DEGRADED, never UNHEALTHY: serving itself still answers.
    if probe.compaction_backlog is None:
        checks["compaction"] = _check(OK, "no compactor attached")
    elif probe.compaction_last_abort:
        checks["compaction"] = _check(
            DEGRADED,
            f"last compaction aborted ({probe.compaction_last_abort}); "
            f"backlog {probe.compaction_backlog}",
        )
    elif (
        probe.compaction_trigger
        and probe.compaction_backlog
        > QUEUE_DEGRADED_FACTOR * probe.compaction_trigger
    ):
        checks["compaction"] = _check(
            DEGRADED,
            f"compaction backlog {probe.compaction_backlog} >> trigger "
            f"{probe.compaction_trigger} (compactor falling behind)",
        )
    else:
        checks["compaction"] = _check(
            OK, f"compaction backlog {probe.compaction_backlog}"
        )

    # overload: a non-zero actuator level is DEGRADED by design — the
    # service is *choosing* reduced work (shedding or cheaper search) to
    # protect p0 latency.  Never UNHEALTHY: that's what the actuators
    # exist to prevent, and an UNHEALTHY verdict would pull the replica
    # from rotation and dump its load on the others mid-overload.
    if probe.admission_level is None and probe.degraded_level is None:
        checks["overload"] = _check(OK, "no overload controller attached")
    elif (probe.admission_level or 0) or (probe.degraded_level or 0):
        checks["overload"] = _check(
            DEGRADED,
            f"shedding at level {probe.admission_level or 0}, "
            f"degraded search level {probe.degraded_level or 0}",
        )
    else:
        checks["overload"] = _check(OK, "no pressure; full-effort search")

    # autotuner: like overload, reduced effort is DEGRADED by design and
    # never UNHEALTHY — the controller is trading recall headroom for
    # latency on purpose.  Pinned at minimum effort is the alarming
    # shape: the latency budget is still burning and the ladder has
    # nothing left to shed, so only an operator (capacity) can help.
    if probe.autotune_level is None:
        checks["autotune"] = _check(OK, "no autotuner attached")
    elif probe.autotune_pinned_min:
        checks["autotune"] = _check(
            DEGRADED,
            f"pinned at minimum effort (level {probe.autotune_level}) "
            f"with the latency budget still burning",
        )
    elif probe.autotune_level > 0:
        checks["autotune"] = _check(
            DEGRADED,
            f"autotuned to effort level {probe.autotune_level} "
            f"(trading recall margin for QPS/latency)",
        )
    else:
        checks["autotune"] = _check(OK, "autotuner at full effort")

    status = worst(*(c["status"] for c in checks.values()))
    return {"status": status, "checks": checks}


def device_memory_check() -> Dict[str, str]:
    """Headroom on the current CUDA device (used = total - free, which
    counts every process on the card); unknown (OK) without a card."""
    try:
        import torch

        if not torch.cuda.is_available():
            return _check(OK, "memory stats unavailable: no CUDA device")
        free, limit = torch.cuda.mem_get_info()
        used = limit - free
        allocated = torch.cuda.memory_allocated()
    except Exception:
        return _check(OK, "memory stats unavailable on this backend")
    if not limit:
        return _check(OK, "memory stats incomplete on this backend")
    frac = used / limit
    detail = (f"{used / 2**20:.0f}MiB / {limit / 2**20:.0f}MiB ({frac:.0%}); "
              f"{allocated / 2**20:.0f}MiB allocated by this process")
    if frac > MEM_UNHEALTHY_FRAC:
        return _check(UNHEALTHY, "device memory exhausted: " + detail)
    if frac > MEM_DEGRADED_FRAC:
        return _check(DEGRADED, "device memory pressure: " + detail)
    return _check(OK, detail)


# previous overall verdict, for edge detection: the flight recorder dumps
# on the *transition* into UNHEALTHY, not on every red healthz() poll
_transition_lock = threading.Lock()
_prev_overall: Optional[str] = None


def reset_transitions() -> None:
    """Forget the last seen overall verdict (test isolation)."""
    global _prev_overall
    with _transition_lock:
        _prev_overall = None


def slo_check(slo_health: Optional[Dict[str, object]]) -> Dict[str, object]:
    """Fold an ``SloEngine.health()`` (ROADMAP Queue 1 item 5b) slice into a
    health check: an exhausted error budget is DEGRADED — serving still
    works, but the operator contract is broken and releases should
    freeze until the budget window rolls."""
    if not slo_health:
        return _check(OK, "no SLOs configured")
    exhausted = list(slo_health.get("exhausted") or ())
    alerting = list(slo_health.get("alerting") or ())
    if exhausted:
        return _check(
            DEGRADED,
            "error budget exhausted: " + ", ".join(sorted(exhausted)),
        )
    if alerting:
        return _check(
            OK, "burn-rate alert firing: " + ", ".join(sorted(alerting))
        )
    return _check(OK, "budgets healthy")


def perf_check(perf: Optional[Dict[str, object]]) -> Dict[str, object]:
    """Fold a :meth:`~raft_tpu_torch.obs.perf.PerfLedger.health_slice` into a
    health check: a device-time regression still inside its debounce
    window is DEGRADED — the executable answers, but slower than its own
    baseline, and the auto-captured profile is waiting to be read."""
    if not perf:
        return _check(OK, "perf ledger off or no dispatches yet")
    active = list(perf.get("active_regressions") or ())
    if active:
        return _check(
            DEGRADED,
            "device-time regression on: " + ", ".join(sorted(active)),
        )
    return _check(OK, "no active device-time regressions")


def budget_check(snapshot: Dict[str, object]) -> Dict[str, object]:
    """Fold a :meth:`raft_tpu_torch.store.budget.MemoryBudget.snapshot` into a
    health check: a near-fully-reserved page budget is DEGRADED — the
    next pagination or page admission will raise ``BudgetExceeded``, so
    the operator hears about the pressure *before* the loud failure."""
    limit = float(snapshot.get("limit_bytes", 0) or 0)
    reserved = float(snapshot.get("reserved_bytes", 0) or 0)
    util = reserved / limit if limit else 0.0
    status = DEGRADED if util >= 0.98 else OK
    out = _check(
        status,
        f"page budget {reserved:.0f}/{limit:.0f}B reserved "
        f"({100.0 * util:.1f}%)",
    )
    out["snapshot"] = dict(snapshot)
    return out


def build_report(
    probes: Dict[str, IndexProbe],
    registry: Optional[MetricsRegistry] = None,
    slo: Optional[Dict[str, object]] = None,
    perf: Optional[Dict[str, object]] = None,
    budget: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """Assemble the service-wide report and publish ``raft_tpu_health``.

    One gauge series per index plus ``index=overall`` — the overall
    verdict also folds in the device memory check (a property of the
    process, not of any one index) and, when ``slo`` (an
    ``SloEngine.health()`` slice) is passed, the error-budget check.  A
    transition *into* UNHEALTHY publishes a ``health_edge`` event on the
    obs bus (whose flight subscriber dumps the ring, debounced), the
    transition back out publishes the recovery edge, and the report's
    ``flight`` key carries the most recent dump's paths so the healthz
    payload that announces the incident also says where the evidence is.
    """
    global _prev_overall
    reg = registry if registry is not None else default_registry()
    gauge = reg.gauge(
        "raft_tpu_health",
        help="serving health verdict (0=OK, 1=DEGRADED, 2=UNHEALTHY)",
    )
    indexes: Dict[str, object] = {}
    statuses = []
    for name, probe in probes.items():
        rep = index_health(probe)
        indexes[name] = rep
        statuses.append(rep["status"])
        gauge.set(VERDICT_VALUES[rep["status"]], index=name)
    mem = device_memory_check()
    slo_c = slo_check(slo) if slo is not None else None
    if slo_c is not None:
        statuses.append(slo_c["status"])
    perf_c = perf_check(perf) if perf is not None else None
    if perf_c is not None:
        statuses.append(perf_c["status"])
    budget_c = budget_check(budget) if budget is not None else None
    if budget_c is not None:
        statuses.append(budget_c["status"])
    overall = worst(mem["status"], *statuses)
    gauge.set(VERDICT_VALUES[overall], index="overall")
    with _transition_lock:
        went_unhealthy = overall == UNHEALTHY and _prev_overall != UNHEALTHY
        recovered = _prev_overall == UNHEALTHY and overall != UNHEALTHY
        _prev_overall = overall
    if went_unhealthy:
        events.publish(
            "health_edge", "health_unhealthy",
            status=overall,
            indexes={n: r["status"] for n, r in indexes.items()},
        )
    elif recovered:
        events.publish(
            "health_edge", "health_recovered", recovered=True,
            status=overall,
        )
    report = {
        "status": overall,
        "memory": mem,
        "indexes": indexes,
        "flight": flight.last_dump(),
    }
    if slo_c is not None:
        report["slo"] = slo_c
    if perf_c is not None:
        report["perf"] = perf_c
    if budget_c is not None:
        report["budget"] = budget_c
    return report
