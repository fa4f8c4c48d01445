"""SLO engine (counterpart of ``raft_tpu.obs.slo``): objectives, error
budgets, multi-window burn-rate alerts.

The registry answers *what is happening* (latency histograms, recall
EWMAs, error counters); this module answers *is it acceptable* — the
signals-to-semantics layer operators actually page on.  Each
:class:`SloSpec` declares an objective over one served index:

- ``availability`` — fraction of requests that resolve without error,
  from ``raft_tpu_serve_requests_total`` + the per-cause
  ``raft_tpu_serve_errors_total`` counters;
- ``latency`` — fraction of requests under the target latency, from the
  ``raft_tpu_serve_request_seconds`` histogram ladder (the bucket edges
  at or below the target count as good);
- ``recall`` — the :class:`~raft_tpu_torch.obs.quality.QualityAuditor` recall
  EWMA against the objective floor;
- ``freshness`` — mutation backlog age
  (:meth:`~raft_tpu_torch.serve.mutation.MutableIndex.backlog_age_s`) under
  the target staleness bound.

A background thread (or explicit :meth:`SloEngine.evaluate_once` calls
— tests drive a synthetic clock instead of sleeping) samples each
source into a sliding ring and evaluates the Google-SRE multi-window
multi-burn-rate policy: the **fast** pair (5 m short / 1 h long, burn
14.4×) catches budget-torching outages in minutes, the **slow** pair
(6 h short / 3 d long, burn 1×) catches slow leaks; an alert fires only
when *both* windows of a pair burn, and re-arms when the short window
recovers — the alarm-fatigue fix a single EWMA threshold lacks.  All
windows (and the evaluation period) scale by
``RAFT_TPU_SLO_WINDOW_SCALE`` so tests run the same policy in
seconds.

Alert edges publish ``slo_burn`` events on the obs bus (opening
incidents, dumping flight artifacts); budget state exports as
``raft_tpu_slo_budget_remaining{slo=}`` /
``raft_tpu_slo_burn_rate{slo=,window=}`` gauges; an exhausted budget
turns ``SearchService.healthz()`` DEGRADED — serving keeps working,
but the operator contract is broken and releases should freeze.

``slo_burn`` edges are also *actuated*, not just paged on: the serve
layer's :class:`~raft_tpu_torch.serve.overload.AdmissionController`
subscribes to them and raises its shed pressure floor while any burn
alert for its index is live (the ``recovered=True`` edge releases the
latch) — the closed loop from "budget is burning" to "lowest-priority
traffic is shed".
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.obs import events as _events
from raft_tpu_torch.obs.registry import MetricsRegistry, default_registry

#: spec kinds understood by the evaluator
KINDS = ("availability", "latency", "recall", "freshness")

#: objective applied to threshold-style specs built by watch_index
#: (latency-under-target, freshness-under-bound)
THRESHOLD_OBJECTIVE = 0.99

#: default evaluation period (seconds, pre-scale)
DEFAULT_EVAL_S = 10.0

#: default error-budget window (seconds, pre-scale): 30 days
DEFAULT_BUDGET_WINDOW_S = 30.0 * 86400.0

#: hard cap on retained samples per spec (memory bound; at the default
#: 10 s tick this spans ~7.6 days — a real deployment would lower the
#: budget window or raise the tick, both env knobs)
MAX_SAMPLES = 65536


@dataclass(frozen=True)
class AlertPolicy:
    """One multi-window burn-rate rule: fire when both the long and the
    short window burn faster than ``max_burn``× budget."""

    name: str
    long_s: float
    short_s: float
    max_burn: float
    severity: str


#: the Google-SRE fast/slow pairs (pre-scale seconds)
ALERT_POLICIES: Tuple[AlertPolicy, ...] = (
    AlertPolicy("fast", long_s=3600.0, short_s=300.0,
                max_burn=14.4, severity="page"),
    AlertPolicy("slow", long_s=3.0 * 86400.0, short_s=6.0 * 3600.0,
                max_burn=1.0, severity="ticket"),
)


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective over one served index.

    ``objective`` is the good fraction promised (0.999 = three nines);
    ``target`` parameterizes threshold kinds (latency target in
    *seconds*, freshness bound in seconds; unused for availability /
    recall).
    """

    name: str
    index: str
    kind: str
    objective: float
    target: float = 0.0
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown SLO kind {self.kind!r}; known: {KINDS}"
            )
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )


class _SpecState:
    """Per-spec evaluator state: the sample ring plus cumulative-counter
    baselines and per-policy alert latches."""

    __slots__ = ("spec", "samples", "prev_bad", "prev_total", "fired",
                 "budget_remaining", "burn", "sli", "first_t")

    def __init__(self, spec: SloSpec, maxlen: int):
        self.spec = spec
        # (t, bad, weight): weight is interval requests for counter
        # kinds, 1.0 for gauge kinds
        self.samples: deque = deque(maxlen=maxlen)
        self.prev_bad: Optional[float] = None
        self.prev_total: Optional[float] = None
        self.fired: Dict[str, bool] = {}
        self.budget_remaining = 1.0
        self.burn: Dict[str, Dict[str, float]] = {}
        self.sli: Optional[float] = None
        self.first_t: Optional[float] = None


def _env_scale() -> float:
    try:
        return max(1e-9, _env.env_float("RAFT_TPU_SLO_WINDOW_SCALE", 1.0))
    except ValueError:
        return 1.0


def _env_eval_s() -> float:
    try:
        return max(1e-4, _env.env_float("RAFT_TPU_SLO_EVAL_S",
                                        DEFAULT_EVAL_S))
    except ValueError:
        return DEFAULT_EVAL_S


def _env_budget_window_s() -> float:
    try:
        return max(1e-3, _env.env_float("RAFT_TPU_SLO_BUDGET_WINDOW_S",
                                        DEFAULT_BUDGET_WINDOW_S))
    except ValueError:
        return DEFAULT_BUDGET_WINDOW_S


def default_specs(index: str) -> List[SloSpec]:
    """The four standard objectives for one served index, parameterized
    by the ``RAFT_TPU_SLO_*`` env knobs."""
    availability = _env.env_float("RAFT_TPU_SLO_AVAILABILITY", 0.999)
    p99_ms = _env.env_float("RAFT_TPU_SLO_P99_MS", 250.0)
    recall = _env.env_float("RAFT_TPU_SLO_RECALL", 0.9)
    freshness_s = _env.env_float("RAFT_TPU_SLO_FRESHNESS_S", 300.0)
    return [
        SloSpec(f"{index}-availability", index, "availability",
                objective=availability,
                description="requests resolving without error"),
        SloSpec(f"{index}-latency", index, "latency",
                objective=THRESHOLD_OBJECTIVE, target=p99_ms / 1e3,
                description=f"requests under {p99_ms:g} ms"),
        SloSpec(f"{index}-recall", index, "recall",
                objective=recall,
                description="audited recall@k EWMA"),
        SloSpec(f"{index}-freshness", index, "freshness",
                objective=THRESHOLD_OBJECTIVE, target=freshness_s,
                description=f"mutation backlog younger than "
                            f"{freshness_s:g} s"),
    ]


class SloEngine:
    """Evaluates :class:`SloSpec` rings into budgets and alerts.

    ``service`` (a :class:`~raft_tpu_torch.serve.SearchService`) supplies the
    recall and freshness sources; availability and latency read the
    metrics registry directly, so an engine without a service still
    covers those.  ``start()`` runs the background evaluator;
    :meth:`evaluate_once` is the deterministic entry tests and the
    bench leg drive directly.
    """

    def __init__(self, specs: Sequence[SloSpec] = (), *,
                 service=None,
                 registry: Optional[MetricsRegistry] = None,
                 scale: Optional[float] = None,
                 eval_s: Optional[float] = None,
                 budget_window_s: Optional[float] = None):
        self._registry = registry if registry is not None \
            else default_registry()
        self._scale = scale if scale is not None else _env_scale()
        self._eval_s = (
            eval_s if eval_s is not None else _env_eval_s()
        ) * self._scale
        self._budget_window_s = (
            budget_window_s if budget_window_s is not None
            else _env_budget_window_s()
        ) * self._scale
        self._service = service
        self._lock = threading.Lock()
        maxlen = int(self._budget_window_s / max(self._eval_s, 1e-9)) + 8
        self._maxlen = max(64, min(maxlen, MAX_SAMPLES))
        self._states: Dict[str, _SpecState] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for spec in specs:
            self.add_spec(spec)
        self._registry.register_provider("slo", self.snapshot)

    # -- spec management -----------------------------------------------------
    def add_spec(self, spec: SloSpec) -> None:
        """Register ``spec`` (replacing a same-named one).  The
        cumulative-counter baseline primes immediately, so history from
        before the spec existed never counts against its budget."""
        state = _SpecState(spec, self._maxlen)
        state.prev_bad, state.prev_total = self._cumulative(spec)
        with self._lock:
            self._states[spec.name] = state

    def remove_spec(self, name: str) -> None:
        with self._lock:
            self._states.pop(name, None)
        for metric, labels in (
            ("raft_tpu_slo_budget_remaining", {"slo": name}),
            ("raft_tpu_slo_burn_rate", {"slo": name}),
            ("raft_tpu_slo_alert", {"slo": name}),
        ):
            self._registry.gauge(metric).remove_matching(**labels)

    def watch_index(self, index: str) -> None:
        """Add the four :func:`default_specs` objectives for ``index``."""
        for spec in default_specs(index):
            self.add_spec(spec)

    def unwatch_index(self, index: str) -> None:
        with self._lock:
            dead = [n for n, s in self._states.items()
                    if s.spec.index == index]
        for name in dead:
            self.remove_spec(name)

    def specs(self) -> List[SloSpec]:
        with self._lock:
            return [s.spec for s in self._states.values()]

    # -- sources -------------------------------------------------------------
    def _cumulative(self, spec: SloSpec
                    ) -> Tuple[Optional[float], Optional[float]]:
        """(cumulative bad, cumulative total) for counter-style kinds;
        (None, None) for gauge-style kinds."""
        if spec.kind == "availability":
            errors = 0.0
            for key, v in self._registry.counter(
                "raft_tpu_serve_errors_total"
            ).collect().items():
                if ("index", spec.index) in key:
                    errors += v
            requests = self._registry.counter(
                "raft_tpu_serve_requests_total"
            ).value(index=spec.index)
            return errors, requests + errors
        if spec.kind == "latency":
            hist = self._registry.histogram(
                "raft_tpu_serve_request_seconds"
            )
            good = 0.0
            total = 0.0
            # bucket_totals, not collect(): collect copies every series'
            # raw reservoir under the lock observe() contends on — at the
            # evaluator's tick rate that stalls the serving hot path
            for key, (bucket_counts, count) in hist.bucket_totals().items():
                if ("index", spec.index) not in key:
                    continue
                total += count
                for i, c in enumerate(bucket_counts):
                    if hist.bucket_edge(i) <= spec.target:
                        good += c
            return total - good, total
        return None, None

    def _gauge_bad_fraction(self, spec: SloSpec) -> Optional[float]:
        """Instantaneous bad fraction for gauge-style kinds, or None when
        the source has no data yet."""
        if spec.kind == "recall":
            auditor = getattr(self._service, "auditor", None)
            if auditor is None:
                return None
            ewma = auditor.recall_ewma(spec.index)
            if ewma is None:
                return None
            return min(1.0, max(0.0, 1.0 - float(ewma)))
        if spec.kind == "freshness":
            service = self._service
            if service is None:
                return None
            try:
                index = service.registry.get(spec.index)
            except KeyError:
                return None
            age_fn = getattr(index, "backlog_age_s", None)
            if age_fn is None:
                return 0.0  # immutable index: never stale
            return 1.0 if float(age_fn()) > spec.target else 0.0
        return None

    # -- evaluation ----------------------------------------------------------
    @traced("slo.evaluate")
    def evaluate_once(self, now: Optional[float] = None
                      ) -> Dict[str, object]:
        """One evaluation tick: sample every spec, update windows,
        budgets, gauges and alert latches; publish ``slo_burn`` edges.
        ``now`` is monotonic-clock seconds (tests pass a synthetic
        clock; production passes nothing)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            states = list(self._states.values())
        report: Dict[str, object] = {}
        for state in states:
            report[state.spec.name] = self._evaluate_spec(state, now)
        return report

    def _evaluate_spec(self, state: _SpecState, now: float
                       ) -> Dict[str, object]:
        spec = state.spec
        # -- sample
        if spec.kind in ("availability", "latency"):
            bad_c, total_c = self._cumulative(spec)
            prev_bad = state.prev_bad if state.prev_bad is not None else 0.0
            prev_total = (
                state.prev_total if state.prev_total is not None else 0.0
            )
            bad = max(0.0, bad_c - prev_bad)
            weight = max(0.0, total_c - prev_total)
            state.prev_bad, state.prev_total = bad_c, total_c
            state.samples.append((now, bad, weight))
        else:
            frac = self._gauge_bad_fraction(spec)
            if frac is not None:
                state.samples.append((now, frac, 1.0))
        if state.first_t is None and state.samples:
            state.first_t = state.samples[0][0]
        budget = max(1e-9, 1.0 - spec.objective)

        def rate(window_s: float) -> float:
            lo = now - window_s
            bad_sum = 0.0
            w_sum = 0.0
            for t, b, w in reversed(state.samples):
                if t < lo:
                    break
                bad_sum += b
                w_sum += w
            return bad_sum / w_sum if w_sum > 0.0 else 0.0

        # -- budget over the (scaled) budget window, prorated by how
        # much of it has actually been observed
        observed = 0.0 if state.first_t is None else now - state.first_t
        span_frac = min(1.0, observed / self._budget_window_s) \
            if self._budget_window_s > 0 else 1.0
        consumed = (rate(self._budget_window_s) / budget) * span_frac
        state.budget_remaining = 1.0 - consumed
        g_budget = self._registry.gauge(
            "raft_tpu_slo_budget_remaining",
            help="error budget left in the rolling window (1 = untouched, "
                 "<= 0 = exhausted)",
        )
        g_budget.set(state.budget_remaining, slo=spec.name)
        g_burn = self._registry.gauge(
            "raft_tpu_slo_burn_rate",
            help="error-budget burn rate per alert window (1.0 = exactly "
                 "on budget)",
        )
        g_alert = self._registry.gauge(
            "raft_tpu_slo_alert",
            help="1 while a burn-rate alert is firing",
        )

        # -- multi-window multi-burn-rate alerts
        burns: Dict[str, Dict[str, float]] = {}
        for policy in ALERT_POLICIES:
            burn_long = rate(policy.long_s * self._scale) / budget
            burn_short = rate(policy.short_s * self._scale) / budget
            g_burn.set(burn_long, slo=spec.name, window=policy.name)
            firing = burn_long > policy.max_burn \
                and burn_short > policy.max_burn
            was = state.fired.get(policy.name, False)
            if firing and not was:
                state.fired[policy.name] = True
                _events.publish(
                    "slo_burn", f"slo_burn_{spec.name}",
                    slo=spec.name, index=spec.index, slo_kind=spec.kind,
                    policy=policy.name, severity=policy.severity,
                    burn_long=burn_long, burn_short=burn_short,
                    threshold=policy.max_burn,
                    budget_remaining=state.budget_remaining,
                )
            elif was and burn_short <= policy.max_burn:
                # the short window recovered: re-arm (and tell the
                # incident manager the story is over)
                state.fired[policy.name] = False
                _events.publish(
                    "slo_burn", f"slo_burn_{spec.name}", recovered=True,
                    slo=spec.name, index=spec.index, policy=policy.name,
                    burn_short=burn_short,
                )
            g_alert.set(
                1.0 if state.fired.get(policy.name, False) else 0.0,
                slo=spec.name, policy=policy.name,
            )
            burns[policy.name] = {
                "long": burn_long, "short": burn_short,
                "threshold": policy.max_burn,
                "firing": state.fired.get(policy.name, False),
            }
        state.burn = burns
        if state.samples:
            _, b, w = state.samples[-1]
            state.sli = 1.0 - (b / w if w > 0 else 0.0)
        return {
            "kind": spec.kind,
            "index": spec.index,
            "objective": spec.objective,
            "sli": state.sli,
            "budget_remaining": state.budget_remaining,
            "burn": burns,
            "samples": len(state.samples),
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Run the background evaluator (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="raft-tpu-slo", daemon=True
            )
            thread = self._thread
        thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._eval_s):
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — the evaluator must survive
                self._registry.counter(
                    "raft_tpu_slo_eval_errors_total",
                    help="exceptions swallowed in the SLO evaluator",
                ).inc()

    def stop(self) -> None:
        """Stop the evaluator thread and detach the snapshot provider."""
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        self._registry.unregister_provider("slo", expected=self.snapshot)

    # -- reading -------------------------------------------------------------
    def budget_remaining(self, name: str) -> Optional[float]:
        with self._lock:
            state = self._states.get(name)
            return state.budget_remaining if state is not None else None

    def health(self) -> Dict[str, List[str]]:
        """``{"exhausted": [spec names], "alerting": [spec names]}`` —
        the slice ``healthz()`` folds into its verdict."""
        with self._lock:
            exhausted = [
                n for n, s in self._states.items()
                if s.budget_remaining <= 0.0
            ]
            alerting = [
                n for n, s in self._states.items()
                if any(s.fired.values())
            ]
        return {"exhausted": exhausted, "alerting": alerting}

    def paging(self) -> List[str]:
        """Spec names with a *page-severity* burn alert currently firing.

        The slice a closed-loop controller should act on: page policies
        (short windows) re-arm as soon as the short window recovers, so
        the signal tracks the incident edge-to-edge.  Ticket-severity
        latches span the long window and would hold a controller in the
        shed state long after the cause cleared.
        """
        page = {p.name for p in ALERT_POLICIES if p.severity == "page"}
        with self._lock:
            return [
                n for n, s in self._states.items()
                if any(s.fired.get(p, False) for p in page)
            ]

    def snapshot(self) -> Dict[str, object]:
        """Provider section for registry snapshots."""
        with self._lock:
            states = list(self._states.values())
        return {
            "scale": self._scale,
            "eval_s": self._eval_s,
            "budget_window_s": self._budget_window_s,
            "specs": {
                s.spec.name: {
                    "kind": s.spec.kind,
                    "index": s.spec.index,
                    "objective": s.spec.objective,
                    "target": s.spec.target,
                    "sli": s.sli,
                    "budget_remaining": s.budget_remaining,
                    "burn": s.burn,
                    "samples": len(s.samples),
                }
                for s in states
            },
        }
