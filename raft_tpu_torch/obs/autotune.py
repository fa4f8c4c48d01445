"""Closed-loop SLO autotuner (counterpart of ``raft_tpu.obs.autotune``): live
Pareto navigation of search effort.

Everything upstream of this module *observes* — the
:class:`~raft_tpu_torch.obs.quality.QualityAuditor` maintains a recall EWMA,
the :class:`~raft_tpu_torch.obs.slo.SloEngine` burns error budgets, the
:class:`~raft_tpu_torch.obs.perf.PerfLedger` attributes device seconds —
and the overload hysteresis ladder is the only other actuator.  This module
closes the loop:

- :class:`FrontierModel` — the measured QPS–recall frontier a
  ``python -m raft_tpu_torch.bench frontier`` sweep emits (effort point →
  measured QPS, recall, device-seconds/query), serialized as a
  schema-versioned document and loadable at serve time
  (``RAFT_TPU_FRONTIER_PATH``).
- :class:`Autotuner` — a background evaluator (same thread/tick
  pattern as :class:`~raft_tpu_torch.obs.slo.SloEngine`) that walks each
  watched index along its warmed effort ladder toward
  *max QPS subject to (recall EWMA ≥ floor, p99 error budget healthy)*:

  * measured recall below the floor raises effort immediately — recall
    is the hard constraint, no hysteresis on the way up;
  * a burning/exhausted latency SLO sheds effort one notch after
    ``degrade_ticks`` consecutive bad ticks;
  * sustained health walks the level back toward the frontier optimum
    (the least-effort warmed point whose predicted recall clears the
    floor) after ``restore_ticks`` consecutive calm ticks.

All movement goes through the single-writer
:class:`~raft_tpu_torch.serve.effort.EffortArbiter` (the overload shed level
clamps, it never writes), every step publishes an ``autotune_step``
context event (annotating the incident the motivating ``slo_burn``
opened), and every tick refreshes the
``raft_tpu_autotune_{level,recall_floor_margin,predicted_qps}`` gauges
(retired with the standard ``remove_matching`` discipline on unwatch).
Because the serving warmup runs every level of the ladder, a step never
builds a kernel on the dispatch thread: the knob values are host arguments
of kernels already built and loaded.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.obs import events as _events
from raft_tpu_torch.obs.registry import MetricsRegistry, default_registry

FRONTIER_SCHEMA = "raft_tpu.frontier"
FRONTIER_SCHEMA_VERSION = 1

#: synthetic fallback model (no frontier file loaded): each ladder level
#: is assumed to trade this much recall for this QPS multiplier — shaped
#: like the measured sweeps (halving n_probes/itopk roughly halves device
#: work and costs a couple recall points), only used for *predictions*,
#: never reported as a measurement
_SYNTH_QPS_GAIN_PER_LEVEL = 1.6
_SYNTH_RECALL_DROP_PER_LEVEL = 0.02


def _scale() -> float:
    return float(_env.env_float("RAFT_TPU_SLO_WINDOW_SCALE", 1.0))


@dataclass
class FrontierPoint:
    """One measured operating point on a backend's QPS–recall frontier."""

    effort: Dict[str, object]
    qps: float
    recall: float
    device_s_per_query: Optional[float] = None

    def to_dict(self) -> Dict[str, object]:
        return {
            "effort": dict(self.effort),
            "qps": float(self.qps),
            "recall": float(self.recall),
            "device_s_per_query": self.device_s_per_query,
        }

    @classmethod
    def from_dict(cls, doc: Dict[str, object]) -> "FrontierPoint":
        return cls(
            effort=dict(doc["effort"]),
            qps=float(doc["qps"]),
            recall=float(doc["recall"]),
            device_s_per_query=doc.get("device_s_per_query"),
        )


def pareto(points: List[FrontierPoint]) -> List[FrontierPoint]:
    """Non-dominated subset (no other point has ≥ recall and > qps),
    sorted by recall ascending — the same filter the plot module applies
    to sweep results."""
    keep: List[FrontierPoint] = []
    for p in sorted(points, key=lambda p: (-p.recall, -p.qps)):
        if not keep or p.qps > keep[-1].qps:
            keep.append(p)
    return list(reversed(keep))


class FrontierModel:
    """Serialized measured frontier: backend → pareto-filtered effort
    points.  ``meta`` carries the sweep's provenance (dataset, n, k,
    platform) so a serve-time load can refuse a mismatched frontier."""

    def __init__(self, points: Optional[Dict[str, List[FrontierPoint]]] = None,
                 meta: Optional[Dict[str, object]] = None):
        self.points: Dict[str, List[FrontierPoint]] = points or {}
        self.meta: Dict[str, object] = meta or {}

    def add(self, backend: str, point: FrontierPoint) -> None:
        self.points.setdefault(backend, []).append(point)

    def backends(self) -> List[str]:
        return sorted(self.points)

    def pareto_filter(self) -> None:
        """Reduce every backend's point set to its pareto frontier."""
        for backend in list(self.points):
            self.points[backend] = pareto(self.points[backend])

    def predict(self, backend: str, effort: Dict[str, object]
                ) -> Optional[FrontierPoint]:
        """The measured point closest to an effort spec's knob values
        (exact knob match preferred; otherwise nearest by relative
        distance over shared numeric knobs).  None when the frontier
        has nothing for the backend."""
        candidates = self.points.get(backend) or []
        if not candidates:
            return None
        best, best_d = None, None
        for p in candidates:
            d = 0.0
            shared = 0
            for k, v in effort.items():
                pv = p.effort.get(k)
                if isinstance(v, (int, float)) and isinstance(pv, (int, float)):
                    lo = max(1e-9, min(abs(float(v)), abs(float(pv))))
                    d += abs(float(v) - float(pv)) / lo
                    shared += 1
                elif pv is not None and pv != v:
                    d += 1.0
            if shared == 0 and d == 0.0:
                d = float("inf") if effort else 0.0
            if best_d is None or d < best_d:
                best, best_d = p, d
        return best

    # -- serialization --------------------------------------------------

    def to_dict(self) -> Dict[str, object]:
        return {
            "schema": FRONTIER_SCHEMA,
            "schema_version": FRONTIER_SCHEMA_VERSION,
            "meta": dict(self.meta),
            "points": {
                b: [p.to_dict() for p in pts]
                for b, pts in sorted(self.points.items())
            },
        }

    @classmethod
    def from_dict(cls, doc: Dict[str, object]) -> "FrontierModel":
        if doc.get("schema") != FRONTIER_SCHEMA:
            raise ValueError(
                f"not a {FRONTIER_SCHEMA} document: {doc.get('schema')!r}"
            )
        if int(doc.get("schema_version", 0)) > FRONTIER_SCHEMA_VERSION:
            raise ValueError(
                f"frontier schema_version {doc['schema_version']} is newer "
                f"than this reader ({FRONTIER_SCHEMA_VERSION})"
            )
        model = cls(meta=dict(doc.get("meta", {})))
        for backend, pts in dict(doc.get("points", {})).items():
            model.points[backend] = [FrontierPoint.from_dict(p) for p in pts]
        return model

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "FrontierModel":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


@dataclass
class _IndexState:
    arbiter: object
    backend: Optional[str]
    base_spec: Optional[object]
    floor: float
    auditor: Optional[object] = None
    slo: Optional[object] = None
    perf: Optional[object] = None
    latency_specs: Tuple[str, ...] = ()
    burn_ticks: int = 0
    calm_ticks: int = 0
    pinned_min: bool = False
    last_reason: Optional[str] = None
    steps: int = 0
    predictions: Dict[int, Tuple[Optional[float], Optional[float]]] = field(
        default_factory=dict
    )


class Autotuner:
    """Background controller stepping each watched index's effort level
    through its :class:`~raft_tpu_torch.serve.effort.EffortArbiter`.

    Same lifecycle contract as :class:`~raft_tpu_torch.obs.slo.SloEngine`:
    ``start()`` runs the tick thread, :meth:`evaluate_once` /
    :meth:`step` are the deterministic entries tests and the bench leg
    drive with a synthetic clock, ``stop()`` joins and unregisters the
    snapshot provider.
    """

    def __init__(self, *, eval_s: Optional[float] = None,
                 recall_floor: Optional[float] = None,
                 frontier: Optional[FrontierModel] = None,
                 frontier_path: Optional[str] = None,
                 degrade_ticks: int = 2,
                 restore_ticks: int = 3,
                 registry: Optional[MetricsRegistry] = None):
        self._registry = registry if registry is not None \
            else default_registry()
        self._eval_s = (
            eval_s if eval_s is not None
            else float(_env.env_float("RAFT_TPU_AUTOTUNE_EVAL_S", 2.0))
        ) * _scale()
        self.recall_floor = (
            recall_floor if recall_floor is not None
            else float(_env.env_float("RAFT_TPU_AUTOTUNE_RECALL_FLOOR", 0.9))
        )
        self.degrade_ticks = max(1, int(degrade_ticks))
        self.restore_ticks = max(1, int(restore_ticks))
        if frontier is None:
            path = frontier_path if frontier_path is not None \
                else _env.env_str("RAFT_TPU_FRONTIER_PATH")
            if path:
                frontier = FrontierModel.load(path)
        self.frontier = frontier
        self._lock = threading.Lock()
        self._states: Dict[str, _IndexState] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registry.register_provider("autotune", self.snapshot)

    # -- index management ----------------------------------------------

    def watch_index(self, name: str, arbiter, *, index=None,
                    auditor=None, slo=None, perf=None,
                    floor: Optional[float] = None,
                    latency_specs: Optional[Tuple[str, ...]] = None) -> None:
        """Put ``name`` under closed-loop control.  ``arbiter`` is the
        index's single effort writer; ``auditor``/``slo``/``perf`` are
        the optional measurement taps (a missing tap just removes that
        input from the policy).  ``latency_specs`` names the SloEngine
        specs whose alert/exhaustion means the p99 budget is unhealthy
        (default: the standard ``{name}-latency`` objective)."""
        from raft_tpu_torch.neighbors import effort as _effort  # lazy: obs stays importable alone

        backend = None
        base_spec = None
        if index is not None:
            base_spec = _effort.spec_for_index(index)
            backend = base_spec.backend if base_spec is not None else None
        state = _IndexState(
            arbiter=arbiter, backend=backend, base_spec=base_spec,
            floor=self.recall_floor if floor is None else float(floor),
            auditor=auditor, slo=slo, perf=perf,
            latency_specs=tuple(latency_specs) if latency_specs is not None
            else (f"{name}-latency",),
        )
        state.predictions = self._ladder_predictions(state)
        with self._lock:
            self._states[name] = state

    def unwatch_index(self, name: str) -> None:
        with self._lock:
            self._states.pop(name, None)
        for metric in ("raft_tpu_autotune_level",
                       "raft_tpu_autotune_recall_floor_margin",
                       "raft_tpu_autotune_predicted_qps"):
            self._registry.gauge(metric).remove_matching(index=name)

    # -- the frontier view ---------------------------------------------

    def _ladder_predictions(self, state: _IndexState
                            ) -> Dict[int, Tuple[Optional[float],
                                                 Optional[float]]]:
        """(qps, recall) prediction per warmed ladder level, from the
        loaded frontier when it covers the backend, else the synthetic
        ladder model anchored at level 0 (None, None) — predictions
        scale *relative* trades, they are never reported as measured."""
        out: Dict[int, Tuple[Optional[float], Optional[float]]] = {}
        spec = state.base_spec
        for level in state.arbiter.levels():
            point = None
            if (self.frontier is not None and spec is not None
                    and state.backend):
                point = self.frontier.predict(
                    state.backend, spec.degraded(level).knobs()
                )
            if point is not None:
                out[level] = (point.qps, point.recall)
            elif level == 0:
                out[level] = (None, None)
            else:
                qps0, recall0 = out.get(0, (None, None))
                out[level] = (
                    qps0 * _SYNTH_QPS_GAIN_PER_LEVEL ** level
                    if qps0 is not None else None,
                    recall0 - _SYNTH_RECALL_DROP_PER_LEVEL * level
                    if recall0 is not None else None,
                )
        return out

    def _target_level(self, state: _IndexState) -> int:
        """Frontier optimum: the deepest (least effort → max QPS) warmed
        level whose predicted recall still clears the floor.  Unknown
        predictions are conservative — they do not qualify — so with no
        frontier loaded the optimum is full effort (level 0)."""
        target = 0
        for level in sorted(state.predictions):
            if level == 0:
                continue
            _qps, recall = state.predictions[level]
            if recall is not None and recall >= state.floor:
                target = level
        return target

    # -- controller ----------------------------------------------------

    def evaluate_once(self, now: Optional[float] = None) -> None:
        with self._lock:
            names = list(self._states)
        for name in names:
            self.step(name, now=now)

    @traced("autotune.step")
    def step(self, name: str, now: Optional[float] = None) -> int:
        """One control tick for one index; returns the (possibly new)
        autotune level.  ``now`` is monotonic seconds — tests and the
        bench leg pass a synthetic clock."""
        now = time.monotonic() if now is None else now
        with self._lock:
            state = self._states.get(name)
        if state is None:
            return 0
        arbiter = state.arbiter
        level = arbiter.autotune_level
        ewma = None
        if state.auditor is not None:
            ewma = state.auditor.recall_ewma(name)
        burning = self._latency_burning(state)
        target = self._target_level(state)

        new, reason = level, None
        if ewma is not None and ewma < state.floor and level > 0:
            # hard constraint: measured recall under the floor buys
            # effort back immediately, no hysteresis on the way up
            new, reason = level - 1, "recall_floor"
            state.burn_ticks = state.calm_ticks = 0
        elif burning:
            state.calm_ticks = 0
            state.burn_ticks += 1
            if state.burn_ticks >= self.degrade_ticks:
                state.burn_ticks = 0
                if level < arbiter.max_level and self._recall_allows(
                        state, level + 1, ewma):
                    new, reason = level + 1, "p99_burn"
        else:
            state.burn_ticks = 0
            state.calm_ticks += 1
            if state.calm_ticks >= self.restore_ticks and level != target:
                state.calm_ticks = 0
                step = -1 if level > target else 1
                if step > 0 and not self._recall_allows(
                        state, level + 1, ewma):
                    step = 0
                if step:
                    new, reason = level + step, "frontier_optimum"

        state.pinned_min = burning and level >= arbiter.max_level
        if new != level:
            new = arbiter.set_autotune_level(new)
            state.last_reason = reason
            state.steps += 1
        self._report(name, state, new, reason, ewma)
        return new

    def _latency_burning(self, state: _IndexState) -> bool:
        # page-severity burn latches only, NOT "exhausted" and NOT
        # ticket alerts: a spent budget stays exhausted for the whole
        # rolling budget window, and a ticket latch (slow pair) holds
        # until its scaled multi-hour short window drains — neither can
        # be refunded by shedding effort.  Page latches re-arm as soon
        # as the short window recovers, so the controller tracks the
        # breach edge-to-edge and climbs back once it actually ends.
        if state.slo is None:
            return False
        paging = getattr(state.slo, "paging", None)
        bad = set(paging() if paging is not None
                  else state.slo.health().get("alerting", ()))
        return any(spec in bad for spec in state.latency_specs)

    def _recall_allows(self, state: _IndexState, level: int,
                       ewma: Optional[float]) -> bool:
        """May effort drop to ``level`` without predicted recall (or,
        absent predictions, the live EWMA margin) crossing the floor?"""
        _qps, recall = state.predictions.get(level, (None, None))
        if recall is not None:
            return recall >= state.floor
        if ewma is not None:
            return ewma >= state.floor + _SYNTH_RECALL_DROP_PER_LEVEL
        return True  # no recall signal at all: latency SLO is in charge

    def _report(self, name: str, state: _IndexState, level: int,
                reason: Optional[str], ewma: Optional[float]) -> None:
        qps, _recall = state.predictions.get(level, (None, None))
        if qps is None and state.perf is not None:
            totals = state.perf.totals().get(name)
            if totals and totals.get("device_s", 0.0) > 0 \
                    and totals.get("rows", 0) > 0:
                qps = float(totals["rows"]) / float(totals["device_s"])
        self._registry.gauge(
            "raft_tpu_autotune_level",
            help="autotuner effort level (0 = full effort)",
        ).set(float(level), index=name)
        if ewma is not None:
            self._registry.gauge(
                "raft_tpu_autotune_recall_floor_margin",
                help="recall EWMA minus the configured floor",
            ).set(float(ewma) - state.floor, index=name)
        if qps is not None:
            self._registry.gauge(
                "raft_tpu_autotune_predicted_qps",
                help="frontier-predicted (or ledger-measured) QPS at the "
                     "current effort level",
            ).set(float(qps), index=name)
        if reason is not None:
            _events.publish(
                "autotune_step", f"autotune_{name}",
                recovered=(level == 0 and reason != "p99_burn"),
                index=name, level=level, step_reason=reason,
                recall_ewma=ewma, floor=state.floor, predicted_qps=qps,
                pinned_min_effort=state.pinned_min,
            )

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        """Run the background controller (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="raft-tpu-autotune", daemon=True
            )
            thread = self._thread
        thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._eval_s):
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — the controller must survive
                self._registry.counter(
                    "raft_tpu_autotune_eval_errors_total",
                    help="exceptions swallowed in the autotune evaluator",
                ).inc()

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=10.0)
        self._registry.unregister_provider(
            "autotune", expected=self.snapshot
        )

    # -- reading --------------------------------------------------------

    def level(self, name: str) -> Optional[int]:
        with self._lock:
            state = self._states.get(name)
        return state.arbiter.autotune_level if state is not None else None

    def health(self) -> Dict[str, List[str]]:
        """``{"pinned_min_effort": [index names]}`` — indexes where the
        latency budget is still burning with no effort left to shed;
        ``healthz()`` folds these into a DEGRADED verdict."""
        with self._lock:
            return {
                "pinned_min_effort": [
                    n for n, s in self._states.items() if s.pinned_min
                ]
            }

    def snapshot(self) -> Dict[str, object]:
        """Provider section for registry snapshots."""
        with self._lock:
            states = dict(self._states)
        return {
            "eval_s": self._eval_s,
            "recall_floor": self.recall_floor,
            "frontier_loaded": self.frontier is not None,
            "indexes": {
                name: {
                    "backend": s.backend,
                    "level": s.arbiter.autotune_level,
                    "effective_level": s.arbiter.effective_level(),
                    "floor": s.floor,
                    "steps": s.steps,
                    "last_reason": s.last_reason,
                    "pinned_min_effort": s.pinned_min,
                }
                for name, s in states.items()
            },
        }
