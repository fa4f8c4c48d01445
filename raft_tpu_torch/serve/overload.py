"""Overload-safe serving (counterpart of ``raft_tpu.serve.overload``):
priority classes, deadlines, admission control and degraded-mode search.

Requests carry a **priority class** (0=interactive, 1=standard, 2=batch,
3=background) and an optional **deadline**, riding beside ``k`` / ``fid``
in the batcher's request records (host metadata: no new shape, no new
kernel build).  Two actuators consume them:

- :class:`AdmissionController` — at every batch cut it expires
  past-deadline requests and, under pressure, sheds the lowest priorities
  first.  Pressure is the max of the oldest queued request's wait against
  ``admit_wait_s``, queue depth against ``queue_factor × max_batch``, and
  active ``slo_burn`` alerts seen on the obs bus.  Shed and expired futures
  resolve with the typed :class:`Shed` / :class:`DeadlineExceeded` errors,
  and every shedding cut publishes one ``admission_shed`` bus event.
- :class:`DegradedModeManager` — steps search effort down under sustained
  pressure and restores it hysteretically (``degrade_after_s`` /
  ``restore_after_s``): each level halves ``n_probes`` / CAGRA's
  ``itopk_size`` and level ≥ 2 drops IVF-PQ's LUT to bf16, through each
  backend's ``EffortSpec`` (``neighbors.effort``).  Enter and exit edges
  publish ``degraded_enter`` / ``degraded_exit``.  The batcher warms every
  level with the bucket ladder.

:class:`HedgedDispatcher` races replica members and needs replicas: it
raises, naming ROADMAP Queue 1 item 7b.  Thresholds live in
:class:`OverloadConfig` (``RAFT_TPU_OVERLOAD_*``); the controllers take
``now=`` so tests drive synthetic time.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, fields as dc_fields, replace as dc_replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.obs import events as obs_events
from raft_tpu_torch.obs.registry import default_registry

#: priority classes, lowest number = most important
N_PRIORITIES = 4
PRIORITY_NAMES = ("interactive", "standard", "batch", "background")


class Shed(RuntimeError):
    """The request was shed by admission control before dispatch.

    Raised out of the request's future (never silently dropped).
    Clients should treat it as explicit backpressure: retry later or
    with a higher priority class.
    """

    def __init__(self, priority: int, level: int, index: str = ""):
        self.priority = int(priority)
        self.level = int(level)
        self.index = index
        super().__init__(
            f"shed at admission (priority={priority} "
            f"[{PRIORITY_NAMES[priority]}], pressure level={level}, "
            f"index={index!r})"
        )


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it reached the device.

    Subclasses :class:`TimeoutError` so callers already catching
    client-side timeouts handle server-side expiry the same way.
    """

    def __init__(self, late_s: float, index: str = ""):
        self.late_s = float(late_s)
        self.index = index
        super().__init__(
            f"deadline exceeded {late_s * 1e3:.1f} ms before dispatch "
            f"(index={index!r})"
        )


@dataclass(frozen=True)
class OverloadConfig:
    """Thresholds for admission control, degradation, and hedging.

    ``admit_wait_s`` and ``queue_factor`` define pressure level 1; each
    doubling of a signal past its threshold raises the level (×2 → 2,
    ×4 → 3), and an active ``slo_burn`` alert adds one more.  Level n
    sheds priority classes ≥ ``4 - n``: background first, interactive
    never.
    """

    admit_wait_s: float = 0.25
    queue_factor: float = 8.0
    degrade_after_s: float = 1.0
    restore_after_s: float = 5.0
    max_degrade_level: int = 2
    hedge: bool = False
    hedge_delay_mult: float = 3.0
    hedge_min_delay_s: float = 0.005

    @classmethod
    def from_env(cls) -> "OverloadConfig":
        return cls(
            admit_wait_s=_env.env_float(
                "RAFT_TPU_OVERLOAD_ADMIT_WAIT_S", cls.admit_wait_s),
            queue_factor=_env.env_float(
                "RAFT_TPU_OVERLOAD_QUEUE_FACTOR", cls.queue_factor),
            degrade_after_s=_env.env_float(
                "RAFT_TPU_OVERLOAD_DEGRADE_AFTER_S", cls.degrade_after_s),
            restore_after_s=_env.env_float(
                "RAFT_TPU_OVERLOAD_RESTORE_AFTER_S", cls.restore_after_s),
            max_degrade_level=_env.env_int(
                "RAFT_TPU_OVERLOAD_MAX_DEGRADE", cls.max_degrade_level),
            hedge=_env.env_bool("RAFT_TPU_OVERLOAD_HEDGE", cls.hedge),
            hedge_delay_mult=_env.env_float(
                "RAFT_TPU_OVERLOAD_HEDGE_MULT", cls.hedge_delay_mult),
            hedge_min_delay_s=_env.env_float(
                "RAFT_TPU_OVERLOAD_HEDGE_MIN_S", cls.hedge_min_delay_s),
        )


def validate_priority(priority) -> int:
    """Normalize/validate a submit-time priority (None → standard)."""
    if priority is None:
        return 1
    p = int(priority)
    if not 0 <= p < N_PRIORITIES:
        raise ValueError(
            f"priority must be in [0, {N_PRIORITIES}), got {priority!r}"
        )
    return p


def priority_name(priority) -> str:
    """Human label for a priority class (explain plans, log lines)."""
    try:
        return PRIORITY_NAMES[int(priority)]
    except (TypeError, ValueError, IndexError):
        return "unknown"


def expire_deadlines(batch: Sequence, *, now: Optional[float] = None,
                     index: str = "", metrics=None) -> List:
    """Return the still-alive requests of ``batch``, resolving expired
    ones' futures with :class:`DeadlineExceeded`.  The deadline-only
    actuator used when no :class:`AdmissionController` is installed —
    expired work must never occupy a device slot regardless of overload
    wiring."""
    now = time.perf_counter() if now is None else now
    alive: List = []
    expired: List = []
    for req in batch:
        deadline = getattr(req, "deadline", None)
        if deadline is not None and now > deadline:
            expired.append(req)
        else:
            alive.append(req)
    if expired:
        for req in expired:
            req.future.set_exception(
                DeadlineExceeded(now - req.deadline, index=index)
            )
        if metrics is not None:
            metrics.record_error("deadline", len(expired))
        default_registry().counter(
            "raft_tpu_serve_deadline_expired_total",
            help="requests expired at batch cut (deadline passed before "
                 "dispatch)",
        ).inc(len(expired), index=index)
    return alive


@dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of one batch-cut admission pass."""

    admitted: Tuple
    shed: Tuple
    expired: Tuple
    level: int


class AdmissionController:
    """Sheds lowest-priority-first at batch-cut time under pressure.

    Pressure is recomputed per cut from the batch itself (oldest wait,
    queue depth) plus the latched set of active ``slo_burn`` alerts for
    this index, maintained by a bus subscription (``recovered=True``
    edges clear their reason).  Shedding strictly respects priority
    order — level 1 sheds only background (3), level 2 sheds batch+
    (≥ 2), level 3 sheds standard+ (≥ 1); interactive (0) is never shed,
    only deadline-expired.
    """

    def __init__(self, config: Optional[OverloadConfig] = None, *,
                 name: str = "default", metrics=None, bus=None):
        self.config = config if config is not None \
            else OverloadConfig.from_env()
        self.name = name
        self.metrics = metrics
        self._lock = threading.Lock()
        self._burning: set = set()
        self.shed_total = 0
        self.expired_total = 0
        self.last_level = 0
        bus = obs_events.default_bus() if bus is None else bus
        self._sub = bus.subscribe(
            self._on_burn, kinds=frozenset({"slo_burn"}),
            name=f"admission:{name}",
        )

    # -- slo_burn latch ------------------------------------------------------
    def _on_burn(self, event) -> None:
        idx = event.fields.get("index")
        if idx is not None and idx != self.name:
            return
        with self._lock:
            if event.recovered:
                self._burning.discard(event.reason)
            else:
                self._burning.add(event.reason)

    def burning(self) -> bool:
        """True while any un-recovered ``slo_burn`` alert is latched."""
        with self._lock:
            return bool(self._burning)

    def close(self) -> None:
        """Detach the bus subscription (service stop / index removal)."""
        self._sub.unsubscribe()

    # -- pressure ------------------------------------------------------------
    def pressure_level(self, *, oldest_wait_s: float, queue_rows: int,
                       max_batch: int) -> int:
        """0 (calm) … 3 (severe): max over the wait and depth signals
        (each doubling past threshold = +1 level) plus one level while
        an SLO burn alert is active."""
        cfg = self.config
        level = 0
        signals = (
            (oldest_wait_s, cfg.admit_wait_s),
            (float(queue_rows), cfg.queue_factor * max(1, max_batch)),
        )
        for value, threshold in signals:
            if threshold <= 0.0:
                continue
            ratio = value / threshold
            if ratio >= 4.0:
                level = max(level, 3)
            elif ratio >= 2.0:
                level = max(level, 2)
            elif ratio >= 1.0:
                level = max(level, 1)
        if self.burning():
            level = min(3, level + 1)
        return level

    # -- the batch-cut decision ----------------------------------------------
    @traced("serve.admission.decide")
    def decide(self, batch: Sequence, *, queue_rows: int = 0,
               max_batch: int = 1,
               now: Optional[float] = None) -> AdmissionDecision:
        """Expire deadlines, then shed by priority if under pressure.

        Resolves every shed/expired future before returning — callers
        dispatch ``decision.admitted`` and nothing else.
        """
        now = time.perf_counter() if now is None else now
        oldest = 0.0
        for req in batch:
            oldest = max(oldest, now - req.t_submit)
        level = self.pressure_level(
            oldest_wait_s=oldest, queue_rows=queue_rows,
            max_batch=max_batch,
        )
        min_shed_priority = N_PRIORITIES - level  # 1→3, 2→2, 3→1
        admitted: List = []
        shed: List = []
        expired: List = []
        for req in batch:
            deadline = getattr(req, "deadline", None)
            if deadline is not None and now > deadline:
                expired.append(req)
            elif level > 0 and req.priority >= min_shed_priority:
                shed.append(req)
            else:
                admitted.append(req)
        with self._lock:
            self.last_level = level
            self.shed_total += len(shed)
            self.expired_total += len(expired)
        if expired or shed:
            self._resolve(shed, expired, level, now)
        return AdmissionDecision(
            tuple(admitted), tuple(shed), tuple(expired), level
        )

    def _resolve(self, shed: Sequence, expired: Sequence, level: int,
                 now: float) -> None:
        # futures first: a slow bus subscriber must not delay the
        # client-visible rejection
        for req in expired:
            req.future.set_exception(
                DeadlineExceeded(now - req.deadline, index=self.name)
            )
        for req in shed:
            req.future.set_exception(
                Shed(req.priority, level, index=self.name)
            )
        reg = default_registry()
        by_priority: Dict[int, int] = {}
        for req in shed:
            by_priority[req.priority] = by_priority.get(req.priority, 0) + 1
        for priority, count in by_priority.items():
            reg.counter(
                "raft_tpu_serve_shed_total",
                help="requests shed by admission control",
            ).inc(count, index=self.name, priority=str(priority))
        if expired:
            reg.counter(
                "raft_tpu_serve_deadline_expired_total",
                help="requests expired at batch cut (deadline passed "
                     "before dispatch)",
            ).inc(len(expired), index=self.name)
        if self.metrics is not None:
            if shed:
                self.metrics.record_error("shed", len(shed))
            if expired:
                self.metrics.record_error("deadline", len(expired))
        if shed:
            obs_events.publish(
                "admission_shed", f"admission_{self.name}",
                index=self.name, level=level,
                shed={str(p): c for p, c in sorted(by_priority.items())},
                expired=len(expired), burning=self.burning(),
            )


def derive_degraded_params(params, level: int):
    """Reduced-effort variant of a backend ``SearchParams`` at a
    degradation level.  The semantics live with each backend's typed
    :class:`~raft_tpu_torch.neighbors.effort.EffortSpec` (``degraded(level)``):
    halve ``n_probes`` (ivf_flat / ivf_pq) and cagra's ``itopk_size``
    per level, drop ivf_pq's LUT to bf16 at level ≥ 2.  Param types
    without an EffortSpec fall back to a field-name walk with the same
    rules; fully unknown types pass through unchanged (brute_force has
    no effort knob)."""
    if level <= 0 or params is None:
        return params
    from raft_tpu_torch.neighbors import effort as _effort  # lazy: serve is importable without the backends

    spec = _effort.spec_for_params(params)
    if spec is not None:
        return spec.degraded(level).apply(params)
    try:
        names = {f.name for f in dc_fields(params)}
    except TypeError:
        return params
    kw: Dict[str, object] = {}
    if "n_probes" in names:
        kw["n_probes"] = max(1, int(params.n_probes) >> level)
    if "itopk_size" in names:
        kw["itopk_size"] = max(32, int(params.itopk_size) >> level)
    if "lut_dtype" in names and level >= 2:
        kw["lut_dtype"] = "bfloat16"
    if not kw:
        return params
    return dc_replace(params, **kw)


class DegradedModeManager:
    """Hysteretic search-effort ladder for one served index.

    ``step(overloaded)`` is called once per batch cut with the admission
    verdict.  The level rises one notch after ``degrade_after_s`` of
    *sustained* pressure and falls one notch after ``restore_after_s``
    of sustained calm — flapping load cannot flap effort.  Enter edges
    publish ``degraded_enter`` (a trigger kind: the decision lands in
    an incident timeline); exits publish ``degraded_exit``, flagged
    recovered once the ladder is back at full effort.
    """

    def __init__(self, config: Optional[OverloadConfig] = None, *,
                 name: str = "default"):
        self.config = config if config is not None \
            else OverloadConfig.from_env()
        self.name = name
        self._lock = threading.Lock()
        self._level = 0
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._derived: Dict[Tuple[int, int], object] = {}

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def levels(self) -> Tuple[int, ...]:
        """Every level warmup must cover (0 … max)."""
        return tuple(range(self.config.max_degrade_level + 1))

    @contextmanager
    def pinned(self, level: int):
        """Force a level without events or hysteresis (warmup ladders,
        tests)."""
        with self._lock:
            prev, self._level = self._level, int(level)
        try:
            yield
        finally:
            with self._lock:
                self._level = prev

    @traced("serve.degrade.step")
    def step(self, overloaded: bool, now: Optional[float] = None) -> int:
        """Advance the hysteresis clock; returns the (possibly new)
        level.  ``now`` is monotonic seconds — tests pass a synthetic
        clock."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        entered = exited = None
        with self._lock:
            if overloaded:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                elif (self._level < cfg.max_degrade_level
                        and now - self._pressure_since >= cfg.degrade_after_s):
                    self._level += 1
                    self._pressure_since = now  # re-arm for the next notch
                    entered = self._level
            else:
                self._pressure_since = None
                if self._calm_since is None:
                    self._calm_since = now
                elif (self._level > 0
                        and now - self._calm_since >= cfg.restore_after_s):
                    self._level -= 1
                    self._calm_since = now
                    exited = self._level
            level = self._level
        if entered is not None or exited is not None:
            default_registry().gauge(
                "raft_tpu_serve_degraded_level",
                help="current degraded-search level (0 = full effort)",
            ).set(float(level), index=self.name)
        if entered is not None:
            obs_events.publish(
                "degraded_enter", f"degraded_{self.name}",
                index=self.name, level=entered,
            )
        if exited is not None:
            obs_events.publish(
                "degraded_exit", f"degraded_{self.name}",
                recovered=(exited == 0), index=self.name, level=exited,
            )
        return level

    def params_for(self, index):
        """The search params the current level prescribes for ``index``,
        or None at full effort (callers fall back to the index's own).
        Derived params are cached per (base params, level): one object per
        level, so deriving costs nothing on the hot path."""
        level = self.level
        if level <= 0:
            return None
        base = getattr(index, "search_params", None)
        if base is None:
            return None
        key = (id(base), level)
        with self._lock:
            derived = self._derived.get(key)
        if derived is None:
            derived = derive_degraded_params(base, level)
            with self._lock:
                self._derived[key] = derived
        return derived


class HedgedDispatcher:  # raft-tpu: ignore[TRACED] no dispatch until replicas are ported (ROADMAP Queue 1 item 7b)
    """raft_tpu's tail-latency hedge across two independently dispatched
    members (a replica-group collective against a direct search).  It
    needs replicas, which the port does not have yet: constructing one
    raises ``NotImplementedError`` naming ROADMAP Queue 1 item 7b."""

    def __init__(self, members: Sequence[Callable] = (),
                 config: Optional[OverloadConfig] = None, *,
                 name: str = "default", metrics=None):
        raise NotImplementedError(
            "serve.HedgedDispatcher races replica members; replicas are "
            "multi-GPU serving (ROADMAP Queue 1 item 7b)")
