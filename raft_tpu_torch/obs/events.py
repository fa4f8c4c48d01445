"""Typed observability event bus (counterpart of ``raft_tpu.obs.events``):
the one pipe every operational edge flows through.  Producers publish one
typed :class:`Event`; consumers subscribe.

Event kinds are raft_tpu's closed taxonomy (:data:`KINDS`) — publishing
an unknown kind raises.  ``TRIGGER_KINDS`` marks the subset that starts an
incident; the rest are context.  Delivery is synchronous on the
publisher's thread; the bus lock is held only to stamp and append, and
subscribers may publish themselves (the recursion guard caps reentrant
depth).  Subscriber exceptions are swallowed and counted
(``raft_tpu_events_subscriber_errors_total``).

The ring of recent events is bounded (``RAFT_TPU_EVENTS_RING``);
overwritten events are counted in ``raft_tpu_events_dropped_total`` and
the ring appears in ``obs.snapshot()`` under the ``events`` provider.

The default bus wires the flight recorder, the perf ledger's profiler
capture, the incident manager and the query archive as subscribers, as
raft_tpu's does.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.obs.registry import default_registry

#: the closed event taxonomy — publish() rejects anything else
KINDS = frozenset({
    "health_edge",
    "quality_alarm",
    "hot_recompile",
    "compaction_trigger",
    "compaction_promote",
    "compaction_abort",
    "registry_swap",
    "batch_error",
    "slo_burn",
    "admission_shed",
    "degraded_enter",
    "degraded_exit",
    "hedge_fired",
    "perf_regression",
    "build_complete",
    "page_thrash",
    # closed-loop autotuner effort moves: context, not trigger — the
    # slo_burn (or degraded_enter) that motivated the move opens the
    # incident; the step annotates its timeline
    "autotune_step",
    # query-archive dump written for an incident trigger: context — the
    # trigger itself opened the incident; this links the artifact into
    # its timeline
    "explain_dump",
})

#: kinds that open incidents / trigger flight dumps; the rest are context
TRIGGER_KINDS = frozenset({
    "health_edge",
    "quality_alarm",
    "hot_recompile",
    "batch_error",
    "compaction_abort",
    "slo_burn",
    "admission_shed",
    "degraded_enter",
    "perf_regression",
    "page_thrash",
})

#: default recent-events ring capacity
DEFAULT_RING = 256

#: hard cap on publishes triggered by subscribers of a single publish
_MAX_REENTRANT_DEPTH = 4


def _env_ring() -> int:
    try:
        return max(1, _env.env_int("RAFT_TPU_EVENTS_RING", DEFAULT_RING))
    except ValueError:
        return DEFAULT_RING


@dataclass(frozen=True)
class Event:
    """One typed bus event.

    ``reason`` is the human/debounce key — it becomes the flight-dump
    reason and filename stem, so producers keep the pre-bus reason
    strings (``"health_unhealthy"``, ``"batch_exception"``, ...) and the
    artifacts existing tests and runbooks know keep their names.
    ``recovered`` marks the *clearing* edge of an alarm: recovery events
    never dump or open incidents, they close them.
    """

    kind: str
    reason: str
    seq: int
    t: float          # time.perf_counter() — aligns with span/flight stamps
    unix_time: float  # time.time() — for humans and JSON exports
    recovered: bool = False
    fields: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {
            "kind": self.kind,
            "reason": self.reason,
            "seq": self.seq,
            "t": self.t,
            "unix_time": self.unix_time,
            "recovered": self.recovered,
            **{k: v for k, v in self.fields.items()},
        }


class _Subscription:
    """Handle returned by :meth:`EventBus.subscribe`.

    Carries the optional kind filter and the per-reason debounce state:
    for a subscription with ``debounce_s`` set, two events sharing a
    ``reason`` within the window deliver only the first (suppressed
    deliveries are counted per reason).  Distinct reasons never suppress
    each other — that is the whole point versus the old global window.
    """

    def __init__(self, bus: "EventBus", fn: Callable[[Event], None],
                 kinds: Optional[frozenset], debounce_s: float, name: str):
        self._bus = bus
        self._fn = fn
        self._kinds = kinds
        self._debounce_s = debounce_s
        self._name = name
        self._lock = threading.Lock()
        self._last_by_reason: Dict[str, float] = {}

    def _should_deliver(self, event: Event, now: float) -> bool:
        if self._kinds is not None and event.kind not in self._kinds:
            return False
        if self._debounce_s <= 0.0:
            return True
        with self._lock:
            last = self._last_by_reason.get(event.reason, float("-inf"))
            if now - last < self._debounce_s:
                debounced = True
            else:
                self._last_by_reason[event.reason] = now
                debounced = False
        if debounced:
            default_registry().counter(
                "raft_tpu_events_debounced_total",
                help="bus deliveries suppressed by per-reason debounce",
            ).inc(subscriber=self._name, reason=event.reason)
        return not debounced

    def unsubscribe(self) -> None:
        self._bus._remove(self)


class EventBus:
    """Bounded, thread-safe pub/sub bus over the :data:`KINDS` taxonomy.

    One instance normally lives for the whole process
    (:func:`default_bus`); tests build private ones.  ``publish`` is the
    only method on producer paths and costs one lock window plus the
    synchronous fan-out.
    """

    def __init__(self, ring: Optional[int] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(
            maxlen=ring if ring is not None else _env_ring()
        )
        self._seq = itertools.count(1)
        self._published: Dict[str, int] = {}
        self._dropped = 0
        self._subs: Tuple[_Subscription, ...] = ()
        self._depth = threading.local()

    # -- subscribing ---------------------------------------------------------
    def subscribe(self, fn: Callable[[Event], None], *,
                  kinds: Optional[frozenset] = None,
                  debounce_s: float = 0.0,
                  name: str = "anonymous") -> _Subscription:
        """Register ``fn`` for every published event (optionally filtered
        to ``kinds``, optionally debounced per reason).  Returns a handle
        with ``unsubscribe()``.  Delivery order follows subscribe order.
        """
        sub = _Subscription(self, fn, kinds, debounce_s, name)
        with self._lock:
            self._subs = self._subs + (sub,)
        return sub

    def _remove(self, sub: _Subscription) -> None:
        with self._lock:
            self._subs = tuple(s for s in self._subs if s is not sub)

    # -- publishing ----------------------------------------------------------
    def publish(self, kind: str, reason: Optional[str] = None, *,
                recovered: bool = False, **fields: object) -> Event:
        """Publish one event; returns it.  ``reason`` defaults to the
        kind.  Raises ``ValueError`` for kinds outside the taxonomy —
        producers are in-tree, so a typo should fail loudly in tests,
        not vanish into an unwatched topic.
        """
        if kind not in KINDS:
            raise ValueError(
                f"unknown event kind {kind!r}; known: {sorted(KINDS)}"
            )
        with self._lock:
            event = Event(
                kind=kind,
                reason=reason if reason is not None else kind,
                seq=next(self._seq),
                t=time.perf_counter(),
                unix_time=time.time(),
                recovered=recovered,
                fields=dict(fields),
            )
            dropped = len(self._ring) == self._ring.maxlen
            self._ring.append(event)
            if dropped:
                self._dropped += 1
            self._published[kind] = self._published.get(kind, 0) + 1
            subs = self._subs
        default_registry().counter(
            "raft_tpu_events_total", help="bus events published",
        ).inc(kind=kind)
        if dropped:
            default_registry().counter(
                "raft_tpu_events_dropped_total",
                help="events evicted from the recent-events ring",
            ).inc()
        depth = getattr(self._depth, "value", 0)
        if depth >= _MAX_REENTRANT_DEPTH:
            return event  # a subscriber publishing in a loop; stop the chain
        self._depth.value = depth + 1
        try:
            now = time.monotonic()
            for sub in subs:
                try:
                    if sub._should_deliver(event, now):
                        sub._fn(event)
                except Exception:  # noqa: BLE001 — never fail a producer
                    default_registry().counter(
                        "raft_tpu_events_subscriber_errors_total",
                        help="exceptions swallowed in bus subscribers",
                    ).inc(subscriber=sub._name)
        finally:
            self._depth.value = depth
        return event

    # -- reading -------------------------------------------------------------
    def recent(self, kind: Optional[str] = None) -> List[Event]:
        """Ring contents, oldest first (optionally one kind)."""
        with self._lock:
            events = list(self._ring)
        if kind is not None:
            events = [e for e in events if e.kind == kind]
        return events

    def snapshot(self) -> Dict[str, object]:
        """Provider section for registry snapshots."""
        with self._lock:
            events = list(self._ring)
            return {
                "ring": self._ring.maxlen,
                "published": dict(self._published),
                "dropped": self._dropped,
                "subscribers": [s._name for s in self._subs],
                "recent": [e.to_dict() for e in events[-16:]],
            }


# ---------------------------------------------------------------------------
# the process-wide default bus + module-level conveniences

_default_lock = threading.Lock()
_default: Optional[EventBus] = None


def _install_default_subscribers(bus: EventBus) -> None:
    # deferred imports keep the obs package cycle-free (flight / incidents
    # import this module's registry sibling)
    from raft_tpu_torch.obs import explain as _explain
    from raft_tpu_torch.obs import flight as _flight
    from raft_tpu_torch.obs import incidents as _incidents
    from raft_tpu_torch.obs import perf as _perf

    # raft_tpu's order: the flight dumper and the perf auto-capture run
    # before the incident manager, so the dump and the capture are fresh
    # when the incident attaches its evidence; the query-archive dumper
    # runs after it, so its reentrant ``explain_dump`` publish finds the
    # incident the trigger just opened
    _flight.install_bus_subscriber(bus)
    _perf.install_bus_subscriber(bus)
    _incidents.install(bus)
    _explain.install_bus_subscriber(bus)
    default_registry().register_provider("events", bus.snapshot)


def default_bus() -> EventBus:
    """The process-wide bus.  First use creates it and installs the
    default subscribers (flight dumper, perf capture, incident manager,
    query-archive dumper) plus the ``events`` snapshot provider."""
    global _default
    created = False
    with _default_lock:
        if _default is None:
            _default = EventBus()
            created = True
        bus = _default
    if created:
        _install_default_subscribers(bus)
    return bus


def publish(kind: str, reason: Optional[str] = None, *,
            recovered: bool = False, **fields: object) -> Event:
    return default_bus().publish(
        kind, reason, recovered=recovered, **fields
    )


def subscribe(fn: Callable[[Event], None], *,
              kinds: Optional[frozenset] = None,
              debounce_s: float = 0.0,
              name: str = "anonymous") -> _Subscription:
    return default_bus().subscribe(
        fn, kinds=kinds, debounce_s=debounce_s, name=name
    )


def recent(kind: Optional[str] = None) -> List[Event]:
    return default_bus().recent(kind)


def events_snapshot() -> Dict[str, object]:
    """Provider section for registry snapshots."""
    return default_bus().snapshot()


def reset() -> None:
    """Drop the default bus (subscriptions die with it) and reset the
    incident manager, flight, perf and explain bus state, so the next
    :func:`default_bus` rewires everything against fresh env knobs."""
    global _default
    import sys

    with _default_lock:
        _default = None
    for mod in ("incidents", "flight", "perf", "explain"):
        m = sys.modules.get(f"raft_tpu_torch.obs.{mod}")
        if m is not None:
            m._on_bus_reset()
