"""Correlated incident timelines over the obs event bus (counterpart of
``raft_tpu.obs.incidents``).

A subscriber on :mod:`raft_tpu_torch.obs.events` groups events that land
within a correlation window (``RAFT_TPU_INCIDENT_WINDOW_S``) into one
:class:`Incident`: an ordered timeline stamped with the operational
context at open and close (whatever sources the service registers) and the
flight dump / profiler capture the same trigger produced.

A trigger event (``events.TRIGGER_KINDS``) with no fresh open incident
opens one (bounded, ``RAFT_TPU_INCIDENT_MAX_OPEN``; overflow is counted);
context events only annotate an open timeline.  Recovery edges stamp the
incident; sustained quiet (``RAFT_TPU_INCIDENT_AUTOCLOSE_S``) closes it,
"recovered" or "quiet".  Closed incidents export
``incident_<id>_<reason>.json`` plus a Chrome trace into
``RAFT_TPU_INCIDENT_DIR`` (default: the flight-dump directory), on the same
``time.perf_counter`` clock as the flight recorder.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.obs import flight as _flight
from raft_tpu_torch.obs import profiler as _profiler
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs.events import Event, EventBus, TRIGGER_KINDS
from raft_tpu_torch.obs.registry import default_registry

#: default correlation window (seconds) — events this close are one story
DEFAULT_WINDOW_S = 5.0

#: default sustained-quiet span (seconds) before an incident auto-closes
DEFAULT_AUTOCLOSE_S = 30.0

#: default cap on concurrently open incidents
DEFAULT_MAX_OPEN = 8

#: closed incidents retained in memory for snapshots
CLOSED_KEEP = 32


def _env_window_s() -> float:
    try:
        return max(0.0, _env.env_float(
            "RAFT_TPU_INCIDENT_WINDOW_S", DEFAULT_WINDOW_S
        ))
    except ValueError:
        return DEFAULT_WINDOW_S


def _env_autoclose_s() -> float:
    try:
        return max(0.0, _env.env_float(
            "RAFT_TPU_INCIDENT_AUTOCLOSE_S", DEFAULT_AUTOCLOSE_S
        ))
    except ValueError:
        return DEFAULT_AUTOCLOSE_S


def _env_max_open() -> int:
    try:
        return max(1, _env.env_int(
            "RAFT_TPU_INCIDENT_MAX_OPEN", DEFAULT_MAX_OPEN
        ))
    except ValueError:
        return DEFAULT_MAX_OPEN


def _env_dir() -> str:
    return _env.env_str("RAFT_TPU_INCIDENT_DIR") or _flight._env_dir()


class Incident:
    """One correlated incident: trigger, ordered timeline, bracketing
    context.  Mutated only by its owning :class:`IncidentManager`."""

    def __init__(self, iid: int, trigger: Event,
                 context: Optional[Dict[str, object]]):
        self.id = iid
        self.status = "open"
        self.trigger = trigger.to_dict()
        self.reason = trigger.reason
        self.opened_unix = trigger.unix_time
        self.opened_t = trigger.t
        self.closed_unix: Optional[float] = None
        self.closed_t: Optional[float] = None
        self.recovered_unix: Optional[float] = None
        self.resolution: Optional[str] = None
        self.timeline: List[Dict[str, object]] = [trigger.to_dict()]
        self.context_open = context
        self.context_close: Optional[Dict[str, object]] = None
        self.flight: Optional[Dict[str, object]] = None
        self.capture: Optional[Dict[str, object]] = None
        self.archive: Optional[Dict[str, object]] = None
        self.last_event_mono = time.monotonic()
        self.last_event_t = trigger.t

    def to_dict(self) -> Dict[str, object]:
        return {
            "schema": "raft_tpu.incident",
            "id": self.id,
            "status": self.status,
            "reason": self.reason,
            "trigger": self.trigger,
            "opened_unix": self.opened_unix,
            "closed_unix": self.closed_unix,
            "recovered_unix": self.recovered_unix,
            "resolution": self.resolution,
            "events": len(self.timeline),
            "timeline": list(self.timeline),
            "context_open": self.context_open,
            "context_close": self.context_close,
            "flight": self.flight,
            "capture": self.capture,
            "archive": self.archive,
        }

    def summary(self) -> Dict[str, object]:
        return {
            "id": self.id,
            "status": self.status,
            "reason": self.reason,
            "opened_unix": self.opened_unix,
            "closed_unix": self.closed_unix,
            "resolution": self.resolution,
            "events": len(self.timeline),
            "flight": (self.flight or {}).get("path"),
            "capture": (self.capture or {}).get("path"),
            "archive": (self.archive or {}).get("path"),
        }

    def trace_events(self) -> List[Dict[str, object]]:
        """Chrome trace events: one "X" slice spanning the incident on
        its own track plus an instant per timeline entry — loads next to
        the flight dump's batch/request tracks (same perf_counter
        clock)."""
        end_t = self.closed_t if self.closed_t is not None \
            else self.last_event_t
        events: List[Dict[str, object]] = [
            {"ph": "M", "pid": 1, "tid": 3, "name": "thread_name",
             "args": {"name": "incidents"}},
            {"ph": "X", "pid": 1, "tid": 3,
             "name": f"incident {self.id} {self.reason}",
             "ts": self.opened_t * 1e6,
             "dur": max(0.0, end_t - self.opened_t) * 1e6,
             "args": {"resolution": self.resolution,
                      "events": len(self.timeline)}},
        ]
        for entry in self.timeline:
            events.append({
                "ph": "i", "pid": 1, "tid": 3, "s": "p",
                "name": str(entry.get("reason", entry.get("kind"))),
                "ts": float(entry.get("t", self.opened_t)) * 1e6,
                "args": {k: v for k, v in entry.items() if k != "t"},
            })
        return events


class IncidentManager:
    """Bounded open-incident table fed by an :class:`EventBus`
    subscription.  One instance normally lives for the whole process
    (installed by ``events.default_bus()``); tests build private ones
    against private buses."""

    def __init__(self, bus: Optional[EventBus] = None, *,
                 window_s: Optional[float] = None,
                 autoclose_s: Optional[float] = None,
                 max_open: Optional[int] = None):
        self._lock = threading.Lock()
        self._window_s = window_s if window_s is not None else _env_window_s()
        self._autoclose_s = (
            autoclose_s if autoclose_s is not None else _env_autoclose_s()
        )
        self._max_open = max_open if max_open is not None else _env_max_open()
        self._open: List[Incident] = []
        self._closed: deque = deque(maxlen=CLOSED_KEEP)
        self._iid = itertools.count(1)
        self._opened_total = 0
        self._dropped = 0
        self._context_sources: Dict[str, Callable[[], Dict[str, object]]] = {}
        self._sub = None
        if bus is not None:
            self._sub = bus.subscribe(self.handle_event, name="incidents")

    # -- context sources -----------------------------------------------------
    def add_context_source(
        self, name: str, fn: Callable[[], Dict[str, object]]
    ) -> None:
        """Register a callable snapshotted into ``context_open`` /
        ``context_close`` (e.g. the service's registry versions and
        compactor state).  Sources must be cheap and must not publish."""
        with self._lock:
            self._context_sources[name] = fn

    def remove_context_source(self, name: str) -> None:
        with self._lock:
            self._context_sources.pop(name, None)

    def _capture_context(self) -> Dict[str, object]:
        # Runs WITHOUT self._lock: sources reach into service/registry/
        # compactor locks, and holding ours underneath would hand the
        # LOCKORDER checker a real cycle.
        with self._lock:
            sources = dict(self._context_sources)
        out: Dict[str, object] = {}
        for name, fn in sources.items():
            try:
                out[name] = fn()
            except Exception as exc:  # noqa: BLE001 — context is best-effort
                out[name] = {"error": repr(exc)}
        return out

    # -- ingestion -----------------------------------------------------------
    @traced("incidents.ingest")
    def handle_event(self, event: Event) -> None:
        """Bus subscriber: correlate ``event`` into an open incident or
        open a new one.  Runs on the publisher's thread; everything
        outside the lock windows is allowed to be slow-ish (context
        capture, export) because events are rare by construction."""
        now = time.monotonic()
        is_trigger = event.kind in TRIGGER_KINDS and not event.recovered
        context = self._capture_context() if is_trigger else None
        dump = _flight.last_dump()
        capture = _profiler.last_capture()
        opened = None
        dropped = False
        with self._lock:
            to_close = self._sweep_locked(now)
            target = self._match_locked(now)
            if target is not None:
                self._append_locked(target, event, dump, capture, now)
            elif is_trigger:
                if len(self._open) >= self._max_open:
                    self._dropped += 1
                    dropped = True
                else:
                    opened = Incident(next(self._iid), event, context)
                    self._attach_flight_locked(opened, event, dump)
                    self._attach_capture_locked(opened, event, capture)
                    self._open.append(opened)
                    self._opened_total += 1
            # a context/recovery event with no fresh incident: not a story
            n_open = len(self._open)
        if opened is not None:
            default_registry().counter(
                "raft_tpu_incidents_total", help="incidents opened",
            ).inc(kind=event.kind)
        if dropped:
            default_registry().counter(
                "raft_tpu_incidents_dropped_total",
                help="trigger events ignored: open-incident table full",
            ).inc()
        default_registry().gauge(
            "raft_tpu_incidents_open", help="currently open incidents",
        ).set(n_open)
        self._finalize_closed(to_close)

    def _match_locked(self, now: float) -> Optional[Incident]:
        best = None
        for inc in self._open:
            if now - inc.last_event_mono <= self._window_s:
                if best is None or inc.last_event_mono > best.last_event_mono:
                    best = inc
        return best

    def _append_locked(self, inc: Incident, event: Event,
                       dump: Optional[Dict[str, object]],
                       capture: Optional[Dict[str, object]],
                       now: float) -> None:
        inc.timeline.append(event.to_dict())
        inc.last_event_mono = now
        inc.last_event_t = event.t
        if event.recovered and inc.recovered_unix is None:
            inc.recovered_unix = event.unix_time
        if event.kind == "explain_dump" and inc.archive is None:
            # the query-archive subscriber runs after us in bus order and
            # publishes this context event right after writing the dump,
            # so the artifact is this incident's by construction
            inc.archive = {
                "path": event.fields.get("path"),
                "reason": event.reason,
                "unix_time": event.unix_time,
            }
        self._attach_flight_locked(inc, event, dump)
        self._attach_capture_locked(inc, event, capture)

    def _attach_flight_locked(self, inc: Incident, event: Event,
                              dump: Optional[Dict[str, object]]) -> None:
        # Attach only a *fresh* dump (the flight subscriber runs before
        # us in bus order, so a dump this event caused already exists);
        # a stale artifact from a past incident is not this one's.
        if dump is None:
            return
        if abs(event.unix_time - float(dump["unix_time"])) > \
                max(self._window_s, 1.0):
            return
        if inc.flight is not None and inc.flight.get("path") == dump["path"]:
            return
        inc.flight = dump
        inc.timeline.append({
            "kind": "flight_dump",
            "reason": dump.get("reason"),
            "t": event.t,
            "unix_time": dump.get("unix_time"),
            "path": dump.get("path"),
            "trace_path": dump.get("trace_path"),
        })

    def _attach_capture_locked(self, inc: Incident, event: Event,
                               capture: Optional[Dict[str, object]]) -> None:
        # Same contract as flight dumps: the perf auto-capture subscriber
        # runs before us in bus order, so a capture this event triggered
        # already started; attach only a fresh one, once.
        if capture is None:
            return
        if abs(event.unix_time - float(capture["unix_time"])) > \
                max(self._window_s, 1.0):
            return
        if inc.capture is not None and \
                inc.capture.get("path") == capture["path"]:
            return
        inc.capture = capture
        inc.timeline.append({
            "kind": "profile_capture",
            "reason": capture.get("reason"),
            "t": event.t,
            "unix_time": capture.get("unix_time"),
            "path": capture.get("path"),
            "duration_s": capture.get("duration_s"),
        })

    # -- closing -------------------------------------------------------------
    def _sweep_locked(self, now: float) -> List[Incident]:
        quiet = [
            inc for inc in self._open
            if now - inc.last_event_mono > self._autoclose_s
        ]
        for inc in quiet:
            self._open.remove(inc)
            inc.status = "closed"
            inc.closed_unix = time.time()
            inc.closed_t = time.perf_counter()
            inc.resolution = (
                "recovered" if inc.recovered_unix is not None else "quiet"
            )
            self._closed.append(inc)
        return quiet

    def poll(self, now: Optional[float] = None) -> List[Incident]:
        """Close incidents whose quiet span exceeded the auto-close
        window; returns them.  Called from ``handle_event`` and
        ``snapshot`` automatically; tests pass a synthetic ``now``
        (monotonic-clock domain) instead of sleeping."""
        now = time.monotonic() if now is None else now
        with self._lock:
            to_close = self._sweep_locked(now)
            n_open = len(self._open)
        if to_close:
            default_registry().gauge(
                "raft_tpu_incidents_open", help="currently open incidents",
            ).set(n_open)
        self._finalize_closed(to_close)
        return to_close

    def _finalize_closed(self, closed: List[Incident]) -> None:
        for inc in closed:
            inc.context_close = self._capture_context()
            self._export(inc)

    def _export(self, inc: Incident) -> None:
        """Write ``incident_<id>_<reason>.json`` + ``.trace.json``.
        Best-effort and gated like flight dumps: disabled obs writes
        nothing."""
        if not _spans.enabled():
            return
        try:
            directory = _env_dir()
            os.makedirs(directory, exist_ok=True)
            stem = f"incident_{inc.id:04d}_{inc.reason}"
            path = os.path.join(directory, stem + ".json")
            with open(path, "w") as f:
                json.dump(inc.to_dict(), f, indent=2, default=str)
            with open(os.path.join(directory, stem + ".trace.json"),
                      "w") as f:
                json.dump({"traceEvents": inc.trace_events()}, f,
                          default=str)
            default_registry().counter(
                "raft_tpu_incidents_exported_total",
                help="closed-incident artifacts written",
            ).inc()
        except Exception:  # noqa: BLE001 — incident paths must not fail
            pass

    # -- reading -------------------------------------------------------------
    def open_incidents(self) -> List[Incident]:
        self.poll()
        with self._lock:
            return list(self._open)

    def closed_incidents(self) -> List[Incident]:
        with self._lock:
            return list(self._closed)

    def snapshot(self) -> Dict[str, object]:
        """Provider section for registry snapshots."""
        self.poll()
        with self._lock:
            return {
                "open": [inc.summary() for inc in self._open],
                "recent_closed": [inc.summary() for inc in self._closed],
                "opened_total": self._opened_total,
                "dropped": self._dropped,
                "window_s": self._window_s,
                "autoclose_s": self._autoclose_s,
            }


# ---------------------------------------------------------------------------
# the process-wide default manager

_default_lock = threading.Lock()
_default: Optional[IncidentManager] = None


def install(bus: Optional[EventBus] = None) -> IncidentManager:
    """Create (once) the process-wide manager subscribed to ``bus`` and
    register its ``incidents`` snapshot provider.  Called automatically
    by ``events.default_bus()``."""
    global _default
    if bus is None:
        # resolve BEFORE taking our lock: creating the default bus runs
        # _install_default_subscribers, which re-enters this function
        # (with the bus this time) — holding _default_lock across that
        # call chain would self-deadlock
        from raft_tpu_torch.obs import events as _events

        bus = _events.default_bus()
    with _default_lock:
        if _default is None:
            _default = IncidentManager(bus)
        mgr = _default
    default_registry().register_provider("incidents", mgr.snapshot)
    return mgr


def default_manager() -> IncidentManager:
    """The process-wide manager (creating the default bus if needed)."""
    from raft_tpu_torch.obs import events as _events

    bus = _events.default_bus()  # first creation runs install() itself
    with _default_lock:
        if _default is not None:
            return _default
    # reset() without events.reset(): the bus survived but the manager
    # (and its subscription) didn't — re-attach to the live bus
    return install(bus)


def incidents_snapshot() -> Dict[str, object]:
    """Provider section for registry snapshots."""
    return default_manager().snapshot()


def _on_bus_reset() -> None:
    """Called by ``events.reset()``: the bus (and our subscription) is
    gone, so drop the manager; the next ``default_bus()`` rebuilds both
    against fresh env knobs."""
    global _default
    with _default_lock:
        mgr, _default = _default, None
    if mgr is not None:
        if mgr._sub is not None:
            # standalone reset(): the bus may still be live — without
            # this the old manager keeps receiving events as a zombie
            mgr._sub.unsubscribe()
        default_registry().unregister_provider(
            "incidents", expected=mgr.snapshot
        )


def reset() -> None:
    """Drop the default manager (tests)."""
    _on_bus_reset()
