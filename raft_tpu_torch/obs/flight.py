"""Always-on flight recorder (counterpart of ``raft_tpu.obs.flight``): the
last N batches, dumpable post-hoc.

The batcher feeds every completed (or failed) batch — member request ids,
per-request timelines reconstructed from the stage timers it already keeps
— into a bounded ring; :func:`dump` writes a JSON snapshot and a
Chrome-trace-event file (Perfetto-loadable).

Triggers arrive over the :mod:`raft_tpu_torch.obs.events` bus (the
recorder is one subscriber, :func:`install_bus_subscriber`, wired when the
default bus is created): a health transition to UNHEALTHY, a kernel build
or library load on a warmed dispatch thread (``hot_recompile``), a batch
exception, a compaction abort.  Dumps are debounced per reason
(``RAFT_TPU_FLIGHT_DEBOUNCE_S``) and behind a short cross-reason
correlation guard (``RAFT_TPU_INCIDENT_WINDOW_S``), so one incident makes
one artifact.

Env knobs: ``RAFT_TPU_FLIGHT_CAP`` (ring size, default 256),
``RAFT_TPU_FLIGHT_DIR`` (dump directory, default the system temp dir),
``RAFT_TPU_FLIGHT_DEBOUNCE_S`` (default 60).  ``RAFT_TPU_OBS_DISABLED`` /
``set_enabled`` turn recording off.  Cost: one dict build and deque append
per batch, on the completion path, after futures are resolved.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import raft_tpu_torch.obs.spans as _spans
from raft_tpu_torch.core import env as _env
from raft_tpu_torch.obs.registry import default_registry

#: default ring capacity (batch records)
DEFAULT_CAP = 256

#: default minimum seconds between auto-dumps
DEFAULT_DEBOUNCE_S = 60.0

# process-wide monotonically increasing request ids, assigned at
# MicroBatcher.submit (itertools.count.__next__ is atomic in CPython)
_req_ids = itertools.count(1)


def next_request_id() -> int:
    """The next request id — assigned once per submitted request."""
    return next(_req_ids)


def _env_cap() -> int:
    try:
        return max(1, _env.env_int("RAFT_TPU_FLIGHT_CAP", DEFAULT_CAP))
    except ValueError:
        return DEFAULT_CAP


def _env_debounce_s() -> float:
    try:
        return max(0.0, _env.env_float(
            "RAFT_TPU_FLIGHT_DEBOUNCE_S", DEFAULT_DEBOUNCE_S
        ))
    except ValueError:
        return DEFAULT_DEBOUNCE_S


def _env_dir() -> str:
    return _env.env_str("RAFT_TPU_FLIGHT_DIR") or tempfile.gettempdir()


class FlightRecorder:
    """Bounded ring of recent batch/event records + dump machinery.

    One instance normally lives for the whole process (module-level
    :func:`default_recorder`); tests build private ones.  All methods are
    thread-safe; :meth:`record_batch` is the only one on a serving path
    and costs a lock + deque append.
    """

    def __init__(self, cap: Optional[int] = None,
                 debounce_s: Optional[float] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=cap if cap is not None else _env_cap())
        self._recorded = 0          # total records ever (ring overwrites)
        self._dump_seq = 0
        self._last_dump: Optional[Dict[str, object]] = None
        self._last_auto = float("-inf")   # monotonic stamp of last auto-dump
        self._debounce_s = (
            debounce_s if debounce_s is not None else _env_debounce_s()
        )

    # -- recording -----------------------------------------------------------
    def record_batch(self, record: Dict[str, object]) -> None:
        """Append one batch record (built by the batcher's completion
        path).  No-op when obs is disabled, so ``RAFT_TPU_OBS_DISABLED``
        really does zero the recorder's footprint."""
        if not _spans.enabled():
            return
        with self._lock:
            self._ring.append(record)
            self._recorded += 1

    def record_event(self, kind: str, **fields: object) -> None:
        """Append one point-in-time event (e.g. a replicated-searcher
        rebuild) so incident dumps carry it next to the affected batches."""
        if not _spans.enabled():
            return
        rec = {"kind": kind, "t": time.perf_counter(), **fields}
        with self._lock:
            self._ring.append(rec)
            self._recorded += 1

    # -- reading -------------------------------------------------------------
    def records(self) -> List[Dict[str, object]]:
        """Ring contents, oldest first."""
        with self._lock:
            return list(self._ring)

    def last_dump(self) -> Optional[Dict[str, object]]:
        """``{"path", "trace_path", "reason", "unix_time"}`` of the most
        recent dump, or None — surfaced by ``SearchService.healthz()``."""
        with self._lock:
            return dict(self._last_dump) if self._last_dump else None

    def snapshot(self) -> Dict[str, object]:
        """Provider section for registry snapshots."""
        with self._lock:
            return {
                "cap": self._ring.maxlen,
                "records": len(self._ring),
                "recorded_total": self._recorded,
                "last_dump": dict(self._last_dump) if self._last_dump else None,
            }

    # -- dumping -------------------------------------------------------------
    def dump(self, directory: Optional[str] = None,
             reason: str = "manual") -> str:
        """Write the ring as ``flight_<seq>_<reason>.json`` plus a Chrome
        trace-event file (``.trace.json``) into ``directory`` (default
        ``RAFT_TPU_FLIGHT_DIR``, else the system temp dir).  Returns the
        JSON snapshot path."""
        directory = directory or _env_dir()
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            records = list(self._ring)
            self._dump_seq += 1
            seq = self._dump_seq
        now = time.time()
        stem = f"flight_{seq:04d}_{reason}"
        path = os.path.join(directory, stem + ".json")
        trace_path = os.path.join(directory, stem + ".trace.json")
        snapshot = {
            "schema": "raft_tpu.flight",
            "reason": reason,
            "unix_time": now,
            "records": records,
        }
        with open(path, "w") as f:
            json.dump(snapshot, f, indent=2, default=str)
        with open(trace_path, "w") as f:
            json.dump({"traceEvents": trace_events(records)}, f, default=str)
        info = {
            "path": path,
            "trace_path": trace_path,
            "reason": reason,
            "unix_time": now,
        }
        with self._lock:
            self._last_dump = info
        default_registry().counter(
            "raft_tpu_flight_dumps_total",
            help="flight-recorder dumps written",
        ).inc(reason=reason)
        return path

    def auto_dump(self, reason: str) -> Optional[str]:
        """Deprecated direct trigger path: :meth:`dump` behind one
        *global* debounce window shared across all reasons.  In-tree
        producers now publish :mod:`raft_tpu_torch.obs.events` events instead
        and the bus subscriber debounces per reason; this survives for
        out-of-tree callers that wired incidents before the bus existed.
        Never raises — these calls sit on health/alarm/error paths that
        must not gain failure modes.
        """
        if not _spans.enabled():
            return None
        with self._lock:
            now = time.monotonic()
            if now - self._last_auto < self._debounce_s:
                default_registry().counter(
                    "raft_tpu_flight_dumps_suppressed_total",
                    help="auto-dumps suppressed by the debounce window",
                ).inc(reason=reason)
                return None
            self._last_auto = now
        try:
            return self.dump(reason=reason)
        except Exception:  # noqa: BLE001 — incident paths must not fail
            return None

    def reset(self) -> None:
        """Clear the ring, debounce state and last-dump pointer; re-read
        the env knobs (tests / long-lived REPLs)."""
        with self._lock:
            self._ring = deque(maxlen=_env_cap())
            self._recorded = 0
            self._last_dump = None
            self._last_auto = float("-inf")
            self._debounce_s = _env_debounce_s()


def trace_events(records: List[Dict[str, object]]) -> List[Dict[str, object]]:
    """Flatten batch records into Chrome trace events (Perfetto-loadable).

    Track layout: tid 1 carries one complete ("X") slice per batch with
    the stage sub-slices laid end to end from the batch pickup stamp
    (reconstructed from the recorded durations — the recorder adds no
    clocks of its own); tid 2 carries one slice per member request
    spanning submit → resolve.  Point events (``record_event``) become
    instant ("i") events.  Timestamps are ``time.perf_counter`` seconds
    scaled to microseconds — relative, which is all Perfetto needs.
    """
    events: List[Dict[str, object]] = [
        {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
         "args": {"name": "batches"}},
        {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name",
         "args": {"name": "requests"}},
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "raft_tpu_torch.serve"}},
    ]
    for rec in records:
        if "t_pickup" not in rec:  # a record_event point, not a batch
            events.append({
                "ph": "i", "pid": 1, "tid": 1, "s": "p",
                "name": str(rec.get("kind", "event")),
                "ts": float(rec.get("t", 0.0)) * 1e6,
                "args": {k: v for k, v in rec.items() if k != "t"},
            })
            continue
        t_pickup = float(rec.get("t_pickup", 0.0))
        t_done = float(rec.get("t_done", t_pickup))
        label = f"batch seq={rec.get('seq')} b{rec.get('bucket')}"
        if rec.get("error"):
            label += " ERROR"
        events.append({
            "ph": "X", "pid": 1, "tid": 1, "name": label,
            "ts": t_pickup * 1e6,
            "dur": max(0.0, t_done - t_pickup) * 1e6,
            "args": {
                "index": rec.get("index"),
                "request_ids": rec.get("request_ids"),
                "rows": rec.get("rows"),
                "compiles": rec.get("compiles"),
                "error": rec.get("error"),
            },
        })
        offset = t_pickup
        for stage, dur in (rec.get("stages_s") or {}).items():
            dur = float(dur)
            events.append({
                "ph": "X", "pid": 1, "tid": 1, "name": stage,
                "ts": offset * 1e6, "dur": max(0.0, dur) * 1e6,
            })
            offset += max(0.0, dur)
        for req in rec.get("requests") or ():
            t_submit = float(req.get("submit", t_pickup))
            t_resolve = float(req.get("resolve", t_done))
            events.append({
                "ph": "X", "pid": 1, "tid": 2,
                "name": f"req {req.get('id')}",
                "ts": t_submit * 1e6,
                "dur": max(0.0, t_resolve - t_submit) * 1e6,
                "args": {k: v for k, v in req.items()
                         if k not in ("submit", "resolve")},
            })
    return events


# ---------------------------------------------------------------------------
# the process-wide default recorder + module-level conveniences

_default = FlightRecorder()


def default_recorder() -> FlightRecorder:
    return _default


def record_batch(record: Dict[str, object]) -> None:
    _default.record_batch(record)


def record_event(kind: str, **fields: object) -> None:
    _default.record_event(kind, **fields)


def records() -> List[Dict[str, object]]:
    return _default.records()


def dump(directory: Optional[str] = None, reason: str = "manual") -> str:
    return _default.dump(directory, reason=reason)


def auto_dump(reason: str) -> Optional[str]:
    return _default.auto_dump(reason)


def last_dump() -> Optional[Dict[str, object]]:
    return _default.last_dump()


def flight_snapshot() -> Dict[str, object]:
    """Provider section for registry snapshots."""
    return _default.snapshot()


def reset() -> None:
    _default.reset()
    _on_bus_reset()


# ---------------------------------------------------------------------------
# event-bus subscriber: the migrated trigger path

#: default cross-reason correlation guard (seconds) — mirrors the
#: incident manager's grouping window so "one incident, one artifact"
#: survives the move to per-reason debounce
DEFAULT_CORRELATION_S = 5.0

_bus_guard = threading.Lock()
_last_bus_dump = float("-inf")   # monotonic stamp of the last bus-triggered dump


def _env_correlation_s() -> float:
    try:
        return max(0.0, _env.env_float(
            "RAFT_TPU_INCIDENT_WINDOW_S", DEFAULT_CORRELATION_S
        ))
    except ValueError:
        return DEFAULT_CORRELATION_S


def _on_bus_event(event) -> None:
    """Dump the ring for a trigger event.  The per-reason debounce
    already ran in the bus subscription; here only the short cross-reason
    correlation guard applies (several symptoms of one incident within
    ``RAFT_TPU_INCIDENT_WINDOW_S`` share the first artifact).  Never
    raises — the bus swallows subscriber errors, but a dump failure
    should not even count as one."""
    global _last_bus_dump
    if event.recovered or not _spans.enabled():
        return
    now = time.monotonic()
    with _bus_guard:
        suppressed = now - _last_bus_dump < _env_correlation_s()
        if not suppressed:
            _last_bus_dump = now
    if suppressed:
        default_registry().counter(
            "raft_tpu_flight_dumps_suppressed_total",
            help="auto-dumps suppressed by the debounce window",
        ).inc(reason=event.reason)
        return
    try:
        _default.dump(reason=event.reason)
    except Exception:  # noqa: BLE001 — incident paths must not fail
        pass


def install_bus_subscriber(bus) -> None:
    """Register the flight dumper on ``bus``: trigger kinds only,
    debounced per reason with the ``RAFT_TPU_FLIGHT_DEBOUNCE_S`` window.
    Called once per bus by :func:`raft_tpu_torch.obs.events.default_bus`."""
    from raft_tpu_torch.obs import events as _events

    bus.subscribe(
        _on_bus_event,
        kinds=_events.TRIGGER_KINDS,
        debounce_s=_env_debounce_s(),
        name="flight",
    )


def _on_bus_reset() -> None:
    global _last_bus_dump
    with _bus_guard:
        _last_bus_dump = float("-inf")
