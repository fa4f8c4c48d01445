"""Per-query EXPLAIN plans and the tail-sampled query archive
(counterpart of ``raft_tpu.obs.explain``).

- **On-demand deep explain** — ``serve.SearchService.explain`` runs one
  real request through the normal batched path and assembles an
  :class:`ExplainPlan` from the enriched flight-recorder batch record
  (keyed by the request id) plus host-side probes taken after the
  dispatch (coarse probe replay, the recall auditor's verdict).
- **Always-on tail sampling** — a bounded :class:`QueryArchive` keeps full
  plans for the slowest per window, shed / deadline-expired and errored
  requests and a deterministic 1-in-N baseline; it dumps beside flight
  records on incident triggers and links the artifact into the open
  incident with an ``explain_dump`` context event.

No clock of its own on the serving path (:class:`TailSampler` runs on the
batch record's ``t_done``).  Gated by ``RAFT_TPU_EXPLAIN`` (deep explains
open the gate for their own request, :func:`deep_scope`) and by the master
obs switch.  Knobs: ``RAFT_TPU_EXPLAIN_ARCHIVE_CAP`` (default 128),
``RAFT_TPU_EXPLAIN_TAIL_PER_WINDOW`` (default 4).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

import raft_tpu_torch.obs.spans as _spans
from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.obs import flight as _flight
from raft_tpu_torch.obs.registry import default_registry

#: default archive ring capacity (plans)
DEFAULT_CAP = 128

#: default slowest-N retained per sampling window
DEFAULT_TAIL_PER_WINDOW = 4

#: tail-sampler window length (seconds of record time, not wall clocks)
WINDOW_S = 1.0

#: deterministic baseline population: every Nth observed request
BASELINE_STRIDE = 64

#: how long after a quality alarm requests count as alarm-correlated
ALARM_WINDOW_S = 2.0


def _env_cap() -> int:
    try:
        return max(1, _env.env_int(
            "RAFT_TPU_EXPLAIN_ARCHIVE_CAP", DEFAULT_CAP
        ))
    except ValueError:
        return DEFAULT_CAP


def _env_tail_per_window() -> int:
    try:
        return max(1, _env.env_int(
            "RAFT_TPU_EXPLAIN_TAIL_PER_WINDOW", DEFAULT_TAIL_PER_WINDOW
        ))
    except ValueError:
        return DEFAULT_TAIL_PER_WINDOW


# ---------------------------------------------------------------------------
# enablement: env gate + deep-explain scope

_deep_lock = threading.Lock()
_deep_active = 0


@contextmanager
def deep_scope():
    """Force the explain gate open for the duration (deep explains work
    without ``RAFT_TPU_EXPLAIN`` set; the batch carrying the explained
    request is observed exactly like a sampled one)."""
    global _deep_active
    with _deep_lock:
        _deep_active += 1
    try:
        yield
    finally:
        with _deep_lock:
            _deep_active -= 1


def enabled() -> bool:
    """Whether explain collection is on: ``RAFT_TPU_EXPLAIN`` or an
    active :func:`deep_scope`.  Checked once per batch (and once per
    paged-lists resolve), never per request."""
    if _deep_active > 0:
        return True
    return _env.env_bool("RAFT_TPU_EXPLAIN")


# ---------------------------------------------------------------------------
# thread-local stamps: decisions recorded where they are already made.
# The dispatch thread stamps (ragged dispatch params, page-cache deltas)
# and the batcher consumes on the same thread right after the call —
# mirroring kernels.stamp_kernel_path/consume_kernel_path.

_tls = threading.local()


def stamp_page_stats(stats: Dict[str, object]) -> None:
    """Record this dispatch's page-cache interaction (set by
    ``neighbors._common.paged_lists_for_search`` on the dispatch
    thread)."""
    _tls.page = stats


def consume_page_stats(default: Optional[Dict[str, object]] = None):
    """Pop the page stamp (batcher ``_invoke``, same thread)."""
    stats = getattr(_tls, "page", None)
    _tls.page = None
    return stats if stats is not None else default


def stamp_dispatch(info: Dict[str, object]) -> None:
    """Record dispatch-level parameters (effective search params, k_max)
    — set by ``serve.ragged.RaggedSearcher`` on the dispatch thread."""
    _tls.dispatch = info


def consume_dispatch(default: Optional[Dict[str, object]] = None):
    """Pop the dispatch stamp (batcher ``_invoke``, same thread)."""
    info = getattr(_tls, "dispatch", None)
    _tls.dispatch = None
    return info if info is not None else default


# ---------------------------------------------------------------------------
# the plan

class ExplainPlan:
    """One request's assembled EXPLAIN-ANALYZE plan.

    A thin, JSON-able wrapper over named sections (``request``,
    ``outcome``, ``admission``, ``effort``, ``bucket``, ``kernel_path``,
    ``probe``, ``page``, ``shards``, ``stages``, ...).  Sections a given
    backend cannot attribute carry ``{"available": False}`` rather than
    disappearing, so consumers need no per-backend branching.
    """

    def __init__(self, sections: Dict[str, object]):
        self.sections = sections

    def __getitem__(self, key: str):
        return self.sections[key]

    def get(self, key: str, default=None):
        return self.sections.get(key, default)

    def to_dict(self) -> Dict[str, object]:
        return {"schema": "raft_tpu.explain", **self.sections}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def to_text(self) -> str:
        """Human-readable plan, one section per block."""
        s = self.sections
        req = s.get("request", {}) or {}
        out = s.get("outcome", {}) or {}
        lines = [
            f"EXPLAIN request {req.get('id')} "
            f"index={s.get('bucket', {}).get('index')} "
            f"outcome={out.get('outcome')}",
        ]
        for key in ("request", "outcome", "admission", "effort", "bucket",
                    "kernel_path", "probe", "page", "shards", "stages",
                    "audit", "sampling", "results"):
            if key not in s:
                continue
            val = s[key]
            if isinstance(val, dict):
                body = ", ".join(f"{k}={v}" for k, v in val.items())
            else:
                body = str(val)
            lines.append(f"  {key:<12} {body}")
        return "\n".join(lines)


def summary_line(record: Dict[str, object]) -> Dict[str, object]:
    """The compact explain summary the slow-query log appends to its
    entries: effort level, kernel path, bucket, page hit ratio — enough
    to act on a slow line without a separate archive lookup."""
    effort = record.get("effort") or {}
    page = record.get("page") or {}
    hits = page.get("hits")
    misses = page.get("misses")
    ratio = None
    if hits is not None and misses is not None and (hits + misses) > 0:
        ratio = round(hits / float(hits + misses), 4)
    return {
        "effort_level": effort.get("effective_level"),
        "effort_source": effort.get("source"),
        "kernel_path": record.get("kernel_path"),
        "page_hit_ratio": ratio,
    }


def build_plan(record: Dict[str, object], member: Dict[str, object],
               reason: str) -> ExplainPlan:
    """Join one member request against its enriched batch record.

    Pure dict shuffling over stamps already taken — no clocks, no device
    access.  ``record`` is the flight-recorder batch dict (enriched by
    the batcher with ``admission_level`` / ``effort`` / ``kernel_path``
    / ``page`` / ``dispatch`` when explain is enabled); ``member`` is
    the per-request entry inside it.
    """
    error = record.get("error")
    dispatch = record.get("dispatch") or {}
    probe = dict(record.get("probe") or {"available": False})
    if dispatch:
        # dispatch-level params (effective n_probes etc.) annotate the
        # probe section even before a deep explain fills in list ids
        probe.setdefault("params", dispatch)
    sections: Dict[str, object] = {
        "request": {
            "id": member.get("id"),
            "rows": member.get("rows"),
            "k": member.get("k"),
            "fid": member.get("fid"),
            "priority": member.get("priority"),
            "queue_ms": member.get("queue_ms"),
            "latency_ms": member.get("latency_ms"),
        },
        "outcome": {
            "outcome": "error" if error else "ok",
            "error": error,
            "sampled_reason": reason,
        },
        "admission": {
            "admitted": True,
            "pressure_level": record.get("admission_level", 0),
        },
        "effort": record.get("effort") or {"available": False},
        "bucket": {
            "index": record.get("index"),
            "bucket": record.get("bucket"),
            "batch_rows": record.get("rows"),
            "seq": record.get("seq"),
            "compiles": record.get("compiles"),
            "hedged": record.get("hedged", False),
        },
        "kernel_path": record.get("kernel_path") or "unknown",
        "probe": probe,
        "page": record.get("page") or {"available": False},
        "shards": {"available": False},
        "stages": {
            "batch_stages_s": record.get("stages_s"),
            "batch_waits_s": record.get("waits_s"),
            "queue_ms": member.get("queue_ms"),
            "latency_ms": member.get("latency_ms"),
            "request_stages_ms": member.get("stages_ms"),
        },
    }
    return ExplainPlan(sections)


def shed_plan(req, index: str, outcome: str, level: int) -> ExplainPlan:
    """Minimal plan for a request that never reached a dispatch: shed by
    admission control or expired at its deadline.  Uses only stamps the
    request already carries (``t_submit``) — no new clocks."""
    try:
        # deferred: obs must not import serve at module time
        from raft_tpu_torch.serve.overload import priority_name
        pname = priority_name(getattr(req, "priority", None))
    except Exception:  # noqa: BLE001 — labeling is best-effort
        pname = "unknown"
    sections: Dict[str, object] = {
        "request": {
            "id": getattr(req, "req_id", None),
            "rows": int(getattr(req, "rows", None).shape[0])
            if getattr(req, "rows", None) is not None else None,
            "k": getattr(req, "k", None),
            "fid": getattr(req, "fid", None),
            "priority": getattr(req, "priority", None),
            "priority_name": pname,
            "submit": getattr(req, "t_submit", None),
        },
        "outcome": {"outcome": outcome, "error": None,
                    "sampled_reason": outcome},
        "admission": {"admitted": False, "pressure_level": level},
        "effort": {"available": False},
        "bucket": {"index": index},
        "kernel_path": "none",
        "probe": {"available": False},
        "page": {"available": False},
        "shards": {"available": False},
        "stages": {"available": False},
    }
    return ExplainPlan(sections)


# ---------------------------------------------------------------------------
# tail sampling

class TailSampler:
    """Deterministic tail selection, clocked by the records themselves.

    "Now" is always the observed batch record's existing ``t_done``
    stamp — the sampler takes **zero clock calls of its own**, which
    also makes selection reproducible on a synthetic clock in tests.
    Selection reasons, in priority order:

    - ``recall_alarm`` — the request completed within
      :data:`ALARM_WINDOW_S` after a quality-alarm edge;
    - ``slow_window`` — among the slowest N (greedy top-N: a request is
      kept when fewer than N were kept this window or it is slower than
      the slowest already kept) in its aligned :data:`WINDOW_S` window;
    - ``baseline`` — every :data:`BASELINE_STRIDE`-th observed request
      (deterministic stride, not RNG).
    """

    def __init__(self, per_window: Optional[int] = None,
                 window_s: float = WINDOW_S,
                 baseline_stride: int = BASELINE_STRIDE,
                 alarm_window_s: float = ALARM_WINDOW_S):
        self._per_window = (
            per_window if per_window is not None else _env_tail_per_window()
        )
        self._window_s = float(window_s)
        self._stride = max(1, int(baseline_stride))
        self._alarm_window_s = float(alarm_window_s)
        self._lock = threading.Lock()
        self._win: Optional[int] = None
        self._kept: List[float] = []     # latencies kept this window
        self._count = 0
        self._alarm_t = float("-inf")

    def note_alarm(self, t: float) -> None:
        """Stamp a quality-alarm edge (bus-subscriber thread; ``t`` is
        the event's existing perf_counter stamp)."""
        with self._lock:
            self._alarm_t = max(self._alarm_t, float(t))

    def reasons(self, *, latency_s: float, now: float) -> List[str]:
        """Selection reasons for one observed request (empty = not
        sampled).  ``now`` is the batch record's ``t_done``."""
        out: List[str] = []
        with self._lock:
            self._count += 1
            if now - self._alarm_t <= self._alarm_window_s:
                out.append("recall_alarm")
            win = int(now // self._window_s) if self._window_s > 0 else 0
            if win != self._win:
                self._win = win
                self._kept = []
            if len(self._kept) < self._per_window:
                self._kept.append(latency_s)
                out.append("slow_window")
            elif latency_s > min(self._kept):
                self._kept.remove(min(self._kept))
                self._kept.append(latency_s)
                out.append("slow_window")
            if self._count % self._stride == 0:
                out.append("baseline")
        return out

    def reset(self) -> None:
        with self._lock:
            self._win = None
            self._kept = []
            self._count = 0
            self._alarm_t = float("-inf")
            self._per_window = _env_tail_per_window()


# ---------------------------------------------------------------------------
# the archive

class QueryArchive:
    """Bounded ring of archived ExplainPlans + dump machinery.

    One instance normally lives for the whole process (module-level
    :func:`default_archive`); tests build private ones.  All methods are
    thread-safe.  :meth:`observe_batch` is the only one near a serving
    path and runs once per completed batch, after futures are resolved,
    only when :func:`enabled` — it scans the record's member list and
    archives the selected tail.
    """

    def __init__(self, cap: Optional[int] = None,
                 sampler: Optional[TailSampler] = None):
        self._lock = threading.Lock()
        self._cap = cap if cap is not None else _env_cap()
        self._ring: deque = deque()
        self._depth: Dict[str, int] = {}
        self._archived = 0
        self._dump_seq = 0
        self._last_dump: Optional[Dict[str, object]] = None
        self._watch: set = set()
        self.sampler = sampler if sampler is not None else TailSampler()

    # -- deep-explain coordination ------------------------------------------
    def watch(self, request_id: int) -> None:
        """Mark one in-flight request for unconditional archiving
        (``SearchService.explain`` retrieves its plan by id)."""
        with self._lock:
            self._watch.add(request_id)

    def unwatch(self, request_id: int) -> None:
        with self._lock:
            self._watch.discard(request_id)

    def find(self, request_id: int) -> Optional[Dict[str, object]]:
        """Most recent archive entry for ``request_id``, or None."""
        with self._lock:
            for entry in reversed(self._ring):
                if entry.get("request_id") == request_id:
                    return entry
        return None

    # -- observation ---------------------------------------------------------
    def observe_batch(self, record: Dict[str, object]) -> None:
        """Scan one enriched batch record (the same dict the flight
        recorder keeps) and archive the interesting tail.  No clocks:
        the sampler runs on the record's ``t_done``."""
        if not _spans.enabled():
            return
        error = record.get("error")
        now = float(record.get("t_done", 0.0))
        with self._lock:
            watching = bool(self._watch)
            watch = set(self._watch) if watching else ()
        for member in record.get("requests") or ():
            reasons: List[str] = []
            if error:
                reasons.append("error")
            latency_s = float(member.get("latency_ms") or 0.0) / 1e3
            reasons.extend(
                self.sampler.reasons(latency_s=latency_s, now=now)
            )
            deep = watching and member.get("id") in watch
            if deep:
                reasons.insert(0, "deep")
            if not reasons:
                continue
            plan = build_plan(record, member, reasons[0])
            plan.sections["sampling"] = {"reasons": reasons}
            self.record(plan, reason=reasons[0])

    def observe_admission(self, index: str, *, shed=(), expired=(),
                          level: int = 0) -> None:
        """Archive requests that never reached a dispatch (shed /
        deadline-expired) — always part of the interesting tail."""
        if not _spans.enabled():
            return
        for req, outcome in (
            [(r, "shed") for r in shed]
            + [(r, "deadline_expired") for r in expired]
        ):
            plan = shed_plan(req, index, outcome, level)
            self.record(plan, reason=outcome)

    @traced("explain.record")
    def record(self, plan: ExplainPlan, *, reason: str) -> None:
        """Append one plan to the ring; evicts oldest-first past the cap
        with per-index depth bookkeeping (the depth gauge must fall when
        an index's plans age out)."""
        if not _spans.enabled():
            return
        sections = plan.sections
        index = str(
            (sections.get("bucket") or {}).get("index") or "default"
        )
        entry = {
            "request_id": (sections.get("request") or {}).get("id"),
            "index": index,
            "reason": reason,
            "plan": sections,
        }
        gauge = default_registry().gauge(
            "raft_tpu_explain_archive_depth",
            help="archived explain plans currently retained, per index",
        )
        with self._lock:
            self._ring.append(entry)
            self._archived += 1
            self._depth[index] = self._depth.get(index, 0) + 1
            evicted: List[Dict[str, object]] = []
            while len(self._ring) > self._cap:
                evicted.append(self._ring.popleft())
            for old in evicted:
                old_index = old["index"]
                n = self._depth.get(old_index, 1) - 1
                if n <= 0:
                    self._depth.pop(old_index, None)
                else:
                    self._depth[old_index] = n
            depths = dict(self._depth)
        default_registry().counter(
            "raft_tpu_explain_sampled_total",
            help="explain plans archived, by index and selection reason",
        ).inc(index=index, reason=reason)
        for name, depth in depths.items():
            gauge.set(depth, index=name)
        for old in evicted:
            if old["index"] not in depths:
                gauge.remove_matching(index=old["index"])

    # -- reading -------------------------------------------------------------
    def plans(self, *, index: Optional[str] = None) -> List[Dict[str, object]]:
        """Archive contents, oldest first (optionally one index)."""
        with self._lock:
            entries = list(self._ring)
        if index is not None:
            entries = [e for e in entries if e["index"] == index]
        return entries

    def last_dump(self) -> Optional[Dict[str, object]]:
        with self._lock:
            return dict(self._last_dump) if self._last_dump else None

    def snapshot(self) -> Dict[str, object]:
        """Provider section for registry snapshots."""
        with self._lock:
            return {
                "cap": self._cap,
                "archived": len(self._ring),
                "archived_total": self._archived,
                "depth": dict(self._depth),
                "last_dump": (
                    dict(self._last_dump) if self._last_dump else None
                ),
            }

    # -- dumping -------------------------------------------------------------
    @traced("explain.dump")
    def dump(self, directory: Optional[str] = None,
             reason: str = "manual") -> str:
        """Write the archive as ``archive_<seq>_<reason>.json`` next to
        the flight dumps (``RAFT_TPU_FLIGHT_DIR``).  Returns the path."""
        directory = directory or _flight._env_dir()
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            entries = list(self._ring)
            self._dump_seq += 1
            seq = self._dump_seq
        now = time.time()
        path = os.path.join(directory, f"archive_{seq:04d}_{reason}.json")
        snapshot = {
            "schema": "raft_tpu.explain_archive",
            "reason": reason,
            "unix_time": now,
            "entries": entries,
        }
        with open(path, "w") as f:
            json.dump(snapshot, f, indent=2, default=str)
        info = {"path": path, "reason": reason, "unix_time": now}
        with self._lock:
            self._last_dump = info
        default_registry().counter(
            "raft_tpu_explain_dumps_total",
            help="query-archive dumps written",
        ).inc(reason=reason)
        return path

    # -- retirement / hygiene ------------------------------------------------
    def unwatch_index(self, name: str) -> None:
        """Retire one index's archive state and metric series
        (``SearchService.remove_index`` is the hook)."""
        with self._lock:
            self._ring = deque(
                e for e in self._ring if e["index"] != name
            )
            self._depth.pop(name, None)
        default_registry().counter(
            "raft_tpu_explain_sampled_total",
            help="explain plans archived, by index and selection reason",
        ).remove_matching(index=name)
        default_registry().gauge(
            "raft_tpu_explain_archive_depth",
            help="archived explain plans currently retained, per index",
        ).remove_matching(index=name)

    def reset(self) -> None:
        """Clear the ring, watches and dump state; re-read env knobs."""
        with self._lock:
            self._cap = _env_cap()
            self._ring = deque()
            self._depth = {}
            self._archived = 0
            self._last_dump = None
            self._watch = set()
        self.sampler.reset()


# ---------------------------------------------------------------------------
# the process-wide default archive + module-level conveniences

_default = QueryArchive()


def default_archive() -> QueryArchive:
    return _default


def observe_batch(record: Dict[str, object]) -> None:
    """Batcher hook: never raises — observability must not add failure
    modes to the completion path it observes."""
    try:
        _default.observe_batch(record)
    except Exception:  # noqa: BLE001 — serving paths must not fail
        pass


def observe_admission(index: str, *, shed=(), expired=(),
                      level: int = 0) -> None:
    """Admission hook: never raises (sits on the shed path)."""
    try:
        _default.observe_admission(
            index, shed=shed, expired=expired, level=level
        )
    except Exception:  # noqa: BLE001 — serving paths must not fail
        pass


def plans(*, index: Optional[str] = None) -> List[Dict[str, object]]:
    return _default.plans(index=index)


def dump(directory: Optional[str] = None, reason: str = "manual") -> str:
    return _default.dump(directory, reason=reason)


def explain_snapshot() -> Dict[str, object]:
    """Provider section for registry snapshots."""
    return _default.snapshot()


def reset() -> None:
    _default.reset()
    _on_bus_reset()


# ---------------------------------------------------------------------------
# event-bus subscriber: alarm correlation + incident-time archive dumps

_bus_guard = threading.Lock()
_last_bus_dump = float("-inf")   # monotonic stamp of the last bus-triggered dump


def _on_bus_event(event) -> None:
    """Trigger-kind handler.  Quality alarms stamp the sampler (so the
    requests completing just after an alarm edge join the tail); every
    non-recovered trigger dumps the archive next to the flight dump —
    behind the same cross-reason correlation guard — and publishes an
    ``explain_dump`` context event that the incident manager links into
    the open incident's timeline.  Installed *after* the incident
    manager so the reentrant publish finds the incident already open.
    Never raises."""
    global _last_bus_dump
    if event.kind == "quality_alarm" and not event.recovered:
        try:
            _default.sampler.note_alarm(event.t)
        except Exception:  # noqa: BLE001 — alarm paths must not fail
            pass
    if event.recovered or not _spans.enabled():
        return
    now = time.monotonic()
    with _bus_guard:
        suppressed = now - _last_bus_dump < _flight._env_correlation_s()
        if not suppressed:
            _last_bus_dump = now
    if suppressed:
        return
    with _default._lock:
        empty = not _default._ring
    if empty:
        return
    try:
        path = _default.dump(reason=event.reason)
    except Exception:  # noqa: BLE001 — incident paths must not fail
        return
    try:
        from raft_tpu_torch.obs import events as _events

        _events.publish(
            "explain_dump", reason=event.reason, path=path,
            trigger_kind=event.kind,
        )
    except Exception:  # noqa: BLE001 — incident paths must not fail
        pass


def install_bus_subscriber(bus) -> None:
    """Register the archive dumper on ``bus``: trigger kinds only,
    debounced per reason with the flight window.  Called once per bus by
    :func:`raft_tpu_torch.obs.events.default_bus` — after the incident
    manager, so the ``explain_dump`` context event correlates into the
    incident the same trigger just opened."""
    from raft_tpu_torch.obs import events as _events

    bus.subscribe(
        _on_bus_event,
        kinds=_events.TRIGGER_KINDS,
        debounce_s=_flight._env_debounce_s(),
        name="explain",
    )


def _on_bus_reset() -> None:
    global _last_bus_dump
    with _bus_guard:
        _last_bus_dump = float("-inf")
