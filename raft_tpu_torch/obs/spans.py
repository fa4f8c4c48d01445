"""Structured spans (counterpart of ``raft_tpu.obs.spans``): what the
``core.trace`` ranges become when they have to be *queried*.

- every range becomes a :class:`Span` (id, parent id, wall time, named
  stage timings, attributed events) on a thread-local stack;
- finishing a span feeds ``raft_tpu_span_seconds{span=<name>}`` in the
  default registry and a bounded ring of recent root spans;
- :func:`current_span` lets leaf code (``obs.device_events``: kernel
  builds and host↔device copies) attach data to whatever operation is
  running, with no plumbing through call signatures.

Spans are not cross-thread: :func:`open_span` / :func:`finish_span` make a
detached root span for an operation that ends on another thread.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.obs.registry import default_registry

def _ring_cap() -> int:
    """Recent-span ring capacity: ``RAFT_TPU_SPAN_RING``, default 512."""
    try:
        return max(1, _env.env_int("RAFT_TPU_SPAN_RING", 512))
    except ValueError:
        return 512


_ids = itertools.count(1)  # itertools.count.__next__ is atomic in CPython
_tls = threading.local()
_recent_lock = threading.Lock()
#: ring of recently finished root spans (tests / debugging / slow log)
_recent: deque = deque(maxlen=_ring_cap())

_disabled = _env.env_bool("RAFT_TPU_OBS_DISABLED", False)


def set_enabled(enabled: bool) -> None:
    """Global kill-switch (also: RAFT_TPU_OBS_DISABLED=1 at import)."""
    global _disabled
    _disabled = not enabled


def enabled() -> bool:
    return not _disabled


class Span:
    """One timed operation. Mutable while open; frozen facts after close."""

    __slots__ = (
        "name", "span_id", "parent_id", "t_start", "t_end",
        "stages", "events",
    )

    def __init__(self, name: str, span_id: int, parent_id: Optional[int]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = time.perf_counter()
        self.t_end: Optional[float] = None
        #: named sub-timings in seconds (queue/pad/dispatch/device, ...)
        self.stages: Dict[str, float] = {}
        #: attributed event tallies (kernel_builds, transfers, ...)
        self.events: Dict[str, float] = {}

    @property
    def duration_s(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_start

    def add_stage(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + float(seconds)

    def add_event(self, name: str, value: float = 1.0) -> None:
        self.events[name] = self.events.get(name, 0.0) + float(value)

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "duration_ms": (
                None if self.duration_s is None else self.duration_s * 1e3
            ),
            "stages_ms": {k: v * 1e3 for k, v in self.stages.items()},
            "events": dict(self.events),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        d = self.duration_s
        return (
            f"<Span {self.name} id={self.span_id} "
            f"{'open' if d is None else f'{d * 1e3:.3f}ms'}>"
        )


def _stack() -> List[Span]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current_span() -> Optional[Span]:
    """Innermost open span on this thread, or None."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


def enter(name: str) -> Optional[Span]:
    """Open a child of the current span (or a root) and push it on this
    thread's stack; None when observability is globally disabled.  Close
    it with :func:`leave` (the hot path of ``core.trace``, which avoids a
    generator-based context manager)."""
    if _disabled:
        return None
    stack = _stack()
    parent = stack[-1] if stack else None
    sp = Span(name, next(_ids), parent.span_id if parent else None)
    stack.append(sp)
    return sp


def leave(sp: Optional[Span]) -> None:
    """Close the innermost span opened by :func:`enter`."""
    if sp is None:
        return
    sp.t_end = time.perf_counter()
    stack = _tls.stack
    stack.pop()
    _record_finished(sp, stack[-1] if stack else None)


@contextlib.contextmanager
def span(name: str) -> Iterator[Optional[Span]]:
    """Open a child of the current span (or a root).  Yields the Span, or
    None when observability is globally disabled."""
    sp = enter(name)
    try:
        yield sp
    finally:
        leave(sp)


def set_ring_capacity(cap: Optional[int] = None) -> int:
    """Resize the recent-span ring, keeping its newest entries.  With no
    argument, re-reads ``RAFT_TPU_SPAN_RING`` — the hook the conftest
    reset fixture and long-lived REPLs use.  Returns the new capacity."""
    global _recent
    new_cap = _ring_cap() if cap is None else max(1, int(cap))
    with _recent_lock:
        if _recent.maxlen != new_cap:
            _recent = deque(_recent, maxlen=new_cap)
    return new_cap


def clear_recent() -> None:
    """Drop the recent-span ring contents (test isolation)."""
    with _recent_lock:
        _recent.clear()


_hist = None   # the span histogram of the default registry, looked up once


def _span_histogram():
    global _hist
    reg = default_registry()
    h = _hist
    if h is None or reg._metrics.get("raft_tpu_span_seconds") is not h:   # reset since
        h = _hist = reg.histogram("raft_tpu_span_seconds",
                                  help="wall time per traced operation")
    return h


def _record_finished(sp: Span, parent: Optional[Span]) -> None:
    try:
        # the span id rides along as a per-bucket exemplar, so a fat p99
        # bucket in the scrape links back to a concrete recorded span
        _span_histogram().observe(sp.duration_s, exemplar=f"span-{sp.span_id}", span=sp.name)
    except Exception:
        # span names are static strings in practice; a pathological dynamic
        # name tripping the cardinality cap must not break the traced API
        pass
    if parent is not None:
        # roll attributed events up so root spans carry the whole story
        for k, v in sp.events.items():
            parent.add_event(k, v)
    else:
        with _recent_lock:
            _recent.append(sp)


def open_span(name: str) -> Optional[Span]:
    """A *detached* root span for operations that cross threads.

    The pipelined serve dispatch opens a ``serve.batch`` span on the
    dispatch thread and closes it on the completion thread — a lifetime
    no context manager on either thread can express.  Detached spans are
    never pushed on a thread-local stack, so :func:`current_span` does
    not see them and device events attribute to whatever stacked span
    is open instead.  Returns ``None`` when obs is disabled; close
    with :func:`finish_span`.
    """
    if _disabled:
        return None
    return Span(name, next(_ids), None)


def finish_span(sp: Optional[Span]) -> None:
    """Close a span from :func:`open_span`: stamps the end time, feeds
    ``raft_tpu_span_seconds`` and the recent-roots ring.  Idempotent and
    None-tolerant so error paths can call it unconditionally."""
    if sp is None or sp.t_end is not None:
        return
    sp.t_end = time.perf_counter()
    _record_finished(sp, None)


def recent_spans(n: int = 50) -> List[Dict[str, object]]:
    """Most recent finished root spans, newest last (JSON-safe)."""
    with _recent_lock:
        items = list(_recent)[-n:]
    return [sp.to_dict() for sp in items]


def spans_snapshot() -> Dict[str, object]:
    """Provider section for registry snapshots."""
    return {"recent": recent_spans(20)}
