"""Slow-query log (counterpart of ``raft_tpu.obs.slowlog``): requests
over a latency threshold, with their span's stage breakdown and attributed
events.

Entries go to a bounded in-memory ring (:func:`entries`, merged into
registry snapshots) and to the ``raft_tpu_torch.obs.slowlog`` logger at
WARNING, one line per slow request.

Threshold: ``RAFT_TPU_SLOW_QUERY_MS`` env var, or :func:`configure`.
Default 250 ms.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.logger import child as _child_logger
from raft_tpu_torch.obs.registry import default_registry
from raft_tpu_torch.obs.spans import Span

_CAP = 256

_lock = threading.Lock()
_entries: deque = deque(maxlen=_CAP)
_threshold_s = _env.env_float("RAFT_TPU_SLOW_QUERY_MS", 250.0) * 1e-3


def configure(threshold_ms: Optional[float]) -> None:
    """Set the slow threshold; None disables the log entirely.

    Rejects negative thresholds: the old behaviour silently armed an
    every-query log (anything is slower than -5 ms), which reads like
    "disabled" but WARNING-spams instead.  Use ``None`` or ``0`` to log
    everything deliberately, a positive value to filter.
    """
    global _threshold_s
    if threshold_ms is not None and float(threshold_ms) < 0:
        raise ValueError(
            f"slow-query threshold must be >= 0 ms (or None to disable), "
            f"got {threshold_ms}"
        )
    _threshold_s = None if threshold_ms is None else float(threshold_ms) * 1e-3


def threshold_ms() -> Optional[float]:
    return None if _threshold_s is None else _threshold_s * 1e3


def maybe_record(span: Span, *, latency_s: Optional[float] = None,
                 detail: Optional[Dict[str, object]] = None) -> bool:
    """Log ``span`` if its latency crossed the threshold.

    ``latency_s`` overrides the span's own wall time — the batcher passes
    the worst submit→complete request latency, which includes queue wait
    the dispatch span can't see.  Returns True when recorded as slow.
    Callers sit on hot paths: the fast path is one float compare.
    """
    if latency_s is None:
        latency_s = span.duration_s
    if _threshold_s is None or latency_s is None:
        return False
    if latency_s < _threshold_s:
        return False
    entry: Dict[str, object] = {
        "unix_time": time.time(),
        "latency_ms": latency_s * 1e3,
        **span.to_dict(),
    }
    if detail:
        entry.update(detail)
    with _lock:
        _entries.append(entry)
    default_registry().counter(
        "raft_tpu_slow_queries_total",
        help="requests over the slow threshold",
    ).inc(span=span.name)
    stages = ", ".join(
        f"{k}={v:.1f}ms" for k, v in entry.get("stages_ms", {}).items()
    )
    # explain summary, when the batcher enriched the detail (the fields
    # ride the entry either way; the line is what an operator greps):
    # effort level + who set it, kernel path, bucket, page hit ratio
    summary = ", ".join(
        f"{key}={entry[key]}"
        for key in ("effort_level", "effort_source", "kernel_path",
                    "bucket", "page_hit_ratio")
        if entry.get(key) is not None
    )
    _child_logger("obs.slowlog").warning(
        "slow query: %s took %.1fms (threshold %.1fms)%s%s",
        span.name,
        latency_s * 1e3,
        _threshold_s * 1e3,
        f" [{stages}]" if stages else "",
        f" [{summary}]" if summary else "",
    )
    return True


def entries(n: int = 50) -> List[Dict[str, object]]:
    """Most recent slow entries, newest last."""
    with _lock:
        return list(_entries)[-n:]


def clear() -> None:
    with _lock:
        _entries.clear()


def slowlog_snapshot() -> Dict[str, object]:
    """Provider section for registry snapshots."""
    return {"threshold_ms": threshold_ms(), "recent": entries(20)}
