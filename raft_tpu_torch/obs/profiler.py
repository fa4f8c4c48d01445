"""One-line profiler captures (counterpart of ``raft_tpu.obs.profiler``):
``with obs.profile(dir): ...``.

raft_tpu wraps ``jax.profiler``; the port wraps ``torch.profiler``
(``core.trace.profile``: host ops, and the card's kernels and copies when
one is present, written as a Chrome trace to ``dir/trace.json``).  The
capture is bracketed in an ``obs.profile`` span and counted, and
``RAFT_TPU_DISABLE_PROFILER`` turns it into a no-op.

:func:`capture_async` is the unattended variant the perf ledger's
``perf_regression`` subscriber fires: a bounded capture of the next
``duration_s`` seconds that does not block the publisher.  The profiler
runs on a daemon thread of its own, which starts it, sleeps out the
window and stops it, so start and stop happen on one thread; the card's
kernels launched from any thread land in the trace.  One capture runs at
a time; overlapping requests are counted and skipped.  :func:`last_capture`
exposes the newest capture's info, which the incident manager attaches to
its timeline as it does flight dumps.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import time
from typing import Dict, Iterator, Optional

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core import trace as _trace
from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs.registry import default_registry


def _count_capture() -> None:
    default_registry().counter(
        "raft_tpu_profile_captures_total",
        help="torch.profiler trace sessions started via obs.profile",
    ).inc()


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/trace.json`` (load it in https://ui.perfetto.dev); every
    ``trace_range``-wrapped call inside shows as a named host range."""
    if _env.env_bool("RAFT_TPU_DISABLE_PROFILER"):
        yield
        return
    _count_capture()
    with _spans.span("obs.profile"):
        with _trace.profile(log_dir):
            yield


# ---------------------------------------------------------------------------
# unattended captures (perf-regression auto-profile)

_state_lock = threading.Lock()
_active = False
_stop = threading.Event()
_last_capture: Optional[Dict[str, object]] = None


def last_capture() -> Optional[Dict[str, object]]:
    """``{"path", "reason", "duration_s", "t", "unix_time"}`` of the most
    recent :func:`capture_async`, or None.  Recorded at capture start, so
    the incident correlating the triggering event can attach it at once
    (the trace file lands ``duration_s`` later)."""
    with _state_lock:
        return dict(_last_capture) if _last_capture is not None else None


def capture_async(
    log_dir: str, *, duration_s: float, reason: str = "manual",
) -> Optional[Dict[str, object]]:
    """Start a bounded profiler capture without blocking the caller.

    Returns the capture info dict (also :func:`last_capture`), or None when
    profiling is disabled or a capture is already running.  The trace is
    written to ``<path>/trace.json`` when the window closes."""
    global _active, _last_capture
    if _env.env_bool("RAFT_TPU_DISABLE_PROFILER") or duration_s <= 0:
        return None
    with _state_lock:
        if _active:
            default_registry().counter(
                "raft_tpu_profile_captures_skipped_total",
                help="async capture requests skipped because one was "
                     "already running",
            ).inc()
            return None
        _active = True
        _stop.clear()
    stem = re.sub(r"[^A-Za-z0-9_.-]", "_", reason)
    path = os.path.join(log_dir, f"profile_{stem}_{os.getpid()}")
    info = {
        "path": path,
        "reason": reason,
        "duration_s": float(duration_s),
        "t": time.perf_counter(),
        "unix_time": time.time(),
    }
    with _state_lock:
        _last_capture = dict(info)
    _count_capture()
    threading.Thread(target=_run_capture, args=(path, float(duration_s)),
                     name="raft-tpu-profile-capture", daemon=True).start()
    return info


def _run_capture(path: str, duration_s: float) -> None:
    global _active
    try:
        with _trace.profile(path):
            _stop.wait(duration_s)
    except Exception:  # a profiler already running elsewhere: no capture
        pass
    finally:
        with _state_lock:
            _active = False


def reset() -> None:
    """End any running capture early and forget the last one (test
    hygiene, reached through ``events.reset`` → ``perf._on_bus_reset``)."""
    global _last_capture
    _stop.set()
    with _state_lock:
        _last_capture = None
