"""Tracing ranges (counterpart of ``raft_tpu.core.trace``; raft's NVTX
ranges).

:func:`trace_range` opens an :mod:`raft_tpu_torch.obs` span (the queryable
record: wall time into the metrics registry, and the attribution point of
kernel builds and host↔device copies) and, while a ``torch.profiler``
capture is running, a ``torch.profiler.record_function("raft_tpu.<name>")``
range inside it, which puts the name on the trace's timeline and on the
device work launched under it — raft_tpu's ``TraceAnnotation`` +
``named_scope``.  ``record_function`` costs host time on every call even
with no profiler attached, so it is entered only while one is.

:func:`traced` is the decorator form for public entry points; the wrapper
carries ``__traced__`` (its label, raft_tpu's) for the coverage test.
:func:`profile` captures a Chrome trace of a block.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Optional, TypeVar

from raft_tpu_torch.core import env as _env

DOMAIN = "raft_tpu"

F = TypeVar("F", bound=Callable)

_spans = None  # imported on the first range: `import raft_tpu_torch` stays cheap
_autograd_profiler = None   # torch.autograd.profiler, bound on the first range


def _obs_spans():
    global _spans
    if _spans is None:
        from raft_tpu_torch.obs import spans

        _spans = spans
    return _spans


def _profiler_active() -> bool:
    global _autograd_profiler
    if _autograd_profiler is None:
        import torch.autograd.profiler as _autograd_profiler
    return _autograd_profiler._is_profiler_enabled


class trace_range:
    """Scoped range ``raft_tpu.<name>`` (a context manager).  Entering
    yields the open :class:`raft_tpu_torch.obs.spans.Span` (``None`` when
    obs is disabled) so call sites can attach stage timings.  A class, not
    a generator: every public entry point enters one."""

    __slots__ = ("name", "_sp", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        spans = _spans if _spans is not None else _obs_spans()
        self._sp = spans.enter(self.name)
        self._rf = None
        if _profiler_active():
            import torch

            self._rf = torch.profiler.record_function(f"{DOMAIN}.{self.name}")
            self._rf.__enter__()
        return self._sp

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _spans.leave(self._sp)
        return False


def traced(name: Optional[str] = None) -> Callable[[F], F]:
    """Decorator form of :func:`trace_range` for public entry points; the
    wrapper carries ``__traced__`` (the range label)."""

    def deco(fn: F) -> F:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with trace_range(label):
                return fn(*args, **kwargs)

        wrapper.__traced__ = label  # type: ignore[attr-defined]
        return wrapper  # type: ignore[return-value]

    return deco


@contextlib.contextmanager
def profile(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host, and
    the card's kernels and copies when one is present) and write it to
    ``log_dir/trace.json`` as a Chrome trace (``chrome://tracing``,
    Perfetto).  A no-op when ``RAFT_TPU_DISABLE_PROFILER`` is set."""
    if _env.env_bool("RAFT_TPU_DISABLE_PROFILER"):
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
