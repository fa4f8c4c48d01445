"""Serving metrics (counterpart of ``raft_tpu.serve.metrics``): QPS,
latency percentiles, batch fill, and the count of kernel builds on the
serving path.

raft_tpu counts XLA backend compiles per thread through
``jax.monitoring``: a compile on the warmed hot path costs seconds, so a
non-zero ``recompiles`` after warmup is a bug.  The port has no XLA; what
can stall a request the same way is building the kernel library (``nvcc``,
``kernels.build``) or loading it (``kernels.library``).  Both are recorded
by ``obs.device_events`` on the thread that caused them, and
:func:`compile_count` counts them per thread under raft_tpu's name.  The
batcher brackets every dispatch with ``compile_count(thread=True)``, so a
build on another thread (a compaction rebuild, another service's warmup)
never counts against the dispatch thread: "zero recompiles after warmup"
reads "no kernel build or library load on the dispatch thread after
warmup".

Latency keeps a bounded reservoir (the last ``_RESERVOIR`` requests); QPS is
measured over the same window from completion stamps.  The batcher also
reports stage reservoirs (queue / pad / inflight_wait / dispatch /
device), so a p99 excursion decomposes without a profiler.  A named
instance mirrors its numbers into the process registry
(``raft_tpu_serve_*`` labeled ``index=<name>``) and appears as a
``serve.<name>`` provider section in ``obs.snapshot()``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

from raft_tpu_torch.obs import device_events
from raft_tpu_torch.obs.registry import default_registry

_RESERVOIR = 4096

#: stage names the batcher reports, in display order.  ``inflight_wait``
#: only appears at pipeline_depth > 1: the time a formed batch waited for
#: an in-flight window slot, measured before the dispatch stage.
STAGES = ("queue", "pad", "inflight_wait", "dispatch", "device")

# ---- process-wide kernel build / library load counter ---------------------

#: device-event families that count: an nvcc build of a kernel source and
#: a load of the kernel library
_COUNTED = frozenset({"backend_compile", "cache_hit", "cache_miss"})

_compile_count = 0
_compile_count_by_thread: Dict[int, int] = {}
_listener_installed = False
_listener_lock = threading.Lock()
_count_lock = threading.Lock()


def _on_device_event(family: str) -> None:
    global _compile_count
    if family in _COUNTED:
        tid = threading.get_ident()
        with _count_lock:
            _compile_count += 1
            _compile_count_by_thread[tid] = _compile_count_by_thread.get(tid, 0) + 1


def install_compile_listener() -> None:
    """Register the device-event listener (idempotent, process-wide)."""
    global _listener_installed
    with _listener_lock:
        if _listener_installed:
            return
        device_events.add_listener(_on_device_event)
        _listener_installed = True


def compile_count(thread: bool = False) -> int:
    """Kernel builds and library loads observed in this process so far.

    ``thread=True`` counts only those made by the calling thread (the
    events are recorded on the thread that builds or loads), so a dispatch
    bracket on the batcher thread stays blind to background builds."""
    install_compile_listener()
    with _count_lock:
        if thread:
            return _compile_count_by_thread.get(threading.get_ident(), 0)
        return _compile_count


class ServingMetrics:
    """Per-service request/batch counters + latency reservoirs.

    Thread-safe; the batcher's worker thread records, any thread snapshots.
    With a ``name`` the instance doubles as an obs registry client: the
    same numbers flow into ``raft_tpu_serve_*`` counters/histograms labeled
    ``index=<name>`` and the instance registers a ``serve.<name>``
    provider so ``obs.snapshot()`` carries the full serving picture.
    """

    def __init__(self, reservoir: int = _RESERVOIR,
                 name: Optional[str] = None):
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=reservoir)   # seconds, per request
        self._done_ts = deque(maxlen=reservoir)     # completion timestamps
        self._stage_lat: Dict[str, deque] = {
            s: deque(maxlen=reservoir) for s in STAGES
        }
        self.name = name
        self.requests = 0
        self.batches = 0
        self.errors: Dict[str, int] = {}   # failed requests by cause
        self.recompiles = 0        # kernel builds / loads on serve dispatches
        self.warmup_compiles = 0   # kernel builds / loads spent in warmup
        self._fill_real = 0        # sum of real rows over all batches
        self._fill_padded = 0      # sum of padded bucket rows
        self._pad_waste = 0        # sum of (bucket - real) padding rows
        # bucket → [real rows, padded rows]: per-capacity-bucket fill, the
        # figure that shows where the pad ladder's waste concentrates
        self._bucket_fill: Dict[int, list] = {}
        self._queue_depth = 0      # rows queued at the last dispatch
        self._pipeline_depth = 1   # in-flight window size (1 = serial)
        self._inflight = 0         # device batches currently in flight
        self._inflight_peak = 0    # high-water mark of the above
        # kernel_path → dispatched batches: the live cuda/torch tally
        self._kernel_paths: Dict[str, int] = {}
        if name is not None:
            default_registry().register_provider(
                f"serve.{name}", self.snapshot
            )

    def close(self) -> None:
        """Detach from the obs registry (batcher teardown).  Only removes
        the provider if it is still this instance's — a hot-replaced
        batcher's teardown must not detach its successor."""
        if self.name is not None:
            default_registry().unregister_provider(
                f"serve.{self.name}", expected=self.snapshot
            )

    # -- recording ----------------------------------------------------------
    def record_batch(
        self,
        n_real_rows: int,
        bucket_rows: int,
        latencies_s,
        compiles: int,
        stages: Optional[Mapping[str, Iterable[float]]] = None,
        request_ids: Optional[Iterable[int]] = None,
        kernel_path: Optional[str] = None,
    ) -> None:
        """One dispatched batch: ``latencies_s`` holds one submit→complete
        latency per coalesced request (queue wait included); ``stages``
        maps stage name → iterable of per-batch (or per-request, for
        ``queue``) stage durations in seconds; ``request_ids`` (parallel
        to ``latencies_s``) attaches each latency observation's request id
        as a histogram exemplar, so a fat p99 bucket names the request;
        ``kernel_path`` is the leg the dispatch actually routed to
        (cuda/torch), stamped live by the kernels thread-local and
        carried as a label on the latency and stage histograms."""
        now = time.perf_counter()
        with self._lock:
            self.requests += len(latencies_s)
            self.batches += 1
            self.recompiles += compiles
            if kernel_path is not None:
                self._kernel_paths[kernel_path] = (
                    self._kernel_paths.get(kernel_path, 0) + 1
                )
            self._fill_real += n_real_rows
            self._fill_padded += bucket_rows
            self._pad_waste += max(0, bucket_rows - n_real_rows)
            fill = self._bucket_fill.setdefault(int(bucket_rows), [0, 0])
            fill[0] += n_real_rows
            fill[1] += bucket_rows
            for lat in latencies_s:
                self._latencies.append(lat)
                self._done_ts.append(now)
            if stages:
                for s, vals in stages.items():
                    dq = self._stage_lat.setdefault(
                        s, deque(maxlen=self._latencies.maxlen)
                    )
                    for v in vals:
                        dq.append(float(v))
        self._mirror_batch(n_real_rows, bucket_rows, latencies_s, compiles,
                           stages, request_ids, kernel_path)

    def _mirror_batch(self, n_real_rows, bucket_rows, latencies_s, compiles,
                      stages, request_ids=None, kernel_path=None) -> None:
        """Feed the obs registry (no-op for anonymous instances)."""
        if self.name is None:
            return
        reg = default_registry()
        label = {"index": self.name}
        # latency/stage histograms carry the dispatch's kernel leg so the
        # cuda-vs-torch comparison reads straight off the live series;
        # counters keep index-only labels (cardinality discipline)
        hist_label = (
            dict(label, kernel_path=kernel_path)
            if kernel_path is not None else label
        )
        reg.counter(
            "raft_tpu_serve_requests_total", help="served requests"
        ).inc(len(latencies_s), **label)
        reg.counter(
            "raft_tpu_serve_batches_total", help="dispatched batches"
        ).inc(**label)
        if compiles:
            reg.counter(
                "raft_tpu_serve_recompiles_total",
                help="kernel builds / library loads on the dispatch thread "
                     "(should stay 0 after warmup)",
            ).inc(compiles, **label)
        lat_h = reg.histogram(
            "raft_tpu_serve_request_seconds",
            help="submit-to-complete request latency",
        )
        ids = list(request_ids) if request_ids is not None else None
        for i, lat in enumerate(latencies_s):
            # the request id rides along as a per-bucket exemplar: the
            # OpenMetrics scrape links the bucket to a flight-recorder entry
            ex = f"req-{ids[i]}" if ids is not None and i < len(ids) else None
            lat_h.observe(lat, exemplar=ex, **hist_label)
        reg.counter(
            "raft_tpu_serve_pad_waste_rows",
            help="padding rows dispatched but never asked for (bucket "
                 "minus real rows) — the pad ladder's tax; ragged "
                 "continuous admission exists to push this down",
        ).inc(max(0, bucket_rows - n_real_rows), **label)
        if stages:
            st_h = reg.histogram(
                "raft_tpu_serve_stage_seconds",
                help="per-stage serving latency (queue/pad/dispatch/device)",
            )
            for s, vals in stages.items():
                for v in vals:
                    st_h.observe(v, stage=s, **hist_label)
            queue = [float(v) for v in stages.get("queue", ())]
            if queue:
                reg.gauge(
                    "raft_tpu_serve_admit_wait_seconds",
                    help="mean submit-to-batch admission wait of the last "
                         "dispatched batch (continuous admission widens "
                         "this only while the device window is full)",
                ).set(sum(queue) / len(queue), **label)

    def record_error(self, cause: str, count: int = 1) -> None:
        """``count`` requests failed at stage ``cause`` (``"dispatch"``:
        the search callable raised; ``"device"``: the device-side
        completion raised).  Failed requests never reach
        :meth:`record_batch`, so without this the availability SLO would
        read a dead index as 100% available.  Mirrored per cause as
        ``raft_tpu_serve_errors_total{index=,cause=}``."""
        with self._lock:
            self.errors[cause] = self.errors.get(cause, 0) + int(count)
        if self.name is not None:
            default_registry().counter(
                "raft_tpu_serve_errors_total",
                help="failed served requests by failure cause",
            ).inc(count, index=self.name, cause=cause)

    def record_queue_depth(self, depth: int) -> None:
        """Rows still queued at dispatch time — the health/backpressure
        signal.  Mirrored as a gauge for named instances."""
        with self._lock:
            self._queue_depth = int(depth)
        if self.name is not None:
            default_registry().gauge(
                "raft_tpu_serve_queue_depth",
                help="rows waiting for dispatch at the last batch boundary",
            ).set(depth, index=self.name)

    def record_pipeline(self, depth: int, inflight: int) -> None:
        """Pipeline window state: ``depth`` is the configured bound,
        ``inflight`` the batches currently dispatched but not completed.
        The peak is retained so a concurrency test (or an operator) can
        assert the in-flight window was never overrun.  Mirrored as
        ``raft_tpu_serve_pipeline_depth`` / ``raft_tpu_serve_inflight_batches``
        gauges for named instances."""
        with self._lock:
            self._pipeline_depth = int(depth)
            self._inflight = int(inflight)
            self._inflight_peak = max(self._inflight_peak, int(inflight))
        if self.name is not None:
            reg = default_registry()
            reg.gauge(
                "raft_tpu_serve_pipeline_depth",
                help="configured in-flight window bound (1 = serial dispatch)",
            ).set(depth, index=self.name)
            reg.gauge(
                "raft_tpu_serve_inflight_batches",
                help="device batches dispatched but not yet completed",
            ).set(inflight, index=self.name)

    def record_warmup(self, compiles: int) -> None:
        with self._lock:
            self.warmup_compiles += compiles

    def reset_hot_path(self) -> None:
        """Zero the hot-path build attribution (called after warmup)."""
        with self._lock:
            self.recompiles = 0

    # -- reading ------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """One dict with the headline serving numbers (JSON-safe)."""
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
            ts = np.asarray(self._done_ts, dtype=np.float64)
            stage_arrs = {
                s: np.asarray(dq, dtype=np.float64)
                for s, dq in self._stage_lat.items()
            }
            out: Dict[str, object] = {
                "requests": self.requests,
                "batches": self.batches,
                "errors": dict(self.errors),
                "recompiles": self.recompiles,
                "warmup_compiles": self.warmup_compiles,
                "queue_depth": self._queue_depth,
                "pipeline_depth": self._pipeline_depth,
                "inflight": self._inflight,
                "inflight_peak": self._inflight_peak,
                "batch_fill": (
                    self._fill_real / self._fill_padded
                    if self._fill_padded
                    else None
                ),
                "pad_waste_rows": self._pad_waste,
                # per-capacity-bucket fill (str keys: JSON-safe)
                "bucket_fill": {
                    str(b): (f[0] / f[1] if f[1] else None)
                    for b, f in sorted(self._bucket_fill.items())
                },
                # dispatched batches per routed kernel leg (live A/B)
                "kernel_paths": dict(self._kernel_paths),
            }
        if lat.size:
            out["p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            out["p99_ms"] = float(np.percentile(lat, 99) * 1e3)
            span = float(ts.max() - ts.min())
            # a single instant (or one request) has no measurable rate
            out["qps"] = float(lat.size / span) if span > 0 else None
        else:
            out["p50_ms"] = out["p99_ms"] = out["qps"] = None
        out["stages"] = {
            s: {
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
            }
            for s, a in stage_arrs.items()
            if a.size
        }
        return out

    def stage_totals(self) -> Dict[str, float]:
        """Sum of each stage reservoir in seconds.

        Input to the bench's device-idle-fraction estimate: the ``device``
        total approximates how long the device had work outstanding.
        Approximate once a reservoir wraps (bounded at construction), so
        benches must keep their batch count under the reservoir size for
        the number to be exact."""
        with self._lock:
            return {
                s: float(sum(dq)) for s, dq in self._stage_lat.items() if dq
            }


def timed_percentiles(latencies_s, qs=(50, 99)) -> Optional[Dict[str, float]]:
    """Helper for benches: {'p50_ms': ..., 'p99_ms': ...} or None if empty."""
    arr = np.asarray(list(latencies_s), dtype=np.float64)
    if not arr.size:
        return None
    return {f"p{q}_ms": float(np.percentile(arr, q) * 1e3) for q in qs}
