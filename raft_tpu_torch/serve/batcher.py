"""Dynamic micro-batcher (counterpart of ``raft_tpu.serve.batcher``):
coalesce single-query requests into padded, power-of-two-bucketed batches.

Batches are always padded to a bucket of the ladder ``min_bucket,
2*min_bucket, ..., max_batch``, and :meth:`MicroBatcher.warmup` runs a
dummy batch through every bucket (and every effort level) before traffic
arrives, so the first real request finds the kernel library built and
loaded.  :class:`~raft_tpu_torch.serve.metrics.ServingMetrics` checks that
with a bracket of :func:`~raft_tpu_torch.serve.metrics.compile_count`
around every dispatch: a kernel build or library load on the dispatch
thread after warmup is counted as a hot-path recompile.

Coalescing: the worker takes what is queued when it wakes; below
``max_batch`` rows it waits up to ``max_delay_ms`` (from the oldest queued
request) for stragglers, then dispatches.  A request's latency is
submit→complete, queue wait included.

On the card each batcher owns a CUDA stream.  A dispatch fills the next
slot of the bucket's ring of pinned host staging buffers, makes its stream
wait for the default stream (where mutations upload their snapshots and
rebuilds build their indexes), copies the queries up with ``non_blocking``
copies, runs the search fn on its stream (the kernels launch on the
current stream), copies the results down into the slot's pinned output
buffers and records one CUDA event.  Whoever reads the results first
waits on that event: the dispatching thread at ``pipeline_depth=1``, the
completion thread at depth > 1.  The searches record which index version
and snapshot they read (``mutation.consume_pins``), and the in-flight
batch holds them until its event completes.

Pipelined dispatch (``pipeline_depth`` > 1): the worker enqueues batch N+1
while the completion thread waits on batch N's event; a semaphore bounds
the batches in flight, and completion is FIFO, so a ring slot (one of
``pipeline_depth`` per bucket) comes round again only after its previous
batch has been copied out.  ``pipeline_depth=1`` is the serial path: pad,
enqueue, wait, resolve, all on the dispatching thread.  Both paths give
the same bytes: the padding rows are zeros on both.

On the CPU (an index built on the CPU) the search runs synchronously and
there is nothing to wait on; the same code paths run.

Every request gets a process-wide id (``fut.request_id``, from
:func:`raft_tpu_torch.obs.flight.next_request_id`); every completed or
failed batch goes to the flight recorder.  Ragged mode (``ragged=`` a
:class:`~raft_tpu_torch.serve.ragged.RaggedSpec`): per-request ``k`` and
filter id ride as descriptor columns (``row_k`` on the device, ``row_fid``
as a host array) and every dispatch computes ``k_max`` columns.
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import threading
import time
from collections import deque
from contextlib import nullcontext
from concurrent.futures import Future, TimeoutError as _FutureTimeout
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import kernels as _kernels
from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.core.trace import trace_range
from raft_tpu_torch.obs import events as obs_events
from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.obs import flight, slowlog, spans
from raft_tpu_torch.obs import perf as obs_perf
from raft_tpu_torch.serve import mutation as _mutation
from raft_tpu_torch.serve.metrics import ServingMetrics, compile_count
from raft_tpu_torch.serve.mutation import _next_pow2
from raft_tpu_torch.serve.overload import expire_deadlines, validate_priority

# search_fn: (queries [b, dim] f32 tensor on the batcher's device) ->
# (distances [b, k], ids [b, k]) tensors.  Ragged mode adds two descriptor
# columns: (queries, row_k [b] int32 tensor, row_fid [b] int32 host array),
# and always returns k_max columns.
SearchFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]

# observer: (queries [n, dim], distances [n, k], ids [n, k]) numpy arrays of
# the real (unpadded) rows after each batch resolves; must not block.
Observer = Callable[[np.ndarray, np.ndarray, np.ndarray], None]


class _Request:
    __slots__ = ("rows", "future", "t_submit", "req_id", "k", "fid",
                 "priority", "deadline")

    def __init__(self, rows: np.ndarray, future: Future, t_submit: float,
                 req_id: int, k: int = 0, fid: int = 0,
                 priority: int = 1, deadline: Optional[float] = None):
        self.rows = rows
        self.future = future
        self.t_submit = t_submit
        self.req_id = req_id
        self.k = k        # ragged mode: this request's top-k (<= k_max)
        self.fid = fid    # ragged mode: registered filter id (0 = all-pass)
        self.priority = priority    # 0 interactive … 3 background
        self.deadline = deadline    # absolute perf_counter s, or None


class _Slot:
    """One ring slot of a bucket: pinned host staging for the queries and
    for the results (the result buffers are made at the first batch, when
    their shapes are known)."""

    __slots__ = ("queries", "dist", "ids")

    def __init__(self, bucket: int, dim: int, pinned: bool):
        self.queries = torch.zeros((bucket, dim), dtype=torch.float32, pin_memory=pinned)
        self.dist: Optional[torch.Tensor] = None
        self.ids: Optional[torch.Tensor] = None


class _Pending:
    """One enqueued batch's results: pinned host copies and the event
    recorded after them (None on the CPU, where the search has finished),
    plus the index versions and snapshots its kernels read."""

    __slots__ = ("dist", "ids", "event", "pins")

    def __init__(self, dist, ids, event, pins):
        self.dist, self.ids, self.event, self.pins = dist, ids, event, pins

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        # copies: the pinned slot is reused by a later batch of the bucket
        return self.dist.numpy().copy(), self.ids.numpy().copy()


class _InFlight:
    """One dispatched-but-not-completed batch, handed from the dispatch
    thread to the completion thread in submission order."""

    __slots__ = (
        "batch", "padded", "n", "bucket", "queue_waits", "t_pad",
        "inflight_wait", "t_dispatch", "t_enqueued", "pending",
        "compiles", "sp", "done", "seq", "t_pickup",
        "kernel_path", "admit_level", "page", "dispatch_info",
    )

    def __init__(self, batch: List[_Request]):
        self.batch = batch
        self.done = threading.Event()
        self.kernel_path = "unknown"
        self.admit_level = 0
        self.page = None           # explain: page-cache stats stamp
        self.dispatch_info = None  # explain: ragged dispatch params stamp


class MicroBatcher:
    """Coalesces query requests into pow2-padded batches for a search fn.

    Parameters as raft_tpu's (``search_fn`` resolved per dispatch, ``dim``,
    ``min_bucket`` / ``max_batch`` rounded up to powers of two,
    ``max_delay_ms``, ``metrics``, ``start``, ``observer``,
    ``cost_accounting`` (env ``RAFT_TPU_COST_ACCOUNTING``: warmup notes each
    bucket's kernel work through ``obs.cost.analyze_callable``),
    ``pipeline_depth`` (env ``RAFT_TPU_PIPELINE_DEPTH``, default 2),
    ``ragged``, ``admission`` / ``degraded`` / ``effort`` (the overload and
    effort actuators) and ``perf_meta``), plus ``device``: where the
    queries go (the card unless the caller asks for the CPU; the service
    passes its index's device).  ``hedger`` needs replicas and raises
    (ROADMAP Queue 1 item 7b).
    """

    def __init__(
        self,
        search_fn: SearchFn,
        dim: int,
        *,
        min_bucket: int = 1,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        metrics: Optional[ServingMetrics] = None,
        start: bool = True,
        observer: Optional[Observer] = None,
        cost_accounting: Optional[bool] = None,
        pipeline_depth: Optional[int] = None,
        ragged=None,
        admission=None,
        degraded=None,
        effort=None,
        hedger=None,
        perf_meta: Optional[Callable[[], Tuple[str, str]]] = None,
        device=None,
    ):
        if hedger is not None:
            raise NotImplementedError(
                "hedged dispatch races replica members; replicas are "
                "multi-GPU serving (ROADMAP Queue 1 item 7b)")
        if dim <= 0:
            raise ValueError(f"dim must be positive, got {dim}")
        if min_bucket <= 0 or max_batch <= 0:
            raise ValueError("min_bucket and max_batch must be positive")
        min_bucket = _next_pow2(min_bucket)
        max_batch = _next_pow2(max_batch)
        if min_bucket > max_batch:
            raise ValueError(
                f"min_bucket={min_bucket} exceeds max_batch={max_batch}"
            )
        self.device = Resources(device=device if device is not None else "cuda").device
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._search_fn = search_fn
        self.dim = int(dim)
        self.min_bucket = min_bucket
        self.max_batch = max_batch
        self.max_delay_s = float(max_delay_ms) * 1e-3
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.observer = observer
        if cost_accounting is None:
            cost_accounting = _env.env_bool("RAFT_TPU_COST_ACCOUNTING", True)
        self.cost_accounting = bool(cost_accounting)
        if pipeline_depth is None:
            pipeline_depth = _env.env_int("RAFT_TPU_PIPELINE_DEPTH", 2)
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        self.ragged = ragged
        if ragged is not None and ragged.k_max < 1:
            raise ValueError(f"ragged k_max must be >= 1, got {ragged.k_max}")
        self.admission = admission
        self.degraded = degraded
        # the effort arbiter's ladder supersedes degraded's for warmup: the
        # search fn consults the arbiter for its effective params
        self.effort = effort
        if admission is not None and admission.metrics is None:
            admission.metrics = self.metrics
        # the perf ledger is sampled once: the hot path holds a reference
        # or None, never an env read
        self._perf = obs_perf.default_ledger() if obs_perf.enabled() else None
        self._perf_meta = perf_meta if perf_meta is not None else (lambda: ("unknown", "0"))
        # attribution when the search fn stamped no routing choice
        self._kpath_default = "cuda" if self._cuda else "torch"
        self._last_kernel_path = self._kpath_default
        # explain stamps consumed per dispatch (written / read under
        # _dispatch_lock) + the last admission verdict level
        self._last_page_stats = None
        self._last_dispatch_info = None
        self._last_admit_level = 0

        self._cond = threading.Condition()
        self._queue: Deque[_Request] = deque()
        self._stopping = False
        # one dispatch stage at a time (worker thread and flush()); at
        # depth 1 it also covers the device wait
        self._dispatch_lock = threading.Lock()
        self._warm = False
        self._thread: Optional[threading.Thread] = None
        # pipelined dispatch state (idle at depth 1)
        self._inflight_sem = threading.Semaphore(self.pipeline_depth)
        self._inflight_q: "queue_mod.Queue[Optional[_InFlight]]" = queue_mod.Queue()
        self._completion_thread: Optional[threading.Thread] = None
        self._inflight_lock = threading.Lock()
        self._inflight = 0
        # per-bucket ring of pipeline_depth staging slots
        self._staging: Dict[int, List[Optional[_Slot]]] = {}
        self._staging_idx: Dict[int, int] = {}
        # union of [enqueue, ready] intervals: the device-busy estimate
        self._busy_s = 0.0
        self._busy_until = 0.0
        self._batch_seq = itertools.count(1)
        self.metrics.record_pipeline(self.pipeline_depth, 0)
        if start:
            self.start()

    # -- bucket ladder -------------------------------------------------------
    def buckets(self) -> List[int]:
        """The full bucket ladder, ascending."""
        out, b = [], self.min_bucket
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return out

    def bucket_for(self, n_rows: int) -> int:
        """Smallest bucket holding ``n_rows`` (clamped into the ladder)."""
        return min(self.max_batch, max(self.min_bucket, _next_pow2(n_rows)))

    # -- lifecycle -----------------------------------------------------------
    def warmup(self) -> int:
        """Run a zero batch through every bucket (at every effort level);
        returns the kernel builds / library loads it caused on this thread,
        booked as ``warmup_compiles``.  The hot-path counter is reset, so a
        later non-zero ``recompiles`` is a build on the serving path."""
        total = 0
        actuator = self.effort if self.effort is not None else self.degraded
        levels = (None,) if actuator is None else actuator.levels()
        with self._dispatch_lock, trace_range("serve.warmup"):
            for level in levels:
                pin = nullcontext() if level is None else actuator.pinned(level)
                with pin:
                    for b in self.buckets():
                        c0 = compile_count(thread=True)
                        slot = self._staging_slot(b)
                        slot.queries.zero_()
                        pending = self._enqueue(slot, [])
                        pending.wait()
                        total += compile_count(thread=True) - c0
                        if self.cost_accounting and not level:
                            self._account_bucket_cost(b)
        self.metrics.record_warmup(total)
        self.metrics.reset_hot_path()
        self._warm = True
        return total

    def _invoke_args(self, queries: torch.Tensor, batch: List[_Request]):
        """The search fn's arguments for one padded bucket on the device.
        Ragged mode adds the descriptor columns: each request's rows carry
        its (k, fid); padding rows run at ``k_max`` / filter 0."""
        if self.ragged is None:
            return (queries,)
        bucket = queries.shape[0]
        row_k = np.full((bucket,), self.ragged.k_max, np.int32)
        row_fid = np.zeros((bucket,), np.int32)
        off = 0
        for req in batch:
            m = req.rows.shape[0]
            row_k[off: off + m] = req.k
            row_fid[off: off + m] = req.fid
            off += m
        return queries, torch.from_numpy(row_k).to(self.device), row_fid

    def _invoke(self, queries: torch.Tensor, batch: List[_Request]):
        """Hand one padded bucket to the search fn; records the
        ``kernel_path`` it stamped and the explain stamps (every call site
        holds ``_dispatch_lock``)."""
        args = self._invoke_args(queries, batch)
        _kernels.consume_kernel_path()  # drop any stale stamp first
        obs_explain.consume_page_stats()
        obs_explain.consume_dispatch()
        out = self._search_fn(*args)
        self._last_kernel_path = _kernels.consume_kernel_path(self._kpath_default)
        self._last_page_stats = obs_explain.consume_page_stats()
        self._last_dispatch_info = obs_explain.consume_dispatch()
        return out

    def _enqueue(self, slot: _Slot, batch: List[_Request]) -> _Pending:
        """Queries of ``slot`` up, the search, the results down: all
        enqueued on the batcher's stream, with one event after them.  Never
        waits for the card (unless the search fn itself reads a value
        back)."""
        if not self._cuda:
            dist, ids = self._invoke(slot.queries, batch)
            return _Pending(dist.cpu(), ids.cpu(), None, None)  # raft-tpu: ignore[HOSTSYNC] the CPU leg: results already on the host, nothing to wait for
        stream = self._stream
        # order this batch after everything queued on the default stream:
        # snapshot uploads of mutations, indexes built by rebuilds
        stream.wait_stream(torch.cuda.default_stream(self.device))
        with torch.cuda.stream(stream):
            _mutation.consume_pins()
            queries = slot.queries.to(self.device, non_blocking=True)
            dist, ids = self._invoke(queries, batch)
            if slot.dist is None or slot.dist.shape != dist.shape or slot.dist.dtype != dist.dtype:
                slot.dist = torch.empty(dist.shape, dtype=dist.dtype, pin_memory=True)
            if slot.ids is None or slot.ids.shape != ids.shape or slot.ids.dtype != ids.dtype:
                slot.ids = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
            slot.dist.copy_(dist, non_blocking=True)
            slot.ids.copy_(ids, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
            pins = _mutation.consume_pins()
        # the device tensors of this batch were made on the batcher's
        # stream: their memory goes back to that stream's pool, behind the
        # copies above in stream order
        return _Pending(slot.dist, slot.ids, event, pins)

    def _staging_slot(self, bucket: int) -> _Slot:
        """Next slot of the bucket's staging ring (dispatch lock held).
        Safe to reuse: at most ``pipeline_depth`` batches are in flight and
        completion is FIFO, so a slot's previous batch has been copied out
        before the slot comes round again."""
        ring = self._staging.get(bucket)
        if ring is None:
            ring = self._staging[bucket] = [None] * self.pipeline_depth
            self._staging_idx[bucket] = 0
        i = self._staging_idx[bucket]
        self._staging_idx[bucket] = (i + 1) % self.pipeline_depth
        if ring[i] is None:
            ring[i] = _Slot(bucket, self.dim, self._cuda)
        return ring[i]

    def _fill(self, slot: _Slot, batch: List[_Request], bucket: int) -> int:
        """Pad the batch into the slot's staging buffer (zeros past the
        real rows); returns the real row count."""
        host = slot.queries.numpy()  # raft-tpu: ignore[HOSTSYNC] a pinned host staging buffer: a view, no device copy
        off = 0
        for req in batch:
            m = req.rows.shape[0]
            host[off: off + m] = req.rows
            off += m
        if off < bucket:
            host[off:] = 0.0
        return off

    def _account_bucket_cost(self, bucket: int) -> None:
        """Best-effort work / time / roofline gauges of one bucket's
        dispatch (``obs.cost``), and its noted work for the perf ledger."""
        try:
            from raft_tpu_torch.obs import cost as obs_cost

            queries = torch.zeros((bucket, self.dim), dtype=torch.float32, device=self.device)
            report = obs_cost.analyze_callable(self._search_fn, *self._invoke_args(queries, []))
            obs_cost.record_cost(report, index=self.metrics.name or "default",
                                 bucket=str(bucket))
            if (self._perf is not None and report is not None
                    and report.flops is not None and report.bytes_accessed is not None):
                self._perf.register_cost(self.metrics.name or "default", int(bucket),
                                         report.flops, report.bytes_accessed)
        except Exception:  # noqa: BLE001 — accounting must not fail warmup
            pass

    @property
    def warm(self) -> bool:
        """True once :meth:`warmup` has run the bucket ladder."""
        return self._warm

    def queue_depth(self) -> int:
        """Rows currently waiting for dispatch (health signal)."""
        with self._cond:
            return sum(r.rows.shape[0] for r in self._queue)

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._cond:
            self._stopping = False
        self._thread = threading.Thread(
            target=self._worker, name="raft-tpu-serve-batcher", daemon=True
        )
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the worker thread; with ``drain`` pending requests complete
        first, otherwise they fail with :class:`RuntimeError`.  Batches
        already in flight complete and resolve either way."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            self.flush()
        else:
            with self._cond:
                pending, self._queue = self._queue, deque()
            for req in pending:
                req.future.set_exception(RuntimeError("MicroBatcher stopped before dispatch"))
        self._shutdown_completion()
        self.metrics.close()

    def _shutdown_completion(self) -> None:
        t = self._completion_thread
        if t is not None and t.is_alive():
            self._inflight_q.put(None)
            t.join()
        self._completion_thread = None

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission ----------------------------------------------------------
    def submit(self, queries, *, k: Optional[int] = None,
               fid: Optional[int] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one request of shape ``[dim]`` or ``[m, dim]``; the
        future resolves to ``(distances [m, k], ids [m, k])`` numpy arrays
        (1-D input: the leading axis squeezed away) and carries
        ``fut.request_id``.  Ragged mode: ``k`` (default and ceiling
        ``k_max``) and ``fid`` (default 0).  Any mode: ``priority`` (0..3,
        default 1) and ``deadline_s`` (a server-side budget from now)."""
        if self.ragged is None:
            if k is not None or fid is not None:
                raise ValueError(
                    "per-request k/fid need ragged mode — construct the "
                    "batcher (or SearchService) with ragged="
                )
            k, fid = 0, 0
        else:
            k = self.ragged.k_max if k is None else int(k)
            if not 1 <= k <= self.ragged.k_max:
                raise ValueError(f"k={k} outside [1, k_max={self.ragged.k_max}]")
            fid = 0 if fid is None else int(fid)
            if fid < 0:
                raise ValueError(f"fid must be >= 0, got {fid}")
        if isinstance(queries, torch.Tensor):
            queries = queries.to(torch.float32).cpu().numpy()
        rows = np.asarray(queries, dtype=np.float32)
        squeeze = rows.ndim == 1
        if squeeze:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"expected queries of dim {self.dim}, got shape {rows.shape}")
        if rows.shape[0] > self.max_batch:
            raise ValueError(
                f"request of {rows.shape[0]} rows exceeds max_batch="
                f"{self.max_batch}; split it client-side"
            )
        priority = validate_priority(priority)
        if deadline_s is not None and float(deadline_s) <= 0.0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        t_submit = time.perf_counter()
        deadline = None if deadline_s is None else t_submit + float(deadline_s)
        req_id = flight.next_request_id()
        fut: Future = Future()
        fut.request_id = req_id
        if squeeze:
            inner = fut
            fut = Future()
            fut.request_id = req_id
            inner.add_done_callback(lambda f, out=fut: _squeeze_result(f, out))
            req = _Request(rows, inner, t_submit, req_id, k, fid, priority, deadline)
        else:
            req = _Request(rows, fut, t_submit, req_id, k, fid, priority, deadline)
        with self._cond:
            self._queue.append(req)
            self._cond.notify()
        return fut

    def search(self, queries, timeout: Optional[float] = None, *,
               k: Optional[int] = None, fid: Optional[int] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None):
        """Synchronous :meth:`submit`; ``timeout`` doubles as the
        server-side deadline when ``deadline_s`` is not given."""
        if deadline_s is None and timeout is not None:
            deadline_s = timeout
        fut = self.submit(queries, k=k, fid=fid, priority=priority, deadline_s=deadline_s)
        if self._thread is None or not self._thread.is_alive():
            self.flush()
        try:
            return fut.result(timeout=timeout)
        except _FutureTimeout:
            raise TimeoutError(
                f"no result within {timeout}s (request still queued or "
                "in flight; its deadline will expire it at the next cut)"
            ) from None

    # -- batching core -------------------------------------------------------
    def flush(self) -> int:
        """Dispatch everything queued right now through the path traffic
        takes; returns the batches issued, after they have resolved."""
        n_batches = 0
        last: Optional[_InFlight] = None
        while True:
            with self._cond:
                if not self._queue:
                    break
                batch = self._take_batch_locked()
            batch = self._admit(batch)
            if not batch:
                continue
            if self.pipeline_depth == 1:
                self._dispatch(batch)
            else:
                rec = self._dispatch_pipelined(batch)
                if rec is not None:
                    last = rec
            n_batches += 1
        if last is not None:
            # FIFO completion: the last record done implies every earlier one
            last.done.wait()
        return n_batches

    def _take_batch_locked(self) -> List[_Request]:
        """Pop a prefix of the queue totalling at most max_batch rows."""
        taken, rows = [], 0
        while self._queue:
            nxt = self._queue[0]
            if taken and rows + nxt.rows.shape[0] > self.max_batch:
                break
            taken.append(self._queue.popleft())
            rows += nxt.rows.shape[0]
        return taken

    def _coalesce_locked(self) -> List[_Request]:
        """Wait (condition held) for stragglers up to the oldest queued
        request's deadline, then pop a batch; [] if the queue emptied."""
        if not self._queue:
            return []
        deadline = self._queue[0].t_submit + self.max_delay_s
        while sum(r.rows.shape[0] for r in self._queue) < self.max_batch and not self._stopping:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            self._cond.wait(timeout=remaining)
            if not self._queue:
                return []
        if not self._queue:
            return []
        return self._take_batch_locked()

    def _admit(self, batch: List[_Request]) -> List[_Request]:
        """Batch-cut admission: expire deadlines and, with a controller,
        shed under pressure (outside the queue condition).  Returns the
        requests that may dispatch."""
        if not batch:
            return batch
        ctrl = self.admission
        index = self.metrics.name or "default"
        if ctrl is None:
            alive = expire_deadlines(batch, index=index, metrics=self.metrics)
            self._last_admit_level = 0
            if len(alive) != len(batch) and obs_explain.enabled():
                alive_ids = {id(r) for r in alive}
                obs_explain.observe_admission(
                    index, expired=[r for r in batch if id(r) not in alive_ids])
            return alive
        decision = ctrl.decide(batch, queue_rows=self.queue_depth(), max_batch=self.max_batch)
        self._last_admit_level = decision.level
        if self.degraded is not None:
            self.degraded.step(decision.level > 0)
        if (decision.shed or decision.expired) and obs_explain.enabled():
            obs_explain.observe_admission(index, shed=decision.shed,
                                          expired=decision.expired, level=decision.level)
        return list(decision.admitted)

    def _worker(self) -> None:
        # continuous admission (ragged + pipeline): claim the in-flight slot
        # BEFORE cutting the batch, so the batch keeps filling while the
        # device window is full
        continuous = self.ragged is not None and self.pipeline_depth > 1
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if self._stopping:
                    return
                if not continuous:
                    batch = self._coalesce_locked()
                    if not batch:
                        continue
            if continuous:
                self._inflight_sem.acquire()
                with self._cond:
                    batch = self._coalesce_locked()
                batch = self._admit(batch)
                if not batch:
                    self._inflight_sem.release()
                    continue
                self._dispatch_pipelined(batch, sem_held=True)
            else:
                batch = self._admit(batch)
                if not batch:
                    continue
                if self.pipeline_depth > 1:
                    self._dispatch_pipelined(batch)
                else:
                    self._dispatch(batch)

    def _record_flight(
        self,
        *,
        seq: int,
        batch: List[_Request],
        n: int,
        bucket: int,
        compiles: int,
        t_pickup: float,
        t_done: float,
        stages_s: Dict[str, float],
        waits_s: Dict[str, float],
        error: Optional[str] = None,
        kernel_path: str = "unknown",
        admit_level: int = 0,
        page: Optional[Dict[str, object]] = None,
        dispatch_info: Optional[Dict[str, object]] = None,
    ) -> None:
        """Feed one completed (or failed) batch to the flight recorder (and
        the query archive when explain is on).  Reconstructs from stamps
        the dispatch paths already take; measures nothing."""
        if not spans.enabled():
            return
        stages_ms = {k: v * 1e3 for k, v in {**waits_s, **stages_s}.items()}
        explain_on = obs_explain.enabled()
        record = {
            "seq": seq,
            "index": self.metrics.name,
            "bucket": bucket,
            "rows": n,
            "compiles": compiles,
            "request_ids": [req.req_id for req in batch],
            "t_pickup": t_pickup,
            "t_done": t_done,
            "stages_s": stages_s,
            "waits_s": waits_s,
            "kernel_path": kernel_path,
            "hedged": False,
            "requests": [
                {
                    "id": req.req_id,
                    "rows": req.rows.shape[0],
                    "submit": req.t_submit,
                    "batched": t_pickup,
                    "resolve": t_done,
                    "queue_ms": (t_pickup - req.t_submit) * 1e3,
                    "latency_ms": (t_done - req.t_submit) * 1e3,
                    "stages_ms": stages_ms,
                    **({"k": req.k, "fid": req.fid} if self.ragged is not None else {}),
                    **({"priority": req.priority} if explain_on else {}),
                }
                for req in batch
            ],
            "error": error,
        }
        if explain_on:
            record["admission_level"] = admit_level
            record["page"] = page
            record["dispatch"] = dispatch_info
            record["effort"] = self.effort.snapshot() if self.effort is not None else None
        flight.record_batch(record)
        if explain_on:
            obs_explain.observe_batch(record)

    def _fail(self, batch: List[_Request], exc: Exception, cause: str, bucket: int) -> None:
        self.metrics.record_error(cause, len(batch))
        obs_events.publish(
            "batch_error", "batch_exception",
            index=self.metrics.name, bucket=bucket, cause=cause,
            requests=len(batch), error=repr(exc),
        )
        for req in batch:
            req.future.set_exception(exc)

    def _resolve(self, batch: List[_Request], dist: np.ndarray, ids: np.ndarray) -> List[float]:
        done = time.perf_counter()
        off = 0
        lats = []
        for req in batch:
            m = req.rows.shape[0]
            d, i = dist[off: off + m], ids[off: off + m]
            if self.ragged is not None and req.k < d.shape[1]:
                # the dispatch computed k_max columns for everyone
                d, i = d[:, : req.k], i[:, : req.k]
            req.future.set_result((d, i))
            off += m
            lats.append(done - req.t_submit)
        return lats

    def _observe(self, queries: np.ndarray, dist: np.ndarray, ids: np.ndarray) -> None:
        observer = self.observer
        if observer is not None:
            # futures are resolved; the observer sees the real rows only
            try:
                observer(queries, dist, ids)
            except Exception:  # noqa: BLE001 — auditing never fails serving
                pass

    def _dispatch(self, batch: List[_Request]) -> None:
        with self._dispatch_lock:
            self._dispatch_locked(batch)

    def _dispatch_locked(self, batch: List[_Request]) -> None:
        """The serial path (depth 1): pad, enqueue, wait, resolve."""
        if not batch:
            return
        seq = next(self._batch_seq)
        t_start = time.perf_counter()
        queue_waits = [t_start - r.t_submit for r in batch]
        n = sum(r.rows.shape[0] for r in batch)
        bucket = self.bucket_for(n)
        slot = self._staging_slot(bucket)
        self._fill(slot, batch, bucket)
        t_pad = time.perf_counter() - t_start
        err_stage = "dispatch"
        c0 = compile_count(thread=True)
        try:
            with trace_range("serve.batch") as sp:
                t0 = time.perf_counter()
                pending = self._enqueue(slot, batch)
                t1 = time.perf_counter()
                err_stage = "device"
                # the serial path's one intended wait
                dist, ids = pending.wait()
                t2 = time.perf_counter()
                if sp is not None:
                    sp.add_stage("queue", max(queue_waits, default=0.0))
                    sp.add_stage("pad", t_pad)
                    sp.add_stage("dispatch", t1 - t0)
                    sp.add_stage("device", t2 - t1)
            compiles = compile_count(thread=True) - c0
        except Exception as exc:  # noqa: BLE001 — fail the waiting futures
            self._record_flight(
                seq=seq, batch=batch, n=n, bucket=bucket,
                compiles=compile_count(thread=True) - c0,
                t_pickup=t_start, t_done=time.perf_counter(),
                stages_s={"pad": t_pad},
                waits_s={"queue": max(queue_waits, default=0.0)},
                error=repr(exc), admit_level=self._last_admit_level,
            )
            self._fail(batch, exc, err_stage, bucket)
            return
        lats = self._resolve(batch, dist, ids)
        done = time.perf_counter()
        self._observe(slot.queries.numpy()[:n].copy(), dist[:n], ids[:n])  # raft-tpu: ignore[HOSTSYNC] host staging buffer, after the copy-out
        self.metrics.record_queue_depth(self.queue_depth())
        self.metrics.record_batch(
            n, bucket, lats, compiles,
            stages={"queue": queue_waits, "pad": (t_pad,), "dispatch": (t1 - t0,),
                    "device": (t2 - t1,)},
            request_ids=[r.req_id for r in batch],
            kernel_path=self._last_kernel_path,
        )
        if self._perf is not None:
            backend, ver = self._perf_meta()
            self._perf.record(
                index=self.metrics.name or "default", backend=backend,
                bucket=bucket, kernel_path=self._last_kernel_path,
                version=ver, device_s=t2 - t1, rows=n, padded_rows=bucket,
            )
        self._record_flight(
            seq=seq, batch=batch, n=n, bucket=bucket, compiles=compiles,
            t_pickup=t_start, t_done=done,
            stages_s={"pad": t_pad, "dispatch": t1 - t0, "device": t2 - t1,
                      "copy_out": done - t2},
            waits_s={"queue": max(queue_waits, default=0.0)},
            kernel_path=self._last_kernel_path,
            admit_level=self._last_admit_level,
            page=self._last_page_stats,
            dispatch_info=self._last_dispatch_info,
        )
        self._after_batch(sp, batch, bucket, compiles, lats, self._last_kernel_path,
                          self._last_page_stats)

    def _after_batch(self, sp, batch, bucket, compiles, lats, kernel_path, page) -> None:
        if compiles and self._warm:
            # a build on the warmed hot path: capture the traffic around it
            obs_events.publish("hot_recompile", index=self.metrics.name,
                               bucket=bucket, compiles=compiles)
        if sp is not None:
            slowlog.maybe_record(
                sp,
                latency_s=max(lats, default=0.0),
                detail={
                    "index": self.metrics.name,
                    "requests": len(batch),
                    "bucket": bucket,
                    "compiles": compiles,
                    "request_ids": [r.req_id for r in batch],
                    **obs_explain.summary_line({
                        "kernel_path": kernel_path,
                        "effort": self.effort.snapshot() if self.effort is not None else None,
                        "page": page,
                    }),
                },
            )

    # -- pipelined dispatch (pipeline_depth > 1) -----------------------------
    @property
    def inflight(self) -> int:
        """Device batches dispatched but not yet completed."""
        with self._inflight_lock:
            return self._inflight

    def device_busy_s(self) -> float:
        """Seconds the device had at least one batch outstanding: the union
        of the [enqueue, ready] intervals (pipelined), or the sum of the
        device stages (serial, where nothing overlaps)."""
        if self.pipeline_depth > 1:
            with self._inflight_lock:
                return self._busy_s
        return self.metrics.stage_totals().get("device", 0.0)

    def _ensure_completion_thread(self) -> None:
        # only called under _dispatch_lock, so no start/start race
        t = self._completion_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._completer, name="raft-tpu-serve-completer",
                             daemon=True)
        self._completion_thread = t
        t.start()

    def _dispatch_pipelined(self, batch: List[_Request], *,
                            sem_held: bool = False) -> Optional[_InFlight]:
        """Pad into a staging slot, enqueue the work, hand the record to the
        completion thread.  Never waits for the card; waits only for the
        in-flight window (``inflight_wait``).  ``sem_held``: the
        continuous-admission worker claimed the slot already."""
        if not batch:
            if sem_held:
                self._inflight_sem.release()
            return None
        t_arrive = time.perf_counter()
        if not sem_held:
            # the window slot before the dispatch lock: a full window stalls
            # this dispatcher without blocking the completion thread
            self._inflight_sem.acquire()
        t_acquired = time.perf_counter()
        with self._dispatch_lock:
            rec = _InFlight(batch)
            rec.seq = next(self._batch_seq)
            rec.t_pickup = t_acquired
            rec.inflight_wait = t_acquired - t_arrive
            rec.queue_waits = [t_acquired - r.t_submit for r in batch]
            n = sum(r.rows.shape[0] for r in batch)
            bucket = self.bucket_for(n)
            t0 = time.perf_counter()
            slot = self._staging_slot(bucket)
            self._fill(slot, batch, bucket)
            rec.n, rec.bucket, rec.padded = n, bucket, slot.queries
            rec.t_pad = time.perf_counter() - t0
            # detached span: opened here, closed by the completion thread
            rec.sp = spans.open_span("serve.batch")
            c0 = compile_count(thread=True)
            try:
                t1 = time.perf_counter()
                rec.pending = self._enqueue(slot, batch)
                rec.t_dispatch = time.perf_counter() - t1
                rec.compiles = compile_count(thread=True) - c0
                rec.kernel_path = self._last_kernel_path
                rec.admit_level = self._last_admit_level
                rec.page = self._last_page_stats
                rec.dispatch_info = self._last_dispatch_info
            except Exception as exc:  # noqa: BLE001 — fail only this batch
                spans.finish_span(rec.sp)
                self._inflight_sem.release()
                self._record_flight(
                    seq=rec.seq, batch=batch, n=n, bucket=bucket,
                    compiles=compile_count(thread=True) - c0,
                    t_pickup=t_acquired, t_done=time.perf_counter(),
                    stages_s={"pad": rec.t_pad},
                    waits_s={"queue": max(rec.queue_waits, default=0.0),
                             "inflight_wait": rec.inflight_wait},
                    error=repr(exc),
                )
                self._fail(batch, exc, "dispatch", bucket)
                return None
            rec.t_enqueued = time.perf_counter()
            self._ensure_completion_thread()
            with self._inflight_lock:
                self._inflight += 1
                inflight = self._inflight
            self.metrics.record_pipeline(self.pipeline_depth, inflight)
            self._inflight_q.put(rec)
        return rec

    def _completer(self) -> None:
        """Wait on the oldest in-flight batch, copy out, resolve futures in
        submission order, run observer / metrics / slow log."""
        while True:
            rec = self._inflight_q.get()
            if rec is None:
                return
            try:
                self._complete(rec)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
                    inflight = self._inflight
                # release after _complete: the staging slot must not come
                # round again before copy-out and the observer are done
                self._inflight_sem.release()
                self.metrics.record_pipeline(self.pipeline_depth, inflight)
                rec.done.set()

    def _complete(self, rec: _InFlight) -> None:
        batch = rec.batch
        t3 = time.perf_counter()
        try:
            # the pipelined path's intended wait: this batch's event
            dist, ids = rec.pending.wait()
            t4 = time.perf_counter()
        except Exception as exc:  # noqa: BLE001 — fail only this batch
            spans.finish_span(rec.sp)
            self._record_flight(
                seq=rec.seq, batch=batch, n=rec.n, bucket=rec.bucket,
                compiles=rec.compiles, t_pickup=rec.t_pickup, t_done=time.perf_counter(),
                stages_s={"pad": rec.t_pad, "dispatch": rec.t_dispatch},
                waits_s={"queue": max(rec.queue_waits, default=0.0),
                         "inflight_wait": rec.inflight_wait},
                error=repr(exc), kernel_path=rec.kernel_path,
                admit_level=rec.admit_level, page=rec.page, dispatch_info=rec.dispatch_info,
            )
            self._fail(batch, exc, "device", rec.bucket)
            return
        rec.pending = None   # drops the pinned index versions
        t_device = t4 - t3
        # device-busy union: FIFO completion keeps intervals ordered by start
        with self._inflight_lock:
            if t4 > self._busy_until:
                self._busy_s += t4 - max(rec.t_enqueued, self._busy_until)
                self._busy_until = t4
        if rec.sp is not None:
            rec.sp.add_stage("queue", max(rec.queue_waits, default=0.0))
            rec.sp.add_stage("pad", rec.t_pad)
            rec.sp.add_stage("inflight_wait", rec.inflight_wait)
            rec.sp.add_stage("dispatch", rec.t_dispatch)
            rec.sp.add_stage("device", t_device)
        spans.finish_span(rec.sp)
        lats = self._resolve(batch, dist, ids)
        done = time.perf_counter()
        # the observer keeps samples past this batch: hand it a copy
        self._observe(rec.padded.numpy()[: rec.n].copy(), dist[: rec.n], ids[: rec.n])  # raft-tpu: ignore[HOSTSYNC] host staging buffer, after the batch's event
        self.metrics.record_queue_depth(self.queue_depth())
        self.metrics.record_batch(
            rec.n, rec.bucket, lats, rec.compiles,
            stages={"queue": rec.queue_waits, "pad": (rec.t_pad,),
                    "inflight_wait": (rec.inflight_wait,), "dispatch": (rec.t_dispatch,),
                    "device": (t_device,)},
            request_ids=[r.req_id for r in batch],
            kernel_path=rec.kernel_path,
        )
        if self._perf is not None:
            backend, ver = self._perf_meta()
            self._perf.record(
                index=self.metrics.name or "default", backend=backend,
                bucket=rec.bucket, kernel_path=rec.kernel_path,
                version=ver, device_s=t_device, rows=rec.n, padded_rows=rec.bucket,
            )
        self._record_flight(
            seq=rec.seq, batch=batch, n=rec.n, bucket=rec.bucket,
            compiles=rec.compiles, t_pickup=rec.t_pickup, t_done=done,
            stages_s={"pad": rec.t_pad, "dispatch": rec.t_dispatch,
                      "completer_wait": max(0.0, t3 - rec.t_enqueued),
                      "device": t_device, "copy_out": done - t4},
            waits_s={"queue": max(rec.queue_waits, default=0.0),
                     "inflight_wait": rec.inflight_wait},
            kernel_path=rec.kernel_path, admit_level=rec.admit_level,
            page=rec.page, dispatch_info=rec.dispatch_info,
        )
        self._after_batch(rec.sp, batch, rec.bucket, rec.compiles, lats, rec.kernel_path,
                          rec.page)


def _squeeze_result(inner: Future, outer: Future) -> None:
    exc = inner.exception()
    if exc is not None:
        outer.set_exception(exc)
        return
    dist, ids = inner.result()
    outer.set_result((dist[0], ids[0]))
