"""Online recall auditing (counterpart of ``raft_tpu.obs.quality``): is the
index still telling the truth?

Latency metrics catch a slow index; nothing else in the serve stack catches
a wrong one.  The auditor shadow-scores a sample of live traffic against an
exact oracle:

- :meth:`QualityAuditor.observe` is called by the batcher after each
  completed batch with the results already computed (host copies: the
  batcher's pinned staging slots are reused by later batches).  It flips a
  sampling coin and, on heads, enqueues the batch on a bounded queue with
  ``put_nowait``: the hot path never computes recall, never touches the
  card and never blocks; a full queue drops the sample and counts
  ``raft_tpu_quality_dropped_total``.
- A daemon worker pops samples, rebuilds the exact answer by a numpy scan
  over the index's live vectors (numpy on purpose, as in raft_tpu: the
  oracle never competes with the dispatch stream for the card and never
  enters the dispatch thread's kernel-build count), and scores the served
  ids with :func:`raft_tpu_torch.stats.metrics.recall_at_k` and
  :func:`~raft_tpu_torch.stats.metrics.rank_displacement`.
- Results land in the registry as ``raft_tpu_recall{index=,version=}`` /
  ``raft_tpu_recall_ewma`` / ``raft_tpu_rank_displacement`` gauges.
- When the recall EWMA crosses ``threshold`` the alarm fires once per
  excursion (edge-triggered): a WARNING log line, a ``quality_alarm`` event
  and the ``on_degraded(name, version, ewma)`` callback; the climb back over
  the threshold re-arms it and publishes the recovery edge.  A new index
  version starts a fresh EWMA (the rebuilt index does not inherit its
  predecessor's history).

The oracle's rows are cached per (name, version, generation): a swap or a
mutation invalidates them, so steady traffic pays one ``live_vectors()``
copy per index state, not per sample.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from raft_tpu_torch.core.logger import child as _child_logger
from raft_tpu_torch.obs import events
from raft_tpu_torch.obs.registry import MetricsRegistry, default_registry
from raft_tpu_torch.stats.metrics import rank_displacement, recall_at_k

_log = _child_logger("obs.quality")

_ORACLE_CACHE_CAP = 4


def _exact_topk(data: np.ndarray, data_ids: np.ndarray, queries: np.ndarray,
                k: int, metric: str) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k (scores, global ids) by a full numpy scan."""
    q = np.asarray(queries, dtype=np.float32)
    x = np.asarray(data, dtype=np.float32)
    if metric == "inner_product":
        scores = -(q @ x.T)                    # negated: smaller is better
    elif metric == "cosine":
        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        scores = 1.0 - qn @ xn.T
    else:                                      # sqeuclidean and friends
        scores = (q * q).sum(1, keepdims=True) - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]
    k = min(k, x.shape[0])
    part = np.argpartition(scores, k - 1, axis=1)[:, :k]
    order = np.argsort(np.take_along_axis(scores, part, axis=1), axis=1)
    idx = np.take_along_axis(part, order, axis=1)
    return np.take_along_axis(scores, idx, axis=1), np.asarray(data_ids)[idx]


class _Sample:
    __slots__ = ("name", "version", "index", "queries", "ids")

    def __init__(self, name, version, index, queries, ids):
        self.name = name
        self.version = version
        self.index = index
        self.queries = queries
        self.ids = ids


class QualityAuditor:
    """Asynchronous shadow-scoring of served batches against an exact oracle.

    ``k``: depth of the audited recall (served results are truncated to
    it); ``sampling``: share of observed batches audited; ``threshold``: an
    EWMA below it fires the alarm; ``ewma_alpha``: weight of the newest
    sample; ``queue_cap``: bound on samples in flight (overflow drops);
    ``on_degraded(name, version, ewma)``: called from the worker once per
    downward crossing; ``registry``: where the gauges go (default: the
    process registry); ``seed``: the sampling coin's.
    """

    def __init__(self, *, k: int = 10, sampling: float = 0.1, threshold: float = 0.9,
                 ewma_alpha: float = 0.3, queue_cap: int = 64,
                 on_degraded: Optional[Callable[[str, int, float], None]] = None,
                 registry: Optional[MetricsRegistry] = None, seed: int = 0):
        if not 0.0 <= sampling <= 1.0:
            raise ValueError(f"sampling must be in [0, 1], got {sampling}")
        self.k = int(k)
        self.sampling = float(sampling)
        self.threshold = float(threshold)
        self.ewma_alpha = float(ewma_alpha)
        self.on_degraded = on_degraded
        self._registry = registry
        self._rng = random.Random(seed)
        self._queue: "queue.Queue[Optional[_Sample]]" = queue.Queue(maxsize=int(queue_cap))
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._submitted = 0
        self._processed = 0
        self._dropped = 0
        self._errors = 0
        # name -> {"version", "ewma", "n", "alarmed", "last", "displacement"}
        self._state: Dict[str, Dict[str, object]] = {}
        self._oracle_cache: Dict[Tuple[str, int, int], Tuple[np.ndarray, np.ndarray]] = {}
        self._stopping = False
        self._thread = threading.Thread(target=self._worker, name="raft-tpu-quality-auditor",
                                        daemon=True)
        self._thread.start()
        self._reg().register_provider("quality", self.snapshot)

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else default_registry()

    # -- hot path ------------------------------------------------------------
    def observe(self, name: str, version: int, index, queries, ids) -> bool:
        """Maybe enqueue one served batch for auditing: O(1), non-blocking,
        exception-free (it runs on the batcher's completion path)."""
        try:
            if self._stopping or self._rng.random() >= self.sampling:
                return False
            sample = _Sample(name, version, index, np.asarray(queries), np.asarray(ids))
            try:
                self._queue.put_nowait(sample)
            except queue.Full:
                with self._lock:
                    self._dropped += 1
                self._reg().counter(
                    "raft_tpu_quality_dropped_total",
                    help="audit samples dropped on a full queue",
                ).inc(index=name)
                return False
            with self._lock:
                self._submitted += 1
            return True
        except Exception:  # noqa: BLE001 — auditing never fails a search
            return False

    # -- worker side ---------------------------------------------------------
    def _oracle(self, sample: _Sample) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        key = (sample.name, sample.version, int(getattr(sample.index, "generation", 0)))
        hit = self._oracle_cache.get(key)
        if hit is not None:
            return hit
        vecs, ids = sample.index.live_vectors()
        if vecs.shape[0] == 0:
            return None
        if len(self._oracle_cache) >= _ORACLE_CACHE_CAP:
            self._oracle_cache.pop(next(iter(self._oracle_cache)))
        self._oracle_cache[key] = (vecs, ids)
        return self._oracle_cache[key]

    def _audit(self, sample: _Sample) -> None:
        oracle = self._oracle(sample)
        if oracle is None:
            return
        vecs, vec_ids = oracle
        metric = getattr(sample.index, "metric", "sqeuclidean")
        k = min(self.k, sample.ids.shape[1], vecs.shape[0])
        _, ref_ids = _exact_topk(vecs, vec_ids, sample.queries, k, metric)
        served = sample.ids[:, :k]
        recall = recall_at_k(served, ref_ids, k)
        displacement = rank_displacement(served, ref_ids, k)

        reg = self._reg()
        labels = {"index": sample.name, "version": str(sample.version)}
        reg.gauge("raft_tpu_recall",
                  help="recall@k of the latest audited batch vs the exact oracle",
                  ).set(recall, **labels)
        reg.gauge("raft_tpu_rank_displacement",
                  help="mean |served rank - true rank| of the latest audited batch",
                  ).set(displacement, **labels)
        reg.counter("raft_tpu_quality_audited_total", help="batches shadow-scored",
                    ).inc(index=sample.name)

        with self._lock:
            st = self._state.get(sample.name)
            if st is None or st["version"] != sample.version:
                st = {"version": sample.version, "ewma": recall, "n": 0, "alarmed": False,
                      "last": recall, "displacement": displacement}
                self._state[sample.name] = st
            else:
                st["ewma"] = self.ewma_alpha * recall + (1.0 - self.ewma_alpha) * float(st["ewma"])
            st["n"] = int(st["n"]) + 1
            st["last"] = recall
            st["displacement"] = displacement
            ewma = float(st["ewma"])
            fire = ewma < self.threshold and not st["alarmed"]
            rearm = bool(st["alarmed"]) and ewma >= self.threshold
            if fire:
                st["alarmed"] = True
            elif rearm:
                st["alarmed"] = False
        reg.gauge("raft_tpu_recall_ewma",
                  help="EWMA of audited recall@k (degradation alarm input)",
                  ).set(ewma, **labels)
        if fire:
            _log.warning(
                "recall degradation on %r v%d: ewma %.3f < threshold %.3f "
                "(last sample %.3f over %d audits)",
                sample.name, sample.version, ewma, self.threshold, recall, int(st["n"]))
            # the alarm edge is an incident: the bus's flight subscriber
            # captures the in-flight batches and the incident manager opens
            # the timeline
            events.publish("quality_alarm", index=sample.name, version=sample.version,
                           ewma=ewma, threshold=self.threshold, last=recall)
            cb = self.on_degraded
            if cb is not None:
                try:
                    cb(sample.name, sample.version, ewma)
                except Exception:
                    _log.exception("on_degraded callback raised")
        elif rearm:
            # recovery edge: the incident manager closes the story
            events.publish("quality_alarm", "quality_recovered", recovered=True,
                           index=sample.name, version=sample.version, ewma=ewma)

    def _worker(self) -> None:
        while True:
            sample = self._queue.get()
            if sample is None:
                return
            try:
                self._audit(sample)
            except Exception:
                with self._lock:
                    self._errors += 1
                _log.exception("audit failed for %r v%s", sample.name, sample.version)
            finally:
                with self._done:
                    self._processed += 1
                    self._done.notify_all()

    # -- introspection / lifecycle -------------------------------------------
    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every enqueued sample has been audited; False on
        timeout."""
        with self._done:
            return self._done.wait_for(lambda: self._processed >= self._submitted,
                                       timeout=timeout)

    def recall_ewma(self, name: str) -> Optional[float]:
        with self._lock:
            st = self._state.get(name)
            return float(st["ewma"]) if st is not None else None

    def snapshot(self) -> Dict[str, object]:
        """Provider section for registry snapshots."""
        with self._lock:
            return {
                "sampling": self.sampling,
                "threshold": self.threshold,
                "submitted": self._submitted,
                "processed": self._processed,
                "dropped": self._dropped,
                "errors": self._errors,
                "indexes": {
                    name: {
                        "version": st["version"],
                        "recall_ewma": float(st["ewma"]),
                        "last_recall": float(st["last"]),
                        "rank_displacement": float(st["displacement"]),
                        "audits": int(st["n"]),
                        "alarmed": bool(st["alarmed"]),
                    }
                    for name, st in self._state.items()
                },
            }

    def stop(self) -> None:
        """Drain and stop the worker; detach the snapshot provider."""
        if self._stopping:
            return
        self._stopping = True
        try:
            self._queue.put(None, timeout=5.0)
        except queue.Full:
            pass  # worker wedged; the daemon thread dies with the process
        self._thread.join(timeout=10.0)
        self._reg().unregister_provider("quality", expected=self.snapshot)

    def __enter__(self) -> "QualityAuditor":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
