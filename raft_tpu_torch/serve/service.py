"""SearchService (counterpart of ``raft_tpu.serve.service``): the assembled
online query-serving front end.

One object wires the serve stack together: an
:class:`~raft_tpu_torch.serve.registry.IndexRegistry` of named
:class:`~raft_tpu_torch.serve.mutation.MutableIndex` es and one
:class:`~raft_tpu_torch.serve.batcher.MicroBatcher` per served name (its
own bucket ladder, CUDA stream and
:class:`~raft_tpu_torch.serve.metrics.ServingMetrics`), on the device the
index lives on.  A batcher's search fn resolves the registry once per
dispatched batch, so every row of a batch is answered by one index
version: :meth:`swap` never tears a batch.

Typical lifecycle::

    svc = SearchService(k=10)
    svc.add_index("wiki", MutableIndex(built), warmup=True)
    dists, ids = svc.search("wiki", query_vec)     # sync
    fut = svc.submit("wiki", query_vec)            # async, coalesced
    svc.get("wiki").upsert(new_rows)               # visible to the next batch
    svc.swap("wiki", MutableIndex(rebuilt))        # atomic hot-swap
    svc.stats("wiki")                              # qps / p50 / p99 / recompiles
    svc.stop()

Not ported yet, and refused loudly (a flag that is asked for is never
ignored): ``replicas=`` and a ``ShardedIndex`` (multi-GPU serving, ROADMAP
Queue 1 item 7); ``auditor=``, ``slo=``, ``autotune=`` and ``gateway=``,
and ``RAFT_TPU_AUTOTUNE=1`` / ``RAFT_TPU_GATEWAY=1`` (ROADMAP Queue 1 item
5b).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Union

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance import DISTANCE_TYPES
from raft_tpu_torch.obs import cost as obs_cost
from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.obs import health as obs_health
from raft_tpu_torch.obs import incidents as obs_incidents
from raft_tpu_torch.obs import perf as obs_perf
from raft_tpu_torch.obs import spans as obs_spans
from raft_tpu_torch.serve.batcher import MicroBatcher
from raft_tpu_torch.serve.compactor import CompactionPolicy, Compactor
from raft_tpu_torch.serve.effort import EffortArbiter
from raft_tpu_torch.serve.metrics import ServingMetrics, install_compile_listener
from raft_tpu_torch.serve.mutation import MutableIndex
from raft_tpu_torch.serve.overload import (
    AdmissionController,
    DeadlineExceeded,
    DegradedModeManager,
    OverloadConfig,
    Shed,
)
from raft_tpu_torch.serve.ragged import FilterRegistry, RaggedSearcher, RaggedSpec
from raft_tpu_torch.serve.registry import IndexRegistry

_ITEM_5B = "ROADMAP Queue 1 item 5b"
_ITEM_7 = "ROADMAP Queue 1 item 7"


def _refuse(option: str, what: str, item: str) -> None:
    raise NotImplementedError(
        f"SearchService({option}): {what} is not ported yet ({item})")


class SearchService:
    """Serve named mutable indexes through per-index micro-batchers."""

    def __init__(
        self,
        registry: Optional[IndexRegistry] = None,
        *,
        k: int = 10,
        min_bucket: int = 1,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        replicas=None,
        start: bool = True,
        auditor=None,
        cost_accounting: Optional[bool] = None,
        pipeline_depth: Optional[int] = None,
        compaction: Union[None, bool, CompactionPolicy, Compactor] = None,
        slo=None,
        ragged: Union[None, bool, RaggedSpec] = None,
        overload: Union[None, bool, OverloadConfig] = None,
        autotune=None,
        gateway=None,
    ):
        if replicas is not None:
            _refuse("replicas=", "replica dispatch", _ITEM_7)
        if auditor is not None:
            _refuse("auditor=", "the online recall auditor (obs.quality)", _ITEM_5B)
        if slo is not None and slo is not False:
            _refuse("slo=", "the SLO engine (obs.slo)", _ITEM_5B)
        if autotune is None:
            autotune = _env.env_bool("RAFT_TPU_AUTOTUNE", False)
        if autotune is not False:
            _refuse("autotune=" if autotune is not True else "autotune / RAFT_TPU_AUTOTUNE",
                    "the SLO autotuner (obs.autotune)", _ITEM_5B)
        if gateway is None:
            gateway = _env.env_bool("RAFT_TPU_GATEWAY", False)
        if gateway is not False:
            _refuse("gateway=" if gateway is not True else "gateway / RAFT_TPU_GATEWAY",
                    "the operational HTTP gateway (obs.gateway)", _ITEM_5B)
        install_compile_listener()
        # span / slow-log / flight / perf / explain sections in snapshots
        # and the default event bus with its subscribers
        obs.install()
        self.registry = registry if registry is not None else IndexRegistry()
        self.k = int(k)
        self.min_bucket = min_bucket
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.cost_accounting = cost_accounting
        # None defers to the batcher's RAFT_TPU_PIPELINE_DEPTH / default
        self.pipeline_depth = pipeline_depth
        # ragged=None: RAFT_TPU_RAGGED decides; True: spec from env
        if ragged is None:
            ragged = _env.env_bool("RAFT_TPU_RAGGED", False)
        if ragged is True:
            ragged = RaggedSpec.from_env()
        elif ragged is False:
            ragged = None
        self.ragged: Optional[RaggedSpec] = ragged
        self._filter_regs: Dict[str, Optional[FilterRegistry]] = {}
        # overload=None: RAFT_TPU_OVERLOAD decides; every added index then
        # gets an AdmissionController and a DegradedModeManager
        if overload is None:
            overload = _env.env_bool("RAFT_TPU_OVERLOAD", False)
        if overload is True:
            overload = OverloadConfig.from_env()
        elif overload is False:
            overload = None
        self.overload: Optional[OverloadConfig] = overload
        self._admission: Dict[str, AdmissionController] = {}
        self._degraded: Dict[str, DegradedModeManager] = {}
        self._effort: Dict[str, EffortArbiter] = {}
        self._start = start
        self._lock = threading.Lock()
        self._batchers: Dict[str, MicroBatcher] = {}
        self._ks: Dict[str, int] = {}  # effective k per served name
        # compaction=None/False: no worker; True: policy from env; a
        # CompactionPolicy: worker with it; a Compactor is adopted as-is
        self.compactor: Optional[Compactor] = None
        if isinstance(compaction, Compactor):
            self.compactor = compaction
        elif isinstance(compaction, CompactionPolicy):
            self.compactor = Compactor(self, compaction, start=start)
        elif compaction:
            self.compactor = Compactor(
                self, start=start and not CompactionPolicy.disabled_by_env())
        # incident timelines carry a service snapshot at open / close
        obs_incidents.default_manager().add_context_source("service", self._incident_context)

    # -- index management ----------------------------------------------------
    def add_index(
        self, name: str, index, *, warmup: bool = False, k: Optional[int] = None
    ) -> int:
        """Register ``index`` (a built index, wrapped automatically, or a
        :class:`MutableIndex`) under ``name`` and start its batcher on the
        index's device.  With ``warmup`` the bucket ladder runs before this
        returns, so the first real query finds the kernels built."""
        if type(index).__name__ == "ShardedIndex":
            _refuse("add_index", "serving a ShardedIndex", _ITEM_7)
        if not isinstance(index, MutableIndex):
            index = MutableIndex(index)
        if (
            _env.env_bool("RAFT_TPU_PAGED", False)
            and getattr(index.index, "paged", None) is None
        ):
            # opt-in paged serving: the main payload moves behind the
            # budget-enforced page store (BudgetExceeded propagates);
            # structurally unpageable indexes keep the monolithic layout
            from raft_tpu_torch.store import paginate_index

            try:
                paginate_index(index.index, name=name)
            except ValueError:
                pass
        k = self.k if k is None else int(k)
        if self.ragged is not None and k > self.ragged.k_max:
            raise ValueError(
                f"default k={k} exceeds the ragged spec's k_max={self.ragged.k_max}"
            )
        version = self.registry.register(name, index)
        admission = degraded = effort = None
        if self.overload is not None:
            admission = AdmissionController(self.overload, name=name)
            degraded = DegradedModeManager(self.overload, name=name)
            # the single effort-arbitration point (overload clamp)
            effort = EffortArbiter(degraded, name=name)
        with self._lock:
            self._ks[name] = k
            old = self._batchers.pop(name, None)
            old_admission = self._admission.pop(name, None)
            self._degraded.pop(name, None)
            self._effort.pop(name, None)
            if admission is not None:
                self._admission[name] = admission
                self._degraded[name] = degraded
                self._effort[name] = effort
            if self.ragged is not None:
                # filter id space: the main index's global ids; side rows
                # upserted later get ids past it and pass every filter
                freg = FilterRegistry(max(1, index.main_size)) if self.ragged.filters else None
                self._filter_regs[name] = freg
                search_fn = RaggedSearcher(self, name, self.ragged, freg,
                                           degraded=degraded, effort=effort)
            else:
                search_fn = self._make_search_fn(name, k)
            batcher = MicroBatcher(
                search_fn,
                index.dim,
                min_bucket=self.min_bucket,
                max_batch=self.max_batch,
                max_delay_ms=self.max_delay_ms,
                metrics=ServingMetrics(name=name),
                start=self._start,
                cost_accounting=self.cost_accounting,
                pipeline_depth=self.pipeline_depth,
                ragged=self.ragged,
                admission=admission,
                degraded=degraded,
                effort=effort,
                perf_meta=self._make_perf_meta(name),
                device=index.device,
            )
            self._batchers[name] = batcher
        if old is not None:
            old.stop()
        if old_admission is not None:
            old_admission.close()
        if warmup:
            batcher.warmup()
        return version

    def effort_arbiter(self, name: str) -> Optional[EffortArbiter]:
        """The index's effort-arbitration point (None without overload)."""
        with self._lock:
            return self._effort.get(name)

    def _make_search_fn(self, name: str, k: int):
        def search_fn(queries):
            # resolve once per BATCH (hot-swap atomicity boundary)
            index, _version = self.registry.get_versioned(name)
            arb = self._effort.get(name)
            if arb is not None:
                params = arb.apply(index)
                if params is not None:
                    return index.search(queries, k, search_params=params)
            return index.search(queries, k)

        return search_fn

    def _make_perf_meta(self, name: str):
        """``(backend, version)`` of the perf ledger's key, resolved per
        dispatch so a hot-swap re-attributes from its first batch."""

        def perf_meta():
            try:
                index, version = self.registry.get_versioned(name)
            except KeyError:  # removed mid-flight
                return ("unknown", "0")
            return (getattr(index, "kind", "unknown") or "unknown", str(version))

        return perf_meta

    def attach_auditor(self, auditor) -> None:
        """raft_tpu's online recall auditor: ROADMAP Queue 1 item 5b."""
        if auditor is not None:
            _refuse("attach_auditor", "the online recall auditor (obs.quality)", _ITEM_5B)

    @traced("serve.swap")
    def swap(self, name: str, index) -> int:
        """Atomically replace the index behind ``name``; the batcher (and
        its warmed ladder) is kept."""
        if type(index).__name__ == "ShardedIndex":
            _refuse("swap", "serving a ShardedIndex", _ITEM_7)
        if not isinstance(index, MutableIndex):
            index = MutableIndex(index)
        with self._lock:
            if name not in self._batchers:
                raise KeyError(f"no served index named {name!r}")
            batcher = self._batchers[name]
            if index.dim != batcher.dim:
                raise ValueError(
                    f"swap dim mismatch for {name!r}: {index.dim} != {batcher.dim}"
                )
            if index.device != batcher.device:
                raise ValueError(
                    f"swap device mismatch for {name!r}: {index.device} != {batcher.device}"
                )
        return self.registry.swap(name, index)

    def get(self, name: str) -> MutableIndex:
        """The live index (for upsert / delete: visible to the next batch)."""
        return self.registry.get(name)

    def register_filter(self, name: str, mask) -> int:
        """Register a sample filter for ragged serving; returns its fid.
        ``mask`` is a bool array (or ``Bitset``) over ``name``'s global ids."""
        if self.ragged is None:
            raise RuntimeError("register_filter needs SearchService(ragged=...)")
        with self._lock:
            freg = self._filter_regs.get(name)
        if freg is None:
            raise RuntimeError(
                f"no filter registry for {name!r}: the spec has filters=False"
            )
        return freg.register(mask)

    def remove_index(self, name: str) -> None:
        with self._lock:
            batcher = self._batchers.pop(name)
            self._ks.pop(name, None)
            self._filter_regs.pop(name, None)
            admission = self._admission.pop(name, None)
            self._degraded.pop(name, None)
            self._effort.pop(name, None)
        batcher.stop()
        if admission is not None:
            admission.close()
        self.registry.unregister(name)
        obs_explain.default_archive().unwatch_index(name)

    def names(self):
        return self.registry.names()

    # -- querying ------------------------------------------------------------
    def _batcher(self, name: str) -> MicroBatcher:
        with self._lock:
            return self._batchers[name]

    def _ragged_args(self, name: str, k: Optional[int], fid: Optional[int]):
        """Validate and default the per-request ragged descriptor."""
        if self.ragged is None:
            if k is not None or fid is not None:
                raise ValueError("per-request k/fid need SearchService(ragged=...)")
            return None, None
        if k is None:
            with self._lock:
                k = self._ks[name]
        if fid is not None and fid != 0:
            with self._lock:
                freg = self._filter_regs.get(name)
            if freg is None or not freg.contains(fid):
                raise ValueError(
                    f"fid {fid} is not registered for {name!r} "
                    "(register_filter returns valid fids)"
                )
        return k, fid

    def submit(self, name: str, queries, *, k: Optional[int] = None,
               fid: Optional[int] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None):
        """Async search; returns a Future of (distances, ids).  Ragged mode
        takes this request's ``k`` / ``fid``; any mode ``priority`` (0..3)
        and ``deadline_s`` (shed / expired requests resolve with
        :class:`Shed` / :class:`DeadlineExceeded`)."""
        k, fid = self._ragged_args(name, k, fid)
        return self._batcher(name).submit(queries, k=k, fid=fid, priority=priority,
                                          deadline_s=deadline_s)

    @traced("serve.search")
    def search(self, name: str, queries, timeout: Optional[float] = None,
               *, k: Optional[int] = None, fid: Optional[int] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None):
        """Sync search through the batcher (coalesces with live traffic);
        ``timeout`` doubles as the server-side deadline."""
        k, fid = self._ragged_args(name, k, fid)
        return self._batcher(name).search(queries, timeout=timeout, k=k, fid=fid,
                                          priority=priority, deadline_s=deadline_s)

    @traced("serve.explain")
    def explain(self, name: str, queries, *, k: Optional[int] = None,
                fid: Optional[int] = None, priority: Optional[int] = None,
                deadline_s: Optional[float] = None,
                timeout: Optional[float] = None) -> obs_explain.ExplainPlan:
        """EXPLAIN ANALYZE one real request through the normal batched
        path; returns its :class:`~raft_tpu_torch.obs.explain.ExplainPlan`
        (the enriched flight record of its batch, plus a coarse-probe
        replay for the IVF kinds).  Needs the obs pipeline on."""
        if not obs_spans.enabled():
            raise RuntimeError(
                "SearchService.explain needs the observability pipeline on "
                "(obs.set_enabled(True))"
            )
        k, fid = self._ragged_args(name, k, fid)
        batcher = self._batcher(name)
        archive = obs_explain.default_archive()
        outcome, error, result = "ok", None, None
        with obs_explain.deep_scope():
            fut = batcher.submit(queries, k=k, fid=fid, priority=priority,
                                 deadline_s=deadline_s)
            req_id = fut.request_id
            archive.watch(req_id)
            try:
                try:
                    result = fut.result(timeout)
                except Shed as exc:
                    outcome, error = "shed", exc
                except DeadlineExceeded as exc:
                    outcome, error = "deadline_expired", exc
                except Exception as exc:  # noqa: BLE001 — reported in plan
                    outcome, error = "error", exc
                # the archive entry lands on the completion thread right
                # after the future resolves; poll briefly for it
                entry = archive.find(req_id)
                give_up = time.monotonic() + 2.0
                while entry is None and time.monotonic() < give_up:
                    time.sleep(0.001)
                    entry = archive.find(req_id)
            finally:
                archive.unwatch(req_id)
        if entry is None:
            sections: Dict[str, object] = {
                "request": {"id": req_id},
                "outcome": {"outcome": outcome, "error": None, "sampled_reason": "deep"},
                "available": False,
            }
        else:
            sections = entry["plan"]
        if outcome != "ok":
            sections["outcome"] = {
                **(sections.get("outcome") or {}),
                "outcome": outcome,
                "error": repr(error),
            }
        self._explain_deep_sections(name, queries, sections, result)
        return obs_explain.ExplainPlan(sections)

    def _explain_deep_sections(self, name, queries, sections, result):
        """The deep-only plan sections: coarse-probe replay, audit verdict
        (no auditor in the port yet), result payload."""
        try:
            index, version = self.registry.get_versioned(name)
        except KeyError:  # removed mid-explain
            return
        sections.setdefault("bucket", {})["version"] = version
        if index.kind in ("ivf_flat", "ivf_pq"):
            prev = sections.get("probe")
            try:
                info = self._probe_replay(name, index, queries)
            except Exception as exc:  # noqa: BLE001 — section degrades
                info = {"available": False, "error": repr(exc)}
            if isinstance(prev, dict) and prev.get("params"):
                info.setdefault("params", prev["params"])
            sections["probe"] = info
        sections["audit"] = {"available": False}
        if result is not None:
            dists, ids = result
            sections["results"] = {
                "ids": np.asarray(ids).tolist(),
                "distances": [
                    round(float(v), 6)
                    for v in np.asarray(dists, dtype=np.float64).reshape(-1)
                ],
            }

    def _probe_replay(self, name, index, queries):
        """Re-run the coarse pass for one explained request (the same
        selection the search makes), reporting the probed lists and their
        candidate counts."""
        from raft_tpu_torch.core.resources import as_f32
        from raft_tpu_torch.neighbors._common import coarse_select

        base = index.index
        params = None
        with self._lock:
            arb = self._effort.get(name)
        if arb is not None:
            params = arb.apply(index)
        if params is None:
            params = index.search_params
        centers = base.centers
        n_lists = int(centers.shape[0])
        n_probes = int(getattr(params, "n_probes", 0) or 0)
        n_probes = max(1, min(n_probes or n_lists, n_lists))
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        probes = coarse_select(as_f32(q, centers.device), centers,
                               DISTANCE_TYPES[index.metric], n_probes).cpu().numpy()
        sizes = base.list_sizes.cpu().numpy()
        probed = np.unique(probes.reshape(-1))
        total = float(sizes.sum())
        return {
            "n_probes": n_probes,
            "n_lists": n_lists,
            "probed_lists": [int(p) for p in probed],
            "candidates": int(sizes[probes.reshape(-1)].sum()),
            "coverage": round(float(sizes[probed].sum()) / total, 4) if total > 0 else None,
        }

    @traced("serve.warmup")
    def warmup(self, name: Optional[str] = None) -> int:
        """Run the bucket ladder(s); returns the kernel builds / library
        loads spent."""
        names = [name] if name is not None else self.names()
        return sum(self._batcher(n).warmup() for n in names)

    @traced("serve.flush")
    def flush(self, name: Optional[str] = None) -> int:
        """Dispatch everything queued for ``name`` (or all indexes); returns
        after the flushed batches have resolved."""
        names = [name] if name is not None else self.names()
        return sum(self._batcher(n).flush() for n in names)

    # -- compaction ----------------------------------------------------------
    def compact_now(self, name: str) -> Dict[str, object]:
        """One synchronous compaction pass for ``name``, bypassing the
        thresholds and any abort cooldown (needs ``compaction=``)."""
        if self.compactor is None:
            raise RuntimeError(
                "no compactor attached; construct the service with "
                "compaction=True (or a CompactionPolicy)"
            )
        return self.compactor.trigger_now(name)

    def pause_compaction(self) -> None:
        if self.compactor is not None:
            self.compactor.pause()

    def resume_compaction(self) -> None:
        if self.compactor is not None:
            self.compactor.resume()

    def drain_compaction(self, timeout: Optional[float] = None) -> bool:
        """Block until no compaction pass is in flight (True without a
        compactor)."""
        if self.compactor is None:
            return True
        return self.compactor.drain(timeout=timeout)

    # -- observability -------------------------------------------------------
    def stats(self, name: str) -> Dict[str, object]:
        """Metrics snapshot + index version / size for one served name,
        with the per-stage latency breakdown under ``stages``."""
        index, version = self.registry.get_versioned(name)
        out = self._batcher(name).metrics.snapshot()
        deleted, side = index.pending_mutations()
        out.update(
            name=name,
            version=version,
            kind=index.kind,
            size=index.size,
            pending_deletes=deleted,
            side_rows=side,
        )
        ctrl = self._admission.get(name)
        if ctrl is not None:
            out.update(
                admission_level=ctrl.last_level,
                shed_requests=ctrl.shed_total,
                deadline_expired=ctrl.expired_total,
            )
        mgr = self._degraded.get(name)
        if mgr is not None:
            out["degraded_level"] = mgr.level
        arb = self._effort.get(name)
        if arb is not None:
            out.update(
                autotune_level=arb.autotune_level,
                effective_effort_level=arb.effective_level(),
            )
        return out

    def _refresh_capacity_gauges(self) -> None:
        """Pull-refresh the per-version gauges (the exporter never runs
        providers, so every export path calls this first)."""
        for refresh in (obs_cost.refresh_live_buffer_gauges,
                        obs_cost.refresh_mutation_gauges,
                        obs_cost.refresh_page_gauges):
            try:
                refresh(self.registry)
            except Exception:  # capacity accounting must never break serving
                pass
        try:
            obs_perf.default_ledger().refresh_gauges()
        except Exception:  # perf accounting must never break serving
            pass

    def _incident_context(self) -> Dict[str, object]:
        """Registry versions and queue depths, attached to incident
        timelines (lock-light by design)."""
        indexes: Dict[str, object] = {}
        for name in self.registry.names():
            try:
                _index, version = self.registry.get_versioned(name)
            except KeyError:
                continue
            entry: Dict[str, object] = {"version": version}
            try:
                entry["queue_depth"] = self._batcher(name).queue_depth()
            except KeyError:
                pass
            indexes[name] = entry
        return {"indexes": indexes}

    def healthz(self) -> Dict[str, object]:
        """OK / DEGRADED / UNHEALTHY: one :class:`obs.health.IndexProbe`
        per served name (warmup, kernel builds after warmup, queue depth,
        the pipeline window, compaction and overload state) folded with the
        card's memory headroom, the perf ledger's regressions and the page
        budget (``store.budget.default_budget``) by
        :func:`raft_tpu_torch.obs.health.build_report`; publishes the
        ``raft_tpu_health`` gauge."""
        self._refresh_capacity_gauges()
        probes: Dict[str, obs_health.IndexProbe] = {}
        for name in self.names():
            try:
                b = self._batcher(name)
            except KeyError:
                continue
            compaction: Dict[str, object] = {}
            if self.compactor is not None:
                try:
                    compaction = self.compactor.stats(name)
                except Exception:
                    compaction = {}
            last_abort = compaction.get("last_abort")
            ctrl = self._admission.get(name)
            mgr = self._degraded.get(name)
            probes[name] = obs_health.IndexProbe(
                warm=b.warm,
                recompiles=b.metrics.recompiles,
                queue_depth=b.queue_depth(),
                max_batch=b.max_batch,
                pipeline_depth=b.pipeline_depth,
                inflight=b.inflight,
                admission_level=ctrl.last_level if ctrl is not None else None,
                degraded_level=mgr.level if mgr is not None else None,
                compaction_backlog=compaction.get("backlog"),
                compaction_trigger=compaction.get("trigger"),
                compaction_last_abort=(
                    str(last_abort.get("reason", "unknown"))
                    if isinstance(last_abort, dict) else None
                ),
            )
        from raft_tpu_torch.store.budget import default_budget

        page_budget = default_budget()
        return obs_health.build_report(
            probes,
            registry=obs.default_registry(),
            perf=obs_perf.default_ledger().health_slice(),
            budget=page_budget.snapshot() if page_budget is not None else None,
        )

    def readyz(self) -> Dict[str, object]:
        """Readiness: every served index warmed."""
        warm = {n: self._batcher(n).warm for n in self.names()}
        return {"ready": bool(warm) and all(warm.values()), "indexes": warm}

    def metrics(self) -> Dict[str, object]:
        """The whole observability picture in one JSON-safe dict: each
        index's :meth:`stats`, the :meth:`healthz` report, the process
        registry snapshot and the perf ledger."""
        return {
            "indexes": {n: self.stats(n) for n in self.names()},
            "health": self.healthz(),
            "registry": obs.snapshot(),
            "perf": obs_perf.default_ledger().snapshot(),
        }

    def prometheus(self) -> str:
        """The process registry in Prometheus text format (pull-style
        gauges refreshed first)."""
        try:
            self.healthz()
        except Exception:
            pass
        return obs.to_prometheus()

    def openmetrics(self) -> str:
        """The registry as OpenMetrics text, exemplars included."""
        try:
            self.healthz()
        except Exception:
            pass
        return obs.to_openmetrics()

    # -- lifecycle -----------------------------------------------------------
    def stop(self) -> None:
        try:
            obs_incidents.default_manager().remove_context_source("service")
        except Exception:  # bus already reset
            pass
        # compactor first: a pass mid-flight may still run searches
        if self.compactor is not None:
            self.compactor.stop()
        with self._lock:
            batchers = list(self._batchers.values())
            controllers = list(self._admission.values())
        for b in batchers:
            b.stop()
        for ctrl in controllers:
            ctrl.close()

    def __enter__(self) -> "SearchService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
