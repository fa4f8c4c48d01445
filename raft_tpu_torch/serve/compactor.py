"""Online compaction (counterpart of ``raft_tpu.serve.compactor``):
background shadow rebuilds with no serving gap.

1. **Watch.**  A worker thread scans every ``MutableIndex`` of the
   service's registry against a :class:`CompactionPolicy` (side-buffer
   rows, tombstone fraction; ``RAFT_TPU_COMPACT_*``) and publishes backlog
   gauges.
2. **Shadow rebuild.**  A pass captures the index's mutation state under
   its lock, decodes the immutable main structure in bounded chunks
   (:meth:`MutableIndex.iter_main_rows`) and rebuilds a shadow on the
   index's device: surviving and side rows ``extend``-ed into an empty IVF
   clone that reuses the trained centers (and codebooks) — on the card the
   extend's assignment is kernel #7 — re-linked CAGRA neighbourhoods
   (survivors' lists remapped, affected nodes re-kNN'd by brute force,
   reverse edges for new nodes), or ``brute_force.build``.  The projected
   peak bytes are checked against ``headroom_frac`` x the live index's
   bytes before anything is allocated.
3. **Shape stability.**  The shadow is padded to the next power of two
   (+1) with permanently tombstoned sentinel rows and wrapped with a
   row → global-id map, so ids never change under the caller; the worker
   runs the service's bucket ladder against the shadow on its own thread
   before promotion, so any kernel build lands there and not on the
   dispatch thread.
4. **Quality gate.**  Recall of the shadow on a held-back sample of live
   rows must not trail the serving index by more than ``recall_slack``
   (both against an exact brute-force oracle, kernel #2 on the card).  A
   failed gate aborts the pass, publishes ``compaction_abort`` and re-arms
   after a cooldown.
5. **Promote.**  The final mutation delta is folded into the shadow under
   the old index's lock, the registry hot-swaps, and the old index is
   retired: writers still holding it forward to the successor.

``Compactor.rebuild_sharded`` (a distributed rebuild into a
``ShardedIndex``) is multi-GPU serving: it raises, naming ROADMAP Queue 1
item 7.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.logger import child as _child_logger
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.core.trace import trace_range, traced
from raft_tpu_torch.distance import DISTANCE_TYPES
from raft_tpu_torch.obs import events as obs_events
from raft_tpu_torch.obs.registry import default_registry
from raft_tpu_torch.serve.mutation import MutableIndex, _next_pow2
from raft_tpu_torch.stats.metrics import recall_at_k
from raft_tpu_torch.store.budget import BudgetExceeded, default_budget

_log = _child_logger("serve.compactor")

#: live compactors, for the test-suite reset hook (order independence)
_live: "weakref.WeakSet[Compactor]" = weakref.WeakSet()


def reset() -> None:
    """Stop every live compactor worker (conftest autouse hook)."""
    for c in list(_live):
        try:
            c.stop()
        except Exception:  # pragma: no cover - teardown best effort
            pass


@dataclass(frozen=True)
class CompactionPolicy:
    """When to compact, how much memory a pass may use, and the gate.

    A pass triggers when *either* pressure threshold is crossed:
    ``max_side_rows`` live side-buffer rows (the brute-force merge cost
    every query pays) or ``max_tombstone_frac`` of the main rows
    tombstoned (dead device memory).  ``headroom_frac`` bounds the
    rebuild's projected peak host bytes at that fraction of the live
    index's ``device_bytes()``; a pass that would exceed it aborts
    before allocating.  ``recall_slack`` is the quality gate's tolerance:
    shadow recall may trail serving recall by at most this much on the
    held-back sample.
    """

    max_side_rows: int = 1024
    max_tombstone_frac: float = 0.25
    interval_s: float = 2.0          # worker scan period
    cooldown_s: float = 30.0         # per-index re-arm delay after an abort
    headroom_frac: float = 4.0       # peak rebuild bytes / live index bytes
    # (the pow2-padded shadow plus the dense row gather peak near 3x
    # the live bytes for brute_force, so 2.0 would refuse normal passes)
    chunk_rows: int = 65536          # main-structure decode chunk
    gate_queries: int = 64           # held-back sample size
    gate_k: int = 10
    recall_slack: float = 0.02
    seed: int = 0x5EED

    @classmethod
    def from_env(cls) -> "CompactionPolicy":
        """Policy with every field overridable via ``RAFT_TPU_COMPACT_*``."""
        return cls(
            max_side_rows=_env.env_int("RAFT_TPU_COMPACT_MAX_SIDE_ROWS", 1024),
            max_tombstone_frac=_env.env_float(
                "RAFT_TPU_COMPACT_MAX_TOMBSTONE_FRAC", 0.25
            ),
            interval_s=_env.env_float("RAFT_TPU_COMPACT_INTERVAL_S", 2.0),
            cooldown_s=_env.env_float("RAFT_TPU_COMPACT_COOLDOWN_S", 30.0),
            headroom_frac=_env.env_float(
                "RAFT_TPU_COMPACT_HEADROOM_FRAC", 4.0
            ),
            chunk_rows=_env.env_int("RAFT_TPU_COMPACT_CHUNK_ROWS", 65536),
            gate_queries=_env.env_int("RAFT_TPU_COMPACT_GATE_QUERIES", 64),
            recall_slack=_env.env_float("RAFT_TPU_COMPACT_RECALL_SLACK", 0.02),
        )

    @staticmethod
    def disabled_by_env() -> bool:
        return _env.env_bool("RAFT_TPU_COMPACT_DISABLED", False)


@dataclass
class _Capture:
    """Mutation state of the source index at one instant (under its lock)."""

    deleted: np.ndarray        # main-row tombstone mask copy
    side_count: int            # occupied side slots at capture
    side_live: np.ndarray      # full side liveness copy (length >= side_count)
    side_ids: np.ndarray       # full side id array copy
    generation: int


def _capture_locked(mi: MutableIndex) -> _Capture:
    return _Capture(
        deleted=mi._deleted.copy(),
        side_count=mi._side_count,
        side_live=mi._side_live.copy(),
        side_ids=mi._side_ids.copy(),
        generation=mi._generation,
    )


class Compactor:
    """Background maintenance worker over a service's registered indexes.

    Owned by :class:`~raft_tpu_torch.serve.service.SearchService` (the
    ``compaction=`` constructor knob); standalone construction takes the
    service explicitly.  ``start=True`` launches the daemon scan loop;
    :meth:`trigger_now` runs one synchronous pass regardless of
    thresholds (operator escape hatch), :meth:`pause`/:meth:`resume`
    gate the automatic loop, and :meth:`drain` blocks until no pass is
    running.
    """

    def __init__(self, service, policy: Optional[CompactionPolicy] = None,
                 *, start: bool = False):
        self.service = service
        self.policy = policy if policy is not None else CompactionPolicy.from_env()
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._lock = threading.Lock()       # compaction state, not the pass
        self._pass_lock = threading.Lock()  # one pass at a time
        self._worker: Optional[threading.Thread] = None
        self._cooldown_until: Dict[str, float] = {}
        self._last_abort: Dict[str, Dict[str, object]] = {}
        self._compactions = 0
        self._aborts = 0
        self._last_result: Optional[Dict[str, object]] = None
        default_registry().register_provider("compaction", self.snapshot)
        _live.add(self)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._stop.clear()
            self._worker = threading.Thread(
                target=self._run, name="raft-tpu-compactor", daemon=True
            )
            self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        worker = self._worker
        if worker is not None and worker is not threading.current_thread():
            worker.join(timeout=30)
        default_registry().unregister_provider(
            "compaction", expected=self.snapshot
        )

    def pause(self) -> None:
        """Suspend automatic triggering (a running pass finishes)."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until no compaction pass is in flight; True on success."""
        return self._idle.wait(timeout=timeout)

    # -- worker loop ---------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            if self._paused.is_set():
                continue
            try:
                self.scan()
            except Exception:  # noqa: BLE001 — the loop must survive
                _log.exception("compactor scan failed")

    def scan(self) -> None:
        """One pass over registered indexes: refresh backlog gauges and
        compact whichever entry crosses its policy thresholds first."""
        registry = self.service.registry
        for name in registry.names():
            try:
                mi, _version = registry.get_versioned(name)
            except KeyError:
                continue
            if not isinstance(mi, MutableIndex):
                continue  # ShardedIndex etc. — immutable, nothing to fold
            deletes, side = mi.pending_mutations()
            self._publish_backlog(name, mi, deletes, side)
            if self._stop.is_set() or self._paused.is_set():
                return
            if not self._should_trigger(name, mi, deletes, side):
                continue
            self.compact(name)

    def _should_trigger(
        self, name: str, mi: MutableIndex, deletes: int, side: int
    ) -> bool:
        if time.monotonic() < self._cooldown_until.get(name, 0.0):
            return False
        if side >= self.policy.max_side_rows:
            return True
        live_cap = mi.main_size - mi._n_structural
        frac = deletes / live_cap if live_cap else 0.0
        return frac >= self.policy.max_tombstone_frac

    def _publish_backlog(
        self, name: str, mi: MutableIndex, deletes: int, side: int
    ) -> None:
        reg = default_registry()
        reg.gauge(
            "raft_tpu_compaction_backlog",
            help="pending mutations (tombstones + live side rows) awaiting "
            "compaction",
        ).set(deletes + side, index=name)
        trigger = self.policy.max_side_rows + int(
            self.policy.max_tombstone_frac
            * max(mi.main_size - mi._n_structural, 1)
        )
        reg.gauge(
            "raft_tpu_compaction_trigger_threshold",
            help="combined backlog level that triggers a compaction pass",
        ).set(trigger, index=name)

    # -- the pass ------------------------------------------------------------
    def trigger_now(self, name: str) -> Dict[str, object]:
        """Run one synchronous pass for ``name``, ignoring thresholds and
        cooldowns (they exist to pace the automatic loop, not operators)."""
        self._cooldown_until.pop(name, None)
        return self.compact(name)

    @traced("serve.compact")
    def compact(self, name: str) -> Dict[str, object]:
        """One full compaction pass: capture → shadow rebuild (budgeted)
        → ladder warm → quality gate → delta-fold promote."""
        with self._pass_lock:
            self._idle.clear()
            try:
                result = self._compact_inner(name)
            except BudgetExceeded as exc:
                # shadow pagination blew the shared page budget — same
                # abort class as the projected-bytes gate, so operators
                # see one "budget" reason for both enforcement points
                result = self.abort(name, "budget", str(exc))
            except Exception as exc:  # noqa: BLE001 — abort, don't crash
                result = self.abort(name, "error", repr(exc))
            finally:
                self._idle.set()
            self._last_result = result
            return result

    def _compact_inner(self, name: str) -> Dict[str, object]:
        registry = self.service.registry
        mi, version = registry.get_versioned(name)
        if not isinstance(mi, MutableIndex):
            return {"name": name, "status": "noop", "reason": "not mutable"}
        deletes, side = mi.pending_mutations()
        if deletes == 0 and side == 0:
            return {"name": name, "status": "noop", "reason": "clean"}
        t0 = time.perf_counter()
        obs_events.publish(
            "compaction_trigger",
            index=name, version=version, deletes=deletes, side=side,
        )
        self._progress(name, 0.0)

        with mi._lock:
            cap = _capture_locked(mi)
        live_main = int((~cap.deleted).sum())
        side_live_n = int(cap.side_live[: cap.side_count].sum())
        m = live_main + side_live_n
        if m < 2:
            return self.abort(name, "empty", f"only {m} live rows")

        # ---- memory budget: project BEFORE allocating -------------------
        live_bytes = mi.device_bytes()
        budget = int(self.policy.headroom_frac * live_bytes)
        projected = self._project_peak_bytes(mi, m)
        default_registry().gauge(
            "raft_tpu_compaction_peak_bytes",
            help="projected peak host bytes of the last rebuild pass",
        ).set(projected, index=name)
        if projected > budget:
            return self.abort(
                name, "budget",
                f"projected {projected}B > {budget}B "
                f"({self.policy.headroom_frac}x of {live_bytes}B live)",
            )
        # shared enforcement with the page-store ledger: a configured
        # RAFT_TPU_PAGE_HBM_BUDGET_MB bounds the rebuild too — the shadow
        # index's pages will reserve from the same budget at pagination
        page_budget = default_budget()
        if (
            page_budget is not None
            and getattr(mi.index, "paged", None) is not None
            and not page_budget.would_fit(projected)
        ):
            return self.abort(
                name, "budget",
                f"projected {projected}B exceeds the page-budget remainder "
                f"{page_budget.remaining()}B (shared "
                "RAFT_TPU_PAGE_HBM_BUDGET_MB ledger)",
            )

        # ---- gather live rows (chunked main decode + captured side) -----
        rows, gids = self._gather_live(mi, cap, m)
        self._progress(name, 0.4)

        # ---- shadow rebuild with pow2 padding + id map ------------------
        shadow_mi = self._build_shadow(mi, cap, rows, gids)
        self._progress(name, 0.6)

        # ---- bulk delta fold (mutations that landed during the gather) --
        cap = self._fold_delta(mi, cap, shadow_mi)

        # ---- warm the ladder + post-swap mutation variants --------------
        self._warm_shadow(name, mi, shadow_mi)
        self._progress(name, 0.8)

        # ---- quality gate ----------------------------------------------
        ok, serving_recall, shadow_recall = self._gate(mi, shadow_mi, rows, gids)
        if not ok:
            return self.abort(
                name, "gate",
                f"shadow recall {shadow_recall:.4f} < serving "
                f"{serving_recall:.4f} - {self.policy.recall_slack}",
            )

        # ---- promote ----------------------------------------------------
        new_version = self.promote(name, mi, cap, shadow_mi)
        obs_events.publish(
            "compaction_promote",
            index=name, old_version=version, version=new_version,
        )
        self._progress(name, 1.0)
        with self._lock:
            self._compactions += 1
            self._last_abort.pop(name, None)
        default_registry().counter(
            "raft_tpu_compactions_total", help="promoted compaction passes"
        ).inc(index=name)
        elapsed = time.perf_counter() - t0
        result = {
            "name": name,
            "status": "promoted",
            "from_version": version,
            "version": new_version,
            "rows": int(m),
            "folded_deletes": deletes,
            "folded_side_rows": side,
            "serving_recall": serving_recall,
            "shadow_recall": shadow_recall,
            "projected_peak_bytes": projected,
            "budget_bytes": budget,
            "elapsed_s": elapsed,
        }
        _log.info(
            "compacted %r v%d -> v%d: %d rows, %d deletes + %d side rows "
            "folded, recall %.4f -> %.4f, %.2fs",
            name, version, new_version, m, deletes, side,
            serving_recall, shadow_recall, elapsed,
        )
        return result

    # -- rebuild pieces ------------------------------------------------------
    def _project_peak_bytes(self, mi: MutableIndex, m: int) -> int:
        """Peak host bytes of the rebuild, estimated before allocating:
        the dense live-rows buffer, a shadow structure scaled from the
        live one by survivor count, and one decode chunk."""
        rows_bytes = m * mi.dim * 4
        struct_bytes = 0
        for v in vars(mi.index).values():
            nb = getattr(v, "nbytes", None)
            if isinstance(nb, (int, np.integer)):
                struct_bytes += int(nb)
        padded = _next_pow2(m + 1)
        shadow_bytes = int(struct_bytes * (padded / max(mi.main_size, 1)))
        chunk_bytes = min(self.policy.chunk_rows, padded) * mi.dim * 4
        return rows_bytes + shadow_bytes + chunk_bytes

    def _gather_live(
        self, mi: MutableIndex, cap: _Capture, m: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense (rows, global ids) of every row live at capture time.

        Main rows stream through :meth:`MutableIndex.iter_main_rows` so
        the full structure is never decoded twice; the captured tombstone
        mask (not the live one) keeps the capture consistent."""
        rows = np.empty((m, mi.dim), np.float32)
        gids = np.empty((m,), np.int64)
        off = 0
        for ridx, chunk in mi.iter_main_rows(self.policy.chunk_rows):
            keep = ~cap.deleted[ridx]
            n = int(keep.sum())
            if not n:
                continue
            rows[off:off + n] = chunk[keep]
            kept_rows = ridx[keep]
            if mi._main_ids is None:
                gids[off:off + n] = kept_rows
            else:
                gids[off:off + n] = mi._main_ids[kept_rows]
            off += n
        live_slots = np.flatnonzero(cap.side_live[: cap.side_count])
        n_side = live_slots.size
        if n_side:
            with mi._lock:  # _side_data may be mid-growth; slot rows are stable
                rows[off:off + n_side] = mi._side_data[live_slots]
            gids[off:off + n_side] = cap.side_ids[live_slots]
            off += n_side
        assert off == m, (off, m)
        return rows, gids

    def _build_shadow(
        self, mi: MutableIndex, cap: _Capture,
        rows: np.ndarray, gids: np.ndarray,
    ) -> MutableIndex:
        """Rebuild the main structure from the live rows, padded to a
        power-of-two row count with permanently-tombstoned sentinels.

        Padding keeps consecutive compactions on the same shapes and the
        tombstone filter always present, as in raft_tpu."""
        m = rows.shape[0]
        padded = _next_pow2(m + 1)
        pad = padded - m
        if DISTANCE_TYPES[mi.metric] == "inner_product":
            # zero rows score 0 under inner product: never competitive
            # for the tombstone filter to matter, and never a neighbor
            pad_rows = np.zeros((pad, mi.dim), np.float32)
        else:
            # push sentinels far from the data so they are nobody's
            # graph neighbor and cluster into one cold IVF list
            pad_rows = np.full((pad, mi.dim), 1e6, np.float32)
        all_rows = np.concatenate([rows, pad_rows], axis=0)
        all_gids = np.concatenate(
            [gids, np.full((pad,), -1, np.int64)], axis=0
        )
        with trace_range("serve.compact.rebuild"):
            shadow_index = self._rebuild_structure(mi, cap, all_rows)
        src_tiered = getattr(mi.index, "paged", None)
        if src_tiered is not None:
            # a paged source promotes to a paged shadow at the same page
            # size; BudgetExceeded here surfaces as a "budget" abort
            from raft_tpu_torch.store import paginate_index

            paginate_index(
                shadow_index,
                page_rows=int(src_tiered.store.page_rows),
                name=f"shadow:{mi.kind}",
            )
        shadow = MutableIndex(
            shadow_index,
            kind=mi.kind,
            search_params=mi.search_params,
            main_ids=all_gids,
        )
        with shadow._lock:
            shadow._deleted[m:] = True
            shadow._n_deleted = pad
            shadow._n_structural = pad
            # padding ids are -1; fresh ids continue the source's sequence
            shadow._next_id = max(shadow._next_id, mi._next_id)
            shadow._refresh_snapshot_locked()
        return shadow

    def _rebuild_structure(
        self, mi: MutableIndex, cap: _Capture, all_rows: np.ndarray
    ):
        from raft_tpu_torch.neighbors import brute_force

        res = Resources(device=mi.device)
        dev = mi.device
        n = all_rows.shape[0]
        ids = torch.arange(n, dtype=torch.int32)
        if mi.kind == "brute_force":
            return brute_force.build(all_rows, metric=mi.metric, res=res)
        if mi.kind == "ivf_flat":
            from raft_tpu_torch.neighbors import ivf_flat

            old = mi.index
            L = old.centers.shape[0]
            # empty clone reusing the trained centers: extend re-clusters
            # every row into it (the streamed initial fill)
            empty = ivf_flat.Index(
                old.metric, old.centers,
                torch.zeros((L, 8, mi.dim), dtype=old.list_data.dtype, device=dev),
                torch.full((L, 8), -1, dtype=torch.int32, device=dev),
                torch.zeros((L,), dtype=torch.int32, device=dev),
                torch.full((L, 8), float("inf"), dtype=torch.float32, device=dev),
                headroom=old.headroom,
            )
            return ivf_flat.extend(empty, all_rows, ids, res=res)
        if mi.kind == "ivf_pq":
            from raft_tpu_torch.neighbors import ivf_pq

            old = mi.index
            L = old.centers.shape[0]
            empty = ivf_pq.Index(
                old.metric, old.codebook_kind, old.pq_bits,
                old.centers, old.centers_rot, old.rotation, old.codebook,
                torch.zeros((L, 8, old.pq_dim), dtype=torch.uint8, device=dev),
                torch.full((L, 8), -1, dtype=torch.int32, device=dev),
                torch.zeros((L,), dtype=torch.int32, device=dev),
                torch.zeros((L, 8, old.rot_dim), dtype=old.list_data.dtype, device=dev),
                torch.zeros((L, 8), dtype=torch.float32, device=dev),
                headroom=old.headroom,
            )
            return ivf_pq.extend(empty, all_rows, ids, res=res)
        if mi.kind == "cagra":
            return self._relink_cagra(mi, cap, all_rows)
        raise ValueError(f"unsupported kind {mi.kind!r}")

    def _relink_cagra(
        self, mi: MutableIndex, cap: _Capture, all_rows: np.ndarray
    ):
        """Re-link the CAGRA graph instead of rebuilding it from scratch:
        surviving rows keep their (remapped) neighbor lists; only nodes
        touching dead neighbors, plus the new side/padding rows, get
        fresh exact neighborhoods — then reverse edges make the new rows
        reachable from the survivors."""
        from raft_tpu_torch.neighbors import brute_force, cagra

        res = Resources(device=mi.device)
        old = mi.index
        n_new = all_rows.shape[0]
        old_graph = old.graph.cpu().numpy()
        degree = min(old_graph.shape[1], n_new - 1)
        # all_rows is laid out [surviving main (row order) | side | pad],
        # matching the gather, so the captured mask names the survivors
        surv_old = np.flatnonzero(~cap.deleted)
        remap = np.full((old_graph.shape[0],), -1, np.int64)
        remap[surv_old] = np.arange(surv_old.size)
        graph = np.full((n_new, degree), -1, np.int64)
        graph[: surv_old.size] = remap[old_graph[surv_old][:, :degree]]
        # affected = survivors referencing dead neighbors + every new row
        affected = np.flatnonzero((graph == -1).any(axis=1))
        if affected.size:
            chunk = max(1, self.policy.chunk_rows // max(degree + 1, 1))
            for s in range(0, affected.size, chunk):
                idx = affected[s : s + chunk]
                _d, nb = brute_force.knn(
                    all_rows, all_rows[idx], degree + 1, metric=mi.metric, res=res
                )
                nb = nb.cpu().numpy().astype(np.int64)
                # drop self-edges, keep the best `degree` others
                rows_nb = np.empty((idx.size, degree), np.int64)
                for j, node in enumerate(idx):
                    cand = nb[j][nb[j] != node][:degree]
                    if cand.size < degree:  # duplicates collapsed the list
                        cand = np.resize(cand, degree)
                    rows_nb[j] = cand
                graph[idx] = rows_nb
        # reverse edges: each brand-new node replaces the worst slot of
        # its first few neighbors, so beam searches seeded on survivors
        # can reach it
        n_surv = surv_old.size
        new_nodes = np.arange(n_surv, n_new)
        slot = {}
        for node in new_nodes:
            for v in graph[node][: max(1, degree // 4)]:
                v = int(v)
                if v == node or v < 0:
                    continue
                s = slot.get(v, 0)
                if s >= max(1, degree // 2):
                    continue
                graph[v, degree - 1 - s] = node
                slot[v] = s + 1
        return cagra.from_graph(mi.metric, all_rows, graph.astype(np.int32), res=res)

    def _fold_delta(
        self, mi: MutableIndex, cap: _Capture, shadow: MutableIndex
    ) -> _Capture:
        """Replay mutations that landed on ``mi`` after ``cap`` into the
        shadow; returns the refreshed capture so the fold is incremental
        (promote runs it once more, small, under the source's lock)."""
        with mi._lock:
            now = _capture_locked(mi)
            # side rows appended after the capture (copy under the lock —
            # the buffer may grow concurrently otherwise)
            new_slots = np.arange(cap.side_count, now.side_count)
            new_rows = mi._side_data[new_slots].copy() if new_slots.size else None
        self._apply_delta(mi, cap, now, new_slots, new_rows, shadow)
        return now

    def _fold_delta_locked(
        self, mi: MutableIndex, cap: _Capture, shadow: MutableIndex
    ) -> None:
        """Final fold, caller holds ``mi._lock`` (nothing can race)."""
        now = _capture_locked(mi)
        new_slots = np.arange(cap.side_count, now.side_count)
        new_rows = mi._side_data[new_slots] if new_slots.size else None
        self._apply_delta(mi, cap, now, new_slots, new_rows, shadow)

    def _apply_delta(self, mi, cap, now, new_slots, new_rows, shadow) -> None:
        # 1. main rows tombstoned since capture -> delete their global ids
        newly_dead = now.deleted & ~cap.deleted
        if newly_dead.any():
            dead_rows = np.flatnonzero(newly_dead)
            if mi._main_ids is None:
                dead_ids = dead_rows
            else:
                dead_ids = mi._main_ids[dead_rows]
            shadow.delete(dead_ids)
        # 2. captured-live side rows killed since capture
        was_live = cap.side_live[: cap.side_count]
        still = now.side_live[: cap.side_count]
        died = was_live & ~still
        if died.any():
            shadow.delete(cap.side_ids[: cap.side_count][died])
        # 3. side rows appended since capture, replayed in slot order so
        # repeated upserts of one id resolve to the latest row
        for i, slot in enumerate(new_slots):
            if not now.side_live[slot]:
                continue  # upserted then deleted during the rebuild
            shadow.upsert(new_rows[i][None], ids=[int(now.side_ids[slot])])

    def _warm_shadow(
        self, name: str, mi: MutableIndex, shadow: MutableIndex
    ) -> None:
        """Run the service's bucket ladder against the shadow on THIS
        thread before the swap, so a kernel build or library load the
        shadow's searches need happens here and not on the dispatch
        thread.  (raft_tpu also walks each side-buffer capacity tier, since
        every XLA shape is an executable of its own; the port's kernels
        take any shape, so the ladder is the whole warmup.)"""
        try:
            batcher = self.service._batcher(name)
            buckets = list(batcher.buckets())
        except KeyError:
            buckets = [1]
        k = self.service._ks.get(name, self.service.k)
        with trace_range("serve.compact.warm"):
            for b in buckets:
                shadow.search(np.zeros((b, shadow.dim), np.float32), k)
            if shadow.device.type == "cuda":
                torch.cuda.synchronize(shadow.device)

    def _gate(
        self, mi: MutableIndex, shadow: MutableIndex,
        rows: np.ndarray, gids: np.ndarray,
    ) -> Tuple[bool, float, float]:
        """Differential recall gate on a held-back sample of live rows:
        the shadow must not trail the serving index by more than
        ``recall_slack`` against an exact oracle over the captured rows."""
        from raft_tpu_torch.neighbors import brute_force

        pol = self.policy
        nq = min(pol.gate_queries, rows.shape[0])
        if nq == 0:
            return True, 1.0, 1.0
        rng = np.random.default_rng(pol.seed + mi.generation)
        pick = rng.choice(rows.shape[0], size=nq, replace=False)
        scale = float(np.abs(rows).mean()) or 1.0
        queries = rows[pick] + rng.standard_normal(
            (nq, rows.shape[1])
        ).astype(np.float32) * 0.01 * scale
        k = min(pol.gate_k, rows.shape[0])
        with trace_range("serve.compact.gate"):
            _d, oracle_rows = brute_force.knn(
                rows, queries, k, metric=mi.metric, res=Resources(device=mi.device)
            )
            oracle_ids = gids[oracle_rows.cpu().numpy()]
            _d, serving_ids = mi.search(queries, k)
            _d, shadow_ids = shadow.search(queries, k)
        serving = recall_at_k(serving_ids.cpu().numpy(), oracle_ids)
        shadowr = recall_at_k(shadow_ids.cpu().numpy(), oracle_ids)
        ok = shadowr + pol.recall_slack >= serving
        return ok, float(serving), float(shadowr)

    @traced("serve.compact.promote")
    def promote(
        self, name: str, mi: MutableIndex, cap: _Capture,
        shadow: MutableIndex,
    ) -> int:
        """Atomic cutover: final delta fold + registry hot-swap + retire
        the old index, all while holding its mutation lock — a writer
        either lands before the fold (and is folded) or after the swap
        (and is forwarded to the successor).  Readers are untouched: the
        swap is a tuple replacement, atomic at batch granularity."""
        with mi._lock:
            self._fold_delta_locked(mi, cap, shadow)
            version = self.service.registry.swap(name, shadow)
            mi._retired_to = shadow
        return version

    @traced("serve.compact.rebuild_sharded")
    def rebuild_sharded(self, name: str, comms=None, **kwargs) -> Dict[str, object]:
        """raft_tpu's distributed rebuild into a ``ShardedIndex``: multi-GPU
        serving, which raises (ROADMAP Queue 1 item 7)."""
        raise NotImplementedError(
            "Compactor.rebuild_sharded builds a ShardedIndex; that is "
            "multi-GPU serving (ROADMAP Queue 1 item 7)")

    @traced("serve.compact.abort")
    def abort(self, name: str, reason: str, detail: str = "") -> Dict[str, object]:
        """Record a failed/refused pass: log, gauge, cooldown, re-arm."""
        entry = {
            "name": name,
            "status": "aborted",
            "reason": reason,
            "detail": detail,
            "at": time.time(),
        }
        with self._lock:
            self._aborts += 1
            self._last_abort[name] = entry
            self._cooldown_until[name] = (
                time.monotonic() + self.policy.cooldown_s
            )
        default_registry().counter(
            "raft_tpu_compaction_aborts_total",
            help="compaction passes aborted (gate/budget/error)",
        ).inc(index=name, reason=reason)
        # the abort→DEGRADED wiring rides the bus too: healthz folds
        # stats()["last_abort"] into its verdict, and this event opens /
        # annotates the incident timeline alongside it
        obs_events.publish(
            "compaction_abort", f"compaction_abort_{reason}",
            index=name, cause=reason, detail=detail,
        )
        _log.warning("compaction of %r aborted (%s): %s", name, reason, detail)
        return entry

    def _progress(self, name: str, frac: float) -> None:
        default_registry().gauge(
            "raft_tpu_compaction_progress",
            help="phase progress of the current/last pass (0..1)",
        ).set(frac, index=name)

    # -- introspection -------------------------------------------------------
    def stats(self, name: str) -> Dict[str, object]:
        """Per-index compaction state for healthz folding."""
        registry = self.service.registry
        backlog = None
        trigger = None
        try:
            mi, _v = registry.get_versioned(name)
            if isinstance(mi, MutableIndex):
                deletes, side = mi.pending_mutations()
                backlog = deletes + side
                trigger = self.policy.max_side_rows + int(
                    self.policy.max_tombstone_frac
                    * max(mi.main_size - mi._n_structural, 1)
                )
        except KeyError:
            pass
        with self._lock:
            last_abort = self._last_abort.get(name)
        return {
            "backlog": backlog,
            "trigger": trigger,
            "last_abort": last_abort,
        }

    def snapshot(self) -> Dict[str, object]:
        """The obs provider section (``obs.snapshot()['compaction']``)."""
        with self._lock:
            out: Dict[str, object] = {
                "compactions": self._compactions,
                "aborts": self._aborts,
                "paused": self._paused.is_set(),
                "running": not self._idle.is_set(),
                "worker_alive": (
                    self._worker is not None and self._worker.is_alive()
                ),
                "last_result": self._last_result,
                "last_aborts": dict(self._last_abort),
            }
        pol = self.policy
        out["policy"] = {
            "max_side_rows": pol.max_side_rows,
            "max_tombstone_frac": pol.max_tombstone_frac,
            "interval_s": pol.interval_s,
            "cooldown_s": pol.cooldown_s,
            "headroom_frac": pol.headroom_frac,
            "chunk_rows": pol.chunk_rows,
            "gate_queries": pol.gate_queries,
            "recall_slack": pol.recall_slack,
        }
        return out
