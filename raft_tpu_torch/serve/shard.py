"""Index sharding: partition one index across a mesh axis (counterpart of
``raft_tpu.serve.shard``).

:class:`ShardedIndex` partitions the index itself — brute-force rows, IVF
lists (IVF-Flat and IVF-PQ; CAGRA serves by row-partitioned brute force
over its dataset) — across the shards of a
:class:`~raft_tpu_torch.comms.comms.Comms` mesh axis, so each shard holds
~1/N of the index.  Every shard runs the *existing* local search over its
partition (the single-device entry points, so on the card the fused kNN,
the IVF scan kernels and their filter legs), and the global answer is one
cross-shard merge: the per-shard top-k candidates gathered in rank order
and one tie-stable ``ops.matrix.select_k_stable`` (the select_k kernel),
on the mesh's first device.  An optional bf16 cast of the gathered
distances (``RAFT_TPU_SHARD_MERGE_DTYPE=bfloat16``) halves what the merge
moves.  Shards that share a card search one after another.

Semantics against the single-device backends (raft_tpu's):

- brute force / CAGRA: exact — the per-shard candidate union holds the
  global top-k, and the id-tie-stable merge returns the same (ids,
  distances).
- IVF-Flat / IVF-PQ: lists are dealt round-robin, and each shard probes up
  to ``n_probes`` of *its own* lists, so the probed set is a superset of
  the single-device one: recall is at least the unsharded search's at
  equal ``n_probes`` (equal when probing is exhaustive).

Tombstones of a :class:`~raft_tpu_torch.serve.mutation.MutableIndex` are
folded in at shard time (the global deleted bitset rides along to every
shard); live side-buffer rows are refused — compact or rebuild first.  A
sharded index is an immutable serving layout: mutate the source and
hot-swap a fresh :meth:`ShardedIndex.from_index` through the registry.
CAGRA's partitioned-graph mode (``cagra_mode="graph"``) is ROADMAP Queue 1
item 7b and raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import kernels as _kernels
from raft_tpu_torch import obs
from raft_tpu_torch.comms.comms import Comms, local_comms
from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.bitset import Bitset, RowFilter
from raft_tpu_torch.core.resources import Resources, as_f32
from raft_tpu_torch.core.trace import trace_range
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES
from raft_tpu_torch.ops import matrix
from raft_tpu_torch.serve.mutation import MutableIndex

#: env knob for the merge gather's distance dtype (EQuARX-style quantized
#: collective): "float32" (default, exact) or "bfloat16"
MERGE_DTYPE_ENV = "RAFT_TPU_SHARD_MERGE_DTYPE"

_MERGE_DTYPES = {
    "float32": None,  # no cast — gather full-precision distances
    "f32": None,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def merge_dtype_from_env() -> Optional[torch.dtype]:
    """Resolve ``RAFT_TPU_SHARD_MERGE_DTYPE`` to a cast dtype (or None)."""
    name = _env.env_str(MERGE_DTYPE_ENV, "float32").strip().lower()
    if name not in _MERGE_DTYPES:
        raise ValueError(
            f"{MERGE_DTYPE_ENV}={name!r} not understood; expected one of "
            f"{sorted(_MERGE_DTYPES)}"
        )
    return _MERGE_DTYPES[name]


#: env knob for how sharded CAGRA serves: "brute" (row-partitioned brute
#: force, exact) or "graph" (partitioned traversal: not ported)
CAGRA_MODE_ENV = "RAFT_TPU_SHARD_CAGRA"


def _resolve_cagra_mode(mode: str) -> str:
    if mode == "env":
        mode = (_env.env_str(CAGRA_MODE_ENV, "brute") or "brute")
    mode = mode.strip().lower()
    if mode not in ("brute", "graph"):
        raise ValueError(
            f"cagra shard mode {mode!r} not understood; expected 'brute', "
            f"'graph' or 'env' ({CAGRA_MODE_ENV})"
        )
    return mode


def _round_robin(n_items: int, n_shards: int) -> list:
    """Per-shard item indices, round-robin (balances size-sorted skew)."""
    return [np.arange(s, n_items, n_shards) for s in range(n_shards)]


def _res(device: torch.device) -> Resources:
    return Resources(device=device)


class ShardedIndex:
    """One logical index partitioned across a mesh axis.

    Build via :meth:`from_index`; call :meth:`search` like any backend.
    Quacks enough like :class:`MutableIndex` (``kind`` / ``dim`` / ``size``
    / ``device`` / ``generation`` / ``pending_mutations`` /
    ``device_bytes`` / ``search``) to be registered and hot-swapped through
    ``IndexRegistry`` / ``SearchService`` and served by ``MicroBatcher``.
    ``shards`` holds, for each of this process's shards in mesh order, its
    partition (a backend index on the shard's device) and sidecars."""

    #: True on the partitioned-graph CAGRA subclass (ROADMAP Queue 1 item
    #: 7b); consumers read it duck-typed via ``getattr``
    graph_mode = False

    def __init__(self, comms: Comms, kind: str, metric: str, dim: int, size: int,
                 shards: List[dict], *, search_params=None, merge_dtype=None,
                 label: str = "", shard_stats: Optional[Dict[str, list]] = None):
        self.comms = comms
        self.kind = kind
        self.metric = metric
        self.dim = int(dim)
        self.size = int(size)
        self.search_params = search_params
        self.label = label or kind
        self.merge_dtype = merge_dtype
        self.select_min = DISTANCE_TYPES[metric] != "inner_product"
        self.shards = shards
        #: results come back on the mesh's first device
        self.device = comms.devices[0]
        # MutableIndex-compatible serving surface: a sharded layout is
        # immutable — mutate the source index and hot-swap a re-shard
        self.generation = 0
        self._shard_stats = shard_stats or {}
        self._publish_shard_gauges()

    @property
    def main_size(self) -> int:
        return self.size

    # -- construction --------------------------------------------------------
    @classmethod
    def from_index(cls, index, comms: Optional[Comms] = None, *,
                   n_devices: Optional[int] = None, search_params=None,
                   merge_dtype="env", label: str = "",
                   cagra_mode: str = "env") -> "ShardedIndex":
        """Partition a built index (or a ``MutableIndex`` with no live side
        rows and dense ids) across ``comms``' axis (default: every visible
        CUDA device, ``local_comms(n_devices)``).

        ``merge_dtype`` defaults to ``RAFT_TPU_SHARD_MERGE_DTYPE``; pass
        None (exact f32 merge) or ``torch.bfloat16``.  ``cagra_mode``:
        ``"brute"`` (row-partitioned brute force over the dataset, exact),
        ``"graph"`` (not ported: ROADMAP Queue 1 item 7b) or ``"env"``."""
        comms = comms if comms is not None else local_comms(n_devices)
        if merge_dtype == "env":
            merge_dtype = merge_dtype_from_env()
        deleted = None
        if isinstance(index, MutableIndex):
            with index._lock:
                if int(index._side_live.sum()) > 0:
                    raise ValueError(
                        "cannot shard a MutableIndex with live side-buffer "
                        "rows; rebuild/compact the index first"
                    )
                if index._main_ids is not None:
                    # the sharded layouts carry global ids as row positions
                    # (arange rows / list_index); a compacted id map would
                    # silently serve wrong ids through them
                    raise ValueError(
                        "cannot shard a MutableIndex with a remapped id "
                        "space (a compacted index); rebuild it with dense "
                        "ids from live_vectors() first"
                    )
                if index._n_deleted:
                    deleted = index._deleted.copy()
            if search_params is None:
                search_params = index.search_params
            kind, inner = index.kind, index.index
        else:
            kind, inner = _infer_kind(index), index
        if kind == "cagra" and _resolve_cagra_mode(cagra_mode) == "graph":
            raise NotImplementedError(
                "graph-mode sharded CAGRA (GraphShardedIndex) is not ported "
                "yet (ROADMAP Queue 1 item 7b); serve it with cagra_mode='brute'")
        if kind in ("brute_force", "cagra"):
            return cls._shard_rows(comms, kind, inner, deleted, merge_dtype, label)
        if kind in ("ivf_flat", "ivf_pq"):
            return cls._shard_ivf(comms, kind, inner, deleted, search_params, merge_dtype,
                                  label)
        raise ValueError(f"unsupported index kind for sharding: {kind!r}")

    @classmethod
    def _shard_rows(cls, comms, kind, inner, deleted, merge_dtype, label):
        from raft_tpu_torch.neighbors import brute_force

        data = inner.dataset
        n, d = data.shape
        s_count = comms.get_size()
        r = -(-n // s_count)
        shards, row_counts = [], []
        for rank, dev in zip(comms.ranks(), comms.devices):
            lo, hi = min(rank * r, n), min((rank + 1) * r, n)
            rows = data[lo:hi].to(dev)
            dead = None
            if deleted is not None and hi > lo and deleted[lo:hi].any():
                dead = Bitset.from_mask(torch.from_numpy(deleted[lo:hi]), device=dev)
            shards.append({
                "index": brute_force.Index(rows, inner.metric),
                "ids": torch.arange(lo, hi, dtype=torch.int32, device=dev),
                "deleted": dead,
            })
            row_counts.append(hi - lo - (0 if deleted is None else int(deleted[lo:hi].sum())))
        live = n if deleted is None else n - int(deleted.sum())
        self = cls(comms, kind, inner.metric, d, live, shards, merge_dtype=merge_dtype,
                   label=label, shard_stats={"rows": row_counts})
        self._rows_per_shard = r
        return self

    @classmethod
    def _shard_ivf(cls, comms, kind, inner, deleted, params, merge_dtype, label):
        from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

        mod = ivf_flat if kind == "ivf_flat" else ivf_pq
        params = params if params is not None else mod.SearchParams()
        names = (("centers", "list_data", "list_index", "list_sizes", "list_norms")
                 if kind == "ivf_flat" else
                 ("centers", "centers_rot", "list_codes", "list_index", "list_sizes",
                  "list_data", "list_y2"))
        arrays = {name: getattr(inner, name) for name in names}
        fills = {"list_index": -1, "list_sizes": 0, "list_norms": float("inf"),
                 "list_y2": float("inf")}
        per_cluster = kind == "ivf_pq" and inner.codebook_kind == "per_cluster"
        if per_cluster:
            arrays["codebook"] = inner.codebook
        stacks, stats = _partition_lists(arrays, fills, comms.get_size())
        n_main = int(inner.list_sizes.sum())
        shards = []
        for rank, dev in zip(comms.ranks(), comms.devices):
            p = {name: stack[rank].to(dev) for name, stack in stacks.items()}
            if kind == "ivf_flat":
                sub = ivf_flat.Index(inner.metric, p["centers"], p["list_data"],
                                     p["list_index"], p["list_sizes"], p["list_norms"])
            else:
                sub = ivf_pq.Index(
                    inner.metric, inner.codebook_kind, inner.pq_bits, p["centers"],
                    p["centers_rot"], inner.rotation.to(dev),
                    p["codebook"] if per_cluster else inner.codebook.to(dev),
                    p["list_codes"], p["list_index"], p["list_sizes"], p["list_data"],
                    p["list_y2"], scan_scale=inner.scan_scale)
            shards.append({
                "index": sub,
                # the global tombstones (IVF list ids are global)
                "deleted": (None if deleted is None else
                            Bitset.from_mask(torch.from_numpy(deleted[:n_main]), device=dev)),
            })
        live = n_main if deleted is None else n_main - int(deleted.sum())
        return cls(comms, kind, inner.metric, int(inner.dim), live, shards,
                   search_params=params, merge_dtype=merge_dtype, label=label,
                   shard_stats=stats)

    # -- search --------------------------------------------------------------
    def search(self, queries, k: int, *, sample_filter=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global (distances [q, k], ids [q, k]) over all shards, on the
        mesh's first device.

        ``sample_filter`` is an optional per-query :class:`RowFilter` over
        **global** ids (the ragged path's packed predicate words, given to
        every shard): the IVF legs fold the tombstones into it and pass it
        to their local search (list ids are global; on the card the
        query-major scan's per-query filter leg), the row legs re-base the
        global bits onto each shard's own rows."""
        queries = as_f32(queries, self.device)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"queries shape {tuple(queries.shape)} vs index dim {self.dim}")
        if sample_filter is not None and not isinstance(sample_filter, RowFilter):
            raise TypeError(
                "ShardedIndex.search expects a per-query RowFilter over global "
                f"ids, got {type(sample_filter).__name__}")
        k = int(k)
        params = self.search_params
        npb, pool = self._local_pool()
        kk = min(k, pool)
        if kk * self.n_shards < k:
            raise ValueError(
                f"k={k} exceeds the sharded candidate pool "
                f"{self.n_shards}x{kk}; raise n_probes or lower k"
            )
        t0 = time.perf_counter()
        with trace_range("serve.sharded_search") as sp:
            outs = self.comms.run(
                lambda rank, shard, q, filt: self._shard_search(shard, q, kk, npb, params,
                                                                filt),
                self.shards, replicated=(queries, sample_filter))
            vg = self.comms.allgather([o[0] for o in outs], axis=1)[0]
            ig = self.comms.allgather([o[1] for o in outs], axis=1)[0]
            # ONE cross-shard selection; ties resolve to the smallest global
            # id whatever the shard layout (the select_k kernel's stable leg)
            v, i = matrix.select_k_stable(vg.to(torch.float32), k,
                                          select_min=self.select_min, input_indices=ig)
            dt = time.perf_counter() - t0
            if sp is not None:
                # dispatch: enqueue of every shard's search and the merge
                # (the device wait lands in the caller's copy-out)
                sp.add_stage("dispatch", dt)
        _kernels.stamp_kernel_path("sharded")
        obs.default_registry().histogram(
            "raft_tpu_sharded_search_seconds",
            help="host-side dispatch latency of index-sharded searches "
            "(the shards of one card search in turn)",
        ).observe(dt, index=self.label, shards=str(self.n_shards))
        return v, i

    @property
    def n_shards(self) -> int:
        return self.comms.get_size()

    def _local_pool(self) -> Tuple[int, int]:
        """(n_probes_local, candidate pool per shard) from the layout."""
        if self.kind in ("brute_force", "cagra"):
            return 0, self._rows_per_shard
        sub = self.shards[0]["index"]
        npb = min(int(self.search_params.n_probes), sub.n_lists)
        return npb, npb * sub.list_cap

    def _shard_search(self, shard: dict, q: torch.Tensor, kk: int, npb: int, params,
                      sample_filter: Optional[RowFilter]):
        """One shard's (distances [q, kk], global ids [q, kk]), cast to the
        merge dtype; padding slots (+inf or -inf, id -1)."""
        dev = q.device
        dead = shard["deleted"]
        if self.kind in ("brute_force", "cagra"):
            from raft_tpu_torch.neighbors import brute_force

            sub, ids = shard["index"], shard["ids"]
            m = sub.size
            filt = None
            if sample_filter is not None:
                # re-base the global per-query bits onto this shard's rows
                mask = _rows_pass(sample_filter.words.to(dev), ids)
                filt = RowFilter.from_mask_rows(mask, device=dev)
            kj = min(kk, m)
            if kj:
                v, li = brute_force.search(sub, q, kj, sample_filter=filt, deleted_mask=dead,
                                           res=_res(dev))
                gi = torch.where(li >= 0, ids[torch.clamp(li, 0, max(m - 1, 0)).long()],
                                 torch.full_like(li, -1))
            else:
                v = torch.empty((q.shape[0], 0), dtype=torch.float32, device=dev)
                gi = torch.empty((q.shape[0], 0), dtype=torch.int32, device=dev)
        else:
            from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

            mod = ivf_flat if self.kind == "ivf_flat" else ivf_pq
            sp = dataclasses.replace(params, n_probes=npb)
            if sample_filter is not None:
                v, gi = mod.search(sp, shard["index"], q, kk,
                                   sample_filter=_fold(_on(sample_filter, dev), dead),
                                   res=_res(dev))
            else:
                v, gi = mod.search(sp, shard["index"], q, kk, deleted_mask=dead,
                                   res=_res(dev))
        worst = float("inf") if self.select_min else float("-inf")
        if v.shape[1] < kk:
            pad = kk - v.shape[1]
            v = torch.cat([v, torch.full((v.shape[0], pad), worst, device=dev)], 1)
            gi = torch.cat([gi, torch.full((gi.shape[0], pad), -1, dtype=gi.dtype,
                                           device=dev)], 1)
        if self.merge_dtype is not None:
            v = v.to(self.merge_dtype)
        return v, gi.to(torch.int32)

    # -- MutableIndex-compatible serving surface ----------------------------
    def pending_mutations(self) -> Tuple[int, int]:
        """(0, 0): a sharded layout is immutable; mutate the source index
        and hot-swap a re-shard through the registry."""
        return 0, 0

    def upsert(self, vectors, ids=None):
        """Loud failure for writes forwarded after a sharded rebuild."""
        raise NotImplementedError(
            "ShardedIndex is immutable: rebuild the source index, re-shard it "
            "and hot-swap the result"
        )

    def delete(self, ids):
        raise NotImplementedError(
            "ShardedIndex is immutable: rebuild the source index, re-shard it "
            "and hot-swap the result"
        )

    def _shard_tensors(self, shard: dict) -> List[torch.Tensor]:
        out = [t for t in vars(shard["index"]).values() if isinstance(t, torch.Tensor)]
        out += [t for t in (shard.get("ids"),) if t is not None]
        if shard["deleted"] is not None:
            out.append(shard["deleted"].words)
        return out

    def per_shard_bytes(self) -> list:
        """Bytes resident on each of this process's shards: its partition
        and its copies of the replicated sidecars (rotation, a shared
        codebook, the tombstones)."""
        return [sum(t.numel() * t.element_size() for t in self._shard_tensors(s))
                for s in self.shards]

    def device_bytes(self) -> int:
        """Total bytes across the shards (comparable with the unsharded
        index's footprint, plus the replicated sidecars)."""
        return sum(self.per_shard_bytes())

    def save(self, path: str) -> None:
        raise NotImplementedError(
            "ShardedIndex is a serving-time layout; snapshot the source "
            "index and re-shard on restore"
        )

    # -- observability -------------------------------------------------------
    def explain_contributions(self, ids) -> Dict[str, object]:
        """Per-shard counts of merged result ids — which shards the answer
        came from.  Deep-explain only (the ids are an already-copied host
        result).  Row-partitioned kinds own contiguous id ranges; the IVF
        kinds read a lazily built id → owner map."""
        try:
            flat = np.asarray(ids).reshape(-1)
            flat = flat[flat >= 0]
            s_count = self.n_shards
            if self.kind in ("brute_force", "cagra"):
                owner = flat // self._rows_per_shard
            else:
                owner_map = self._id_owner()
                flat = flat[flat < owner_map.shape[0]]
                owner = owner_map[flat]
            counts = np.bincount(owner[(owner >= 0) & (owner < s_count)], minlength=s_count)
            return {
                "available": True,
                "n_shards": s_count,
                "per_shard": [int(c) for c in counts[:s_count]],
            }
        except Exception as exc:  # never let explain break serving
            return {"available": False, "error": repr(exc)}

    def _id_owner(self) -> np.ndarray:
        """Cached global-id → owning-shard map of the IVF layouts (built
        once, deep-explain only)."""
        owner = getattr(self, "_owner_map", None)
        if owner is None:
            per = [(rank, s["index"].list_index.cpu().numpy().reshape(-1))  # raft-tpu: ignore[HOSTSYNC] deep-explain only: one-time owner-map pull
                   for rank, s in zip(self.comms.ranks(), self.shards)]
            top = max((int(li.max()) + 1 for _, li in per if li.size), default=0)
            owner = np.full(max(top, 0), -1, np.int32)
            for rank, li in per:
                owner[li[li >= 0]] = rank
            self._owner_map = owner
        return owner

    def _publish_shard_gauges(self) -> None:
        """Per-shard row / list / byte gauges — the imbalance dashboard."""
        reg = obs.default_registry()
        per_bytes = self.per_shard_bytes()
        rows = self._shard_stats.get("rows")
        lists = self._shard_stats.get("lists")
        for j, s in enumerate(self.comms.ranks()):
            labels = {"index": self.label, "shard": str(s)}
            if rows is not None:
                reg.gauge(
                    "raft_tpu_shard_rows",
                    help="live vectors owned by each index shard",
                ).set(float(rows[s]), **labels)
            if lists is not None:
                reg.gauge(
                    "raft_tpu_shard_lists",
                    help="IVF lists owned by each index shard",
                ).set(float(lists[s]), **labels)
            reg.gauge(
                "raft_tpu_shard_live_bytes",
                help="per-device bytes held by each index shard "
                "(its partition + replicated sidecars)",
            ).set(float(per_bytes[j]), **labels)

    def measure_shard_skew(self, queries, k: int) -> Dict[str, object]:
        """Per-shard time probe — straggler detection.  Runs each shard's
        local search alone (warmed, then timed to its completion) and
        publishes ``raft_tpu_shard_device_seconds{index,shard}`` and the
        max / mean factor ``raft_tpu_shard_device_skew{index}``.  Off the
        hot path (an operator / bench entry): its syncs never touch the
        batcher."""
        queries = as_f32(queries, self.device)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"queries shape {tuple(queries.shape)} vs index dim {self.dim}")
        npb, pool = self._local_pool()
        kk = min(int(k), pool)
        times = []
        with trace_range("serve.shard_skew"):
            for shard, dev in zip(self.shards, self.comms.devices):
                q = queries.to(dev)
                run = lambda: self._shard_search(shard, q, kk, npb, self.search_params, None)  # noqa: E731
                run()
                self.comms.sync_stream(q)
                t0 = time.perf_counter()
                run()
                self.comms.sync_stream(q)
                times.append(time.perf_counter() - t0)
        reg = obs.default_registry()
        for s, dt in zip(self.comms.ranks(), times):
            reg.gauge(
                "raft_tpu_shard_device_seconds",
                help="measured per-shard seconds for one probe search, "
                "dispatched alone",
            ).set(float(dt), index=self.label, shard=str(s))
        mean = sum(times) / len(times)
        skew = (max(times) / mean) if mean > 0.0 else 1.0
        reg.gauge(
            "raft_tpu_shard_device_skew",
            help="max/mean of the per-shard probe times — the straggler factor",
        ).set(float(skew), index=self.label)
        return {"per_shard_s": times, "skew": skew}


def _rows_pass(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[q, m] bool: each query's global pass bit of each of a shard's rows."""
    return RowFilter(words, words.shape[1] * 32).test_rows(
        ids[None, :].expand(words.shape[0], -1))


def _on(row_filter: RowFilter, dev: torch.device) -> RowFilter:
    """``row_filter`` with its tensors on ``dev``."""
    if row_filter.words.device == dev:
        return row_filter
    move = lambda t: None if t is None else t.to(dev)  # noqa: E731
    return RowFilter(row_filter.words.to(dev), row_filter.n_bits, fid=move(row_filter.fid),
                     table=move(row_filter.table), pass_count=row_filter.pass_count)


def _fold(row_filter: RowFilter, deleted: Optional[Bitset]) -> RowFilter:
    """The per-query filter with the tombstones cleared from every row (and
    from its descriptor table), over the ids both cover."""
    if deleted is None:
        return row_filter
    live = ~deleted.words.to(row_filter.words.device)
    nw = min(live.shape[0], row_filter.words.shape[1])
    words = row_filter.words.clone()
    words[:, :nw] &= live[:nw]
    table = row_filter.table
    if table is not None:
        table = table.clone()
        table[:, :nw] &= live[:nw]
    return RowFilter(words, row_filter.n_bits, fid=row_filter.fid, table=table,
                     pass_count=row_filter.pass_count)


def _infer_kind(index) -> str:
    mod = type(index).__module__.rsplit(".", 1)[-1]
    if mod not in ("brute_force", "ivf_flat", "ivf_pq", "cagra"):
        raise ValueError(
            f"cannot infer index kind from {type(index)!r}; pass a built "
            "brute_force/ivf_flat/ivf_pq/cagra index or a MutableIndex"
        )
    return mod


def _partition_lists(arrays: Dict[str, torch.Tensor], fills: Dict[str, float], s_count: int):
    """Round-robin the leading (list) axis of every array into [S, Lp, ...]
    stacks, padding with empty lists (sizes 0, ids -1, norms inf)."""
    l_total = arrays["list_index"].shape[0]
    groups = _round_robin(l_total, s_count)
    lp = max(len(g) for g in groups)
    out = {}
    for name, arr in arrays.items():
        stack = torch.full((s_count, lp) + tuple(arr.shape[1:]), fills.get(name, 0),
                           dtype=arr.dtype, device=arr.device)
        for s, g in enumerate(groups):
            if len(g):
                gi = torch.from_numpy(g).to(arr.device)
                stack[s, : len(g)] = arr[gi]
                if name == "centers" and len(g) < lp:
                    # padded slots re-use a real center: they may attract
                    # probes (wasting one) but their lists are empty, so
                    # every candidate they yield is (-1, worst) — harmless
                    stack[s, len(g):] = arr[gi[0]]
        out[name] = stack
    sizes = arrays["list_sizes"].cpu().numpy()
    stats = {
        "lists": [len(g) for g in groups],
        "rows": [int(sizes[g].sum()) for g in groups],
    }
    return out, stats


def shard_index(index, comms: Optional[Comms] = None, **kwargs) -> ShardedIndex:
    """Convenience alias for :meth:`ShardedIndex.from_index`."""
    return ShardedIndex.from_index(index, comms, **kwargs)
