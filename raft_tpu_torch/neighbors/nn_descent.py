"""NN-descent kNN graphs (counterpart of ``raft_tpu.neighbors.nn_descent``):
the in-memory build, the out-of-core batch build, and the exact graph of
CAGRA's ``build_algo="brute_force"``.

One iteration is raft_tpu's three static-shape stages over the current
graph [n, k]:

1. **sample**: ``sample`` random neighbours of each row (``cols`` [n, s],
   slots of its list);
2. **expand**: the candidates of a row are its samples' neighbour lists
   [s·k] and a reverse-edge sample [s]: edge u → v lands in slot
   ``slot[u, j]`` of v's bucket;
3. **merge**: exact distances of each row to its candidates (a gather of
   their rows and a batched product, f32 with TF32 off), then the merge
   with the current list: sorted-id dedup, repeats and −1 demoted to +inf,
   and ``select_k`` with the ids as ``input_indices`` (the select_k kernel
   on the card).

An iteration is a function of its draws (:func:`nn_descent_iter` takes
``cols`` and ``slot``; :func:`init_graph` the random initial ids), so a test
can feed it raft_tpu's threefry draws.  The build draws them from a
``torch.Generator`` seeded with ``params.seed`` on the dataset's device:
two builds with one seed give the same graph, but not raft_tpu's (the
build is held to graph recall, not ids).

The reverse-edge sample is a scatter whose targets repeat.  raft_tpu
writes it with ``rev.at[tgt, slot].set(src, mode="drop")``, which XLA on
the CPU applies in row-major edge order, so the last edge wins.  CUDA's
``index_put_`` with repeats is nondeterministic, so the port states that
rule itself: each bucket keeps the edge of the largest row-major position
(``scatter_reduce("amax")`` of the positions, then a gather), on either
device.

Rows are processed in tiles sized as raft_tpu sizes them: ``[tile, c, d]``
gathered candidate rows fit ``res.workspace_rows(4 c (d + 4))`` (at most
4,096 rows).  raft_tpu's last tile repeats row n − 1 to fill its static
shape and so counts that row's updates more than once; the port counts each
row once (the count only decides the early exit).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, as_f32, ensure, from_numpy, to_numpy
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.neighbors._common import sorted_id_dedup, subsample_trainset
from raft_tpu_torch.ops.matrix import select_k_untraced as select_k

_INF = float("inf")


@dataclass
class IndexParams:
    """raft_tpu's (raft's ``nn_descent`` index_params)."""

    graph_degree: int = 64
    intermediate_graph_degree: int = 128
    max_iterations: int = 20
    termination_threshold: float = 0.0001
    metric: str = "sqeuclidean"
    sample_size: int = 0  # 0 → auto (min(deg, 16))
    seed: int = 0


@dataclass
class Index:
    """A kNN graph: neighbour ids and their distances, nearest first.
    ``updates``: the new ids each NN-descent iteration brought in, one entry
    per iteration run (empty for the exact graph)."""

    graph: torch.Tensor       # [n, graph_degree] int32
    distances: torch.Tensor   # [n, graph_degree] f32
    updates: List[int] = field(default_factory=list)


def _dataset(dataset, device: torch.device) -> torch.Tensor:
    """The rows in their own dtype on ``device`` (gathers cast to f32)."""
    t = from_numpy(dataset) if isinstance(dataset, np.ndarray) else torch.as_tensor(dataset)
    return t.to(device)


def _sqnorms(x: torch.Tensor) -> torch.Tensor:
    """|x_i|^2 of every row, f32."""
    x = x.to(torch.float32)
    return (x * x).sum(dim=1)


def _row_distance(x: torch.Tensor, cand: torch.Tensor, metric: str,
                  x2: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """dist(x[i], cand[i, j]) for x [t, d] and cand [t, c, d] (f32), with
    their squared norms ``x2`` [t] and ``c2`` [t, c] (raft_tpu's
    ``_row_distance``; the norms are each row's, summed once)."""
    ip = torch.bmm(cand, x[:, :, None])[:, :, 0]
    if metric == "inner_product":
        return -ip
    if metric == "cosine":
        xn = torch.clamp(torch.sqrt(x2), min=1e-12)
        cn = torch.clamp(torch.sqrt(c2), min=1e-12)
        return 1.0 - ip / (xn[:, None] * cn)
    return torch.clamp(x2[:, None] + c2 - 2.0 * ip, min=0.0)


def _merge_dedup(ids_a: torch.Tensor, dists_a: torch.Tensor, ids_b: torch.Tensor,
                 dists_b: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge two candidate lists per row, keep the first copy of each id,
    and return the k nearest: (ids [n, k], dists [n, k], the number of
    (row, slot) pairs where a finite new id entered, as a 0-d tensor).
    Repeats and id −1 are demoted to +inf and stay selectable as pads
    (raft_tpu's ``_merge_dedup``)."""
    ids = torch.cat([ids_a, ids_b], dim=1).to(torch.int32)
    dists = torch.cat([dists_a, dists_b], dim=1)
    order, dup = sorted_id_dedup(ids)
    ids_s = torch.gather(ids, 1, order)
    dists_s = torch.gather(dists, 1, order)
    dists_s = torch.where(dup | (ids_s < 0), torch.full_like(dists_s, _INF), dists_s)
    vals, idx = select_k(dists_s, k, select_min=True, input_indices=ids_s)
    was_present = (idx[:, :, None] == ids_a[:, None, :]).any(dim=2)
    new_mask = (vals < _INF) & ~was_present
    return idx, vals, new_mask.sum()


def reverse_sample(graph_ids: torch.Tensor, slot: torch.Tensor, sample: int) -> torch.Tensor:
    """The reverse-edge sample [n, sample] int32: edge u → v = graph_ids[u, j]
    (v ≥ 0) is written to ``rev[v, slot[u, j]]``; where edges collide the
    last in row-major order wins (XLA's CPU order for raft_tpu's scatter),
    on any device; empty buckets hold −1."""
    n, k = graph_ids.shape
    tgt = graph_ids.reshape(-1).long()
    valid = tgt >= 0
    cell = (tgt * sample + slot.reshape(-1).long())[valid]
    pos = torch.arange(n * k, device=graph_ids.device)[valid]
    win = torch.full((n * sample,), -1, dtype=torch.long, device=graph_ids.device)
    win = win.scatter_reduce(0, cell, pos, reduce="amax", include_self=True)
    return torch.where(win >= 0, win // k, torch.full_like(win, -1)).view(n, sample).to(torch.int32)


def _tile_rows(res: Resources, n: int, c: int, d: int) -> int:
    """raft_tpu's tile: the [tile, c, d] gather fits the workspace."""
    return max(1, min(n, res.workspace_rows(4 * c * (d + 4), cap=4096)))


def nn_descent_iter(dataset: torch.Tensor, graph_ids: torch.Tensor, graph_dists: torch.Tensor,
                    cols: torch.Tensor, slot: torch.Tensor, metric: str, tile: int,
                    norms: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One NN-descent iteration from its draws: ``cols`` [n, s] (the sampled
    slots of each row's list) and ``slot`` [n, k] (each edge's reverse
    bucket).  Every tile reads the iteration's starting graph, so tiles are
    independent.  Returns (ids [n, k] int32, dists [n, k] f32, updates)."""
    n, k = graph_ids.shape
    dev = graph_ids.device
    sample = cols.shape[1]
    norms = _sqnorms(dataset) if norms is None else norms
    smp = torch.gather(graph_ids, 1, cols.long().to(dev))
    rev = reverse_sample(graph_ids, slot.to(dev), sample)
    out_i = torch.empty_like(graph_ids)
    out_d = torch.empty_like(graph_dists)
    updates = torch.zeros((), dtype=torch.long, device=dev)
    for r0 in range(0, n, tile):
        rows = torch.arange(r0, min(r0 + tile, n), device=dev)
        t = rows.shape[0]
        two_hop = graph_ids[smp[r0:r0 + t].long().clamp(0, n - 1)].reshape(t, -1)
        cand = torch.cat([two_hop, rev[r0:r0 + t]], dim=1)
        cand = torch.where(cand == rows[:, None].to(cand.dtype), torch.full_like(cand, -1), cand)
        safe = cand.long().clamp(0, n - 1)
        vecs = dataset[safe].to(torch.float32)
        d = _row_distance(dataset[r0:r0 + t].to(torch.float32), vecs, metric,
                          norms[r0:r0 + t], norms[safe])
        del vecs
        d = torch.where(cand < 0, torch.full_like(d, _INF), d)
        m_i, m_d, nu = _merge_dedup(graph_ids[r0:r0 + t], graph_dists[r0:r0 + t], cand, d, k)
        out_i[r0:r0 + t] = m_i
        out_d[r0:r0 + t] = m_d
        updates += nu
    return out_i, out_d, int(updates)


def init_graph(dataset: torch.Tensor, init: torch.Tensor, metric: str, k: int, tile: int,
               norms: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The starting graph from random ids ``init`` [n, k] (raft_tpu's
    ``_init_graph``): a row's own id is moved to the next row, the ids are
    scored, and repeats are merged away (by tiles of ``tile`` rows)."""
    n = dataset.shape[0]
    dev = dataset.device
    norms = _sqnorms(dataset) if norms is None else norms
    init = init.to(device=dev, dtype=torch.int32)
    ar = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    init = torch.where(init == ar, (init + 1) % n, init)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    for r0 in range(0, n, tile):
        ids = init[r0:r0 + tile]
        t = ids.shape[0]
        safe = ids.long()
        d = _row_distance(dataset[r0:r0 + t].to(torch.float32), dataset[safe].to(torch.float32),
                          metric, norms[r0:r0 + t], norms[safe])
        m_i, m_d, _ = _merge_dedup(ids, d, torch.full_like(ids, -1),
                                   torch.full_like(d, _INF), k)
        out_i[r0:r0 + t] = m_i
        out_d[r0:r0 + t] = m_d
    return out_i, out_d


def _draw(gen: torch.Generator, high: int, shape, device: torch.device) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=gen, device=device, dtype=torch.int32)


def _descend(gen: torch.Generator, dataset: torch.Tensor, *, metric: str, k: int, sample: int,
             tile: int, iters: int, stop_at: Optional[float]):
    """Draw the starting graph, then up to ``iters`` iterations, stopping
    after one whose updates are at most ``stop_at`` (None: never)."""
    n = dataset.shape[0]
    dev = dataset.device
    norms = _sqnorms(dataset)
    ids, dists = init_graph(dataset, _draw(gen, n, (n, k), dev), metric, k, tile, norms)
    updates = []
    for _ in range(iters):
        cols = _draw(gen, k, (n, sample), dev)
        slot = _draw(gen, sample, (n, k), dev)
        ids, dists, upd = nn_descent_iter(dataset, ids, dists, cols, slot, metric, tile, norms)
        updates.append(upd)
        if stop_at is not None and upd <= stop_at:
            break
    return ids, dists, updates


def gnnd_fixed(seed: int, dataset, *, metric: str, k: int, sample: int, tile: int,
               iters: int, res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration NN-descent with no early exit (raft_tpu's per-batch
    worker of its sharded CAGRA build, which needs one uniform program):
    (ids [n, k], dists [n, k])."""
    ds = _dataset(dataset, ensure(res).device)
    gen = torch.Generator(device=ds.device).manual_seed(int(seed))
    ids, dists, _ = _descend(gen, ds, metric=DISTANCE_TYPES[metric], k=k, sample=sample,
                             tile=tile, iters=iters, stop_at=None)
    return ids, dists


@traced("nn_descent.build")
def build(params: IndexParams, dataset, *, res: Optional[Resources] = None) -> Index:
    """Build an approximate kNN graph by NN-descent iterations, stopping
    early once an iteration brings in at most ``termination_threshold · n ·
    k`` new ids."""
    res = ensure(res)
    ds = _dataset(dataset, res.device)
    n, d = ds.shape
    metric = DISTANCE_TYPES[params.metric]
    k = min(params.intermediate_graph_degree, n - 1)
    sample = params.sample_size or min(k, 16)
    tile = _tile_rows(res, n, sample * k + sample, d)
    gen = torch.Generator(device=ds.device).manual_seed(int(params.seed))
    ids, dists, updates = _descend(gen, ds, metric=metric, k=k, sample=sample, tile=tile,
                                   iters=params.max_iterations,
                                   stop_at=params.termination_threshold * n * k)
    deg = min(params.graph_degree, k)
    return Index(graph=ids[:, :deg].contiguous(), distances=dists[:, :deg].contiguous(),
                 updates=updates)


# ---------------------------------------------------------------------------
# the out-of-core batch build


@traced("nn_descent.build_batch")
def build_batch(params: IndexParams, dataset: np.ndarray, *, n_clusters: int = 0,
                max_cluster_rows: int = 65_536, res: Optional[Resources] = None) -> Index:
    """Out-of-core NN-descent for datasets larger than device memory
    (raft_tpu's ``build_batch``): balanced-k-means clustering, each row
    assigned to its two nearest clusters, the in-memory build per cluster
    padded to one row count with far sentinel rows, and each local graph
    merged into a host-resident global graph.  Peak device memory is one
    padded cluster and its local graph, whatever n.  ``dataset`` is a host
    array (a memmap works); L2 metrics only."""
    res = ensure(res)
    dataset = np.asarray(dataset)
    plan = plan_batches(params, dataset, n_clusters=n_clusters,
                        max_cluster_rows=max_cluster_rows, res=res)
    if plan is None:
        return build(params, dataset, res=res)
    return _run_batches(params, dataset, plan, res)


def _local_params(params: IndexParams, k_out: int, rows: int) -> IndexParams:
    return replace(params, graph_degree=k_out,
                   intermediate_graph_degree=min(params.intermediate_graph_degree, rows - 1))


def _top2(xt: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The two nearest centres of each row (L2 score, lowest column wins a
    tie)."""
    c2 = (centers * centers).sum(dim=1)
    sc = c2[None, :] - 2.0 * torch.matmul(xt, centers.T)
    return select_k(sc, 2, select_min=True)[1]


def plan_batches(params: IndexParams, dataset: np.ndarray, *, n_clusters: int = 0,
                 max_cluster_rows: int = 65_536, force: bool = False,
                 res: Optional[Resources] = None):
    """The host half of the batch build (raft_tpu's ``plan_batches``):
    balanced-k-means clustering (re-split with more clusters while the
    top-2 assignment leaves one over ``max_cluster_rows``), the rows of each
    cluster, and one padded batch shape.  Returns the plan dict, or None
    when one cluster suffices (unless ``force``)."""
    from raft_tpu_torch.cluster import kmeans_balanced

    metric = DISTANCE_TYPES[params.metric]
    if metric not in ("sqeuclidean", "euclidean"):
        # a far sentinel has no inner-product / cosine analog: under -ip it
        # would be every row's best neighbour
        raise ValueError(f"batch GNND supports L2 metrics, got {params.metric}")
    res = ensure(res)
    n, d = dataset.shape
    n_clusters = n_clusters or max(1, -(-2 * n // max_cluster_rows))
    if n_clusters <= 1:
        if not force:
            return None
        k_out = min(params.graph_degree, params.intermediate_graph_degree, n - 1)
        return {"batches": [np.arange(n, dtype=np.int64)], "pad_m": n,
                "sentinel": np.zeros((d,), np.float32), "k_out": k_out,
                "local_params": _local_params(params, k_out, n)}

    kb = kmeans_balanced.KMeansBalancedParams(n_iters=10, metric="sqeuclidean",
                                              seed=params.seed)
    for _ in range(3):
        n_train = min(n, max(n_clusters * 64, 16_384))
        train = subsample_trainset(dataset, n_train, params.seed) if n_train < n else dataset
        centers = kmeans_balanced.fit(kb, np.asarray(train, np.float32), n_clusters, res=res)
        tile = max(1, res.workspace_rows(4 * (n_clusters + d), cap=1 << 17))
        top2 = np.empty((n, 2), np.int32)
        absmax = 0.0
        for s in range(0, n, tile):
            xt = np.asarray(dataset[s:s + tile], np.float32)
            absmax = max(absmax, float(np.abs(xt).max()))
            top2[s:s + tile] = to_numpy(_top2(as_f32(xt, res.device), centers))
        counts = np.bincount(top2.reshape(-1), minlength=n_clusters)
        if int(counts.max()) <= max_cluster_rows or n_clusters >= n:
            break
        n_clusters = min(n, int(np.ceil(n_clusters * counts.max() / max_cluster_rows * 1.25)))

    flat = top2.reshape(-1)
    rows_of = np.repeat(np.arange(n, dtype=np.int64), 2)
    order = np.argsort(flat, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    pad_m = int(min(n, -(-int(counts.max()) // 1024) * 1024,
                    -(-max_cluster_rows // 1024) * 1024))
    # far sentinel from the dataset-wide peak
    sentinel = np.full((d,), 4.0 * (absmax + 1.0) * max(1.0, np.sqrt(d)), np.float32)
    k_out = min(params.graph_degree, params.intermediate_graph_degree, pad_m - 1, n - 1)
    batches = []
    for cid in range(n_clusters):
        all_rows = rows_of[order[starts[cid]:starts[cid + 1]]]
        for cs in range(0, all_rows.shape[0], pad_m):
            chunk = all_rows[cs:cs + pad_m]
            if chunk.shape[0]:
                batches.append(chunk)
    return {"batches": batches, "pad_m": pad_m, "sentinel": sentinel, "k_out": k_out,
            "local_params": _local_params(params, k_out, pad_m)}


def pad_batch(dataset: np.ndarray, rows: np.ndarray, plan) -> np.ndarray:
    """One batch at the plan's padded shape (sentinel rows fill the tail)."""
    m = rows.shape[0]
    xc = np.empty((plan["pad_m"], dataset.shape[1]), np.float32)
    xc[:m] = dataset[rows]
    xc[m:] = plan["sentinel"]
    return xc


def merge_local_graph(g_ids: np.ndarray, g_dists: np.ndarray, rows: np.ndarray, li, ld,
                      plan) -> None:
    """Fold one batch's local graph into the host-resident global graph:
    local ids become global row ids, padding neighbours −1, and the merge
    keeps the best copy of a row met in both of its clusters.  Mutates
    ``g_ids`` / ``g_dists``; the merge runs on the local graph's device."""
    pad_m, k_out = plan["pad_m"], plan["k_out"]
    m = rows.shape[0]
    device = li.device if isinstance(li, torch.Tensor) else torch.device("cpu")
    li = to_numpy(li) if isinstance(li, torch.Tensor) else np.asarray(li)
    ld = to_numpy(ld) if isinstance(ld, torch.Tensor) else np.asarray(ld)
    gi_cand = np.full((pad_m, k_out), -1, np.int32)
    gi_cand[:m] = np.where((li[:m] >= 0) & (li[:m] < m), rows[np.clip(li[:m], 0, m - 1)], -1)
    ld = np.where(gi_cand >= 0, ld, np.inf).astype(np.float32)
    old_i = np.full((pad_m, k_out), -1, np.int32)
    old_d = np.full((pad_m, k_out), np.inf, np.float32)
    old_i[:m] = g_ids[rows]
    old_d[:m] = g_dists[rows]
    on = functools.partial(torch.as_tensor, device=device)
    mi, md, _ = _merge_dedup(on(old_i), on(old_d), on(gi_cand), on(ld), k_out)
    g_ids[rows] = to_numpy(mi)[:m]
    g_dists[rows] = to_numpy(md)[:m]


def finalize_global_graph(g_ids: np.ndarray, g_dists: np.ndarray) -> Index:
    """Drop self edges (possible through a row's two clusters) and sort each
    row by distance (host tensors)."""
    n = g_ids.shape[0]
    self_col = g_ids == np.arange(n, dtype=np.int32)[:, None]
    g_dists = np.where(self_col, np.inf, g_dists)
    g_ids = np.where(self_col, -1, g_ids)
    order2 = np.argsort(g_dists, axis=1, kind="stable")
    g_ids = np.take_along_axis(g_ids, order2, axis=1)
    g_dists = np.take_along_axis(g_dists, order2, axis=1)
    return Index(graph=torch.from_numpy(np.ascontiguousarray(g_ids, np.int32)),
                 distances=torch.from_numpy(np.ascontiguousarray(g_dists, np.float32)))


def _run_batches(params: IndexParams, dataset: np.ndarray, plan, res: Resources) -> Index:
    """The batches one after another, one padded cluster on the device at
    a time."""
    n = dataset.shape[0]
    k_out = plan["k_out"]
    g_ids = np.full((n, k_out), -1, np.int32)
    g_dists = np.full((n, k_out), np.inf, np.float32)
    for rows in plan["batches"]:
        local = build(plan["local_params"], pad_batch(dataset, rows, plan), res=res)
        merge_local_graph(g_ids, g_dists, rows, local.graph, local.distances, plan)
        del local
    out = finalize_global_graph(g_ids, g_dists)
    return Index(graph=out.graph.to(res.device), distances=out.distances.to(res.device))


# ---------------------------------------------------------------------------
# the exact graph


def build_exact(dataset, graph_degree: int, metric: str = "sqeuclidean", *,
                res: Optional[Resources] = None) -> Index:
    """The exact kNN graph: ``brute_force.knn`` of every row against the
    dataset for ``graph_degree + 1`` neighbours, then the row's own id
    dropped wherever it ranked (the last column when it did not appear)."""
    res = ensure(res)
    x = as_f32(dataset, res.device)
    dists, ids = brute_force.knn(x, x, graph_degree + 1, metric=metric, res=res)
    self_col = ids == torch.arange(x.shape[0], dtype=ids.dtype, device=ids.device)[:, None]
    order = torch.sort(self_col.to(torch.uint8), dim=1, stable=True).indices
    ids = torch.gather(ids, 1, order)[:, :graph_degree]
    dists = torch.gather(dists, 1, order)[:, :graph_degree]
    return Index(graph=ids, distances=dists)
