"""CAGRA: graph index, build + batched beam search (counterpart of
``raft_tpu.neighbors.cagra``; dense f32 / bf16 / int8 / uint8 datasets).

Build: a kNN graph of ``intermediate_graph_degree`` neighbours per row —
IVF-PQ search of every row for ``gpu_top_k = 2 (inter + 1)`` candidates,
refined exactly to ``inter + 1`` (``build_algo="ivf_pq"``), the exact
graph (``"brute_force"``), or NN-descent (``"nn_descent"``, in memory;
``"nn_descent_batch"``, out of core: ``neighbors.nn_descent``) — then
``optimize``: the detour-count prune to
``graph_degree``, reverse edges, and the merge of the two; last a coarse
entry-point table (a small balanced k-means and the dataset row nearest
each centre).  ``"auto"`` takes the exact graph up to 131,072 rows on a
CUDA device and 8,192 rows on the CPU (raft_tpu reads its accelerator's
backend the same way), IVF-PQ above.

Search: per query tile, a seed buffer from the entry points and random
rows (:func:`make_seed_ids`, :func:`traverse_init`), then exactly
``max_iter`` hops (:func:`traverse_steps`): each picks the ``search_width``
best unexplored parents and runs one hop.  On the card the whole walk of a
tile is one launch (``kernels.cagra_traverse.cagra_traverse_steps``, the
``cagra_traverse`` kernel); CPU tensors take its plain version, the loop of
:func:`pick_parents` and ``cagra_fused_hop_torch``.  raft_tpu's loop stops
early once no query of the tile has an unexplored finite slot; every
further hop is a no-op, so the fixed trip count gives the same results (the
kernel stops a query's walk where its frontier ends).

Filtered search (``sample_filter`` / ``deleted_mask``) is raft_tpu's XLA
body (``cagra.py:572-737``), as raft_tpu keeps its fused hop off filtered
traffic: the traversal stays unfiltered, and a result buffer of the best
k filter-passing candidates, with its own membership mask, is merged every
hop (:func:`traverse_steps_filtered`); ``itopk`` is widened by the
inverse pass rate (:func:`filtered_itopk`).  Its hops are PyTorch ops and
``select_k`` (the select_k kernel on the card up to k = 2048, a sort past
it).

Random seed ids come from a ``torch.Generator`` seeded with
``rand_xor_mask & 0x7FFFFFFF``, not raft_tpu's threefry: compare searches
of the two packages by passing ``seed_ids``.  ``save`` / ``load`` use
raft_tpu's file format (kind "cagra", version 1).

Paged datasets (``store.paginate_index``; ``dataset`` is then a host
tensor): the beam search gathers rows the graph decides, so ``search`` pins
the whole payload in the device pool once (``BudgetExceeded`` when the pool
is smaller) and reads rows through a ``store.PagedRows`` page table — the
hop's paged leg unfiltered, ``PagedRows.decode`` in :func:`traverse_init`
and the filtered body — bitwise equal to the dense search.

int8 / uint8 datasets (BIGANN's rows are uint8) stay 1 byte a value in the
index, as in raft_tpu: the graph build reads them as its brute-force and
IVF-PQ stages read any rows (an f32 copy inside ``brute_force.knn``; the
IVF-PQ build, its searches and the refine convert tiles of rows), and the
walk reads 8-bit rows on the hop kernel's 8-bit legs, each value converted
exactly to f32 where it is staged.

VPQ-compressed datasets (:func:`compress`, ``neighbors.vpq_dataset``):
the search decodes the candidate rows it gathers.  raft_tpu keeps such a
dataset on its XLA body, off the fused hop; the port walks it on the plain
walk (:func:`cagra_traverse_steps_torch` over decoded rows) and stamps
``kernel_path`` "torch".  ``save`` / ``load`` write and read raft_tpu's
"vpq" dataset kind.

``EffortSpec`` holds the search's effort knobs (``itopk_size``,
``search_width``).  hnswlib export and search are ``neighbors.hnsw``; the
sharded graph mode is not ported (ROADMAP Queue 1 item 7b).
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.bitset import RowFilter
from raft_tpu_torch.core.resources import Resources, as_f32, ensure, from_numpy
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES
from raft_tpu_torch.kernels import stamp_kernel_path
from raft_tpu_torch.kernels import cagra_traverse as _ct
from raft_tpu_torch.kernels.cagra_traverse import (
    cagra_traverse_steps,
    cagra_traverse_steps_torch,
    gather_rows,
)
from raft_tpu_torch.neighbors import brute_force, ivf_pq, nn_descent, vpq_dataset
from raft_tpu_torch.neighbors._common import (
    invalid_mask,
    postprocess,
    resolve_pass_filter,
    sorted_id_dedup,
    subsample_trainset,
)
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.ops.matrix import select_k_untraced as select_k
from raft_tpu_torch.store.paged import PagedRows

_SERIALIZATION_VERSION = 1
_METRICS = ("sqeuclidean", "euclidean", "inner_product")
_ROADMAP = "ROADMAP Queue 1 item 3, CAGRA leftovers"


@dataclass
class IndexParams:
    """raft's defaults.  ``entry_points``: size of the coarse entry-point
    table, ``None`` → auto (about 4·√n, a power of two in [64, 4096]),
    ``0`` → none (random seeds only).  ``nn_descent_niter``: the
    iterations of the NN-descent builds."""

    metric: str = "sqeuclidean"
    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    #: auto | ivf_pq | brute_force | nn_descent | nn_descent_batch
    build_algo: str = "auto"
    nn_descent_niter: int = 20
    seed: int = 0
    entry_points: Optional[int] = None


@dataclass
class SearchParams:
    """``num_entry_centers``: coarse entry points seeding each query's
    buffer (0: random seeds only); ``max_iterations`` 0 → auto (itopk /
    width, at least 8, with entry points; twice that, at least 16,
    without).  ``min_iterations`` is accepted for raft_tpu compatibility
    and has no effect: the search runs exactly ``max_iterations`` hops, and
    a hop past the frontier's end changes nothing."""

    max_queries: int = 0          # 0 → auto query tile
    itopk_size: int = 64
    max_iterations: int = 0
    search_width: int = 1
    min_iterations: int = 0
    rand_xor_mask: int = 0x128394
    num_random_samplings: int = 1
    num_entry_centers: int = 16


@dataclass(frozen=True)
class EffortSpec:
    """The search-effort knobs of CAGRA (raft_tpu's ``EffortSpec``; see
    ``ivf_flat.EffortSpec``): the buffer ``itopk_size`` and the parents a
    hop ``search_width``.  Stepping down moves ``itopk_size`` only."""

    itopk_size: int = 64
    search_width: int = 1

    backend: ClassVar[str] = "cagra"

    @classmethod
    def from_params(cls, params: Optional[SearchParams] = None, **extra) -> "EffortSpec":
        base = params if params is not None else SearchParams()
        return cls(itopk_size=int(base.itopk_size), search_width=int(base.search_width))

    def apply(self, params: Optional[SearchParams] = None) -> SearchParams:
        base = params if params is not None else SearchParams()
        return dc_replace(base, itopk_size=int(self.itopk_size),
                          search_width=int(self.search_width))

    def degraded(self, level: int) -> "EffortSpec":
        """``level`` notches down: ``itopk_size`` halved per level (at least 32)."""
        if level <= 0:
            return self
        return EffortSpec(itopk_size=max(32, int(self.itopk_size) >> int(level)),
                          search_width=int(self.search_width))

    def knobs(self):
        return {"itopk_size": int(self.itopk_size), "search_width": int(self.search_width)}


class Index:
    """Dataset [n, d] (f32, bf16, int8 or uint8, or a
    ``vpq_dataset.VpqDataset``), graph [n, degree] int32, and the optional
    entry-point table: centres [c, d] f32 and the id of the dataset row
    nearest each."""

    def __init__(self, metric: str, dataset: torch.Tensor, graph: torch.Tensor,
                 entry_centers: Optional[torch.Tensor] = None,
                 entry_ids: Optional[torch.Tensor] = None):
        self.metric = metric
        self.dataset = dataset
        self.graph = graph
        self.entry_centers = entry_centers
        self.entry_ids = entry_ids
        #: the store.TieredStore of a paged index (store.paginate_index)
        self.paged = None

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]


@traced("cagra.compress")
def compress(index: Index, params: Optional[vpq_dataset.VpqParams] = None, *,
             res: Optional[Resources] = None) -> Index:
    """The index with its dense dataset replaced by a VPQ-compressed one
    (``vpq_dataset.build``); searches then decode the rows they gather and
    distances become approximate."""
    if isinstance(index.dataset, vpq_dataset.VpqDataset):
        raise ValueError("index dataset is already compressed")
    if index.paged is not None:
        raise ValueError("a paged index cannot be compressed; compress the dense index")
    ds = vpq_dataset.build(params or vpq_dataset.VpqParams(), index.dataset, res=res)
    return Index(index.metric, ds, index.graph, index.entry_centers, index.entry_ids)


def _as_dataset(dataset, device: torch.device) -> torch.Tensor:
    """The dataset as the index keeps it, in its own dtype (raft_tpu keeps
    f32 / bf16 / int8 / uint8 rows; the search converts gathered rows only):
    f64 becomes f32, other types raise."""
    t = from_numpy(dataset) if isinstance(dataset, np.ndarray) else torch.as_tensor(dataset)
    if t.dtype in (torch.bfloat16, torch.int8, torch.uint8, torch.float32):
        return t.to(device)
    if t.dtype == torch.float64:
        return t.to(device=device, dtype=torch.float32)
    raise NotImplementedError(f"CAGRA datasets of {t.dtype} are not ported ({_ROADMAP})")


def _check_metric(metric: str) -> str:
    canonical = DISTANCE_TYPES[metric]
    if canonical not in _METRICS:
        raise ValueError(f"cagra supports L2/IP metrics, got {metric}")
    return canonical


# ---------------------------------------------------------------------------
# graph optimization


def _prune_detourable(graph: torch.Tensor, out_degree: int, tile: int) -> torch.Tensor:
    """Detour-count prune.  Edge u → v = g[u, j] is detourable through
    w = g[u, i], i < j, when v is also in w's list; edges are ranked by
    (detour count, original rank) and the best ``out_degree`` kept.  Tiles
    of ``tile`` rows bound the [tile, K, K, K] membership tensor."""
    n, K = graph.shape
    earlier = torch.triu(torch.ones((K, K), dtype=torch.bool, device=graph.device), 1)
    out = torch.empty((n, out_degree), dtype=torch.int32, device=graph.device)
    for s in range(0, n, tile):
        g = graph[s:s + tile]
        hop2 = graph[g.long().clamp(0, n - 1)]                            # [t, K(i), K(l)]
        match = (hop2[:, :, :, None] == g[:, None, None, :]).any(dim=2)   # [t, i, j]
        detour = (match & earlier).sum(dim=1)                             # [t, j]
        detour = torch.where(g < 0, torch.full_like(detour, K + 1), detour)
        order = torch.sort(detour, dim=1, stable=True).indices[:, :out_degree]
        out[s:s + tile] = torch.gather(g, 1, order)
    return out


def _reverse_graph(graph: torch.Tensor, rev_cap: int) -> torch.Tensor:
    """Reverse-edge lists, up to ``rev_cap`` per row in source order, by one
    stable sort of the edges by target."""
    n, D = graph.shape
    dev = graph.device
    src = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, D).reshape(-1)
    tgt = graph.reshape(-1)
    tgt_s, order = torch.sort(tgt, stable=True)
    src_s = src[order]
    first = torch.searchsorted(tgt_s, tgt_s, side="left")
    pos = torch.arange(n * D, device=dev) - first
    valid = (tgt_s >= 0) & (pos < rev_cap)
    rev = torch.full((n, rev_cap), -1, dtype=torch.int32, device=dev)
    rev[tgt_s[valid].long(), pos[valid]] = src_s[valid]
    return rev


def _merge_forward_reverse(forward: torch.Tensor, reverse: torch.Tensor) -> torch.Tensor:
    """Final edge list: the best forward half first, then reverse edges,
    then the weaker forward edges; repeats and -1 dropped keeping order;
    rows left short are filled from the forward list."""
    n, D = forward.shape
    prot = (D + 1) // 2
    cand = torch.cat([forward[:, :prot], reverse, forward[:, prot:]], dim=1)
    m = cand.shape[1]
    order, dup_s = sorted_id_dedup(cand)
    dup = torch.zeros((n, m), dtype=torch.bool, device=cand.device).scatter(1, order, dup_s)
    bad = dup | (cand < 0)
    ar = torch.arange(m, device=cand.device)
    prio = torch.where(bad, m + ar, ar)
    keep = torch.sort(prio, dim=1, stable=True).indices[:, :D]
    out = torch.gather(cand, 1, keep)
    return torch.where(out < 0, forward, out)


@traced("cagra.optimize")
def optimize(knn_graph, out_degree: int, *, res: Optional[Resources] = None) -> torch.Tensor:
    """Prune a kNN graph (rows sorted by distance) to a ``out_degree``
    CAGRA search graph: the detour-count prune, reverse edges, merge."""
    res = ensure(res)
    g = torch.as_tensor(knn_graph).to(device=res.device, dtype=torch.int32)
    n, K = g.shape
    if out_degree > K:
        raise ValueError(f"out_degree {out_degree} > input degree {K}")
    tile = max(1, min(n, res.workspace_rows(K * K * K, cap=256)))
    pruned = _prune_detourable(g, out_degree, tile)
    return _merge_forward_reverse(pruned, _reverse_graph(pruned, out_degree))


# ---------------------------------------------------------------------------
# build


def _build_entry_points(dataset: torch.Tensor, n_entries: int, metric: str, seed: int, res):
    """Coarse entry-point table: a balanced k-means of a trainset subsample
    and the dataset row nearest each centre (brute-force 1-NN)."""
    n = dataset.shape[0]
    kb_metric = "inner_product" if metric == "inner_product" else "sqeuclidean"
    n_train = min(n, max(n_entries * 8, 8192))
    train = subsample_trainset(dataset, n_train, seed) if n_train < n else dataset
    kb = kmeans_balanced.KMeansBalancedParams(n_iters=10, metric=kb_metric, seed=seed)
    centers = kmeans_balanced.fit(kb, train.to(torch.float32), n_entries, res=res)
    _, ids = brute_force.knn(dataset, centers, 1, metric=metric, res=res)
    return centers, ids[:, 0].to(torch.int32)


def _auto_entry_points(n: int) -> int:
    """≈ 4·√n rounded up to a power of two, clamped to [64, 4096]."""
    raw = max(2.0, 4.0 * float(np.sqrt(max(n, 1))))
    return int(np.clip(1 << int(np.ceil(np.log2(raw))), 64, 4096))


def _graph_build_ivf_pq_params(params: IndexParams, n: int, d: int):
    """The IVF-PQ configuration of the kNN-graph build (raft_tpu's): √n
    lists (4 below 10,000 rows), up to 32 probes, and ``gpu_top_k = 2
    (inter + 1)`` candidates per row for the exact refine."""
    inter = min(params.intermediate_graph_degree, n - 1)
    n_lists = 4 if n < 10_000 else max(32, int(n ** 0.5))
    ip = ivf_pq.IndexParams(
        n_lists=n_lists,
        metric=params.metric,
        kmeans_trainset_fraction=1.0 if n < 10_000 else max(0.1, min(1.0, 128.0 * n_lists / n)),
        seed=params.seed,
    )
    sp = ivf_pq.SearchParams(n_probes=max(8, min(n_lists, 32)))
    gpu_top_k = min(n, 2 * (inter + 1))
    return ip, sp, gpu_top_k


def _graph_build_qtile(res: Resources, n: int, d: int) -> int:
    """Rows searched at once in the graph build's IVF-PQ stage."""
    return max(1, res.workspace_rows(4 * n // 64 + 4 * d, cap=8192))


def resolve_build_algo(build_algo: str, n: int, device: torch.device) -> str:
    """``"auto"`` → the exact graph up to 131,072 rows on a CUDA device
    (8,192 on the CPU), IVF-PQ above; any other name is returned as is."""
    if build_algo != "auto":
        return build_algo
    brute_cap = 131_072 if device.type == "cuda" else 8192
    return "brute_force" if n <= brute_cap else "ivf_pq"


@traced("cagra.build")
def build(params: IndexParams, dataset, *, res: Optional[Resources] = None) -> Index:
    """kNN graph (IVF-PQ + refine, exact, or NN-descent) →
    :func:`finalize_index`.  A host dataset (numpy or a CPU tensor) given to
    ``"nn_descent_batch"`` stays on the host until the graph is built, as in
    raft_tpu: the out-of-core build uploads one cluster at a time."""
    res = ensure(res)
    _check_metric(params.metric)
    algo = resolve_build_algo(params.build_algo, dataset.shape[0], res.device)
    host = _as_dataset(dataset, torch.device("cpu")) if algo == "nn_descent_batch" else None
    dataset = _as_dataset(dataset, res.device) if host is None else host
    n, d = dataset.shape
    inter = min(params.intermediate_graph_degree, n - 1)
    if algo == "brute_force":
        knn_graph = nn_descent.build_exact(dataset, inter, metric=params.metric, res=res).graph
    elif algo in ("nn_descent", "nn_descent_batch"):
        nnd = nn_descent.IndexParams(
            graph_degree=inter,
            intermediate_graph_degree=min(n - 1, max(inter + inter // 2, inter + 8)),
            max_iterations=params.nn_descent_niter, metric=params.metric, seed=params.seed)
        if algo == "nn_descent_batch":
            rows = host.to(torch.float32) if host.dtype == torch.bfloat16 else host
            knn_graph = nn_descent.build_batch(nnd, rows.numpy(), res=res).graph
        else:
            knn_graph = nn_descent.build(nnd, dataset, res=res).graph
    elif algo == "ivf_pq":
        ip, sp, gpu_top_k = _graph_build_ivf_pq_params(params, n, d)
        idx = ivf_pq.build(ip, dataset, res=res)
        qtile = _graph_build_qtile(res, n, d)
        cands = torch.cat([ivf_pq.search(sp, idx, dataset[s:s + qtile], gpu_top_k, res=res)[1]
                           for s in range(0, n, qtile)])
        del idx
        _, knn_graph = refine(dataset, dataset, cands, inter + 1, metric=params.metric, res=res)
        del cands
        # drop the self column wherever it landed (the last one when absent)
        self_col = knn_graph == torch.arange(n, dtype=knn_graph.dtype,
                                             device=knn_graph.device)[:, None]
        order = torch.sort(self_col.to(torch.uint8), dim=1, stable=True).indices
        knn_graph = torch.gather(knn_graph, 1, order)[:, :inter]
    else:
        raise ValueError(f"unknown build_algo {params.build_algo}")
    return finalize_index(params, dataset, knn_graph, res=res)


def finalize_index(params: IndexParams, dataset, knn_graph, *,
                   res: Optional[Resources] = None) -> Index:
    """Optimize the kNN graph to the output degree and build the entry-point
    table."""
    res = ensure(res)
    dataset = _as_dataset(dataset, res.device)
    n = dataset.shape[0]
    metric = _check_metric(params.metric)
    inter = min(params.intermediate_graph_degree, n - 1)
    graph = optimize(knn_graph, min(params.graph_degree, inter), res=res)
    n_entries = _auto_entry_points(n) if params.entry_points is None else params.entry_points
    n_entries = min(n_entries, n)
    entry_centers = entry_ids = None
    if n_entries:
        entry_centers, entry_ids = _build_entry_points(dataset, n_entries, metric,
                                                       params.seed, res)
    return Index(params.metric, dataset, graph, entry_centers, entry_ids)


def from_graph(metric: str, dataset, graph, entry_centers=None, entry_ids=None, *,
               res: Optional[Resources] = None) -> Index:
    """An index from a prebuilt graph (and optional entry-point table);
    ``dataset`` is rows or a ``vpq_dataset.VpqDataset``."""
    dev = ensure(res).device
    _check_metric(metric)
    rows = (dataset.to(dev) if isinstance(dataset, vpq_dataset.VpqDataset)
            else _as_dataset(dataset, dev))
    return Index(
        metric, rows, torch.as_tensor(graph).to(dev, torch.int32),
        None if entry_centers is None else as_f32(entry_centers, dev),
        None if entry_ids is None else torch.as_tensor(entry_ids).to(dev, torch.int32),
    )


# ---------------------------------------------------------------------------
# search


def _entry_seeds(queries: torch.Tensor, centers: torch.Tensor, entry_ids: torch.Tensor,
                 s: int, metric: str) -> torch.Tensor:
    """The ``s`` nearest entry points of each query: seed ids [q, s]."""
    if metric == "inner_product":
        sc = -torch.matmul(queries, centers.T)
    else:
        c2 = (centers * centers).sum(dim=1)
        sc = c2[None, :] - 2.0 * torch.matmul(queries, centers.T)
    _, top = select_k(sc, s, select_min=True)
    return entry_ids[top.long()]


def make_seed_ids(params: SearchParams, index: Index, queries: torch.Tensor, k: int,
                  itopk: Optional[int] = None) -> torch.Tensor:
    """Seed ids [q, s] of a query batch: the nearest entry points (when the
    index has them) and a random top-up from a ``torch.Generator`` seeded
    with ``rand_xor_mask & 0x7FFFFFFF`` on the index's device."""
    if itopk is None:
        itopk = min(max(params.itopk_size, k), index.size)
    n = index.size
    metric = DISTANCE_TYPES[index.metric]
    dev = index.graph.device
    samplings = max(1, params.num_random_samplings)
    entry = None
    if index.entry_centers is not None and params.num_entry_centers > 0:
        s = int(min(params.num_entry_centers, index.entry_centers.shape[0]))
        entry = _entry_seeds(as_f32(queries, dev), index.entry_centers.to(torch.float32),
                             index.entry_ids, s, metric)
        n_rand = min(n, max(itopk, 32) * samplings)
    else:
        n_rand = min(n, max(2 * itopk, 128) * samplings)
    gen = torch.Generator(device=dev).manual_seed(params.rand_xor_mask & 0x7FFFFFFF)
    seed_ids = torch.randint(0, n, (queries.shape[0], n_rand), generator=gen, device=dev,
                             dtype=torch.int32)
    return seed_ids if entry is None else torch.cat([entry.to(torch.int32), seed_ids], dim=1)


def _query_distance(qs: torch.Tensor, vecs: torch.Tensor, metric: str) -> torch.Tensor:
    """dist(qs[i], vecs[i, j]) for qs [t, d] and vecs [t, c, d]."""
    ip = torch.einsum("td,tcd->tc", qs, vecs)
    if metric == "inner_product":
        return -ip
    v2 = (vecs * vecs).sum(dim=2)
    q2 = (qs * qs).sum(dim=1)
    return torch.clamp(q2[:, None] + v2 - 2.0 * ip, min=0.0)


def traverse_init(dataset, queries: torch.Tensor, seed_ids: torch.Tensor,
                  itopk: int, metric: str):
    """The seed buffer ``(buf_d, buf_i, explored)`` [tile, itopk]: seed rows
    (of a dense dataset or a ``PagedRows``) scored, repeats dropped (the
    first occurrence kept), the best ``itopk`` kept, id -1 at every +inf
    slot, nothing explored."""
    seed_ids = seed_ids.to(torch.int32)
    vecs = gather_rows(dataset, seed_ids)
    dists = _query_distance(queries, vecs, metric)
    inf = torch.full((), float("inf"), device=dists.device)
    dists = torch.where(seed_ids < 0, inf, dists)
    order, dup = sorted_id_dedup(seed_ids)
    s_ids = torch.gather(seed_ids, 1, order)
    s_d = torch.where(dup, inf, torch.gather(dists, 1, order))
    buf_d, buf_i = select_k(s_d, itopk, select_min=True, input_indices=s_ids)
    buf_i = torch.where(torch.isfinite(buf_d), buf_i, torch.full_like(buf_i, -1))
    return buf_d, buf_i, torch.zeros(buf_d.shape, dtype=torch.bool, device=buf_d.device)


def traverse_steps(dataset, graph: torch.Tensor, queries: torch.Tensor,
                   buf_d: torch.Tensor, buf_i: torch.Tensor, explored: torch.Tensor,
                   steps: int, width: int, metric: str):
    """``steps`` beam-search hops over ``(buf_d, buf_i, explored)``, each
    picking parents (:func:`pick_parents`) and hopping: one
    ``cagra_traverse`` launch on the card, the plain loop for CPU tensors
    (``kernels.cagra_traverse.cagra_traverse_steps``, which stamps
    ``kernel_path``).  A hop whose frontier is exhausted changes nothing, so
    any trip count past the frontier is safe.  Returns ``(buf_d, buf_i,
    explored)``."""
    return cagra_traverse_steps(dataset, graph, queries, buf_d, buf_i, explored, steps=steps,
                                width=width, metric=metric)[:3]


def pick_parents(buf_d: torch.Tensor, buf_i: torch.Tensor, explored: torch.Tensor,
                 width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``width`` best unexplored finite slots of each buffer (``select_k``,
    the lowest slot winning a tie), marked explored: (parents [tile, width]
    int32, -1 where the frontier ran out; explored)."""
    return _ct.pick_parents(buf_d, buf_i, explored, width, select=select_k)


def filtered_itopk(itopk: int, n: int, pass_filter) -> int:
    """raft_tpu's widening of the internal buffer for a filtered search: by
    the inverse pass rate (``pass_filter.count()``, a host int), at most
    32×, rounded up to a power of two and capped at n."""
    passing = max(1, int(pass_filter.count()))
    scale = min(32.0, max(1.0, n / passing))
    widened = min(n, int(itopk * scale))
    return min(1 << (widened - 1).bit_length(), n)


def search_plan(params: SearchParams, index: Index, n_queries: int, k: int,
                res: Optional[Resources] = None, pass_filter=None) -> Tuple[int, int, int]:
    """(itopk, max_iter, query tile) of a search: raft_tpu's rules, with
    ``itopk`` widened for a pass filter (:func:`filtered_itopk`)."""
    res = ensure(res)
    itopk = min(max(params.itopk_size, k), index.size)
    if pass_filter is not None:
        itopk = filtered_itopk(itopk, index.size, pass_filter)
    width = params.search_width
    use_entries = index.entry_centers is not None and params.num_entry_centers > 0
    if params.max_iterations:
        max_iter = params.max_iterations
    elif use_entries:
        max_iter = max(8, -(-itopk // width))
    else:
        max_iter = max(16, -(-itopk // width) * 2)
    per_q = 4 * (width * index.graph_degree) * (index.dim + 4) + 16 * itopk
    tile = params.max_queries or max(1, min(max(n_queries, 1),
                                            res.workspace_rows(per_q, cap=512)))
    return itopk, max_iter, tile


def traverse_steps_filtered(dataset, graph: torch.Tensor,
                            queries: torch.Tensor, buf_d: torch.Tensor, buf_i: torch.Tensor,
                            explored: torch.Tensor, k: int, steps: int, width: int,
                            metric: str, words: torch.Tensor):
    """raft_tpu's filtered search body over one query tile, ``steps`` hops;
    ``words`` are the pass filter's words [W], or a RowFilter's rows of the
    tile [tile, W].
    The traversal is unfiltered (filtered-out nodes still route the walk);
    a result buffer of the best ``k`` filter-passing candidates seen so far,
    kept free of repeats by its own membership mask, is merged every hop.
    A hop whose frontier is exhausted leaves both buffers as they are.
    Returns (values [t, k], ids [t, k]) of the result buffer, deduplicated
    once at the end."""
    n = dataset.shape[0]
    tile = queries.shape[0]
    inf = torch.full((), float("inf"), device=buf_d.device)
    deg = graph.shape[1]
    c_w = width * deg
    # earlier[i, j] ⇔ i < j: demotes later copies of an id in one batch
    earlier = torch.triu(torch.ones((c_w, c_w), dtype=torch.bool, device=buf_d.device), 1)
    res_d, res_i = select_k(torch.where(invalid_mask(buf_i, words), inf, buf_d), k,
                            select_min=True, input_indices=buf_i)
    res_i = torch.where(torch.isfinite(res_d), res_i, torch.full_like(res_i, -1))
    for _ in range(steps):
        parents, explored = pick_parents(buf_d, buf_i, explored, width)
        nbrs = graph[parents.long().clamp(0, n - 1)]
        cand = torch.where(parents[:, :, None] >= 0, nbrs,
                           torch.full_like(nbrs, -1)).reshape(tile, c_w)
        vecs = gather_rows(dataset, cand)
        cd = torch.where(cand < 0, inf, _query_distance(queries, vecs, metric))
        dup_in_batch = ((cand[:, :, None] == cand[:, None, :]) & earlier).any(dim=1)
        in_buf = (cand[:, :, None] == buf_i[:, None, :]).any(dim=2)
        cd = torch.where(dup_in_batch | in_buf, inf, cd)
        # every node already in buf was offered to the result buffer when it
        # was first met; res may hold ids long evicted from buf
        in_res = (cand[:, :, None] == res_i[:, None, :]).any(dim=2)
        offer = torch.where(in_res | invalid_mask(cand, words), inf, cd)
        res_d, res_i = select_k(torch.cat([res_d, offer], dim=1), k, select_min=True,
                                input_indices=torch.cat([res_i, cand], dim=1))
        res_i = torch.where(torch.isfinite(res_d), res_i, torch.full_like(res_i, -1))
        all_i = torch.cat([buf_i, cand], dim=1)
        all_e = torch.cat([explored, torch.zeros_like(cand, dtype=torch.bool)], dim=1)
        buf_d, pos = select_k(torch.cat([buf_d, cd], dim=1), buf_d.shape[1], select_min=True)
        pos = pos.long()
        buf_i = torch.gather(all_i, 1, pos)
        buf_i = torch.where(torch.isfinite(buf_d), buf_i, torch.full_like(buf_i, -1))
        explored = torch.gather(all_e, 1, pos) | ~torch.isfinite(buf_d)
    order, dup = sorted_id_dedup(res_i)
    s_i = torch.gather(res_i, 1, order)
    s_d = torch.where(dup, inf, torch.gather(res_d, 1, order))
    v, i = select_k(s_d, k, select_min=True, input_indices=s_i)
    return v, torch.where(torch.isfinite(v), i, torch.full_like(i, -1))


@traced("cagra.search")
def search(params: SearchParams, index: Index, queries, k: int, *, sample_filter=None,
           deleted_mask=None, res: Optional[Resources] = None, seed_ids=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched beam search: (distances [q, k] f32, indices [q, k] int32).
    ``seed_ids`` [q, s] replaces the generated seeds.  ``sample_filter`` (a
    ``Bitset``, or a ``RowFilter`` with one row per query) keeps its set
    bits and ``deleted_mask`` excludes its set bits: such a search widens
    ``itopk`` and runs :func:`traverse_steps_filtered` (no hop kernel).
    The call stamps ``kernel_path`` "cuda" (its kernels) or "torch" (CPU
    tensors, or a compressed dataset's plain walk)."""
    res = ensure(res)
    res.device  # raises without a card unless the caller asked for the CPU
    dev = index.graph.device
    queries = as_f32(queries, dev)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(f"queries shape {tuple(queries.shape)} vs index dim {index.dim}")
    metric = DISTANCE_TYPES[index.metric]
    pass_filter = resolve_pass_filter(sample_filter, deleted_mask)
    per_row = isinstance(pass_filter, RowFilter)
    if per_row and pass_filter.words.shape[0] != queries.shape[0]:
        raise ValueError(f"row filter has {pass_filter.words.shape[0]} rows for "
                         f"{queries.shape[0]} queries")
    words = None if pass_filter is None else pass_filter.words.to(dev)
    itopk, max_iter, tile = search_plan(params, index, queries.shape[0], k, res, pass_filter)
    if seed_ids is None:
        seed_ids = make_seed_ids(params, index, queries, k, itopk=itopk)
    else:
        seed_ids = torch.as_tensor(np.array(seed_ids) if isinstance(seed_ids, np.ndarray)
                                   else seed_ids).to(dev, torch.int32)
    dataset = index.dataset
    # a compressed dataset walks on the plain walk, its rows decoded as gathered
    compressed = isinstance(dataset, vpq_dataset.VpqDataset)
    if index.paged is not None:
        # the walk gathers rows the graph decides, so no probe-keyed
        # prefetch exists: identity-pin the whole payload once
        # (BudgetExceeded if the pool is short) and read through the table
        index.paged.pin_identity()
        pool, page_slot = index.paged.view()
        dataset = PagedRows(pool, page_slot, index.size)
    vs, is_ = [], []
    for s in range(0, queries.shape[0], tile):
        qs = queries[s:s + tile]
        buf = traverse_init(dataset, qs, seed_ids[s:s + tile], itopk, metric)
        if pass_filter is None:
            walk = cagra_traverse_steps_torch if compressed else cagra_traverse_steps
            buf_d, buf_i = walk(dataset, index.graph, qs, *buf, steps=max_iter,
                                width=params.search_width, metric=metric)[:2]
            v, i = select_k(buf_d, k, select_min=True, input_indices=buf_i)
            i = torch.where(torch.isfinite(v), i, torch.full_like(i, -1))
        else:
            v, i = traverse_steps_filtered(
                dataset, index.graph, qs, *buf, k=k, steps=max_iter,
                width=params.search_width, metric=metric,
                words=words[s:s + tile] if per_row else words)
        vs.append(v)
        is_.append(i)
    stamp_kernel_path("cuda" if dev.type == "cuda" and not compressed else "torch")
    if not vs:
        return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    return postprocess(torch.cat(vs), metric), torch.cat(is_)


# ---------------------------------------------------------------------------
# serialization (raft_tpu's format)


@traced("cagra.save")
def save(filename: str, index: Index, *, include_dataset: bool = True) -> None:
    arrays = {"graph": index.graph}
    if index.entry_centers is not None:
        arrays["entry_centers"] = index.entry_centers
        arrays["entry_ids"] = index.entry_ids
    kind = "none"
    if include_dataset and isinstance(index.dataset, vpq_dataset.VpqDataset):
        kind = "vpq"
        ds = index.dataset
        arrays.update(vq_centers=ds.vq_centers, pq_codebook=ds.pq_codebook,
                      vq_codes=ds.vq_codes, pq_codes=ds.pq_codes)
    elif include_dataset:
        kind = "dense"
        ds = index.dataset.detach().cpu()
        # numpy has no bf16: its raw 2-byte words, as raft_tpu writes them
        arrays["dataset"] = (ds.view(torch.int16).numpy().view("V2")
                             if ds.dtype == torch.bfloat16 else ds)
    ser.save_tree(
        filename, "cagra", _SERIALIZATION_VERSION,
        {"metric": index.metric, "dataset_kind": kind, "dim": int(index.dim),
         "include_dataset": int(include_dataset)},
        arrays,
    )


@traced("cagra.load")
def load(filename: str, *, dataset=None, res: Optional[Resources] = None) -> Index:
    """An index saved by either package (dense rows, VPQ codes, or none);
    ``dataset`` supplies the rows of a file saved without them."""
    scalars, arrays = ser.load_tree(filename, "cagra", _SERIALIZATION_VERSION)
    kind = scalars.get("dataset_kind", "dense" if scalars["include_dataset"] else "none")
    if kind == "dense":
        raw = arrays["dataset"]
        ds = (torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
              if raw.dtype == np.dtype("V2") else np.array(raw))
    elif kind == "vpq":
        ds = vpq_dataset.VpqDataset(
            torch.from_numpy(np.array(arrays["vq_centers"], np.float32)),
            torch.from_numpy(np.array(arrays["pq_codebook"], np.float32)),
            torch.from_numpy(np.array(arrays["vq_codes"], np.int32)),
            torch.from_numpy(np.array(arrays["pq_codes"], np.uint8)),
            int(scalars["dim"]))
    elif dataset is not None:
        ds = dataset
    else:
        raise ValueError("index was saved without dataset; pass dataset=")
    return from_graph(scalars["metric"], ds, np.array(arrays["graph"]),
                      arrays.get("entry_centers"), arrays.get("entry_ids"), res=res)
