"""Hierarchical balanced k-means — the coarse quantizer trainer of the IVF
builds (counterpart of ``raft_tpu.cluster.kmeans_balanced``).

Assignment is ``distance.pairwise.tiled_argmin`` (a ``torch.matmul`` tile
+ argmin, as raft_tpu leaves it to XLA); the update sums rows and weights
by ``ops.matrix.segment_sum``, in a fixed order, so one seed gives one set
of centers on the card run after run; starved clusters (count < average /
8) teleport to a uniformly drawn positive-weight row, as raft_tpu's
``adjust_centers``.

Random draws come from a ``torch.Generator`` seeded from ``params.seed``
and are drawn on the host, so a seed gives the same draws on any device.
They are not raft_tpu's threefry draws: compare builds by quality, or
inject centers.  raft_tpu's hierarchical fine fit runs one padded,
vmapped fit of ``max(fine_k)`` clusters per mesocluster and keeps the
first ``fine_k[m]``; here the vmap becomes a loop that fits exactly
``fine_k[m]`` clusters on each mesocluster's members.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, ensure
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import argmin_tile_rows, tiled_argmin
from raft_tpu_torch.ops.matrix import segment_sum


@dataclass
class KMeansBalancedParams:
    n_iters: int = 20
    metric: str = "sqeuclidean"  # sqeuclidean | cosine (spherical) | inner_product
    mesocluster_threshold: int = 256  # hierarchy kicks in above this many clusters
    seed: int = 0


def _maybe_normalize(x: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "cosine":
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)
    return x


def _inner(metric: str) -> str:
    return "inner_product" if metric == "inner_product" else "sqeuclidean"


@traced("kmeans_balanced.predict")
def predict(centers, x, *, metric: str = "sqeuclidean",
            res: Optional[Resources] = None) -> torch.Tensor:
    """Labels [n] int32 of the nearest center under the training metric."""
    res = ensure(res)
    device = res.device
    centers = torch.as_tensor(centers).to(device=device, dtype=torch.float32)
    x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    labels = tiled_argmin(
        _maybe_normalize(x, metric), _maybe_normalize(centers, metric),
        _inner(metric), argmin_tile_rows(centers.shape[0], res),
    )
    return labels.to(torch.int32)


def _update(x, weights, labels, centers, n_clusters, spherical):
    sc = segment_sum(torch.cat([x * weights[:, None], weights[:, None]], dim=1),
                     labels, n_clusters)
    sums, counts = sc[:, :-1], sc[:, -1]
    centers = torch.where(
        counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1e-30), centers
    )
    if spherical:
        centers = _maybe_normalize(centers, "cosine")
    return centers, counts


def _balanced_iterations(
    gen: torch.Generator,
    x: torch.Tensor,
    centers0: torch.Tensor,
    weights: torch.Tensor,
    n_iters: int,
    n_clusters: int,
    metric: str = "sqeuclidean",
    tile_rows: int = 1 << 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """n_iters x (assign → update → teleport starved clusters), then one
    clean update.  Returns (centers, labels int64)."""
    n = x.shape[0]
    spherical = metric == "cosine"
    inner = _inner(metric)
    cum = torch.cumsum((weights > 0).to(torch.int32), dim=0)
    n_pos = int(cum[-1])
    # one host draw per iteration, made up front: one upload for the loop
    draws = torch.randint(1, n_pos + 1, (max(n_iters, 1), n_clusters), generator=gen)
    draws = draws.to(device=x.device, dtype=torch.int32)
    avg = weights.sum() / n_clusters
    centers = centers0
    for it in range(n_iters):
        labels = tiled_argmin(x, centers, inner, tile_rows)
        centers, counts = _update(x, weights, labels, centers, n_clusters, spherical)
        starved = counts < avg / 8.0
        picks = torch.clamp(torch.searchsorted(cum, draws[it]), 0, n - 1)
        centers = torch.where(starved[:, None], x[picks], centers)
    labels = tiled_argmin(x, centers, inner, tile_rows)
    centers, _ = _update(x, weights, labels, centers, n_clusters, spherical)
    return centers, labels


#: host elements of one Gumbel top-k draw block
_DRAW_BLOCK = 1 << 22


def draw_rows(gen: torch.Generator, weights: torch.Tensor, k: int) -> torch.Tensor:
    """``k`` row indices [S, k] for each of S problems, drawn ∝ ``weights``
    [S, n] (≥ 0) on the host: without replacement by Gumbel top-k (the k
    largest ``log w - log(-log u)``) when ``n >= k``, with replacement
    otherwise.  Unlike ``torch.multinomial``, which refuses more than 2**24
    categories, the draw takes any n: rows go in blocks of bounded size and
    each block's top-k merges into the running one."""
    w = weights.detach().to("cpu", torch.float64)
    S, n = w.shape
    if n < k:
        return torch.multinomial(w, k, replacement=True, generator=gen)
    step = max(k, _DRAW_BLOCK // max(S, 1))
    best_v = best_i = None
    for s in range(0, n, step):
        ws = w[:, s:s + step]
        u = torch.rand(ws.shape, generator=gen, dtype=torch.float64)
        v, i = torch.topk(torch.log(ws) - torch.log(-torch.log(u)), min(k, ws.shape[1]), dim=1)
        i = i + s
        if best_v is not None:
            v, j = torch.topk(torch.cat([best_v, v], dim=1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], dim=1), 1, j)
        best_v, best_i = v, i
    return best_i


def _fit_flat(gen, x, n_clusters: int, n_iters: int, weights, metric: str,
              tile_rows: int) -> torch.Tensor:
    """Seeds drawn ∝ weight without replacement (with replacement only
    when there are fewer rows than clusters), then balancing iterations."""
    idx = draw_rows(gen, weights[None, :], n_clusters)[0]
    centers, _ = _balanced_iterations(
        gen, x, x[idx.to(x.device)], weights, n_iters, n_clusters, metric, tile_rows
    )
    return centers


@traced("kmeans_balanced.fit")
def fit(params: KMeansBalancedParams, x, n_clusters: int, *,
        res: Optional[Resources] = None) -> torch.Tensor:
    """Train ``n_clusters`` balanced centers: flat below
    ``mesocluster_threshold`` clusters (or fewer than 4 rows per cluster),
    else mesoclusters → per-mesocluster fine fits → final balancing."""
    res = ensure(res)
    metric = params.metric
    x = torch.as_tensor(x).to(device=res.device, dtype=torch.float32)
    x = _maybe_normalize(x, metric)
    n = x.shape[0]
    gen = torch.Generator().manual_seed(int(params.seed))
    ones = torch.ones(n, dtype=torch.float32, device=x.device)
    tile_rows = argmin_tile_rows(n_clusters, res)
    if n_clusters <= params.mesocluster_threshold or n < 4 * n_clusters:
        return _fit_flat(gen, x, n_clusters, params.n_iters, ones, metric, tile_rows)

    n_meso = int(math.ceil(math.sqrt(n_clusters)))
    meso_centers = _fit_flat(gen, x, n_meso, params.n_iters, ones, metric, tile_rows)
    meso_labels = predict(meso_centers, x, metric=metric, res=res).cpu().numpy()

    counts = np.bincount(meso_labels, minlength=n_meso).astype(np.int64)
    fine_k = np.where(
        counts > 0,
        np.maximum(1, np.floor(n_clusters * counts / max(n, 1)).astype(np.int64)),
        0,
    )
    occupied = counts > 0
    while fine_k.sum() != n_clusters:  # fix rounding drift
        if fine_k.sum() < n_clusters:
            load = np.where(occupied, counts / np.maximum(fine_k, 1), -np.inf)
            fine_k[np.argmax(load)] += 1
        else:
            load = np.where(fine_k > 1, counts / np.maximum(fine_k, 1), np.inf)
            fine_k[np.argmin(load)] -= 1

    parts = []
    order = np.argsort(meso_labels, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    for m in np.nonzero(occupied & (fine_k > 0))[0]:
        members = torch.from_numpy(order[starts[m]:starts[m + 1]]).to(x.device)
        sub = x[members]
        parts.append(_fit_flat(
            gen, sub, int(fine_k[m]), params.n_iters,
            torch.ones(sub.shape[0], dtype=torch.float32, device=x.device),
            metric, tile_rows,
        ))
    centers = torch.cat(parts)
    if centers.shape[0] != n_clusters:
        raise RuntimeError(f"hierarchical fit made {centers.shape[0]} of {n_clusters} centers")
    centers, _ = _balanced_iterations(
        gen, x, centers, ones, max(2, params.n_iters // 10), n_clusters, metric, tile_rows
    )
    return centers


def _assign_sharded(metric: str, tile_rows: int):
    """The assignment of one shard's rows for ``lloyd_stats``: the fused
    L2 argmin (kernel #7 on the card) for the L2 and (normalized) cosine
    metrics, the matmul tile for inner products (labels only)."""
    from raft_tpu_torch.comms.distributed import assign_l2

    if metric != "inner_product":
        return assign_l2
    return lambda x, c: (None, tiled_argmin(x, c, "inner_product", tile_rows).to(torch.int64))


@traced("kmeans_balanced.fit_sharded")
def fit_sharded(comms, params: KMeansBalancedParams, data_sharded, n_clusters: int,
                sample_weights=None, *, init_centers=None, reduce_dtype: Optional[str] = None,
                res: Optional[Resources] = None):
    """:func:`fit` over data row-sharded across ``comms``' axis (a list of
    per-shard row blocks in rank order, or one tensor the axis size
    divides; ``sample_weights`` shards alongside).

    Seeding (the hierarchical / flat :func:`fit`) runs on a replicated
    weight-aware subsample (rows travel once, a bounded number), unless
    ``init_centers`` is given; then ``params.n_iters`` balancing
    iterations run over the full sharded rows: each shard assigns its rows
    (kernel #7 on the card for L2 and cosine) and sums them by label, and
    the partials merge in one packed allreduce an iteration, optionally
    quantized (``reduce_dtype``, default ``RAFT_TPU_BUILD_REDUCE_DTYPE``).
    Starved clusters teleport to rows of the subsample, drawn up front from
    a ``torch.Generator`` seeded by ``params.seed`` (one seed, one result).
    Returns (centers [k, d] on the mesh's first device, labels: a
    rank-ordered list of each shard's int32 labels, against the centers of
    the last balancing iteration, as raft_tpu's)."""
    from raft_tpu_torch.comms.distributed import _shards, lloyd_stats, take_rows
    from raft_tpu_torch.comms.quantized import reduce_dtype_from_env

    res = ensure(res)
    metric = params.metric
    if reduce_dtype is None:
        reduce_dtype = reduce_dtype_from_env()
    shards = [_maybe_normalize(s.to(torch.float32), metric)
              for s in _shards(comms, data_sharded)]
    weights = ([torch.ones(s.shape[0], dtype=torch.float32, device=s.device) for s in shards]
               if sample_weights is None
               else [w.to(torch.float32) for w in _shards(comms, sample_weights)])
    n = int(comms.allreduce([torch.tensor(s.shape[0]) for s in shards])[0])
    gen = torch.Generator().manual_seed(int(params.seed))
    # replicated pool: seeds the hierarchy and feeds the teleport draws.
    # With-replacement draw; zero-weight (padding) rows never seed
    idx = torch.randint(0, n, (min(n, max(8 * n_clusters, 8192)),), generator=gen)
    w_pool = take_rows(comms, [w[:, None] for w in weights], idx)[:, 0]
    keep = (w_pool > 0).cpu()
    if not bool(keep.any()):
        raise ValueError("all sample weights are zero; nothing to cluster")
    idx = idx[keep]
    pool = _maybe_normalize(take_rows(comms, shards, idx), metric)
    pool_w = w_pool[keep.to(w_pool.device)]
    root = pool.device
    if init_centers is None:
        c0 = fit(params, pool, n_clusters, res=Resources(device=root,
                 workspace_limit_bytes=res.workspace_limit_bytes))
    else:
        c0 = _maybe_normalize(torch.as_tensor(init_centers).to(root, torch.float32), metric)
    tile_rows = argmin_tile_rows(n_clusters, res)
    d = c0.shape[1]
    m = pool.shape[0]
    n_iters = max(1, params.n_iters)
    cum = torch.cumsum((pool_w > 0).to(torch.int32), dim=0)
    draws = torch.randint(1, int(cum[-1]) + 1, (n_iters, n_clusters), generator=gen)
    draws = draws.to(device=root, dtype=torch.int32)

    assign = _assign_sharded(metric, tile_rows)

    def update(centers):
        packed, labels = lloyd_stats(comms, shards, weights, centers, reduce_dtype, assign)
        g_sums, g_counts = packed[:, :d], packed[:, d]
        centers = torch.where(g_counts[:, None] > 0,
                              g_sums / torch.clamp(g_counts[:, None], min=1e-30), centers)
        if metric == "cosine":
            centers = _maybe_normalize(centers, "cosine")
        return centers, [lab.to(torch.int32) for lab in labels], g_counts

    centers = c0
    for it in range(n_iters):
        centers, _, g_counts = update(centers)
        starved = g_counts < g_counts.sum() / n_clusters / 8.0
        picks = torch.clamp(torch.searchsorted(cum, draws[it]), 0, m - 1)
        centers = torch.where(starved[:, None], pool[picks], centers)
    centers, labels, _ = update(centers)   # a final clean update
    return centers, labels


@traced("kmeans_balanced.fit_predict")
def fit_predict(
    params: KMeansBalancedParams,
    x,
    n_clusters: int,
    *,
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centers, labels): :func:`fit`, then :func:`predict` of the same rows."""
    centers = fit(params, x, n_clusters, res=res)
    return centers, predict(centers, x, metric=params.metric, res=res)
