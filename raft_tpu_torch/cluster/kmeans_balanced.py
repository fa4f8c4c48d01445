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
