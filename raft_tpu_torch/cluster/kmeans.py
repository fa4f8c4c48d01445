"""Lloyd's k-means with kmeans++ init (counterpart of
``raft_tpu.cluster.kmeans``; ``fit_sharded`` waits for the multi-GPU
slice).

The assignment step is the distance layer's fused 1-NN: the sqeuclidean
tile (``distance.pairwise.distance_matrix_tile``: ``max(|x|^2 + |c|^2 -
2 x.c, 0)``, a ``torch.matmul`` with TF32 off) and its argmin, row-tiled
by ``batch_samples``, as raft_tpu's ``_assign``.  The fused argmin kernel
(#7) is not used: its score has no |x|^2 term and no clamp, and routing it
here would move labels away from raft_tpu's (``kernels.fused_argmin``).
The update is balanced k-means' (``kmeans_balanced._update``): rows and
weights summed by ``ops.matrix.segment_sum``, in a fixed order, so one
input gives one set of centers on the card run after run; an empty cluster
keeps its center.

The Lloyd loop is raft_tpu's ``_lloyd``: stop after ``max_iter``
iterations, or when the relative change of the assignment inertia is at
most ``tol`` (never before two iterations); the returned inertia is taken
against the final centers.  ``metric="cosine"`` is spherical k-means: rows
and centers live on the unit sphere.

Random draws (kmeans++ seeds, ``init="random"``) come from a
``torch.Generator`` seeded by ``params.seed`` and are drawn on the host, so
a seed gives the same draws on any device.  They are not raft_tpu's
threefry draws: compare fits by quality, or pass ``init_centers``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans_balanced import _update, draw_rows
from raft_tpu_torch.core.resources import Resources, as_f32, ensure, to_device
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.fused_nn import _fused_nn
from raft_tpu_torch.distance.pairwise import distance_matrix_tile

_METRICS = ("sqeuclidean", "euclidean", "l2", "cosine")


@dataclass
class KMeansParams:
    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: str = "kmeans++"  # kmeans++ | random | array
    n_init: int = 1
    seed: int = 0
    metric: str = "sqeuclidean"  # sqeuclidean | cosine (spherical k-means)
    batch_samples: int = 1 << 15  # assignment row tile (bounds the [tile, k] matrix)


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _assign(x: torch.Tensor, centers: torch.Tensor,
            tile: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min squared distance [n] f32, label [n] int32) per row, one
    [tile, k] distance block at a time (all rows at once when ``tile`` <= 0):
    the fused 1-NN of the distance layer."""
    return _fused_nn(x, centers, "sqeuclidean", tile if tile > 0 else max(x.shape[0], 1))


@traced("kmeans.plus_plus_init")
def kmeans_plus_plus_init(gen: torch.Generator, x, n_clusters: int,
                          weights=None) -> torch.Tensor:
    """kmeans++ seeding: each next center drawn ∝ weight × the squared
    distance to the nearest center so far (``kmeans_balanced.draw_rows``,
    on the host from ``gen``); the running minimum is one [n, d] pass a
    step."""
    x = torch.as_tensor(x).to(torch.float32)
    n = x.shape[0]
    w = torch.ones(n, dtype=torch.float32, device=x.device) if weights is None else weights
    first = int(draw_rows(gen, w[None, :], 1)[0, 0])
    centers = torch.zeros((n_clusters, x.shape[1]), dtype=torch.float32, device=x.device)
    centers[0] = x[first]
    min_d2 = ((x - x[first][None, :]) ** 2).sum(dim=1)
    for i in range(1, n_clusters):
        probs = w * min_d2
        nxt = int(draw_rows(gen, probs[None, :], 1)[0, 0])
        centers[i] = x[nxt]
        min_d2 = torch.minimum(min_d2, ((x - x[nxt][None, :]) ** 2).sum(dim=1))
    return centers


@traced("kmeans.compute_new_centroids")
def compute_new_centroids(x, centroids, labels=None, weights=None, *,
                          res: Optional[Resources] = None) -> torch.Tensor:
    """One centroid-update step (pylibraft's ``compute_new_centroids``)."""
    dev = ensure(res).device
    x = as_f32(x, dev)
    c = as_f32(centroids, dev)
    if labels is None:
        _, labels = _assign(x, c)
    labels = to_device(np.array(labels) if not torch.is_tensor(labels) else labels,
                       dev).to(torch.int64)
    w = torch.ones(x.shape[0], dtype=torch.float32, device=dev) if weights is None \
        else as_f32(weights, dev)
    return _update(x, w, labels, c, c.shape[0], False)[0]


def _lloyd(x, centers, weights, max_iter: int, tol: float, spherical: bool, tile: int,
           history: Optional[List[float]]):
    """raft_tpu's ``_lloyd``: (centers, inertia against them, iterations)."""
    it, prev, cur = 0, float("inf"), float("inf")
    while it < max_iter and not abs(prev - cur) <= tol * max(cur, 1e-30):
        best, labels = _assign(x, centers, tile)
        inertia = float((weights * best).sum())   # of this assignment
        centers, _ = _update(x, weights, labels, centers, centers.shape[0], spherical)
        if history is not None:
            history.append(inertia)
        prev, cur = cur, inertia
        it += 1
    best, _ = _assign(x, centers, tile)
    return centers, (weights * best).sum(), it


@traced("kmeans.fit")
def fit(params: KMeansParams, x, sample_weights=None, *, init_centers=None,
        history: Optional[List[float]] = None,
        res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Fit k-means: (centroids [k, d], inertia (f32 scalar tensor), n_iter).
    ``n_init`` restarts keep the best inertia; explicit ``init_centers``
    (required by ``init="array"``) run once.  ``history``, when given, gets
    each Lloyd iteration's assignment inertia (of the best restart's run
    appended last)."""
    dev = ensure(res).device
    if params.metric not in _METRICS:
        raise ValueError(f"kmeans supports sqeuclidean/cosine, got {params.metric}")
    spherical = params.metric == "cosine"
    x = as_f32(x, dev)
    if spherical:
        x = _normalize_rows(x)
    w = (torch.ones(x.shape[0], dtype=torch.float32, device=dev) if sample_weights is None
         else as_f32(sample_weights, dev))
    if params.init == "array" and init_centers is None:
        raise ValueError("init='array' requires init_centers")
    if init_centers is None and params.init not in ("kmeans++", "random"):
        raise ValueError(f"unknown init {params.init!r}")
    gen = torch.Generator().manual_seed(int(params.seed))
    n_init = 1 if init_centers is not None else max(params.n_init, 1)
    best = None
    for _ in range(n_init):
        if init_centers is not None:
            c0 = as_f32(init_centers, dev)
            if spherical:
                c0 = _normalize_rows(c0)
        elif params.init == "random":
            c0 = x[draw_rows(gen, torch.ones((1, x.shape[0])), params.n_clusters)[0].to(dev)]
        else:
            c0 = kmeans_plus_plus_init(gen, x, params.n_clusters, w)
        run: List[float] = []
        centers, inertia, n_iter = _lloyd(x, c0, w, params.max_iter, params.tol, spherical,
                                          params.batch_samples, run)
        if best is None or float(inertia) < float(best[1]):
            best, best_run = (centers, inertia, n_iter), run
    if history is not None:
        history.extend(best_run)
    return best


@traced("kmeans.predict")
def predict(centroids, x, *, metric: str = "sqeuclidean", batch_samples: int = 1 << 15,
            res: Optional[Resources] = None) -> torch.Tensor:
    """Nearest-centroid labels [n] int32."""
    dev = ensure(res).device
    x, c = as_f32(x, dev), as_f32(centroids, dev)
    if metric == "cosine":
        x, c = _normalize_rows(x), _normalize_rows(c)
    return _assign(x, c, batch_samples)[1]


@traced("kmeans.fit_predict")
def fit_predict(params: KMeansParams, x, sample_weights=None, *,
                res: Optional[Resources] = None):
    """(centroids, labels, inertia, n_iter)."""
    centroids, inertia, n_iter = fit(params, x, sample_weights, res=res)
    labels = predict(centroids, x, metric=params.metric, batch_samples=params.batch_samples,
                     res=res)
    return centroids, labels, inertia, n_iter


@traced("kmeans.transform")
def transform(centroids, x, *, res: Optional[Resources] = None) -> torch.Tensor:
    """Squared distances [n, k] of every row to every centroid."""
    dev = ensure(res).device
    return distance_matrix_tile(as_f32(x, dev), as_f32(centroids, dev), "sqeuclidean")


@traced("kmeans.cluster_cost")
def cluster_cost(x, centroids, *, batch_samples: int = 1 << 15,
                 res: Optional[Resources] = None) -> torch.Tensor:
    """Total inertia: the sum of each row's squared distance to its nearest
    centroid."""
    dev = ensure(res).device
    return _assign(as_f32(x, dev), as_f32(centroids, dev), batch_samples)[0].sum()
