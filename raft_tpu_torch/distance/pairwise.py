"""Metric names and the row-tiled fused distance + argmin used by k-means
(counterpart of ``raft_tpu.distance.pairwise``; this slice ports the L2
and inner-product argmin).

``tiled_argmin`` is plain XLA in raft_tpu, not a Pallas kernel, so its
product is ``torch.matmul`` (full f32: the package turns TF32 off).
"""

from __future__ import annotations

import torch

# Metric name → canonical key (pylibraft's accepted names).
DISTANCE_TYPES = {
    "euclidean": "euclidean",
    "l2": "euclidean",
    "sqeuclidean": "sqeuclidean",
    "cosine": "cosine",
    "inner_product": "inner_product",
    "l1": "l1",
    "cityblock": "l1",
    "manhattan": "l1",
    "taxicab": "l1",
    "chebyshev": "chebyshev",
    "linf": "chebyshev",
    "canberra": "canberra",
    "minkowski": "minkowski",
    "lp": "minkowski",
    "correlation": "correlation",
    "jaccard": "jaccard",
    "hellinger": "hellinger",
    "braycurtis": "braycurtis",
    "jensenshannon": "jensenshannon",
    "hamming": "hamming",
    "kl_divergence": "kl_divergence",
    "russellrao": "russellrao",
    "dice": "dice",
    "haversine": "haversine",
}


def argmin_tile_rows(n_centers: int, res) -> int:
    """Row-tile size for a fused distance+argmin against ``n_centers``
    targets, bounded by the workspace budget (the [tile, L] f32 score tile
    is the only distance-matrix memory)."""
    return int(min(max(res.workspace_rows(4 * max(n_centers, 1)), 8), 1 << 16))


def tiled_argmin(x: torch.Tensor, centers: torch.Tensor, metric: str,
                 tile_rows: int) -> torch.Tensor:
    """Labels [n] int64 of the nearest center, one [tile_rows, L] score
    tile at a time.  ``metric`` is "sqeuclidean" (max(|x|^2 + |c|^2 -
    2 x.c, 0)) or "inner_product" (-x.c); normalize first for cosine.  The
    first center wins a tie."""
    if metric not in ("sqeuclidean", "inner_product"):
        raise ValueError(f"tiled_argmin serves sqeuclidean/inner_product, got {metric!r}")
    ct = centers.T
    cc = (centers * centers).sum(dim=1) if metric == "sqeuclidean" else None
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], max(1, tile_rows)):
        t = x[s:s + tile_rows]
        ip = torch.matmul(t, ct)
        if metric == "inner_product":
            d = -ip
        else:
            xx = (t * t).sum(dim=1)
            d = torch.clamp(xx[:, None] + cc[None, :] - 2.0 * ip, min=0.0)
        out[s:s + tile_rows] = torch.argmin(d, dim=1)
    return out
