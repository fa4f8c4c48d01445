"""Automatic k search for k-means (counterpart of
``raft_tpu.cluster.auto_find_k``): bisection over k on the relative inertia
gain per added cluster."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.core.resources import Resources, as_f32, ensure
from raft_tpu_torch.core.trace import traced


@traced("cluster.find_k")
def find_k(
    x,
    kmax: int,
    *,
    kmin: int = 1,
    threshold: float = 0.05,
    max_iter: int = 100,
    seed: int = 0,
    res: Optional[Resources] = None,
) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Search [kmin, kmax] for the inertia elbow: (k, centroids [k, d],
    inertia)."""
    res = ensure(res)
    x = as_f32(x, res.device)
    if not (1 <= kmin <= kmax <= x.shape[0]):
        raise ValueError(f"bad k range [{kmin}, {kmax}] for n={x.shape[0]}")
    cache = {}

    def cost(k: int):
        if k not in cache:
            params = kmeans.KMeansParams(n_clusters=k, max_iter=max_iter, seed=seed)
            centers, inertia, _ = kmeans.fit(params, x, res=res)
            cache[k] = (centers, float(inertia))
        return cache[k]

    lo, hi = kmin, kmax
    _, c_lo = cost(lo)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        _, c_mid = cost(mid)
        gain = (c_lo - c_mid) / max(c_lo, 1e-30) / max(mid - lo, 1)
        if gain > threshold:
            lo, c_lo = mid, c_mid
        else:
            hi = mid
    centers, inertia = cost(lo)
    return lo, centers, torch.tensor(inertia, dtype=torch.float32)
