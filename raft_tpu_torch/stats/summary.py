"""Summary statistics (counterpart of ``raft_tpu.stats.summary``; the
reference's raft/stats/{mean,meanvar,stddev,minmax,cov,histogram,
weighted_mean,mean_center,dispersion}.cuh): plain torch reductions on
``res``'s device (``cuda`` unless the caller passes
``Resources(device="cpu")``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, ensure, to_device

_Res = Optional[Resources]


def _on(m, res: _Res) -> torch.Tensor:
    return to_device(m if isinstance(m, torch.Tensor) else np.asarray(m), ensure(res).device)


def _f(m, res: _Res) -> torch.Tensor:
    t = _on(m, res)
    return t if t.is_floating_point() else t.to(torch.float32)


def mean(m, *, axis: int = 0, res: _Res = None) -> torch.Tensor:
    return _f(m, res).mean(dim=axis)


def mean_center(m, *, axis: int = 0, res: _Res = None) -> torch.Tensor:
    m = _f(m, res)
    return m - m.mean(dim=axis, keepdim=True)


def meanvar(m, *, axis: int = 0, sample: bool = True,
            res: _Res = None) -> Tuple[torch.Tensor, torch.Tensor]:
    m = _f(m, res)
    return m.mean(dim=axis), m.var(dim=axis, correction=1 if sample else 0)


def stddev(m, *, axis: int = 0, sample: bool = True, res: _Res = None) -> torch.Tensor:
    return _f(m, res).std(dim=axis, correction=1 if sample else 0)


def minmax(m, *, axis: int = 0, res: _Res = None) -> Tuple[torch.Tensor, torch.Tensor]:
    m = _on(m, res)
    return m.amin(dim=axis), m.amax(dim=axis)


def cov(m, *, sample: bool = True, centered: bool = False, res: _Res = None) -> torch.Tensor:
    """Column covariance matrix (stats/cov.cuh): one gemm."""
    m = _f(m, res)
    x = m if centered else m - m.mean(dim=0, keepdim=True)
    n = m.shape[0]
    return (x.T @ x) / ((n - 1) if sample else n)


def histogram(m, n_bins: int, *, lo: float, hi: float, res: _Res = None) -> torch.Tensor:
    """Per-column histogram [n_bins, cols] int32 (stats/histogram.cuh)."""
    m = _f(m, res)
    m2 = m if m.ndim == 2 else m[:, None]
    bins = torch.clamp(((m2 - lo) / (hi - lo) * n_bins).to(torch.int64), 0, n_bins - 1)
    cols = torch.arange(m2.shape[1], device=m2.device)[None, :]
    flat = (bins * m2.shape[1] + cols).reshape(-1)
    counts = torch.bincount(flat, minlength=n_bins * m2.shape[1])
    return counts.reshape(n_bins, m2.shape[1]).to(torch.int32)


def weighted_mean(m, weights, *, axis: int = 0, res: _Res = None) -> torch.Tensor:
    m = _f(m, res)
    w = _on(weights, res).to(m.dtype)
    if axis == 0:
        return (m * w[:, None]).sum(dim=0) / w.sum()
    return (m * w[None, :]).sum(dim=1) / w.sum()


def dispersion(centroids, cluster_sizes, *,
               global_centroid: Optional[torch.Tensor] = None, res: _Res = None) -> torch.Tensor:
    """Between-cluster dispersion (stats/dispersion.cuh)."""
    centroids = _f(centroids, res)
    sizes = _on(cluster_sizes, res).to(centroids.dtype)
    n = sizes.sum()
    if global_centroid is None:
        global_centroid = (centroids * sizes[:, None]).sum(dim=0) / n
    d2 = ((centroids - _on(global_centroid, res).to(centroids.dtype)[None, :]) ** 2).sum(dim=1)
    return torch.sqrt((sizes * d2).sum() / n)
