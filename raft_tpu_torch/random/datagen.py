"""Synthetic dataset generators (counterpart of ``raft_tpu.random.datagen``):
``make_blobs``, ``make_regression`` and the R-MAT graph generator, each
drawn from a ``torch.Generator`` on its device."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import ensure


def make_blobs(
    gen: torch.Generator,
    n_samples: int,
    n_features: int,
    *,
    n_clusters: int = 5,
    cluster_std: float = 1.0,
    center_box: Tuple[float, float] = (-10.0, 10.0),
    centers=None,
    shuffle: bool = True,
    dtype=torch.float32,
    res=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clustered Gaussian blobs: (data [n, d], labels [n] int32, centers
    [k, d]).  Centers uniform in ``center_box`` (unless given), labels
    uniform over the centers, noise normal with ``cluster_std``."""
    g = gen.device
    if centers is None:
        lo, hi = center_box
        centers = lo + (hi - lo) * torch.rand((n_clusters, n_features), generator=gen,
                                              dtype=dtype, device=g)
    else:
        centers = torch.as_tensor(centers).to(device=g, dtype=dtype)
        n_clusters = centers.shape[0]
    labels = torch.randint(0, n_clusters, (n_samples,), generator=gen, device=g)
    noise = cluster_std * torch.randn((n_samples, n_features), generator=gen, dtype=dtype,
                                      device=g)
    data = centers[labels] + noise
    if shuffle:
        perm = torch.randperm(n_samples, generator=gen, device=g)
        data, labels = data[perm], labels[perm]
    dev = ensure(res).device
    return data.to(dev), labels.to(device=dev, dtype=torch.int32), centers.to(dev)


def make_regression(
    gen: torch.Generator,
    n_samples: int,
    n_features: int,
    *,
    n_informative: int = 10,
    n_targets: int = 1,
    bias: float = 0.0,
    noise: float = 0.0,
    shuffle: bool = True,
    dtype=torch.float32,
    res=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linear-model regression problem: (X [n, d], y [n, t], coef [d, t]);
    the first ``n_informative`` coefficients uniform in [0, 100), the rest
    0."""
    g = gen.device
    n_informative = min(n_informative, n_features)
    x = torch.randn((n_samples, n_features), generator=gen, dtype=dtype, device=g)
    coef = torch.zeros((n_features, n_targets), dtype=dtype, device=g)
    coef[:n_informative] = 100.0 * torch.rand((n_informative, n_targets), generator=gen,
                                              dtype=dtype, device=g)
    y = x @ coef + bias
    if noise > 0:
        y = y + noise * torch.randn(y.shape, generator=gen, dtype=dtype, device=g)
    if shuffle:
        perm = torch.randperm(n_samples, generator=gen, device=g)
        x, y = x[perm], y[perm]
    dev = ensure(res).device
    return x.to(dev), y.to(dev), coef.to(dev)


def rmat(
    gen: torch.Generator,
    r_scale: int,
    c_scale: int,
    n_edges: int,
    *,
    theta=None,
    res=None,
) -> torch.Tensor:
    """R-MAT rectangular graph: [n_edges, 2] int32 (src, dst).  At each of
    max(r_scale, c_scale) levels every edge picks a quadrant from that
    level's theta [a, b, c, d] (default 0.57, 0.19, 0.19, 0.05 at every
    level); the row bit is set for c / d, the column bit for b / d."""
    max_scale = max(r_scale, c_scale)
    g = gen.device
    if theta is None:
        theta = torch.tensor([0.57, 0.19, 0.19, 0.05], dtype=torch.float32).repeat(max_scale, 1)
    else:
        theta = torch.as_tensor(theta, dtype=torch.float32).reshape(max_scale, 4)
    theta = theta / theta.sum(dim=1, keepdim=True)
    bounds = torch.cumsum(theta, dim=1)[:, :3].to(g)
    src = torch.zeros(n_edges, dtype=torch.int32, device=g)
    dst = torch.zeros(n_edges, dtype=torch.int32, device=g)
    for lvl in range(max_scale):
        u = torch.rand(n_edges, generator=gen, device=g)
        q = (u[:, None] >= bounds[lvl][None, :]).sum(dim=1)     # quadrant 0..3
        if lvl < r_scale:
            src = (src << 1) | (q >= 2).to(torch.int32)
        if lvl < c_scale:
            dst = (dst << 1) | (q % 2 == 1).to(torch.int32)
    return torch.stack([src, dst], dim=1).to(ensure(res).device)
