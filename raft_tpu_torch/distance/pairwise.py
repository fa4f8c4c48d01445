"""Pairwise distances over every metric of ``DISTANCE_TYPES``, and the
row-tiled fused distance + argmin used by k-means (counterpart of
``raft_tpu.distance.pairwise``).

raft_tpu computes these in XLA (no Pallas kernel), so the port computes
them with ``torch.matmul`` and elementwise torch ops on either device:
full f32, since the package turns TF32 off.

- "Expanded" metrics decompose into Gram terms, ``d(x, y) = f(|x|, |y|,
  x.y)``: one matrix product plus an epilogue (``_expanded_tile``).  When
  both operands are 8-bit integers the Gram matrix is exact, as raft_tpu's
  int32 accumulation makes it (``_int_gram``).
- "Unexpanded" metrics (L1, Canberra, ...) take the elementwise
  [rows, n, d] tile (``_elementwise_tile``), so ``pairwise_distance`` sizes
  its row tiles to the workspace budget.
- Haversine: great-circle distance over [lat, lon] radians.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core import validation
from raft_tpu_torch.core.resources import Resources, ensure, to_device
from raft_tpu_torch.core.trace import traced

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

EXPANDED = {
    "euclidean", "sqeuclidean", "cosine", "inner_product", "correlation", "jaccard",
    "hellinger", "russellrao", "dice",
}

#: largest magnitude of each 8-bit type
_INT8_MAX = {torch.int8: 128, torch.uint8: 255}


def _int_gram(xt: torch.Tensor, y: torch.Tensor) -> Optional[torch.Tensor]:
    """The exact integer Gram x.y^T [m, n] as f32 when both operands are
    8-bit, as raft_tpu's int32 accumulation gives it.  Each block of
    dimensions whose sums stay below 2^24 is one f32 product (exact in any
    order); the blocks add exactly in int64, and the total rounds to f32
    once, as raft_tpu's int32 → f32 cast."""
    if xt.dtype not in _INT8_MAX or y.dtype not in _INT8_MAX or xt.shape[1] > 32_000:
        return None
    d = xt.shape[1]
    block = max(1, ((1 << 24) - 1) // (_INT8_MAX[xt.dtype] * _INT8_MAX[y.dtype]))
    xf, yf = xt.to(torch.float32), y.to(torch.float32)
    total = None
    for s in range(0, d, block):
        part = torch.matmul(xf[:, s:s + block], yf[:, s:s + block].T).to(torch.int64)
        total = part if total is None else total + part
    return total.to(torch.float32)


def _sq_norms(t: torch.Tensor) -> torch.Tensor:
    return (t * t).sum(dim=1)


def _expanded_tile(xt: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """Gram-term metrics: one product and an epilogue, in raft_tpu's order
    of operations."""
    if metric in ("euclidean", "sqeuclidean", "inner_product", "cosine"):
        int_ip = _int_gram(xt, y)
        if int_ip is not None:
            if metric == "inner_product":
                return int_ip
            xx = _sq_norms(xt.to(torch.float32))
            yy = _sq_norms(y.to(torch.float32))
            if metric == "cosine":
                den = torch.clamp(torch.sqrt(xx)[:, None] * torch.sqrt(yy)[None, :], min=1e-30)
                return 1.0 - int_ip / den
            d2 = torch.clamp(xx[:, None] + yy[None, :] - 2.0 * int_ip, min=0.0)
            return torch.sqrt(d2) if metric == "euclidean" else d2
    f32 = xt.to(torch.float32)
    yf = y.to(torch.float32)
    if metric == "hellinger":
        ip = torch.matmul(torch.sqrt(torch.clamp(f32, min=0)), torch.sqrt(torch.clamp(yf, min=0)).T)
        return torch.sqrt(torch.clamp(1.0 - ip, min=0.0))
    ip = torch.matmul(f32, yf.T)
    if metric == "inner_product":
        return ip
    if metric in ("euclidean", "sqeuclidean"):
        d2 = torch.clamp(_sq_norms(f32)[:, None] + _sq_norms(yf)[None, :] - 2.0 * ip, min=0.0)
        return torch.sqrt(d2) if metric == "euclidean" else d2
    if metric == "cosine":
        den = torch.sqrt(_sq_norms(f32))[:, None] * torch.sqrt(_sq_norms(yf))[None, :]
        return 1.0 - ip / torch.clamp(den, min=1e-30)
    if metric == "correlation":
        d = f32.shape[1]
        mx = f32.mean(dim=1)
        my = yf.mean(dim=1)
        # centred inner product by expansion: sum (x - mx)(y - my) = x.y - d mx my
        cip = ip - d * mx[:, None] * my[None, :]
        # variances clamped before the product: cancellation can leave tiny
        # negatives for (near-)constant rows
        vx = torch.clamp(_sq_norms(f32) - d * mx * mx, min=0.0)
        vy = torch.clamp(_sq_norms(yf) - d * my * my, min=0.0)
        denom = torch.sqrt(vx[:, None] * vy[None, :])
        return torch.where(denom > 1e-12, 1.0 - cip / torch.clamp(denom, min=1e-12),
                           torch.ones_like(denom))
    if metric == "jaccard":
        union = f32.sum(dim=1)[:, None] + yf.sum(dim=1)[None, :] - ip
        return torch.where(union > 0, 1.0 - ip / torch.clamp(union, min=1e-30),
                           torch.zeros_like(union))
    if metric == "dice":
        tot = f32.sum(dim=1)[:, None] + yf.sum(dim=1)[None, :]
        return torch.where(tot > 0, 1.0 - 2.0 * ip / torch.clamp(tot, min=1e-30),
                           torch.zeros_like(tot))
    if metric == "russellrao":
        d = f32.shape[1]
        return (d - ip) / d
    raise ValueError(metric)


def _xlogy_ratio(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · log(a / b) where a > 0, else 0 (both floored at 1e-30 inside the
    log), raft_tpu's ``safe_log``."""
    r = a * torch.log(torch.clamp(a, min=1e-30) / torch.clamp(b, min=1e-30))
    return torch.where(a > 0, r, torch.zeros_like(r))


def _elementwise_tile(xt: torch.Tensor, y: torch.Tensor, metric: str, p: float) -> torch.Tensor:
    """Unexpanded metrics over the [rows, n, d] broadcast tile."""
    f32 = xt.to(torch.float32)[:, None, :]
    yf = y.to(torch.float32)[None, :, :]
    if metric == "l1":
        return (f32 - yf).abs().sum(dim=-1)
    if metric == "chebyshev":
        return (f32 - yf).abs().amax(dim=-1)
    if metric == "canberra":
        num = (f32 - yf).abs()
        den = f32.abs() + yf.abs()
        ratio = num / torch.clamp(den, min=1e-30)
        return torch.where(den > 0, ratio, torch.zeros_like(ratio)).sum(dim=-1)
    if metric == "minkowski":
        return ((f32 - yf).abs() ** p).sum(dim=-1) ** (1.0 / p)
    if metric == "braycurtis":
        num = (f32 - yf).abs().sum(dim=-1)
        den = (f32 + yf).abs().sum(dim=-1)
        return torch.where(den > 0, num / torch.clamp(den, min=1e-30), torch.zeros_like(den))
    if metric == "jensenshannon":
        m = 0.5 * (f32 + yf)
        js = 0.5 * (_xlogy_ratio(f32.expand_as(m), m) + _xlogy_ratio(yf.expand_as(m), m)).sum(dim=-1)
        return torch.sqrt(torch.clamp(js, min=0.0))
    if metric == "hamming":
        return (f32 != yf).to(torch.float32).mean(dim=-1)
    if metric == "kl_divergence":
        return _xlogy_ratio(f32.expand(-1, yf.shape[1], -1), yf).sum(dim=-1)
    raise ValueError(metric)


def _haversine_tile(xt: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Great-circle distance over [lat, lon] radians."""
    xt, y = xt.to(torch.float32), y.to(torch.float32)
    lat1, lon1 = xt[:, 0][:, None], xt[:, 1][:, None]
    lat2, lon2 = y[:, 0][None, :], y[:, 1][None, :]
    sdlat = torch.sin(0.5 * (lat2 - lat1))
    sdlon = torch.sin(0.5 * (lon2 - lon1))
    a = sdlat * sdlat + torch.cos(lat1) * torch.cos(lat2) * sdlon * sdlon
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def distance_matrix_tile(x_tile: torch.Tensor, y: torch.Tensor, metric: str,
                         p: float = 2.0) -> torch.Tensor:
    """Distance matrix [rows, n] f32 of one row tile of x against all of y:
    the building block of ``pairwise_distance``, brute-force kNN and the
    fused 1-NN searches."""
    metric = DISTANCE_TYPES[metric]
    if metric == "haversine":
        return _haversine_tile(x_tile, y)
    if metric in EXPANDED:
        return _expanded_tile(x_tile, y, metric)
    return _elementwise_tile(x_tile, y, metric, p)


def argmin_tile_rows(n_centers: int, res) -> int:
    """Row-tile size for a fused distance+argmin against ``n_centers``
    targets, bounded by the workspace budget (the [tile, L] f32 score tile
    is the only distance-matrix memory)."""
    return int(min(max(res.workspace_rows(4 * max(n_centers, 1)), 8), 1 << 16))


def tiled_argmin(x: torch.Tensor, centers: torch.Tensor, metric: str,
                 tile_rows: int) -> torch.Tensor:
    """Labels [n] int64 of the nearest center, one [tile_rows, L] score
    tile at a time.  ``metric`` is "sqeuclidean" (the distance tile:
    max(|x|^2 + |c|^2 - 2 x.c, 0)) or "inner_product" (-x.c); normalize
    first for cosine.  The first center wins a tie."""
    if metric not in ("sqeuclidean", "inner_product"):
        raise ValueError(f"tiled_argmin serves sqeuclidean/inner_product, got {metric!r}")
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], max(1, tile_rows)):
        t = x[s:s + tile_rows]
        d = (-torch.matmul(t, centers.T) if metric == "inner_product"
             else distance_matrix_tile(t, centers, "sqeuclidean"))
        out[s:s + tile_rows] = torch.argmin(d, dim=1)
    return out


@traced("pairwise.pairwise_distance")
def pairwise_distance(x, y=None, *, metric: str = "euclidean", p: float = 2.0,
                      res: Optional[Resources] = None) -> torch.Tensor:
    """Full [m, n] pairwise distance matrix (f32, on the resources'
    device), row-tiled against the workspace budget so the elementwise
    broadcast never exceeds it.  Inputs keep their dtype (two 8-bit inputs
    take the exact integer Gram).  With ``y`` None (or ``x`` itself) the
    diagonal is exactly 0 for every metric but ``inner_product``: the
    expanded form cancels catastrophically there in f32."""
    res = ensure(res)
    dev = res.device
    x_is_y = y is None or y is x
    x = to_device(x, dev)
    y = x if x_is_y else to_device(y, dev)
    validation.check_in(metric, DISTANCE_TYPES, "metric")
    validation.check_matrix(x, "x")
    validation.check_matrix(y, "y")
    validation.check_same_cols(x, y)
    canonical = DISTANCE_TYPES[metric]
    n, d = y.shape
    row_bytes = 4 * n if canonical in EXPANDED or canonical == "haversine" else 4 * n * d
    tile_rows = min(max(res.workspace_rows(row_bytes), 8), max(x.shape[0], 1))
    out = torch.empty((x.shape[0], n), dtype=torch.float32, device=dev)
    for s in range(0, x.shape[0], tile_rows):
        out[s:s + tile_rows] = distance_matrix_tile(x[s:s + tile_rows], y, canonical, p)
    if x_is_y and canonical != "inner_product":
        out.fill_diagonal_(0.0)
    return out
