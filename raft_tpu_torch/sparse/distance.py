"""Sparse pairwise distances (counterpart of ``raft_tpu.sparse.distance``).

Two lanes, as raft_tpu's:

* **Gram-term metrics** (L2, IP, cosine, correlation, hellinger, jaccard,
  dice, russellrao): the sparse Gram matrix ``A . B^T`` plus per-row
  statistics.  The statistics are row sums over the slots in slot order
  (``kernels.csr_spmm.row_sums``); the Gram matrix accumulates over
  **feature tiles**, each densifying ``[n_rows, tile_d]`` columns of both
  operands into one ``torch.matmul`` (f32, TF32 off), so peak memory is
  ``O(n . tile_d)`` whatever the column count.
* **Elementwise metrics** (L1, Linf, Canberra, Lp, Bray-Curtis,
  Jensen-Shannon, Hamming, KL): per-feature terms added (max-ed for
  Linf) over the same feature tiles, a ``[row_tile, n_b, tile_d]``
  broadcast at a time.

Densifying sums repeated (row, col) slots in slot order
(``formats._dense_from_slots``).
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import Resources, ensure
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES
from raft_tpu_torch.kernels import csr_spmm as _csr
from raft_tpu_torch.sparse.formats import CSR, _dense_from_slots

_GRAM_METRICS = {
    "sqeuclidean", "euclidean", "inner_product", "cosine", "correlation", "hellinger",
    "jaccard", "dice", "russellrao",
}

_ELEMENTWISE_METRICS = {
    "l1", "chebyshev", "canberra", "minkowski", "braycurtis", "jensenshannon", "hamming",
    "kl_divergence",
}


def _densify_rows(csr: CSR, start: int, count: int) -> torch.Tensor:
    """Rows [start, start + count) as a dense [count, n_cols] block."""
    local = csr.row_ids() - start
    in_tile = csr.valid & (local >= 0) & (local < count)
    return _dense_from_slots((count, csr.shape[1]), local, csr.indices, csr.data, in_tile)


def _row_stats(csr: CSR):
    """(sum of squares, sum, count of nonzeros) per row, f32."""
    w = csr.data.to(torch.float32)
    norm2 = _csr.row_sums(csr.indptr, w * w)
    s = _csr.row_sums(csr.indptr, w)
    live = csr.valid & (w != 0)
    nnz = torch.bincount(csr.row_ids()[live].long(), minlength=csr.shape[0])[:csr.shape[0]]
    return norm2, s, nnz.to(torch.float32)


def row_norms_sq(csr: CSR) -> torch.Tensor:
    """|row|^2 for every row (slot sums; no densify)."""
    return _row_stats(csr)[0]


def _densify_dtile(csr: CSR, col_start: int, tile_d: int, transform: str = "none"):
    """Columns [col_start, col_start + tile_d) of all rows, f32 (``sqrt``
    applied to the values first for hellinger)."""
    local_c = csr.indices - col_start
    in_tile = csr.valid & (local_c >= 0) & (local_c < tile_d)
    v = csr.data.to(torch.float32)
    if transform == "sqrt":
        v = torch.sqrt(torch.clamp(v, min=0.0))
    return _dense_from_slots((csr.shape[0], tile_d), csr.row_ids(), local_c, v, in_tile)


def _sparse_gram(a: CSR, b: CSR, res: Resources, transform: str = "none") -> torch.Tensor:
    """A . B^T accumulated over feature tiles (peak memory
    O((n_a + n_b) tile_d))."""
    n_a, d = a.shape
    n_b = b.shape[0]
    per_col = 4 * (n_a + n_b)
    tile_d = int(min(d, max(128, res.workspace_limit_bytes // (2 * max(per_col, 1)))))
    gram = torch.zeros((n_a, n_b), dtype=torch.float32, device=a.device)
    for s in range(0, d, tile_d):
        da = _densify_dtile(a, s, tile_d, transform)
        db = _densify_dtile(b, s, tile_d, transform)
        gram = gram + torch.matmul(da, db.T)
    return gram


def _safe_xlog(a, b):
    return torch.where(a > 0, a * torch.log(torch.clamp(a, min=1e-30) / torch.clamp(b, min=1e-30)),
                       torch.zeros_like(a))


def _ew_partial(da, db, metric: str, p: float):
    """Partial terms over one feature tile: da [ta, td], db [nb, td] ->
    tuple of [ta, nb]."""
    x = da[:, None, :]
    y = db[None, :, :]
    if metric == "l1":
        return ((x - y).abs().sum(-1),)
    if metric == "chebyshev":
        return ((x - y).abs().amax(-1),)
    if metric == "canberra":
        num = (x - y).abs()
        den = x.abs() + y.abs()
        return (torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                            torch.zeros_like(num)).sum(-1),)
    if metric == "minkowski":
        return (((x - y).abs() ** p).sum(-1),)
    if metric == "braycurtis":
        return ((x - y).abs().sum(-1), (x + y).abs().sum(-1))
    if metric == "jensenshannon":
        m = 0.5 * (x + y)
        return ((_safe_xlog(x, m) + _safe_xlog(y, m)).sum(-1),)
    if metric == "hamming":
        return ((x != y).to(torch.float32).sum(-1),)
    if metric == "kl_divergence":
        return (_safe_xlog(x, y).sum(-1),)
    raise ValueError(metric)


def _ew_finalize(partials, metric: str, p: float, d: int):
    if metric == "minkowski":
        return partials[0] ** (1.0 / p)
    if metric == "braycurtis":
        num, den = partials
        return torch.where(den > 0, num / torch.clamp(den, min=1e-30), torch.zeros_like(num))
    if metric == "jensenshannon":
        return torch.sqrt(torch.clamp(0.5 * partials[0], min=0.0))
    if metric == "hamming":
        return partials[0] / d
    return partials[0]


def _elementwise_sparse(a: CSR, b: CSR, metric: str, p: float, res: Resources):
    n_a, d = a.shape
    n_b = b.shape[0]
    tile_d = int(min(d, max(64, res.workspace_rows(4 * (n_a + n_b), cap=4096))))
    tile_a = max(8, res.workspace_rows(4 * n_b * tile_d, cap=4096))
    n_acc = 2 if metric == "braycurtis" else 1
    partials = [torch.zeros((n_a, n_b), dtype=torch.float32, device=a.device)
                for _ in range(n_acc)]
    for s in range(0, d, tile_d):
        da = _densify_dtile(a, s, tile_d)
        db = _densify_dtile(b, s, tile_d)
        for t in range(0, n_a, tile_a):
            parts = _ew_partial(da[t:t + tile_a], db, metric, p)
            for acc, pp in zip(partials, parts):
                if metric == "chebyshev":
                    acc[t:t + tile_a] = torch.maximum(acc[t:t + tile_a], pp)
                else:
                    acc[t:t + tile_a] += pp
    return _ew_finalize(partials, metric, p, d)


@traced("distance.pairwise_distance_sparse")
def pairwise_distance_sparse(
    a: CSR,
    b: CSR,
    *,
    metric: str = "sqeuclidean",
    p: float = 2.0,
    res: Optional[Resources] = None,
) -> torch.Tensor:
    """All-pairs distances between the rows of two CSR matrices -> dense
    [a_rows, b_rows] f32 (raft_tpu's sparse metric coverage)."""
    res = ensure(res)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"column mismatch {a.shape} vs {b.shape}")
    a, b = a.to(res.device), b.to(res.device)
    canonical = DISTANCE_TYPES[metric]
    d = a.shape[1]
    if canonical in _ELEMENTWISE_METRICS:
        return _elementwise_sparse(a, b, canonical, p, res)
    if canonical not in _GRAM_METRICS:
        raise ValueError(f"unsupported sparse metric {metric!r}")
    if canonical == "hellinger":
        ip = _sparse_gram(a, b, res, transform="sqrt")
        return torch.sqrt(torch.clamp(1.0 - ip, min=0.0))
    ip = _sparse_gram(a, b, res)
    n2a, sa, _ = _row_stats(a)
    n2b, sb, _ = _row_stats(b)
    if canonical == "inner_product":
        return ip
    if canonical in ("euclidean", "sqeuclidean"):
        d2 = torch.clamp(n2a[:, None] + n2b[None, :] - 2.0 * ip, min=0.0)
        return torch.sqrt(d2) if canonical == "euclidean" else d2
    if canonical == "cosine":
        denom = torch.sqrt(n2a)[:, None] * torch.sqrt(n2b)[None, :]
        return 1.0 - ip / torch.clamp(denom, min=1e-30)
    if canonical == "correlation":
        cip = ip - sa[:, None] * sb[None, :] / d
        vx = torch.clamp(n2a - sa * sa / d, min=0.0)
        vy = torch.clamp(n2b - sb * sb / d, min=0.0)
        denom = torch.sqrt(vx[:, None] * vy[None, :])
        return torch.where(denom > 1e-12, 1.0 - cip / torch.clamp(denom, min=1e-12),
                           torch.ones_like(cip))
    if canonical == "jaccard":
        union = sa[:, None] + sb[None, :] - ip
        return torch.where(union > 0, 1.0 - ip / torch.clamp(union, min=1e-30),
                           torch.zeros_like(ip))
    if canonical == "dice":
        tot = sa[:, None] + sb[None, :]
        return torch.where(tot > 0, 1.0 - 2.0 * ip / torch.clamp(tot, min=1e-30),
                           torch.zeros_like(ip))
    if canonical == "russellrao":
        return (d - ip) / d
    raise ValueError(canonical)
