"""Smaller neighbour primitives: the epsilon neighbourhood, masked L2 1-NN
and incremental batch-k queries (counterpart of
``raft_tpu.neighbors.extras``; the reference's
``epsilon_neighborhood.cuh``, ``distance/masked_nn.cuh`` and
``knn_brute_force_batch_k_query.cuh``).

raft_tpu computes these in XLA (no Pallas kernel), so the port computes
them with ``torch.matmul`` and elementwise ops in row tiles; the batch-k
query runs ``brute_force.knn`` (fused_knn, kernel #2, on the card).

An epsilon test is decided exactly (:func:`l2_eps_hits`): the expanded
f32 distance decides every pair it cannot get wrong, and the pairs within
its rounding bound of ``eps`` are decided again in float64
(:func:`exact_sq_le`).  So the answer does not depend on the tile shapes
the matrix product runs at, and ``ball_cover.eps_nn`` (which scores the
same pairs in batched tiles of balls) gives the same adjacency as
:func:`epsilon_neighborhood`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import Resources, ensure, resolve_device, to_device
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import distance_matrix_tile
from raft_tpu_torch.neighbors import brute_force

#: pairs of the float64 re-decision evaluated at once
_EXACT_CHUNK = 1 << 20


def l2_rounding_bound(d: int, x2_max: float, y2_max: float) -> float:
    """An upper bound on |computed - exact| of the f32 expanded squared
    distance ``max(|x|^2 + |y|^2 - 2 x.y, 0)`` over d dimensions whose
    squared norms are at most ``x2_max`` / ``y2_max``: each of |x|^2, |y|^2
    and x.y is a sum of d rounded terms (γ_d = d u each, summed in any
    order), and the two additions round once more; u = 2^-24."""
    return (2 * d + 8) * 2.0 ** -24 * (x2_max + y2_max)


def exact_sq_le(x: torch.Tensor, i: torch.Tensor, y: torch.Tensor, j, eps_sq: float
                ) -> torch.Tensor:
    """[P] bool, ``|x[i] - y[j]|^2 <= eps_sq`` decided in float64 from the
    f32 rows, ``_EXACT_CHUNK`` pairs at a time; ``j`` is an index tensor or
    a tuple of them over y's leading dimensions."""
    js = j if isinstance(j, tuple) else (j,)
    out = torch.empty(i.shape[0], dtype=torch.bool, device=x.device)
    for s in range(0, i.shape[0], _EXACT_CHUNK):
        e = s + _EXACT_CHUNK
        diff = x[i[s:e]].to(torch.float64) - y[tuple(t[s:e] for t in js)].to(torch.float64)
        out[s:e] = (diff * diff).sum(dim=1) <= float(eps_sq)
    return out


def l2_eps_hits(x: torch.Tensor, y: torch.Tensor, eps_sq: float, bound: float) -> torch.Tensor:
    """[m, n] bool, ``|x_i - y_j|^2 <= eps_sq``, decided exactly: the f32
    distance tile decides every pair farther than ``bound`` (its rounding
    bound, :func:`l2_rounding_bound`) from ``eps_sq``; the rest are
    decided again by :func:`exact_sq_le`."""
    d = distance_matrix_tile(x, y, "sqeuclidean")
    hits = d <= eps_sq
    i, j = torch.nonzero((d - eps_sq).abs() <= bound).unbind(1)
    hits[i, j] = exact_sq_le(x, i, y, j, eps_sq)
    return hits


def sq_norm_max(t: torch.Tensor) -> float:
    """The largest |row|^2 of ``t`` (0 for no rows)."""
    return float((t * t).sum(dim=1).max()) if t.shape[0] else 0.0


@traced("extras.epsilon_neighborhood")
def epsilon_neighborhood(x, y, eps_sq: float, *,
                         res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean adjacency ``adj[i, j] = |x_i - y_j|^2 <= eps_sq`` [m, n] and
    each row's degree [m] int32 (the reference's ``eps_neighbors_l2sq``:
    a dense bool output and the vertex degrees), in row tiles sized by the
    workspace budget."""
    res = ensure(res)
    dev = res.device
    x = to_device(x, dev).to(torch.float32)
    y = to_device(y, dev).to(torch.float32)
    m, n = x.shape[0], y.shape[0]
    tile = max(1, min(m, res.workspace_rows(5 * n, cap=8192)))
    bound = l2_rounding_bound(x.shape[1], sq_norm_max(x), sq_norm_max(y))
    adj = torch.empty((m, n), dtype=torch.bool, device=dev)
    for s in range(0, m, tile):
        adj[s:s + tile] = l2_eps_hits(x[s:s + tile], y, eps_sq, bound)
    return adj, adj.sum(dim=1, dtype=torch.int32)


@traced("extras.masked_l2_nn")
def masked_l2_nn(x, y, adj, group_idxs, *, sqrt: bool = False,
                 res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked fused L2 1-NN (the reference's ``masked_l2_nn``).

    ``adj`` [m, n_groups] marks which y groups each x row may match;
    ``group_idxs`` [n_groups] are the *exclusive end offsets* of contiguous
    y groups (a row of y past the last end belongs to the last group).
    Returns (min distance [m], argmin [m] int32); a row with no admissible
    y gets (+inf, -1).  Row tiles of the distance matrix are masked and
    reduced as they are made, so no [m, n] matrix exists.  Runs on ``res``
    when given, else where ``x`` lives (numpy: cuda)."""
    dev = resolve_device(res, x)
    x = to_device(x, dev).to(torch.float32)
    y = to_device(y, dev).to(torch.float32)
    adj = to_device(adj, dev).to(torch.bool)
    ends = to_device(group_idxs, dev).to(torch.int64)
    n = y.shape[0]
    group_of_col = torch.searchsorted(ends, torch.arange(n, device=dev), right=True)
    group_of_col = group_of_col.clamp(max=ends.shape[0] - 1)
    m = x.shape[0]
    budget = res if isinstance(res, Resources) else Resources(device=dev)
    tile = max(1, min(m, budget.workspace_rows(5 * max(n, 1), cap=8192)))
    vals = torch.empty(m, dtype=torch.float32, device=dev)
    ids = torch.empty(m, dtype=torch.int32, device=dev)
    for s in range(0, m, tile):
        d = distance_matrix_tile(x[s:s + tile], y, "sqeuclidean")
        d = torch.where(adj[s:s + tile][:, group_of_col], d, torch.full_like(d, float("inf")))
        j = torch.argmin(d, dim=1)
        v = torch.gather(d, 1, j[:, None])[:, 0]
        vals[s:s + tile] = v
        ids[s:s + tile] = torch.where(torch.isfinite(v), j, torch.full_like(j, -1)).to(torch.int32)
    if sqrt:
        vals = torch.sqrt(torch.clamp(vals, min=0.0))
    return vals, ids


class BatchKQuery:
    """Incremental-k query: iterate over successive batches of neighbours
    (the reference's ``batch_k_query``).  Each ``next()`` selects again
    only when the cached horizon is passed, to at least twice the cached k
    (the reference's capacity doubling); each selection is one
    ``brute_force.knn``."""

    def __init__(self, dataset, queries, batch_size: int, *,
                 metric: str = "sqeuclidean", res: Optional[Resources] = None):
        self.res = ensure(res)
        dev = self.res.device
        self.dataset = to_device(dataset, dev).to(torch.float32)
        self.queries = to_device(queries, dev).to(torch.float32)
        self.batch_size = int(batch_size)
        self.metric = metric
        self._pos = 0
        self._vals: Optional[torch.Tensor] = None
        self._ids: Optional[torch.Tensor] = None

    def _ensure(self, upto: int) -> None:
        have = 0 if self._vals is None else self._vals.shape[1]
        if upto <= have:
            return
        horizon = min(self.dataset.shape[0], max(upto, 2 * max(have, self.batch_size)))
        self._vals, self._ids = brute_force.knn(
            self.dataset, self.queries, horizon, metric=self.metric, res=self.res)

    def __iter__(self):
        self._pos = 0
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._pos >= self.dataset.shape[0]:
            raise StopIteration
        end = min(self._pos + self.batch_size, self.dataset.shape[0])
        self._ensure(end)
        v = self._vals[:, self._pos:end]
        i = self._ids[:, self._pos:end]
        self._pos = end
        return v, i
