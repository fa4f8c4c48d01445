"""Fused pairwise distance + argmin (1-NN) (counterpart of
``raft_tpu.distance.fused_nn``).

Row tiles of the distance matrix (``pairwise.distance_matrix_tile``) are
reduced to (min, argmin) at once, so only a [tile, n] block ever exists,
as raft_tpu's ``_fused_nn_jit`` does on XLA.  The first column wins a tie
(``torch.argmin``'s rule, and ``jnp.argmin``'s).

The L2 score here is raft_tpu's: ``max(|x|^2 + |y|^2 - 2 x.y, 0)``.  The
fused argmin kernel (``kernels.fused_argmin``, kernel #7) scores
``|y|^2 - 2 x.y`` with no |x|^2 and no clamp, which moves ties and
clamped labels, so it is not routed here (see its module).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import Resources, ensure, to_device
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import distance_matrix_tile

_L2 = ("euclidean", "l2", "sqeuclidean")


def _tile_rows_for(res: Resources, n: int, m: int) -> int:
    return min(max(res.workspace_rows(4 * n), 8), max(m, 1))


def _fused_nn(x: torch.Tensor, y: torch.Tensor, metric: str, tile_rows: int, adj=None):
    """(min [m] f32, argmin [m] int32) of each row's distances to y, row
    tile by row tile; ``adj`` [m, n] bool masks the columns a row may
    match (a masked column scores +inf)."""
    m = x.shape[0]
    vals = torch.empty(m, dtype=torch.float32, device=x.device)
    idx = torch.empty(m, dtype=torch.int32, device=x.device)
    for s in range(0, m, tile_rows):
        dist = distance_matrix_tile(x[s:s + tile_rows], y, metric)
        if adj is not None:
            dist = torch.where(adj[s:s + tile_rows], dist, torch.full_like(dist, float("inf")))
        i = torch.argmin(dist, dim=1)
        vals[s:s + tile_rows] = torch.gather(dist, 1, i[:, None])[:, 0]
        idx[s:s + tile_rows] = i.to(torch.int32)
    return vals, idx


@traced("fused_nn.fused_l2_nn")
def fused_l2_nn(x, y, *, sqrt: bool = False,
                res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min_dist [m], argmin [m] int32) of the squared L2 distance from each
    x row to the y rows (its root with ``sqrt``)."""
    res = ensure(res)
    x, y = to_device(x, res.device), to_device(y, res.device)
    vals, idx = _fused_nn(x, y, "sqeuclidean", _tile_rows_for(res, y.shape[0], x.shape[0]))
    return (torch.sqrt(vals) if sqrt else vals), idx


@traced("fused_nn.fused_l2_nn_argmin")
def fused_l2_nn_argmin(x, y, *, res: Optional[Resources] = None) -> torch.Tensor:
    """Argmin only (pylibraft's ``fused_l2_nn_argmin``)."""
    return fused_l2_nn(x, y, res=res)[1]


@traced("fused_nn.fused_distance_nn_argmin")
def fused_distance_nn_argmin(x, y, *, metric: str = "sqeuclidean",
                             res: Optional[Resources] = None) -> torch.Tensor:
    """Fused 1-NN argmin for L2 or cosine (pylibraft's
    ``fused_distance_nn_argmin``)."""
    if metric in _L2:
        return fused_l2_nn(x, y, res=res)[1]
    if metric != "cosine":
        raise ValueError("fused_distance_nn supports l2/sqeuclidean/cosine")
    res = ensure(res)
    x, y = to_device(x, res.device), to_device(y, res.device)
    return _fused_nn(x, y, "cosine", _tile_rows_for(res, y.shape[0], x.shape[0]))[1]


@traced("fused_nn.masked_l2_nn_argmin")
def masked_l2_nn_argmin(x, y, adj, group_idxs=None, *,
                        res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked fused L2 1-NN: rows of x match only the allowed columns of y
    (a row with none allowed gets +inf and id 0).  ``adj`` is a dense
    [m, n] bool mask, or with ``group_idxs`` ([n_groups] end offsets over
    y's rows) the [m, n_groups] group adjacency, expanded here to the
    dense mask."""
    res = ensure(res)
    dev = res.device
    x, y = to_device(x, dev), to_device(y, dev)
    adj = to_device(adj, dev).to(torch.bool)
    n = y.shape[0]
    if group_idxs is not None:
        # column j belongs to group g iff end_{g-1} <= j < end_g; a column
        # past the last end reads the last group, as a clamped gather does
        ends = to_device(group_idxs, dev).to(torch.int64)
        cols = torch.arange(n, device=dev)
        group_of_col = (cols[None, :] >= ends[:, None]).sum(dim=0)
        adj = adj[:, group_of_col.clamp(max=ends.shape[0] - 1)]
    return _fused_nn(x, y, "sqeuclidean", _tile_rows_for(res, n, x.shape[0]), adj)
