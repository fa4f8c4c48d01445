"""Sparse neighbors: brute-force kNN over CSR rows and the kNN graph of
dense rows (counterpart of ``raft_tpu.sparse.neighbors``;
``cross_component_nn`` lives with the MST solver in ``sparse.solver``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import Resources, as_f32, ensure
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.ops.matrix import merge_topk, select_k_untraced
from raft_tpu_torch.sparse.distance import _densify_rows
from raft_tpu_torch.sparse.formats import COO, CSR


@traced("neighbors.brute_force_knn")
def brute_force_knn(
    dataset: CSR,
    queries: CSR,
    k: int,
    *,
    metric: str = "sqeuclidean",
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN between sparse row sets: dataset row blocks densified,
    dense distances to the densified queries, each block's top-k
    (``ops.matrix.select_k``: the select_k kernel on the card) merged into
    the running one (``merge_topk``: smallest id wins a tie)."""
    from raft_tpu_torch.distance.pairwise import pairwise_distance

    res = ensure(res)
    dataset, queries = dataset.to(res.device), queries.to(res.device)
    n, d = dataset.shape
    q = queries.shape[0]
    if k > n:
        raise ValueError(f"k={k} > dataset rows {n}")
    tile = max(k, min(n, res.workspace_rows(4 * (2 * d + q), cap=4096)))
    q_tiles = [_densify_rows(queries, s, min(tile, q - s)) for s in range(0, q, tile)]
    vals = idx = None
    for s in range(0, n, tile):
        cnt = min(tile, n - s)
        blk = _densify_rows(dataset, s, cnt)
        dist = torch.cat([pairwise_distance(qb, blk, metric=metric, res=res) for qb in q_tiles])
        kk = min(k, cnt)
        v, i = select_k_untraced(dist, kk, select_min=True)
        i = i + s
        if kk < k:
            pad = k - kk
            v = torch.cat([v, torch.full((q, pad), float("inf"), dtype=v.dtype,
                                         device=v.device)], dim=1)
            i = torch.cat([i, torch.full((q, pad), -1, dtype=i.dtype, device=i.device)], dim=1)
        if vals is None:
            vals, idx = v, i
        else:
            vals, idx = merge_topk(vals, idx, v, i, k)
    return vals, idx


@traced("neighbors.knn_graph")
def knn_graph(
    dataset,
    k: int,
    *,
    metric: str = "sqeuclidean",
    res: Optional[Resources] = None,
) -> COO:
    """Symmetric kNN adjacency of a dense dataset as a COO (max of the two
    directions): ``brute_force.knn`` at k + 1 (the fused_knn kernel on the
    card for the L2 / inner-product metrics), each row's own id dropped
    wherever it landed."""
    from raft_tpu_torch.neighbors import brute_force as dense_bf
    from raft_tpu_torch.sparse.linalg import symmetrize

    res = ensure(res)
    x = as_f32(dataset, res.device)
    n = x.shape[0]
    dists, ids = dense_bf.knn(x, x, k + 1, metric=metric, res=res)
    self_col = ids == torch.arange(n, dtype=ids.dtype, device=ids.device)[:, None]
    order = torch.argsort(self_col.to(torch.int8), dim=1, stable=True)
    ids = torch.gather(ids, 1, order)[:, :k]
    dists = torch.gather(dists, 1, order)[:, :k]
    rows = torch.arange(n, dtype=torch.int32, device=x.device).repeat_interleave(k)
    coo = COO(rows, ids.reshape(-1), dists.reshape(-1), (n, n))
    return symmetrize(coo, op="max")
