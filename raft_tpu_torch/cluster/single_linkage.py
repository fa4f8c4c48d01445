"""Single-linkage agglomerative clustering (counterpart of
``raft_tpu.cluster.single_linkage``): a symmetric kNN graph
(``sparse.neighbors.knn_graph``), its Boruvka MST with cross-component
connection rounds (``sparse.solver``), then the dendrogram as a sequential
union-find over the weight-sorted MST edges on the host, as raft_tpu and
the reference build it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, as_f32, ensure
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.sparse import solver as _solver
from raft_tpu_torch.sparse.formats import COO
from raft_tpu_torch.sparse.neighbors import knn_graph


@dataclass
class SingleLinkageOutput:
    labels: torch.Tensor     # [n] cluster ids 0..n_clusters-1
    dendrogram: np.ndarray   # [n-1, 2] merged child pair per step
    deltas: np.ndarray       # [n-1] merge distances
    sizes: np.ndarray        # [n-1] merged cluster sizes
    n_clusters: int


@traced("single_linkage.single_linkage")
def single_linkage(
    x,
    *,
    n_clusters: int = 2,
    c: int = 15,
    metric: str = "sqeuclidean",
    res: Optional[Resources] = None,
) -> SingleLinkageOutput:
    """kNN-graph single linkage (k = max(2, c), at most n - 1)."""
    res = ensure(res)
    x = as_f32(x, res.device)
    n = x.shape[0]
    if not (1 <= n_clusters <= n):
        raise ValueError(f"n_clusters {n_clusters} out of range [1, {n}]")
    k = min(n - 1, max(2, c))
    graph = knn_graph(x, k, metric=metric, res=res)
    rows = graph.rows[:graph.nnz].cpu().numpy()
    cols = graph.cols[:graph.nnz].cpu().numpy()
    data = graph.data[:graph.nnz].cpu().numpy()
    # a kNN graph need not be connected: add each component's lightest
    # edge to another component until the MST spans every row
    for _ in range(32):
        mst_coo, comp, _ = _solver.mst(COO(rows, cols, data, (n, n), device=res.device), res=res)
        if len(np.unique(comp.cpu().numpy())) == 1:
            break
        extra = _solver.cross_component_nn(x, comp, res=res)
        rows = np.concatenate([rows, extra.rows.cpu().numpy()])
        cols = np.concatenate([cols, extra.cols.cpu().numpy()])
        data = np.concatenate([data, extra.data.cpu().numpy()])
    else:
        raise RuntimeError("could not connect MST components")

    er = mst_coo.rows[:mst_coo.nnz].cpu().numpy()
    ec = mst_coo.cols[:mst_coo.nnz].cpu().numpy()
    ew = mst_coo.data[:mst_coo.nnz].cpu().numpy()
    order = np.argsort(ew, kind="stable")
    er, ec, ew = er[order], ec[order], ew[order]

    parent = np.arange(2 * n - 1)
    cluster_of = np.arange(n)
    size = np.ones(2 * n - 1, np.int64)

    def find(u):
        while parent[u] != u:
            parent[u] = parent[parent[u]]
            u = parent[u]
        return u

    dendrogram = np.zeros((n - 1, 2), np.int64)
    deltas = np.zeros(n - 1, np.float64)
    sizes = np.zeros(n - 1, np.int64)
    nxt = n
    for i in range(n - 1):
        ra, rb = find(er[i]), find(ec[i])
        ca, cb = cluster_of[ra], cluster_of[rb]
        dendrogram[i] = (ca, cb)
        deltas[i] = ew[i]
        sz = size[ca] + size[cb]
        sizes[i] = sz
        parent[rb] = ra
        cluster_of[ra] = nxt
        size[nxt] = sz
        nxt += 1

    # flat labels: the union sequence stopped n_clusters - 1 merges early
    parent = np.arange(n)
    for i in range(n - n_clusters):
        ra, rb = find(er[i]), find(ec[i])
        parent[rb] = ra
    roots = np.fromiter((find(u) for u in range(n)), np.int64, n)
    _, labels = np.unique(roots, return_inverse=True)
    return SingleLinkageOutput(
        labels=torch.from_numpy(labels.astype(np.int32)).to(res.device),
        dendrogram=dendrogram,
        deltas=deltas,
        sizes=sizes,
        n_clusters=n_clusters,
    )
