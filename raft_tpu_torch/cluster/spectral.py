"""Spectral graph partitioning and modularity maximization (counterpart of
``raft_tpu.cluster.spectral``).

The Laplacian and modularity matvecs are ``sparse.linalg.spmv_coo`` (the
csr_spmm kernel on the card), the eigensolver is ``ops.lanczos`` (full
reorthogonalization), and the row-normalized embedding is clustered by
``cluster.kmeans``.  Every sum of the path runs in a fixed order, so one
seed gives the same labels and eigenvalues run after run on the card; the
labels are not raft_tpu's (its draws are threefry's), so compare them by
adjusted Rand index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.core.resources import Resources, ensure, to_device
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.ops.lanczos import eigsh_lanczos
from raft_tpu_torch.sparse.formats import COO
from raft_tpu_torch.sparse.linalg import laplacian, spmv_coo, weighted_degree


def _cluster_embedding(emb, n_clusters, seed, res):
    # rows scaled to unit norm before k-means, as raft_tpu (and the
    # reference's transform_eigen_matrix) does
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
    params = kmeans.KMeansParams(n_clusters=n_clusters, seed=seed, n_init=3)
    centers, _, _ = kmeans.fit(params, emb, res=res)
    return kmeans.predict(centers, emb, res=res)


def fit_embedding(
    adj: COO,
    n_components: int,
    *,
    normalized: bool = False,
    seed: int = 0,
) -> torch.Tensor:
    """Smallest-eigenvector Laplacian embedding [n, n_components], the
    trivial constant eigenvector skipped; runs on the adjacency's device."""
    n = adj.shape[0]
    lap = laplacian(adj, normalized=normalized)
    _, vecs = eigsh_lanczos(lambda v: spmv_coo(lap, v), n, n_components + 1,
                            which="smallest", seed=seed, res=Resources(device=adj.device))
    return vecs[:, 1:n_components + 1]


@traced("spectral.partition")
def partition(
    adj: COO,
    n_clusters: int,
    *,
    n_eigenvecs: int = 0,
    normalized: bool = True,
    seed: int = 0,
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral min-balanced-cut partition: the Laplacian's smallest
    eigenvectors clustered by k-means.  Returns (labels [n], eigenvalues
    [k])."""
    res = ensure(res)
    adj = adj.to(res.device)
    n = adj.shape[0]
    k = n_eigenvecs or n_clusters
    lap = laplacian(adj, normalized=normalized)
    vals, vecs = eigsh_lanczos(lambda v: spmv_coo(lap, v), n, k, which="smallest", seed=seed,
                               res=res)
    labels = _cluster_embedding(vecs, n_clusters, seed, res)
    return labels, vals


def analyze_partition(adj: COO, labels, n_clusters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edge cut cost, smallest cluster size)."""
    n = adj.shape[0]
    labels = to_device(labels, adj.device).long()
    lr = labels[torch.clamp(adj.rows.long(), 0, n - 1)]
    lc = labels[torch.clamp(adj.cols.long(), 0, n - 1)]
    cut = torch.where(adj.valid & (lr != lc), adj.data, torch.zeros_like(adj.data)).sum() / 2.0
    sizes = torch.bincount(labels, minlength=n_clusters)[:n_clusters].to(torch.int32)
    return cut, sizes.min()


@traced("spectral.modularity_maximization")
def modularity_maximization(
    adj: COO,
    n_clusters: int,
    *,
    n_eigenvecs: int = 0,
    seed: int = 0,
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clusters from the largest eigenvectors of the modularity matrix
    B = A - d d^T / 2m, kept implicit (one spmv and a rank-1 correction a
    matvec).  Returns (labels [n], eigenvalues [k])."""
    res = ensure(res)
    adj = adj.to(res.device)
    n = adj.shape[0]
    k = n_eigenvecs or n_clusters
    d = weighted_degree(adj)
    two_m = torch.clamp(d.sum(), min=1e-30)

    def matvec(v):
        return spmv_coo(adj, v) - d * (torch.dot(d, v) / two_m)

    vals, vecs = eigsh_lanczos(matvec, n, k, which="largest", seed=seed, res=res)
    labels = _cluster_embedding(vecs, n_clusters, seed, res)
    return labels, vals


def analyze_modularity(adj: COO, labels) -> torch.Tensor:
    """Modularity Q of a labelling."""
    n = adj.shape[0]
    labels = to_device(labels, adj.device).long()
    d = weighted_degree(adj)
    two_m = torch.clamp(d.sum(), min=1e-30)
    lr = labels[torch.clamp(adj.rows.long(), 0, n - 1)]
    lc = labels[torch.clamp(adj.cols.long(), 0, n - 1)]
    a_in = torch.where(adj.valid & (lr == lc), adj.data, torch.zeros_like(adj.data)).sum()
    k = int(labels.max()) + 1
    d_per = torch.zeros(k, dtype=d.dtype, device=d.device).index_add(0, labels, d)
    return a_in / two_m - ((d_per / two_m) ** 2).sum()
