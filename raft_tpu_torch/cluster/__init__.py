"""Clustering: flat and balanced k-means, single linkage, spectral
partitioning and ``find_k`` (counterpart of ``raft_tpu.cluster``;
``fit_sharded`` is ROADMAP Queue 1 item 7)."""

from raft_tpu_torch.cluster import kmeans_balanced, spectral
from raft_tpu_torch.cluster.auto_find_k import find_k
from raft_tpu_torch.cluster.kmeans import (
    KMeansParams,
    cluster_cost,
    compute_new_centroids,
    fit,
    fit_predict,
    kmeans_plus_plus_init,
    predict,
    transform,
)
from raft_tpu_torch.cluster.single_linkage import SingleLinkageOutput, single_linkage

__all__ = [
    "spectral",
    "find_k",
    "SingleLinkageOutput",
    "single_linkage",
    "KMeansParams",
    "fit",
    "predict",
    "fit_predict",
    "transform",
    "cluster_cost",
    "compute_new_centroids",
    "kmeans_plus_plus_init",
    "kmeans_balanced",
]
