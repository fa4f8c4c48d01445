"""Clustering: flat and balanced k-means (each with ``fit_sharded`` over
a ``comms`` mesh), single linkage, spectral partitioning and ``find_k``
(counterpart of ``raft_tpu.cluster``)."""

from raft_tpu_torch.cluster import kmeans_balanced, spectral
from raft_tpu_torch.cluster.auto_find_k import find_k
from raft_tpu_torch.cluster.kmeans import (
    KMeansParams,
    cluster_cost,
    compute_new_centroids,
    fit,
    fit_predict,
    fit_sharded,
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
    "fit_sharded",
    "transform",
    "cluster_cost",
    "compute_new_centroids",
    "kmeans_plus_plus_init",
    "kmeans_balanced",
]
