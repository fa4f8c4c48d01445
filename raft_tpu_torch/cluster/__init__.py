"""Clustering: flat and balanced k-means (counterpart of
``raft_tpu.cluster``; ``fit_sharded``, single-linkage, spectral and
``find_k`` are not ported yet)."""

from raft_tpu_torch.cluster import kmeans_balanced
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

__all__ = [
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
