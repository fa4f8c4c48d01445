"""pylibraft.cluster (counterpart of ``raft_tpu.compat.pylibraft.cluster``):
``KMeansParams``, ``fit``, ``cluster_cost``, ``compute_new_centroids``."""

from __future__ import annotations

from typing import Optional

from raft_tpu_torch.cluster import kmeans as _kmeans
from raft_tpu_torch.compat.pylibraft.common import DeviceResources, on_device, resources_of
from raft_tpu_torch.compat.pylibraft.config import convert_output

KMeansParams = _kmeans.KMeansParams


def _opt(x, handle):
    return None if x is None else on_device(x, handle)


class kmeans:
    """Namespace of pylibraft.cluster.kmeans."""

    KMeansParams = _kmeans.KMeansParams

    @staticmethod
    def fit(params, X, sample_weights=None, handle: Optional[DeviceResources] = None):
        centroids, inertia, n_iter = _kmeans.fit(
            params, on_device(X, handle), _opt(sample_weights, handle), res=resources_of(handle))
        return convert_output(centroids), float(inertia), int(n_iter)

    @staticmethod
    def cluster_cost(X, centroids, handle: Optional[DeviceResources] = None):
        return float(_kmeans.cluster_cost(on_device(X, handle), on_device(centroids, handle),
                                          res=resources_of(handle)))

    @staticmethod
    def compute_new_centroids(X, centroids, labels=None, sample_weights=None,
                              handle: Optional[DeviceResources] = None):
        out = _kmeans.compute_new_centroids(
            on_device(X, handle), on_device(centroids, handle), _opt(labels, handle),
            _opt(sample_weights, handle), res=resources_of(handle))
        return convert_output(out)


fit = kmeans.fit
cluster_cost = kmeans.cluster_cost
compute_new_centroids = kmeans.compute_new_centroids
