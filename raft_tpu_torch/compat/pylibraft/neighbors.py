"""pylibraft.neighbors (counterpart of ``raft_tpu.compat.pylibraft.neighbors``):
``brute_force``, ``ivf_flat``, ``ivf_pq``, ``cagra``, ``hnsw``, ``refine``,
``rbc`` (random ball cover) and ``eps_neighborhood``."""

from __future__ import annotations

from typing import Optional

from raft_tpu_torch.compat.pylibraft.common import DeviceResources, on_device, resources_of
from raft_tpu_torch.compat.pylibraft.config import convert_output
from raft_tpu_torch.neighbors import ball_cover as _ball_cover
from raft_tpu_torch.neighbors import brute_force as _bf
from raft_tpu_torch.neighbors import cagra as _cagra
from raft_tpu_torch.neighbors import extras as _extras
from raft_tpu_torch.neighbors import hnsw as _hnsw
from raft_tpu_torch.neighbors import ivf_flat as _ivf_flat
from raft_tpu_torch.neighbors import ivf_pq as _ivf_pq
from raft_tpu_torch.neighbors.refine import refine as _refine


def _pair(out):
    return convert_output(out[0]), convert_output(out[1])


class brute_force:
    @staticmethod
    def knn(dataset, queries, k, metric="sqeuclidean", handle: Optional[DeviceResources] = None):
        return _pair(_bf.knn(on_device(dataset, handle), on_device(queries, handle), int(k),
                             metric=metric, res=resources_of(handle)))


class _IndexModule:
    """The shared surface of the ivf_flat / ivf_pq / cagra namespaces:
    IndexParams, SearchParams, build, search, save, load."""

    _mod = None

    @classmethod
    def build(cls, params, dataset, handle: Optional[DeviceResources] = None):
        return cls._mod.build(params, on_device(dataset, handle), res=resources_of(handle))

    @classmethod
    def search(cls, params, index, queries, k, handle: Optional[DeviceResources] = None):
        return _pair(cls._mod.search(params, index, on_device(queries, handle), int(k),
                                     res=resources_of(handle)))

    @classmethod
    def save(cls, filename, index):
        cls._mod.save(filename, index)

    @classmethod
    def load(cls, filename, handle: Optional[DeviceResources] = None):
        return cls._mod.load(filename, res=resources_of(handle))


class _Extendable(_IndexModule):
    @classmethod
    def extend(cls, index, new_vectors, new_indices=None,
               handle: Optional[DeviceResources] = None):
        return cls._mod.extend(index, on_device(new_vectors, handle),
                               None if new_indices is None else on_device(new_indices, handle),
                               res=resources_of(handle))


class ivf_flat(_Extendable):
    _mod = _ivf_flat
    IndexParams = _ivf_flat.IndexParams
    SearchParams = _ivf_flat.SearchParams


class ivf_pq(_Extendable):
    _mod = _ivf_pq
    IndexParams = _ivf_pq.IndexParams
    SearchParams = _ivf_pq.SearchParams


class cagra(_IndexModule):
    _mod = _cagra
    IndexParams = _cagra.IndexParams
    SearchParams = _cagra.SearchParams


class hnsw:
    """pylibraft.neighbors.hnsw: a CAGRA index exported in hnswlib's
    layout, loaded back and searched on the CAGRA walk."""

    @staticmethod
    def from_cagra(index, filename, handle: Optional[DeviceResources] = None):
        _hnsw.serialize_to_hnswlib(filename, index, res=resources_of(handle))
        return _hnsw.load(filename, index.dim, metric=index.metric, res=resources_of(handle))

    @staticmethod
    def load(filename, dim, metric="sqeuclidean", handle: Optional[DeviceResources] = None):
        return _hnsw.load(filename, dim, metric=metric, res=resources_of(handle))

    @staticmethod
    def search(index, queries, k, ef=64, handle: Optional[DeviceResources] = None):
        return _pair(_hnsw.search(index, on_device(queries, handle), int(k), ef=ef,
                                  res=resources_of(handle)))


def refine(dataset, queries, candidates, k, metric="sqeuclidean",
           handle: Optional[DeviceResources] = None):
    return _pair(_refine(on_device(dataset, handle), on_device(queries, handle),
                         on_device(candidates, handle), int(k), metric=metric,
                         res=resources_of(handle)))


class rbc:
    """pylibraft.neighbors.rbc: random ball cover."""

    @staticmethod
    def build(dataset, metric="sqeuclidean", n_landmarks=0,
              handle: Optional[DeviceResources] = None):
        return _ball_cover.build(on_device(dataset, handle), metric=metric,
                                 n_landmarks=n_landmarks, res=resources_of(handle))

    @staticmethod
    def query(index, queries, k, handle: Optional[DeviceResources] = None):
        return _pair(_ball_cover.knn_query(index, on_device(queries, handle), int(k),
                                           res=resources_of(handle)))

    @staticmethod
    def eps_query(index, queries, eps, handle: Optional[DeviceResources] = None):
        return _pair(_ball_cover.eps_nn(index, on_device(queries, handle), eps,
                                        res=resources_of(handle)))


def eps_neighborhood(x, y, eps_sq, handle: Optional[DeviceResources] = None):
    return _pair(_extras.epsilon_neighborhood(on_device(x, handle), on_device(y, handle), eps_sq,
                                              res=resources_of(handle)))
