"""Sparse formats, linear algebra, ops, distances and graph primitives
(counterpart of ``raft_tpu.sparse``)."""

from raft_tpu_torch.sparse.formats import COO, CSR
from raft_tpu_torch.sparse import convert, distance, linalg, neighbors, op, solver

__all__ = ["COO", "CSR", "convert", "distance", "linalg", "neighbors", "op", "solver"]
