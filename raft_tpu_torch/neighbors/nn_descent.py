"""Exact kNN graphs for CAGRA's ``build_algo="brute_force"`` (counterpart
of the ``Index`` and ``build_exact`` of ``raft_tpu.neighbors.nn_descent``).

raft_tpu's NN-descent builds themselves (``build``, ``build_batch``) are not
ported yet: ``cagra.build`` raises ``NotImplementedError`` for
``build_algo`` "nn_descent" and "nn_descent_batch".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from raft_tpu_torch.core.resources import Resources, as_f32, ensure
from raft_tpu_torch.neighbors import brute_force


@dataclass
class Index:
    """A kNN graph: neighbour ids and their distances, nearest first."""

    graph: torch.Tensor       # [n, graph_degree] int32
    distances: torch.Tensor   # [n, graph_degree] f32


def build_exact(dataset, graph_degree: int, metric: str = "sqeuclidean", *,
                res: Optional[Resources] = None) -> Index:
    """The exact kNN graph: ``brute_force.knn`` of every row against the
    dataset for ``graph_degree + 1`` neighbours, then the row's own id
    dropped wherever it ranked (the last column when it did not appear)."""
    res = ensure(res)
    x = as_f32(dataset, res.device)
    dists, ids = brute_force.knn(x, x, graph_degree + 1, metric=metric, res=res)
    self_col = ids == torch.arange(x.shape[0], dtype=ids.dtype, device=ids.device)[:, None]
    order = torch.sort(self_col.to(torch.uint8), dim=1, stable=True).indices
    ids = torch.gather(ids, 1, order)[:, :graph_degree]
    dists = torch.gather(dists, 1, order)[:, :graph_degree]
    return Index(graph=ids, distances=dists)
