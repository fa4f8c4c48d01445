"""Nearest-neighbour indexes of the port (counterpart of ``raft_tpu.neighbors``;
sparse kNN and the kNN graph are ``raft_tpu_torch.sparse.neighbors``, as in
raft_tpu).  ``refine`` stays the module (raft_tpu's package rebinds the
name to its function; the port's modules import the module by this
name)."""

from raft_tpu_torch.neighbors import (
    ball_cover,
    brute_force,
    cagra,
    effort,
    extras,
    hnsw,
    ivf_flat,
    ivf_pq,
    nn_descent,
    refine,
    vpq_dataset,
)
from raft_tpu_torch.neighbors.extras import (
    BatchKQuery,
    epsilon_neighborhood,
    masked_l2_nn,
)

__all__ = [
    "ball_cover",
    "brute_force",
    "cagra",
    "effort",
    "extras",
    "hnsw",
    "ivf_flat",
    "ivf_pq",
    "nn_descent",
    "vpq_dataset",
    "refine",
    "BatchKQuery",
    "epsilon_neighborhood",
    "masked_l2_nn",
]
