"""Pairwise distances, fused 1-NN and Gram-matrix kernels (counterpart of
``raft_tpu.distance``)."""

from raft_tpu_torch.distance.pairwise import (
    DISTANCE_TYPES,
    distance_matrix_tile,
    pairwise_distance,
)
from raft_tpu_torch.distance.kernels import KernelParams, gram_matrix
from raft_tpu_torch.distance.fused_nn import (
    fused_distance_nn_argmin,
    fused_l2_nn,
    fused_l2_nn_argmin,
    masked_l2_nn_argmin,
)

__all__ = [
    "DISTANCE_TYPES",
    "pairwise_distance",
    "distance_matrix_tile",
    "fused_l2_nn_argmin",
    "fused_distance_nn_argmin",
    "fused_l2_nn",
    "masked_l2_nn_argmin",
    "KernelParams",
    "gram_matrix",
]
