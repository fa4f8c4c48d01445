"""Exact (brute-force) kNN — the oracle every recall is scored against
(counterpart of ``raft_tpu.neighbors.brute_force``; this slice ports
sqeuclidean, euclidean and inner_product, unfiltered).

Routing, as raft_tpu's fused path (``brute_force.py:197-222``) with no
switch: CUDA tensors go through ``kernels.fused_knn.fused_l2_topk``, which
serves ``k <= 512`` and raises past it; CPU tensors take its plain version
at any k.  The kernel returns partial scores; |q|^2 is added here and
clamped at 0, and euclidean takes the root.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import validation
from raft_tpu_torch.core.resources import Resources, as_f32, ensure
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES
from raft_tpu_torch.kernels import stamp_kernel_path
from raft_tpu_torch.kernels.fused_knn import fused_l2_topk, fused_l2_topk_torch

_SUPPORTED = ("sqeuclidean", "euclidean", "inner_product")


def knn(
    dataset,
    queries,
    k: int,
    *,
    metric: str = "sqeuclidean",
    sample_filter=None,
    deleted_mask=None,
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: (distances [n_q, k] f32, indices [n_q, k] int32).
    ``inner_product`` returns the largest products, every other metric the
    smallest distances."""
    if sample_filter is not None or deleted_mask is not None:
        raise NotImplementedError(
            "filtered brute force arrives with the filters slice of the port"
        )
    res = ensure(res)
    device = res.device
    validation.check_in(metric, DISTANCE_TYPES, "metric")
    canonical = DISTANCE_TYPES[metric]
    if canonical not in _SUPPORTED:
        raise NotImplementedError(
            f"brute_force metric {metric!r} arrives in a later slice of the port"
        )
    dataset = as_f32(dataset, device)
    queries = as_f32(queries, device)
    validation.check_matrix(dataset, "dataset")
    validation.check_matrix(queries, "queries")
    validation.check_same_cols(dataset, queries, "dataset", "queries")
    validation.check_positive(k, "k")
    validation.expects(
        k <= dataset.shape[0], f"k={k} larger than dataset size {dataset.shape[0]}"
    )
    mode = "ip" if canonical == "inner_product" else "l2"
    if mode == "ip":
        xx = torch.zeros(dataset.shape[0], dtype=torch.float32, device=device)
    else:
        xx = (dataset * dataset).sum(dim=1)
    on_card = device.type == "cuda"
    stamp_kernel_path("cuda" if on_card else "torch")
    topk = fused_l2_topk if on_card else fused_l2_topk_torch
    vals, idx = topk(queries, dataset, xx, int(k), mode=mode)
    if mode == "ip":
        return -vals, idx
    q2 = (queries * queries).sum(dim=1)
    vals = torch.clamp(vals + q2[:, None], min=0.0)
    if canonical == "euclidean":
        vals = torch.sqrt(vals)
    return vals, idx


class Index:
    """Brute-force index: the dataset and its metric."""

    def __init__(self, dataset: torch.Tensor, metric: str = "sqeuclidean"):
        self.dataset = dataset
        self.metric = metric

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]


def build(dataset, *, metric: str = "sqeuclidean",
          res: Optional[Resources] = None) -> Index:
    res = ensure(res)
    return Index(as_f32(dataset, res.device), metric)


def search(index: Index, queries, k: int, *, sample_filter=None,
           deleted_mask=None, res: Optional[Resources] = None):
    return knn(index.dataset, queries, k, metric=index.metric,
               sample_filter=sample_filter, deleted_mask=deleted_mask, res=res)
