"""Exact (brute-force) kNN — the oracle every recall is scored against
(counterpart of ``raft_tpu.neighbors.brute_force``; this slice ports
sqeuclidean, euclidean and inner_product).

Routing, as raft_tpu's fused path (``brute_force.py:197-222``) with no
switch: CUDA tensors go through ``kernels.fused_knn.fused_l2_topk``, which
serves ``k <= 512`` and raises past it; CPU tensors take its plain version
at any k.  The kernel returns partial scores; |q|^2 is added here and
clamped at 0, and euclidean takes the root.

Filtered searches (``sample_filter`` / ``deleted_mask``) take raft_tpu's
tiled leg (``_tiled_knn``), as the fused kernel has no post-filter leg:
distance tiles by ``torch.matmul`` (a product raft_tpu also leaves outside
any kernel), each tile's top-k and the running merge by
``ops.matrix.select_k`` (the select_k kernel on the card); a filtered-out
column takes the worst value and id -1.

A paged index (``store.paginate_index``; ``dataset`` is then a host
tensor) scans every row each call, so ``search`` pins the whole payload in
the device pool once (``BudgetExceeded`` when the pool is smaller) and
passes the flat pool view to ``knn``: bitwise the dense rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import validation
from raft_tpu_torch.core.bitset import RowFilter
from raft_tpu_torch.core.resources import Resources, as_f32, ensure
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES
from raft_tpu_torch.kernels import stamp_kernel_path
from raft_tpu_torch.kernels.fused_knn import fused_l2_topk, fused_l2_topk_torch
from raft_tpu_torch.neighbors._common import invalid_mask, resolve_pass_filter
from raft_tpu_torch.ops.matrix import select_k

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
    smallest distances.  ``sample_filter`` (a ``Bitset``, or a ``RowFilter``
    with one row per query) keeps its set bits, ``deleted_mask`` excludes
    its set bits; an excluded row surfaces as id -1 at the worst value."""
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
    pass_filter = resolve_pass_filter(sample_filter, deleted_mask)
    if pass_filter is not None:
        n = dataset.shape[0]
        if pass_filter.n_bits < n:
            raise ValueError(f"filter covers {pass_filter.n_bits} ids but dataset has {n} rows")
        if isinstance(pass_filter, RowFilter):
            validation.expects(
                pass_filter.words.shape[0] == queries.shape[0],
                f"row filter has {pass_filter.words.shape[0]} rows for "
                f"{queries.shape[0]} queries")
        stamp_kernel_path("cuda" if device.type == "cuda" else "torch")
        return _tiled_knn(queries, dataset, int(k), canonical, pass_filter.words.to(device), res)
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


def _tiled_knn(queries: torch.Tensor, dataset: torch.Tensor, k: int, metric: str,
               words: torch.Tensor, res: Resources):
    """raft_tpu's ``_tiled_knn`` with a pass filter's words (one set [W], or
    a RowFilter's [n_q, W]): query tiles of up to 1,024 rows against column
    tiles of the dataset sized from the workspace (raft_tpu's rule), each
    tile's top-k merged into a running top-k.  Excluded columns take the
    worst value and id -1."""
    n, d = dataset.shape
    select_min = metric != "inner_product"
    worst = float("inf") if select_min else float("-inf")
    query_tile = min(max(queries.shape[0], 1), 1024)
    tile_cols = int(min(n, max(512, res.workspace_rows(4 * max(d, query_tile), cap=1 << 14))))
    per_row = words.ndim == 2
    yy = None if metric == "inner_product" else (dataset * dataset).sum(dim=1)
    vs, is_ = [], []
    for qs in range(0, queries.shape[0], query_tile):
        qt = queries[qs:qs + query_tile]
        xx = None if yy is None else (qt * qt).sum(dim=1)
        best_v = torch.full((qt.shape[0], k), worst, dtype=torch.float32, device=qt.device)
        best_i = torch.full((qt.shape[0], k), -1, dtype=torch.int32, device=qt.device)
        for cs in range(0, n, tile_cols):
            tile = dataset[cs:cs + tile_cols]
            ip = torch.matmul(qt, tile.T)
            if metric == "inner_product":
                dist = ip
            else:
                dist = torch.clamp(xx[:, None] + yy[None, cs:cs + tile.shape[0]] - 2.0 * ip,
                                   min=0.0)
                if metric == "euclidean":
                    dist = torch.sqrt(dist)
            col = torch.arange(cs, cs + tile.shape[0], device=qt.device)
            failing = (invalid_mask(col.expand(qt.shape[0], -1), words[qs:qs + query_tile])
                       if per_row else invalid_mask(col, words)[None, :])
            dist = torch.where(failing, torch.full_like(dist, worst), dist)
            ids = torch.where(failing, torch.full((), -1, dtype=torch.int32, device=qt.device),
                              col.to(torch.int32)[None, :])
            tv, ti = select_k(dist, min(k, tile.shape[0]), select_min=select_min,
                              input_indices=ids.expand(qt.shape[0], -1))
            best_v, best_i = select_k(torch.cat([best_v, tv], dim=1), k, select_min=select_min,
                                      input_indices=torch.cat([best_i, ti], dim=1))
        vs.append(best_v)
        is_.append(best_i)
    return torch.cat(vs), torch.cat(is_)


class Index:
    """Brute-force index: the dataset and its metric."""

    def __init__(self, dataset: torch.Tensor, metric: str = "sqeuclidean"):
        self.dataset = dataset
        self.metric = metric
        #: the store.TieredStore of a paged index (store.paginate_index)
        self.paged = None

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
    dataset = index.dataset
    if index.paged is not None:
        # every row is scanned each call: identity-pin the whole payload
        # once (one host-to-device transfer; BudgetExceeded if the pool is
        # short) and scan the flat pool view (bitwise the dense rows)
        index.paged.pin_identity()
        pool, _ = index.paged.view()
        dataset = pool.reshape((-1,) + tuple(pool.shape[2:]))[: index.size]
    return knn(dataset, queries, k, metric=index.metric,
               sample_filter=sample_filter, deleted_mask=deleted_mask, res=res)
