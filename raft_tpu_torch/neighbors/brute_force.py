"""Exact (brute-force) kNN — the oracle every recall is scored against
(counterpart of ``raft_tpu.neighbors.brute_force``), over every metric of
``DISTANCE_TYPES``.

Routing, with no switch:

- Unfiltered sqeuclidean / euclidean / inner_product: raft_tpu's fused
  path (``brute_force.py:197-222``).  CUDA tensors go through
  ``kernels.fused_knn.fused_l2_topk`` (kernel #2), which serves
  ``k <= 2048`` and raises past it; CPU tensors take its plain version at
  any k.  The kernel returns partial scores; |q|^2 is added here and
  clamped at 0, and euclidean takes the root.  It scores an f32 copy of
  the dataset: 8-bit values and their products are exact in f32, and so
  are their sums while 255^2 d < 2^24.
- Every other metric, and every filtered search (``sample_filter`` /
  ``deleted_mask``): raft_tpu's tiled leg (``_tiled_knn``): query tiles of
  up to 1,024 rows against column tiles of the dataset sized from the
  workspace, each a ``distance.pairwise.distance_matrix_tile`` (the exact
  integer Gram when queries and dataset are both 8-bit), each tile's top-k
  and the running merge by ``ops.matrix.select_k`` (the select_k kernel,
  #1, on the card); a filtered-out column takes the worst value and id -1.

``Index`` keeps the dataset in its input dtype (f32, bf16, int8, uint8),
and ``save`` / ``load`` read and write raft_tpu's format, so an index saved
by either package loads in the other.  ``make_batch_k_query`` serves
neighbours in batches of growing k over one query set (searches at a
doubling k); ``EffortSpec`` is the identity effort spec.

A paged index (``store.paginate_index``; ``dataset`` is then a host
tensor) scans every row each call, so ``search`` pins the whole payload in
the device pool once (``BudgetExceeded`` when the pool is smaller) and
passes the flat pool view to ``knn``: bitwise the dense rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional, Tuple

import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core import validation
from raft_tpu_torch.core.bitset import RowFilter
from raft_tpu_torch.core.resources import Resources, ensure, from_numpy, to_device
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES, EXPANDED, distance_matrix_tile
from raft_tpu_torch.kernels import stamp_kernel_path
from raft_tpu_torch.kernels.fused_knn import fused_l2_topk, fused_l2_topk_torch
from raft_tpu_torch.neighbors._common import invalid_mask, resolve_pass_filter
from raft_tpu_torch.ops.matrix import select_k_untraced as select_k

_SERIALIZATION_VERSION = 1
#: the metrics of the fused kernel
_FUSED = ("sqeuclidean", "euclidean", "inner_product")


@traced("brute_force.knn")
def knn(
    dataset,
    queries,
    k: int,
    *,
    metric: str = "sqeuclidean",
    p: float = 2.0,
    sample_filter=None,
    deleted_mask=None,
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: (distances [n_q, k] f32, indices [n_q, k] int32).
    ``inner_product`` returns the largest products, every other metric the
    smallest distances (``p``: minkowski's order).  ``sample_filter`` (a
    ``Bitset``, or a ``RowFilter`` with one row per query) keeps its set
    bits, ``deleted_mask`` excludes its set bits; an excluded row surfaces
    as id -1 at the worst value."""
    res = ensure(res)
    device = res.device
    validation.check_in(metric, DISTANCE_TYPES, "metric")
    canonical = DISTANCE_TYPES[metric]
    dataset = to_device(dataset, device)
    queries = to_device(queries, device)
    validation.check_matrix(dataset, "dataset")
    validation.check_matrix(queries, "queries")
    validation.check_same_cols(dataset, queries, "dataset", "queries")
    validation.check_positive(k, "k")
    validation.expects(
        k <= dataset.shape[0], f"k={k} larger than dataset size {dataset.shape[0]}"
    )
    pass_filter = resolve_pass_filter(sample_filter, deleted_mask)
    stamp_kernel_path("cuda" if device.type == "cuda" else "torch")
    if pass_filter is not None:
        n = dataset.shape[0]
        if pass_filter.n_bits < n:
            raise ValueError(f"filter covers {pass_filter.n_bits} ids but dataset has {n} rows")
        if isinstance(pass_filter, RowFilter):
            validation.expects(
                pass_filter.words.shape[0] == queries.shape[0],
                f"row filter has {pass_filter.words.shape[0]} rows for "
                f"{queries.shape[0]} queries")
    if pass_filter is not None or canonical not in _FUSED:
        both_int = not dataset.is_floating_point() and not queries.is_floating_point()
        if not both_int:
            queries = queries.to(torch.float32)
        words = None if pass_filter is None else pass_filter.words.to(device)
        return _tiled_knn(queries, dataset, int(k), canonical, p, words, res)
    dataset = dataset.to(torch.float32)
    queries = queries.to(torch.float32)
    mode = "ip" if canonical == "inner_product" else "l2"
    if mode == "ip":
        xx = torch.zeros(dataset.shape[0], dtype=torch.float32, device=device)
    else:
        xx = (dataset * dataset).sum(dim=1)
    topk = fused_l2_topk if device.type == "cuda" else fused_l2_topk_torch
    vals, idx = topk(queries, dataset, xx, int(k), mode=mode)
    if mode == "ip":
        return -vals, idx
    q2 = (queries * queries).sum(dim=1)
    vals = torch.clamp(vals + q2[:, None], min=0.0)
    if canonical == "euclidean":
        vals = torch.sqrt(vals)
    return vals, idx


def _tiled_knn(queries: torch.Tensor, dataset: torch.Tensor, k: int, metric: str, p: float,
               words: Optional[torch.Tensor], res: Resources):
    """raft_tpu's ``_tiled_knn``: query tiles of up to 1,024 rows against
    column tiles of the dataset sized from the workspace (raft_tpu's rule:
    an expanded tile holds [query_tile, tile_cols], an elementwise one the
    [query_tile, tile_cols, d] broadcast), each tile's top-k merged into a
    running top-k, earlier columns first.  ``words``: a pass filter's
    words (one set [W], or a RowFilter's [n_q, W]), or None; excluded
    columns take the worst value and id -1."""
    n, d = dataset.shape
    select_min = metric != "inner_product"
    worst = float("inf") if select_min else float("-inf")
    query_tile = min(max(queries.shape[0], 1), 1024)
    elem = 4 * max(d, query_tile) if metric in EXPANDED or metric == "haversine" \
        else 4 * d * query_tile
    tile_cols = int(min(n, max(512, res.workspace_rows(elem, cap=1 << 14))))
    per_row = words is not None and words.ndim == 2
    vs, is_ = [], []
    for qs in range(0, queries.shape[0], query_tile):
        qt = queries[qs:qs + query_tile]
        best_v = torch.full((qt.shape[0], k), worst, dtype=torch.float32, device=qt.device)
        best_i = torch.full((qt.shape[0], k), -1, dtype=torch.int32, device=qt.device)
        for cs in range(0, n, tile_cols):
            tile = dataset[cs:cs + tile_cols]
            dist = distance_matrix_tile(qt, tile, metric, p)
            col = torch.arange(cs, cs + tile.shape[0], device=qt.device)
            ids = col.to(torch.int32)[None, :].expand(qt.shape[0], -1)
            if words is not None:
                failing = (invalid_mask(col.expand(qt.shape[0], -1), words[qs:qs + query_tile])
                           if per_row else invalid_mask(col, words)[None, :])
                dist = torch.where(failing, torch.full_like(dist, worst), dist)
                ids = torch.where(failing, torch.full((), -1, dtype=torch.int32,
                                                      device=qt.device), ids)
            tv, ti = select_k(dist, min(k, tile.shape[0]), select_min=select_min,
                              input_indices=ids)
            best_v, best_i = select_k(torch.cat([best_v, tv], dim=1), k, select_min=select_min,
                                      input_indices=torch.cat([best_i, ti], dim=1))
        vs.append(best_v)
        is_.append(best_i)
    return torch.cat(vs), torch.cat(is_)


@dataclass(frozen=True)
class EffortSpec:
    """The identity effort spec (raft_tpu's): exact search has no effort
    knob, so every level is the same full effort.  It lets the effort
    machinery treat the four backends alike."""

    backend: ClassVar[str] = "brute_force"

    @classmethod
    def from_params(cls, params=None, **extra) -> "EffortSpec":
        return cls()

    def apply(self, params=None):
        return params

    def degraded(self, level: int) -> "EffortSpec":
        return self

    def knobs(self):
        return {}


class Index:
    """Brute-force index: the dataset (in its input dtype) and its metric."""

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


@traced("brute_force.build")
def build(dataset, *, metric: str = "sqeuclidean",
          res: Optional[Resources] = None) -> Index:
    res = ensure(res)
    return Index(to_device(dataset, res.device), metric)


@traced("brute_force.search")
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


class Batch:
    """One batch of a :class:`BatchKQuery`: neighbours ``[offset, offset +
    size)`` of every query, nearest first."""

    def __init__(self, distances: torch.Tensor, indices: torch.Tensor, offset: int):
        self._distances = distances
        self._indices = indices
        self.offset = offset

    def distances(self) -> torch.Tensor:
        return self._distances

    def indices(self) -> torch.Tensor:
        return self._indices

    @property
    def size(self) -> int:
        return self._indices.shape[1]


class BatchKQuery:
    """Queries of growing k over a brute-force index: batch 0 holds each
    query's nearest ``batch_size`` neighbours, batch 1 the next
    ``batch_size``, and so on, with no final k chosen up front (raft_tpu's
    ``BatchKQuery``).  The result of one :func:`search` at a cached k is
    kept; a batch past it searches again at ``max(offset + size, 2 x
    cached, 2 x batch_size)`` (the reference's doubling rule), so b batches
    cost O(log b) searches.  On the card each is a fused_knn search, which
    serves k up to 2048."""

    def __init__(self, index: Index, queries, batch_size: int, *,
                 res: Optional[Resources] = None):
        validation.check_positive(batch_size, "batch_size")
        self.index = index
        self.queries = queries
        self.batch_size = int(batch_size)
        self._res = res
        self._cached_k = 0
        self._vals: Optional[torch.Tensor] = None
        self._ids: Optional[torch.Tensor] = None

    def _ensure(self, upto: int) -> None:
        upto = min(upto, self.index.size)
        if upto <= self._cached_k:
            return
        want = min(self.index.size, max(upto, 2 * self._cached_k, 2 * self.batch_size))
        self._vals, self._ids = search(self.index, self.queries, want, res=self._res)
        self._cached_k = want

    def batch(self, offset: int, size: int) -> Batch:
        """Neighbours ``[offset, offset + size)`` of every query (cut at the
        index size)."""
        validation.expects(offset >= 0, f"offset must be >= 0, got {offset}")
        size = max(0, min(size, self.index.size - offset))
        if size == 0:
            dev = ensure(self._res).device
            n_q = self.queries.shape[0]
            return Batch(torch.zeros((n_q, 0), dtype=torch.float32, device=dev),
                         torch.zeros((n_q, 0), dtype=torch.int32, device=dev), offset)
        self._ensure(offset + size)
        return Batch(self._vals[:, offset:offset + size], self._ids[:, offset:offset + size],
                     offset)

    def __iter__(self):
        offset = 0
        while offset < self.index.size:
            b = self.batch(offset, self.batch_size)
            yield b
            offset += b.size


def make_batch_k_query(index: Index, queries, batch_size: int, *,
                       res: Optional[Resources] = None) -> BatchKQuery:
    """A :class:`BatchKQuery` over ``index`` (raft_tpu's ``make_batch_k_query``)."""
    return BatchKQuery(index, queries, batch_size, res=res)


@traced("brute_force.save")
def save(filename: str, index: Index) -> None:
    """raft_tpu's format: the metric and the dataset in its dtype."""
    ser.save_tree(filename, "brute_force", _SERIALIZATION_VERSION,
                  {"metric": index.metric}, {"dataset": index.dataset})


@traced("brute_force.load")
def load(filename: str, *, res: Optional[Resources] = None) -> Index:
    """An index saved by this package's or raft_tpu's ``save``."""
    scalars, arrays = ser.load_tree(filename, "brute_force", _SERIALIZATION_VERSION)
    return Index(from_numpy(arrays["dataset"]).to(ensure(res).device), scalars["metric"])
