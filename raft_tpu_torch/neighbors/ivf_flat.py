"""IVF-Flat: inverted-file index over uncompressed vectors (counterpart of
``raft_tpu.neighbors.ivf_flat``).

Storage is raft_tpu's dense padded layout: ``list_data [n_lists, cap,
dim]`` in the dataset's dtype (f32, bf16, int8 or uint8), ``list_index
[n_lists, cap]`` (-1 past each list's size), ``list_norms [n_lists, cap]``
f32 (+inf past the size).  As in raft_tpu, k-means trains on the rows cast
to f32 and the norms are those of the stored rows cast to f32.  An index
saved by ``raft_tpu.neighbors.ivf_flat.save`` loads here unchanged.

Search is ``_common.scan_search``: coarse select (``torch.matmul`` +
select_k) → list scan → merge, on raft_tpu's schedule rule, every row
scored in f32 (raft_tpu's ``scan_dtype="highest"``).  Both scans reach the
CUDA kernels of ``kernels.ivf_scan`` for CUDA tensors (k up to 2048 there;
deeper k raises) on the storage type's leg (f32; bf16 rows with f32
products; raw uint8 / int8 rows, ``_u8`` / ``_s8``), and their plain
versions for CPU tensors, unfiltered or on their filter legs
(``sample_filter`` / ``deleted_mask``); every call stamps ``kernel_path``
"cuda" or "torch".  A paged search of 8-bit lists takes the paged
``_u8`` / ``_s8`` legs.

Paged storage (``store.paginate_index``): the lists move to host pages
behind a device pool at ``index.paged`` (``list_data`` is then a host
tensor at the page-aligned capacity), and ``search`` reads them through the
page table on the paged legs of the same kernels, bitwise equal to the
monolithic search; ``extend`` refuses a paged index, as raft_tpu's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core import validation
from raft_tpu_torch.core.resources import Resources, as_f32, ensure, to_device
from raft_tpu_torch.core.resources import from_numpy as tensor_from_numpy
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES
from raft_tpu_torch.neighbors import _common
from raft_tpu_torch.neighbors._common import (
    allocate_append_slots,
    centroid_group_inverse,
    compute_list_layout,
    default_max_cap,
    merge_split_lists,
    subsample_trainset,
    unpack_lists,
)

_SERIALIZATION_VERSION = 1
_METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")
#: the list storage types (raft_tpu keeps the dataset's dtype)
_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.uint8)
#: the scans' storage-leg arguments: raw rows (an int8 list is not a
#: scaled cache), scored in f32
_SCAN_KW = {"scan_scale": None}


@dataclass
class IndexParams:
    n_lists: int = 1024
    metric: str = "sqeuclidean"
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    adaptive_centers: bool = False
    add_data_on_build: bool = True
    conservative_memory_allocation: bool = False
    seed: int = 0


@dataclass
class SearchParams:
    n_probes: int = 20
    strategy: str = "auto"  # auto | query_major | probe_major


@dataclass(frozen=True)
class EffortSpec:
    """The search-effort knobs of IVF-Flat (raft_tpu's ``EffortSpec``): what
    the serving layer and the bench move.  ``n_probes`` acts through
    :class:`SearchParams`; ``refine_ratio`` is the bench's offline
    multiplier (search ``k x ratio`` candidates, refine exactly).  Pure host
    values."""

    n_probes: int = 20
    refine_ratio: int = 1

    backend: ClassVar[str] = "ivf_flat"

    @classmethod
    def from_params(cls, params: Optional[SearchParams] = None, **extra) -> "EffortSpec":
        base = params if params is not None else SearchParams()
        return cls(n_probes=int(base.n_probes), refine_ratio=int(extra.get("refine_ratio", 1)))

    def apply(self, params: Optional[SearchParams] = None) -> SearchParams:
        """``params`` (default: the defaults) with this spec's online knobs."""
        base = params if params is not None else SearchParams()
        return dc_replace(base, n_probes=int(self.n_probes))

    def degraded(self, level: int) -> "EffortSpec":
        """``level`` notches down: ``n_probes`` halved per level (at least
        1), refine dropped."""
        if level <= 0:
            return self
        return EffortSpec(n_probes=max(1, int(self.n_probes) >> int(level)), refine_ratio=1)

    def knobs(self):
        return {"n_probes": int(self.n_probes), "refine_ratio": int(self.refine_ratio)}


class Index:
    """Padded-list IVF-Flat index; every field is a tensor on one device."""

    def __init__(self, metric, centers, list_data, list_index, list_sizes,
                 list_norms, headroom: bool = True):
        if list_data.dtype not in _DTYPES:
            raise NotImplementedError(
                f"ivf_flat storage {list_data.dtype}: the port stores {_DTYPES}")
        self.metric = metric
        self.centers = centers
        self.list_data = list_data
        self.list_index = list_index
        self.list_sizes = list_sizes
        self.list_norms = list_norms
        self.headroom = headroom
        #: the store.TieredStore of a paged index (store.paginate_index)
        self.paged = None
        self._group_inverse = None
        self._scan_norms = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())

    @property
    def list_cap(self) -> int:
        return self.list_data.shape[1]

    @property
    def scan_norms(self) -> torch.Tensor:
        """Row norms with padding slots zeroed: the scans mask those slots
        by ``ids < 0``, and a zero keeps +inf out of their arithmetic."""
        if self._scan_norms is None:
            self._scan_norms = torch.where(
                self.list_index >= 0, self.list_norms,
                torch.zeros_like(self.list_norms),
            )
        return self._scan_norms


def _kb_metric(metric: str) -> str:
    canonical = DISTANCE_TYPES[metric]
    return canonical if canonical in ("cosine", "inner_product") else "sqeuclidean"


def _pack_lists(rows: torch.Tensor, ids: torch.Tensor, labels: np.ndarray,
                n_lists: int, headroom: bool):
    """Scatter rows into the padded [n_lists', cap, dim] layout (in the rows'
    dtype; norms of the rows cast to f32); oversized lists are split with
    duplicated centroids (returns center_map)."""
    n, d = rows.shape
    lst, slot, sizes, center_map, cap = compute_list_layout(
        labels, n_lists, max_cap=default_max_cap(n, n_lists), headroom=headroom,
    )
    L = len(center_map)
    dev = rows.device
    l_data = torch.zeros((L, cap, d), dtype=rows.dtype, device=dev)
    l_index = torch.full((L, cap), -1, dtype=torch.int32, device=dev)
    l_norms = torch.full((L, cap), float("inf"), dtype=torch.float32, device=dev)
    lj = torch.from_numpy(lst).to(dev)
    sj = torch.from_numpy(slot).to(dev)
    l_data[lj, sj] = rows
    l_index[lj, sj] = ids.to(torch.int32)
    rows32 = rows.to(torch.float32)
    l_norms[lj, sj] = (rows32 * rows32).sum(dim=1)
    return l_data, l_index, torch.from_numpy(sizes).to(dev), l_norms, center_map


@traced("ivf_flat.build")
def build(params: IndexParams, dataset, *, res: Optional[Resources] = None) -> Index:
    """Subsample a trainset → balanced k-means → predict → pack lists."""
    res = ensure(res)
    device = res.device
    dataset = to_device(dataset, device)
    n, d = dataset.shape
    if DISTANCE_TYPES[params.metric] not in _METRICS:
        raise ValueError(f"ivf_flat supports L2/IP/cosine metrics, got {params.metric}")
    kb = kmeans_balanced.KMeansBalancedParams(
        n_iters=params.kmeans_n_iters, metric=_kb_metric(params.metric), seed=params.seed
    )
    n_train = max(params.n_lists, int(n * params.kmeans_trainset_fraction))
    trainset = subsample_trainset(dataset, n_train, params.seed) if n_train < n else dataset
    centers = kmeans_balanced.fit(kb, as_f32(trainset, device), params.n_lists, res=res)
    index = Index(
        params.metric,
        centers,
        torch.zeros((params.n_lists, 8, d), dtype=dataset.dtype, device=device),
        torch.full((params.n_lists, 8), -1, dtype=torch.int32, device=device),
        torch.zeros((params.n_lists,), dtype=torch.int32, device=device),
        torch.full((params.n_lists, 8), float("inf"), dtype=torch.float32, device=device),
        headroom=not params.conservative_memory_allocation,
    )
    if params.add_data_on_build:
        index = extend(index, dataset, torch.arange(n, dtype=torch.int32), res=res)
    return index


@traced("ivf_flat.extend")
def extend(index: Index, new_vectors, new_indices=None, *,
           res: Optional[Resources] = None) -> Index:
    """Add vectors: append into spare list capacity when every centroid
    group has room, else merge with the existing rows and repack."""
    if index.paged is not None:
        raise ValueError(
            "extend() on a paged index is unsupported — paged serving routes growth "
            "through side buffers and re-paginates at compaction"
        )
    res = ensure(res)
    dev = index.centers.device
    x = to_device(new_vectors, dev).to(index.list_data.dtype)   # stored as the lists
    x32 = x.to(torch.float32)
    n_new = x.shape[0]
    labels = kmeans_balanced.predict(
        index.centers, x32, metric=_kb_metric(index.metric), res=res
    ).cpu().numpy()
    old_n = index.size
    if new_indices is None:
        new_indices = torch.arange(old_n, old_n + n_new, dtype=torch.int32)
    new_ids = torch.as_tensor(new_indices).to(device=dev, dtype=torch.int32)

    if n_new and old_n:
        if index._group_inverse is None:
            index._group_inverse = centroid_group_inverse(index.centers.cpu().numpy())
        alloc = allocate_append_slots(
            index.centers.cpu().numpy(), index.list_sizes.cpu().numpy(),
            index.list_cap, labels, group_inverse=index._group_inverse,
        )
        if alloc is not None:
            slab, slots, counts_new = alloc
            lj = torch.from_numpy(slab).to(dev)
            sj = torch.from_numpy(slots).to(dev)
            list_data = index.list_data.clone()
            list_index = index.list_index.clone()
            list_norms = index.list_norms.clone()
            list_data[lj, sj] = x
            list_index[lj, sj] = new_ids
            list_norms[lj, sj] = (x32 * x32).sum(dim=1)
            new = Index(
                index.metric, index.centers, list_data, list_index,
                index.list_sizes + torch.from_numpy(counts_new).to(dev, torch.int32),
                list_norms, headroom=index.headroom,
            )
            new._group_inverse = index._group_inverse
            return new

    old_rows, old_ids, old_labels = unpack_lists(index.list_data, index.list_index)
    if old_rows.shape[0] == 0:
        all_rows, all_ids, all_labels = x, new_ids, labels
    else:
        all_rows = torch.cat([old_rows, x])
        all_ids = torch.cat([old_ids, new_ids])
        all_labels = np.concatenate([old_labels.cpu().numpy(), labels])
    uniq, all_labels = merge_split_lists(index.centers.cpu().numpy(), all_labels)
    base_centers = index.centers[torch.from_numpy(uniq).to(dev)]
    list_data, list_index, list_sizes, list_norms, center_map = _pack_lists(
        all_rows, all_ids, all_labels, len(uniq), index.headroom,
    )
    centers = base_centers[torch.from_numpy(center_map).to(dev)]
    return Index(index.metric, centers, list_data, list_index, list_sizes,
                 list_norms, headroom=index.headroom)


def _lists(index: Index, queries: torch.Tensor, n_probes: int):
    """(list_data, scan norms, list_index) of a search of ``queries``: a
    paged index's lists are the ``PagedLists`` view, its probed pages made
    resident (``_common.paged_lists_for_search``)."""
    data = index.list_data
    if index.paged is not None:
        data = _common.paged_lists_for_search(index, queries, DISTANCE_TYPES[index.metric],
                                              n_probes)
    return data, index.scan_norms, index.list_index


def probe_major_scan_inputs(index: Index, queries: torch.Tensor, n_probes: int,
                            k: int, bucket: int):
    """Coarse select + probe inversion for one probe-major block: returns
    (the positional arguments of ``ivf_scan_probe_major``, bucket_pair)."""
    return _common.probe_major_scan_inputs(
        queries, queries, index.centers, _lists(index, queries, n_probes),
        DISTANCE_TYPES[index.metric], n_probes, k, bucket)


def query_major_scan_inputs(index: Index, queries: torch.Tensor, n_probes: int,
                            k: int):
    """Coarse select for one query-major block: the positional arguments
    of ``ivf_scan_query_major``."""
    return _common.query_major_scan_inputs(
        queries, queries, index.centers, _lists(index, queries, n_probes),
        DISTANCE_TYPES[index.metric], n_probes, k)


@traced("ivf_flat.search")
def search(
    params: SearchParams,
    index: Index,
    queries,
    k: int,
    *,
    sample_filter=None,
    deleted_mask=None,
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (distances [q, k] f32, indices [q, k] int32); id -1 appears
    only when the probed lists hold fewer than k passing rows (distance
    +inf).

    ``sample_filter`` (a ``core.bitset.Bitset`` over ids, or a
    ``RowFilter`` with one bitset per query, with or without its
    ``fid`` / ``table`` descriptor) keeps its set bits; ``deleted_mask``
    (a ``Bitset``) excludes its set bits.  See ``_common.scan_search`` for
    the filter legs."""
    ensure(res).device  # raises without a card unless the caller asked for the CPU
    pass_filter = _common.resolve_pass_filter(sample_filter, deleted_mask)
    dev = index.centers.device
    queries = as_f32(queries, dev)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(f"queries shape {tuple(queries.shape)} vs index dim {index.dim}")
    n_probes = min(params.n_probes, index.n_lists)
    if k > n_probes * index.list_cap:
        raise ValueError(
            f"k={k} exceeds the candidate pool n_probes*list_cap="
            f"{n_probes}*{index.list_cap}; raise n_probes"
        )
    validation.check_in(params.strategy, ("auto", "query_major", "probe_major"), "strategy")
    metric = DISTANCE_TYPES[index.metric]
    with _common.search_lists(index, queries, metric, n_probes, index.scan_norms) as lists:
        v, i = _common.scan_search(
            queries, int(k), n_probes, params.strategy, index.centers, lists, metric,
            lambda qt: qt, _SCAN_KW, ensure(res).workspace_limit_bytes, pass_filter,
        )
    return _common.postprocess(v, metric), i


@traced("ivf_flat.save")
def save(filename: str, index: Index) -> None:
    ser.save_tree(
        filename, "ivf_flat", _SERIALIZATION_VERSION,
        {"metric": index.metric, "headroom": int(index.headroom)},
        {
            "centers": index.centers,
            "list_data": index.list_data,
            "list_index": index.list_index,
            "list_sizes": index.list_sizes,
            "list_norms": index.list_norms,
        },
    )


def from_numpy(arrays, metric: str, *, headroom: bool = True,
               res: Optional[Resources] = None) -> Index:
    """An Index from raft_tpu's index arrays (``centers``, ``list_data``,
    ``list_index``, ``list_sizes``, ``list_norms``)."""
    dev = ensure(res).device
    t = {name: tensor_from_numpy(np.array(arrays[name])).to(dev)  # a writable copy
         for name in ("centers", "list_data", "list_index", "list_sizes", "list_norms")}
    return Index(metric, t["centers"], t["list_data"], t["list_index"].to(torch.int32),
                 t["list_sizes"].to(torch.int32), t["list_norms"], headroom=headroom)


@traced("ivf_flat.load")
def load(filename: str, *, res: Optional[Resources] = None) -> Index:
    scalars, arrays = ser.load_tree(filename, "ivf_flat", _SERIALIZATION_VERSION)
    return from_numpy(arrays, scalars["metric"],
                      headroom=bool(scalars.get("headroom", 1)), res=res)
