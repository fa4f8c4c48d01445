"""IVF-Flat: inverted-file index over uncompressed f32 vectors
(counterpart of ``raft_tpu.neighbors.ivf_flat``).

Storage is raft_tpu's dense padded layout: ``list_data [n_lists, cap,
dim]``, ``list_index [n_lists, cap]`` (-1 past each list's size),
``list_norms [n_lists, cap]`` (+inf past the size).  An index saved by
``raft_tpu.neighbors.ivf_flat.save`` loads here unchanged.

Search is ``_common.scan_search``: coarse select (``torch.matmul`` +
select_k) → list scan → merge, on raft_tpu's schedule rule.  Both scans
reach the f32 legs of the CUDA kernels of ``kernels.ivf_scan`` for CUDA
tensors (k up to 128 there; deeper k raises) and their plain versions for
CPU tensors; every call stamps
``kernel_path`` "cuda" or "torch".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core import validation
from raft_tpu_torch.core.resources import Resources, as_f32, ensure
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


class Index:
    """Padded-list IVF-Flat index; every field is a tensor on one device."""

    def __init__(self, metric, centers, list_data, list_index, list_sizes,
                 list_norms, headroom: bool = True):
        if list_data.dtype != torch.float32:
            raise NotImplementedError(
                f"ivf_flat storage {list_data.dtype}: this slice of the port "
                "stores float32 lists (bf16 / int8 legs come later)"
            )
        self.metric = metric
        self.centers = centers
        self.list_data = list_data
        self.list_index = list_index
        self.list_sizes = list_sizes
        self.list_norms = list_norms
        self.headroom = headroom
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
    """Scatter rows into the padded [n_lists', cap, dim] layout; oversized
    lists are split with duplicated centroids (returns center_map)."""
    n, d = rows.shape
    lst, slot, sizes, center_map, cap = compute_list_layout(
        labels, n_lists, max_cap=default_max_cap(n, n_lists), headroom=headroom,
    )
    L = len(center_map)
    dev = rows.device
    l_data = torch.zeros((L, cap, d), dtype=torch.float32, device=dev)
    l_index = torch.full((L, cap), -1, dtype=torch.int32, device=dev)
    l_norms = torch.full((L, cap), float("inf"), dtype=torch.float32, device=dev)
    lj = torch.from_numpy(lst).to(dev)
    sj = torch.from_numpy(slot).to(dev)
    l_data[lj, sj] = rows
    l_index[lj, sj] = ids.to(torch.int32)
    l_norms[lj, sj] = (rows * rows).sum(dim=1)
    return l_data, l_index, torch.from_numpy(sizes).to(dev), l_norms, center_map


def build(params: IndexParams, dataset, *, res: Optional[Resources] = None) -> Index:
    """Subsample a trainset → balanced k-means → predict → pack lists."""
    res = ensure(res)
    device = res.device
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
        torch.zeros((params.n_lists, 8, d), dtype=torch.float32, device=device),
        torch.full((params.n_lists, 8), -1, dtype=torch.int32, device=device),
        torch.zeros((params.n_lists,), dtype=torch.int32, device=device),
        torch.full((params.n_lists, 8), float("inf"), dtype=torch.float32, device=device),
        headroom=not params.conservative_memory_allocation,
    )
    if params.add_data_on_build:
        index = extend(index, dataset, torch.arange(n, dtype=torch.int32), res=res)
    return index


def extend(index: Index, new_vectors, new_indices=None, *,
           res: Optional[Resources] = None) -> Index:
    """Add vectors: append into spare list capacity when every centroid
    group has room, else merge with the existing rows and repack."""
    res = ensure(res)
    dev = index.centers.device
    x = as_f32(new_vectors, dev)
    n_new = x.shape[0]
    labels = kmeans_balanced.predict(
        index.centers, x, metric=_kb_metric(index.metric), res=res
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
            list_norms[lj, sj] = (x * x).sum(dim=1)
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


def _lists(index: Index):
    return index.list_data, index.scan_norms, index.list_index


def probe_major_scan_inputs(index: Index, queries: torch.Tensor, n_probes: int,
                            k: int, bucket: int):
    """Coarse select + probe inversion for one probe-major block: returns
    (the positional arguments of ``ivf_scan_probe_major``, bucket_pair)."""
    return _common.probe_major_scan_inputs(
        queries, queries, index.centers, _lists(index), DISTANCE_TYPES[index.metric],
        n_probes, k, bucket)


def query_major_scan_inputs(index: Index, queries: torch.Tensor, n_probes: int,
                            k: int):
    """Coarse select for one query-major block: the positional arguments
    of ``ivf_scan_query_major``."""
    return _common.query_major_scan_inputs(
        queries, queries, index.centers, _lists(index), DISTANCE_TYPES[index.metric],
        n_probes, k)


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
    only when the probed lists hold fewer than k rows (distance +inf)."""
    if sample_filter is not None or deleted_mask is not None:
        raise NotImplementedError(
            "filtered ivf_flat search arrives with the filters slice of the port"
        )
    ensure(res).device  # raises without a card unless the caller asked for the CPU
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
    v, i = _common.scan_search(
        queries, int(k), n_probes, params.strategy, index.centers, _lists(index), metric,
        lambda qt: qt, {}, ensure(res).workspace_limit_bytes,
    )
    return _common.postprocess(v, metric), i


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
    t = {name: torch.from_numpy(np.array(arrays[name])).to(dev)  # a writable copy
         for name in ("centers", "list_data", "list_index", "list_sizes", "list_norms")}
    return Index(metric, t["centers"], t["list_data"], t["list_index"].to(torch.int32),
                 t["list_sizes"].to(torch.int32), t["list_norms"], headroom=headroom)


def load(filename: str, *, res: Optional[Resources] = None) -> Index:
    scalars, arrays = ser.load_tree(filename, "ivf_flat", _SERIALIZATION_VERSION)
    return from_numpy(arrays, scalars["metric"],
                      headroom=bool(scalars.get("headroom", 1)), res=res)
