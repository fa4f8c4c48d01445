"""IVF-PQ: inverted-file index over product-quantized residuals
(counterpart of ``raft_tpu.neighbors.ivf_pq``).

Build: trainset subsample → balanced k-means → rotation → Lloyd codebooks
on the rotated residuals (one per subspace, or one per cluster) → encode
every row → pack lists.  Storage is raft_tpu's: the codes
``list_codes [L, cap, pq_dim] uint8`` beside the *decoded scan cache*
``list_data [L, cap, rot_dim]``, ``y = center_rot + concat_j
codebook[j, code_j]``, stored as bf16 (the "auto" default), f32, or int8
with one global scale ``scan_scale``; ``list_y2`` holds the squared norms
of the stored values (0 at padding slots).

Search: coarse select on the raw queries, ``q_rot = queries @
rotation.T`` (``torch.matmul``, plain XLA in raft_tpu too), then
``_common.scan_search`` against the decoded cache: the bf16, int8 or f32
leg of the ``kernels.ivf_scan`` kernels, with ``lut_dtype`` choosing f32 or
bf16 products.  ``neighbors.refine`` re-ranks the candidates exactly.

Random draws (a random rotation, the codebooks' seed rows) come from a
``torch.Generator`` seeded from ``params.seed``, not raft_tpu's threefry:
compare builds by quality, or inject state.  ``save`` / ``load`` use
raft_tpu's file format, so an index saved by either package loads in the
other; the scan cache is derived state, rebuilt from the codes on load.

Filtered search (``sample_filter`` / ``deleted_mask``) rides the scans'
filter legs (``_common.scan_search``).  ``internal_distance_dtype=
"bfloat16"`` is raft_tpu's XLA leg, which it keeps off its Pallas scans
(they sum in f32): plain PyTorch ops on the card, in raft_tpu's dtypes
(:func:`_search_bf16_distance`).  On the card a kernel search serves k up
to 2048 (the scan kernels' envelope) and raises past it.
Paged storage (``store.paginate_index``): the scan cache moves to host pages
behind a device pool at ``index.paged`` (``list_data`` and the codes are then
host tensors at the page-aligned capacity), and ``search`` reads it through
the page table on the paged legs of the same kernels, bitwise equal to the
monolithic search; ``extend`` refuses a paged index, as raft_tpu's does.
The sharded build's unsplit layout is not ported.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core import validation
from raft_tpu_torch.core.bitset import RowFilter
from raft_tpu_torch.core.resources import Resources, as_f32, ensure
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
from raft_tpu_torch.kernels import stamp_kernel_path
from raft_tpu_torch.kernels.toolkit import int8_scored_ip, true_div
from raft_tpu_torch.ops.matrix import segment_sum
from raft_tpu_torch.ops.matrix import select_k_untraced as select_k
from raft_tpu_torch.store.paged import gather_lists

_SERIALIZATION_VERSION = 1

CODEBOOK_PER_SUBSPACE = "per_subspace"
CODEBOOK_PER_CLUSTER = "per_cluster"

#: scan-cache storage types: bf16 halves the scan's bytes, f32 is the exact
#: decode, int8 the memory-lean cache (rot_dim bytes a row)
_DECODED_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}

#: share of device memory the scan cache may claim before "auto" picks int8
_AUTO_HBM_FRACTION = 0.55
#: bytes of f32 decode intermediates per chunk of lists or rows
_DECODE_CHUNK_BYTES = 256 << 20
#: bytes of one Lloyd distance block, [S, chunk, n_centers] f32, across all
#: S codebook problems
_LLOYD_BLOCK_BYTES = 512 << 20
_LLOYD_ITERS = 25


@dataclass
class IndexParams:
    n_lists: int = 1024
    metric: str = "sqeuclidean"
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8          # 4..8
    pq_dim: int = 0           # 0 → auto: dim/4, rounded up to 8
    codebook_kind: str = CODEBOOK_PER_SUBSPACE
    force_random_rotation: bool = False
    add_data_on_build: bool = True
    conservative_memory_allocation: bool = False
    seed: int = 0
    #: "auto" (bf16 unless the projected cache outgrows the card: int8),
    #: "bfloat16", "float32" or "int8"
    decoded_dtype: str = "auto"


@dataclass
class SearchParams:
    n_probes: int = 20
    lut_dtype: str = "float32"                 # float32 | bfloat16 products
    internal_distance_dtype: str = "float32"   # float32 | bfloat16 (plain ops)
    strategy: str = "auto"                     # auto | query_major | probe_major


@dataclass(frozen=True)
class EffortSpec:
    """The search-effort knobs of IVF-PQ (raft_tpu's ``EffortSpec``; see
    ``ivf_flat.EffortSpec``): ``n_probes`` and ``lut_dtype`` act through
    :class:`SearchParams`, ``refine_ratio`` is the bench's exact-refine
    multiplier."""

    n_probes: int = 20
    refine_ratio: int = 1
    lut_dtype: str = "float32"

    backend: ClassVar[str] = "ivf_pq"

    @classmethod
    def from_params(cls, params: Optional[SearchParams] = None, **extra) -> "EffortSpec":
        base = params if params is not None else SearchParams()
        return cls(n_probes=int(base.n_probes), refine_ratio=int(extra.get("refine_ratio", 1)),
                   lut_dtype=str(base.lut_dtype))

    def apply(self, params: Optional[SearchParams] = None) -> SearchParams:
        base = params if params is not None else SearchParams()
        return dc_replace(base, n_probes=int(self.n_probes), lut_dtype=str(self.lut_dtype))

    def degraded(self, level: int) -> "EffortSpec":
        """``level`` notches down: ``n_probes`` halved per level (at least
        1), bf16 products from level 2, refine dropped."""
        if level <= 0:
            return self
        return EffortSpec(n_probes=max(1, int(self.n_probes) >> int(level)), refine_ratio=1,
                          lut_dtype="bfloat16" if level >= 2 else str(self.lut_dtype))

    def knobs(self):
        return {"n_probes": int(self.n_probes), "refine_ratio": int(self.refine_ratio),
                "lut_dtype": str(self.lut_dtype)}


def _auto_pq_dim(dim: int) -> int:
    v = max(1, dim // 4)
    return (v + 7) // 8 * 8 if v > 8 else v


def _dtype_name(dtype: torch.dtype) -> str:
    return {v: k for k, v in _DECODED_DTYPES.items()}[dtype]


class Index:
    """IVF-PQ index; every tensor field lives on one device.

    centers [L, dim] f32, centers_rot [L, rot_dim] f32, rotation
    [rot_dim, dim] f32, codebook [pq_dim | L, 2**pq_bits, pq_len] f32,
    list_codes [L, cap, pq_dim] uint8, list_index [L, cap] int32 (-1 past
    each list's size), list_sizes [L] int32, list_data [L, cap, rot_dim]
    bf16 / f32 / int8, list_y2 [L, cap] f32; ``scan_scale`` is the value of
    one int8 step (a Python float, as raft_tpu keeps it; 1.0 for float
    caches)."""

    def __init__(self, metric, codebook_kind, pq_bits, centers, centers_rot, rotation,
                 codebook, list_codes, list_index, list_sizes, list_data, list_y2,
                 scan_scale: float = 1.0, headroom: bool = True):
        self.metric = metric
        self.codebook_kind = codebook_kind
        self.pq_bits = pq_bits
        self.centers = centers
        self.centers_rot = centers_rot
        self.rotation = rotation
        self.codebook = codebook
        self.list_codes = list_codes
        self.list_index = list_index
        self.list_sizes = list_sizes
        self.list_data = list_data
        self.list_y2 = list_y2
        self.scan_scale = float(scan_scale)
        self.headroom = headroom
        #: the store.TieredStore of a paged index (store.paginate_index)
        self.paged = None
        self._group_inverse = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def pq_dim(self) -> int:
        return self.list_codes.shape[2]

    @property
    def pq_len(self) -> int:
        return self.rot_dim // self.pq_dim

    @property
    def pq_n_centers(self) -> int:
        return 1 << self.pq_bits

    @property
    def list_cap(self) -> int:
        return self.list_codes.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())

    @property
    def decoded_dtype(self) -> str:
        return _dtype_name(self.list_data.dtype)

    @property
    def per_cluster(self) -> bool:
        return self.codebook_kind == CODEBOOK_PER_CLUSTER


def make_rotation_matrix(gen: torch.Generator, rot_dim: int, dim: int,
                         force_random: bool) -> torch.Tensor:
    """Orthonormal [rot_dim, dim] f32 on the host: the identity (zero-padded
    when rot_dim > dim) unless ``force_random``, else Q of a QR of a
    Gaussian drawn from ``gen``."""
    if not force_random:
        return torch.eye(rot_dim, dim, dtype=torch.float32)
    if rot_dim <= dim:
        q, _ = torch.linalg.qr(torch.randn(dim, rot_dim, generator=gen))
        return q.T.contiguous()
    q, _ = torch.linalg.qr(torch.randn(rot_dim, dim, generator=gen))
    return q


def _train_codebooks_lloyd(gen: torch.Generator, subvecs: torch.Tensor, n_centers: int,
                           n_iters: int, weights: Optional[torch.Tensor] = None):
    """Lloyd iterations over S independent problems at once: subvecs
    [S, n, pq_len] (weights [S, n], 0 ⇒ padding) → [S, n_centers, pq_len].
    Seeds are drawn ∝ weight (without replacement when n ≥ n_centers); the
    assignment runs in row chunks so the [S, chunk, n_centers] distance
    block stays under ``_LLOYD_BLOCK_BYTES``, and the update sums by
    ``segment_sum`` in a fixed order."""
    S, n, L = subvecs.shape
    dev = subvecs.device
    w = torch.ones((S, n), dtype=torch.float32, device=dev) if weights is None else weights
    # a problem with no rows takes any seed; its centers never move
    w_draw = torch.where((w.sum(dim=1) > 0)[:, None], w, torch.ones_like(w))
    seeds = kmeans_balanced.draw_rows(gen, w_draw, n_centers)
    centers = torch.gather(subvecs, 1, seeds.to(dev)[:, :, None].expand(S, n_centers, L))
    chunk = int(np.clip(_LLOYD_BLOCK_BYTES // (4 * S * n_centers), 256, max(n, 1)))
    for _ in range(n_iters):
        c2 = (centers * centers).sum(dim=2)[:, None, :]                    # [S, 1, K]
        acc = torch.zeros((S, n_centers, L + 1), dtype=torch.float32, device=dev)
        for s in range(0, n, chunk):
            xb, wb = subvecs[:, s:s + chunk], w[:, s:s + chunk, None]
            labels = (c2 - 2.0 * torch.bmm(xb, centers.transpose(1, 2))).argmin(dim=2)
            acc += segment_sum(torch.cat([xb * wb, wb], dim=2), labels, n_centers,
                               block_bytes=_LLOYD_BLOCK_BYTES)
        counts = acc[..., L:]
        centers = torch.where(counts > 0, acc[..., :L] / torch.clamp(counts, min=1e-12), centers)
    return centers


def _pool_per_cluster(resid, labels, n_lists, pq_dim, pq_len, k_pq):
    """Every subspace slice of each cluster's residuals pooled into one
    training set per cluster, padded with weight-0 rows and capped at
    max(8·k_pq, 2048) rows (raft_tpu's per_cluster pooling, on the host)."""
    flat = resid.cpu().numpy().reshape(-1, pq_len)
    lab2 = np.repeat(labels.cpu().numpy(), pq_dim)
    counts = np.bincount(lab2, minlength=n_lists)
    cap = max(int(counts.max()) if counts.size else 1, k_pq)
    cap = min(cap, max(8 * k_pq, 2048))
    order = np.argsort(lab2, kind="stable")
    starts = np.cumsum(counts) - counts
    within = np.arange(len(lab2)) - starts[lab2[order]]
    keep = within < cap
    pooled = np.zeros((n_lists, cap, pq_len), np.float32)
    wts = np.zeros((n_lists, cap), np.float32)
    pooled[lab2[order][keep], within[keep]] = flat[order][keep]
    wts[lab2[order][keep], within[keep]] = 1.0
    return torch.from_numpy(pooled).to(resid.device), torch.from_numpy(wts).to(resid.device)


def _encode(rotation, centers, codebook, x, labels, codebook_kind: str) -> torch.Tensor:
    """Residual-encode rows → codes [n, pq_dim] uint8: the nearest codebook
    entry of each rotated residual slice, argmin of |cb|^2 - 2 sub·cb."""
    lab = labels.long()
    res_rot = torch.matmul(x - centers[lab], rotation.T)                   # [n, rot]
    if codebook_kind == CODEBOOK_PER_SUBSPACE:
        pq_dim, _, pq_len = codebook.shape
        sub = res_rot.reshape(-1, pq_dim, pq_len).transpose(0, 1)          # [j, n, l]
        ip = torch.bmm(sub, codebook.transpose(1, 2))                      # [j, n, k]
        cb2 = (codebook * codebook).sum(dim=2)[:, None, :]                 # [j, 1, k]
        codes = (cb2 - 2.0 * ip).argmin(dim=2).T
    else:
        pq_len = codebook.shape[2]
        sub = res_rot.reshape(res_rot.shape[0], -1, pq_len)                # [n, j, l]
        cb = codebook[lab]                                                 # [n, k, l]
        ip = torch.bmm(sub, cb.transpose(1, 2))                            # [n, j, k]
        cb2 = (cb * cb).sum(dim=2)[:, None, :]                             # [n, 1, k]
        codes = (cb2 - 2.0 * ip).argmin(dim=2)
    return codes.to(torch.uint8).contiguous()


def _rows_y(codebook, centers_rot, codes, lists, per_cluster: bool) -> torch.Tensor:
    """f32 reconstructions [n, rot_dim] of coded rows in lists ``lists``:
    centers_rot[list] + concat_j codebook[j or list, code_j]."""
    c = codes.long()
    lab = lists.long()
    if per_cluster:
        dec = codebook[lab[:, None], c]                                    # [n, j, l]
    else:
        dec = codebook[torch.arange(codebook.shape[0], device=c.device)[None, :], c]
    return dec.reshape(codes.shape[0], -1) + centers_rot[lab]


def _store(y: torch.Tensor, dtype: torch.dtype, scale: float):
    """Reconstructions → (stored values, y2 f32 of the stored values).  An
    int8 cache divides by the scale rounded to f32, as raft_tpu does."""
    if dtype == torch.int8:
        stored = torch.clamp(torch.round(true_div(y, scale)), -127, 127).to(torch.int8)
        y_f32 = stored.to(torch.float32) * torch.full((), scale, dtype=torch.float32,
                                                     device=y.device)
    else:
        stored = y.to(dtype)
        y_f32 = stored.to(torch.float32)
    return stored, (y_f32 * y_f32).sum(dim=-1)


def _int8_scale(absmax: float) -> float:
    """raft_tpu's scan_scale: a Python float (float64) from the f32 peak."""
    return max(absmax, 1e-12) / 127.0


def _decode_lists(codebook, codebook_kind, centers_rot, list_codes, list_index, dtype):
    """The scan cache of packed lists → (list_data [L, cap, rot_dim] of
    ``dtype``, list_y2 [L, cap], scan_scale); padding slots are zero.
    Chunked over lists so the f32 intermediates stay under
    ``_DECODE_CHUNK_BYTES``."""
    L, cap, pq_dim = list_codes.shape
    rot_dim = centers_rot.shape[1]
    dev = list_codes.device
    per_cluster = codebook_kind == CODEBOOK_PER_CLUSTER
    chunk = int(np.clip(_DECODE_CHUNK_BYTES // max(1, cap * rot_dim * 4), 1, max(L, 1)))

    def decoded(s):
        e = min(s + chunk, L)
        lists = torch.arange(s, e, device=dev).repeat_interleave(cap)
        y = _rows_y(codebook, centers_rot, list_codes[s:e].reshape(-1, pq_dim), lists,
                    per_cluster)
        return torch.where((list_index[s:e] >= 0).reshape(-1, 1), y, torch.zeros_like(y))

    scale = 1.0
    if dtype == torch.int8:
        scale = _int8_scale(max(float(decoded(s).abs().max()) for s in range(0, L, chunk)))
    data = torch.zeros((L, cap, rot_dim), dtype=dtype, device=dev)
    y2 = torch.zeros((L, cap), dtype=torch.float32, device=dev)
    for s in range(0, L, chunk):
        e = min(s + chunk, L)
        stored, sq = _store(decoded(s), dtype, scale)
        data[s:e] = stored.reshape(e - s, cap, rot_dim)
        y2[s:e] = sq.reshape(e - s, cap)
    return data, y2, scale


def _assemble_lists(codes, ids, labels, n_lists, codebook, codebook_kind, centers_rot,
                    dtype, headroom: bool = True):
    """Pack coded rows (codes [n, pq_dim] uint8 and ids on the device,
    labels numpy) into the padded layout, decoding each row chunk into the
    scan cache.  Oversized lists are split with duplicated centroids.
    Returns (list_codes, list_index, list_sizes, list_data, list_y2,
    center_map, scan_scale)."""
    n, pq_dim = codes.shape
    dev = codes.device
    lst, slot, sizes, center_map, cap = compute_list_layout(
        labels, n_lists, max_cap=default_max_cap(n, n_lists), headroom=headroom,
    )
    L = len(center_map)
    cmap = torch.from_numpy(center_map).to(dev)
    per_cluster = codebook_kind == CODEBOOK_PER_CLUSTER
    cr = centers_rot[cmap]
    cb = codebook[cmap] if per_cluster else codebook
    rot_dim = cr.shape[1]
    per_row = rot_dim * 4 * 4 + (cb.shape[1] * cb.shape[2] * 4 if per_cluster else 0)
    chunk = int(np.clip(_DECODE_CHUNK_BYTES // per_row, 8, max(n, 8)))
    lst_t = torch.from_numpy(lst).to(dev)
    slot_t = torch.from_numpy(slot).to(dev)

    def rows_y(s):
        return _rows_y(cb, cr, codes[s:s + chunk], lst_t[s:s + chunk], per_cluster)

    scale = 1.0
    if dtype == torch.int8 and n:
        scale = _int8_scale(max(float(rows_y(s).abs().max()) for s in range(0, n, chunk)))
    l_codes = torch.zeros((L, cap, pq_dim), dtype=torch.uint8, device=dev)
    l_index = torch.full((L, cap), -1, dtype=torch.int32, device=dev)
    l_data = torch.zeros((L, cap, rot_dim), dtype=dtype, device=dev)
    l_y2 = torch.zeros((L, cap), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        lj, sj = lst_t[s:s + chunk], slot_t[s:s + chunk]
        stored, y2 = _store(rows_y(s), dtype, scale)
        l_codes[lj, sj] = codes[s:s + chunk]
        l_index[lj, sj] = ids[s:s + chunk]
        l_data[lj, sj] = stored
        l_y2[lj, sj] = y2
    return (l_codes, l_index, torch.from_numpy(sizes).to(dev), l_data, l_y2, center_map,
            scale)


def _device_memory_budget(device: torch.device) -> Tuple[int, bool]:
    """Bytes of device memory to plan against, and whether that is the
    card's real size (``torch.cuda.mem_get_info``) rather than the 16 GiB
    assumed off the card."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1]), True
    return 16 << 30, False


def _resolve_decoded_dtype(params: IndexParams, n: int, rot_dim: int, pq_dim: int,
                           device: torch.device) -> str:
    """"auto": bf16 unless the projected bf16 index outgrows
    ``_AUTO_HBM_FRACTION`` of a real device memory size, then int8."""
    if params.decoded_dtype != "auto":
        validation.check_in(params.decoded_dtype, _DECODED_DTYPES, "decoded_dtype")
        return params.decoded_dtype
    est_rows = int(n * 1.35) + 8 * params.n_lists
    bf16_bytes = est_rows * (rot_dim * 2 + pq_dim + 8)
    total, real = _device_memory_budget(device)
    budget = int(_AUTO_HBM_FRACTION * total)
    if bf16_bytes > budget and real:
        warnings.warn(
            f"ivf_pq.build: projected bf16 cache {bf16_bytes / 2**30:.1f} GiB exceeds the "
            f"{budget / 2**30:.1f} GiB budget; using the int8 scan cache"
        )
        return "int8"
    return "bfloat16"


@traced("ivf_pq.build")
def build(params: IndexParams, dataset, *, res: Optional[Resources] = None) -> Index:
    """Subsample a trainset → balanced k-means → rotation → codebooks →
    encode and pack every row (``add_data_on_build``)."""
    res = ensure(res)
    device = res.device
    n, dim = dataset.shape
    canonical = DISTANCE_TYPES[params.metric]
    if canonical not in ("sqeuclidean", "euclidean", "inner_product"):
        raise ValueError(f"ivf_pq supports L2/IP metrics, got {params.metric}")
    if not 4 <= params.pq_bits <= 8:
        raise ValueError(f"pq_bits must be in [4, 8], got {params.pq_bits}")
    validation.check_in(params.codebook_kind, (CODEBOOK_PER_SUBSPACE, CODEBOOK_PER_CLUSTER),
                        "codebook_kind")
    pq_dim = params.pq_dim or _auto_pq_dim(dim)
    pq_len = math.ceil(dim / pq_dim)
    rot_dim = pq_dim * pq_len
    gen = torch.Generator().manual_seed(int(params.seed))

    n_train = min(n, max(params.n_lists * 2, int(n * params.kmeans_trainset_fraction)))
    trainset = as_f32(subsample_trainset(dataset, n_train, params.seed) if n_train < n
                      else dataset, device)
    kb_metric = "inner_product" if canonical == "inner_product" else "sqeuclidean"
    kb = kmeans_balanced.KMeansBalancedParams(
        n_iters=params.kmeans_n_iters, metric=kb_metric, seed=params.seed)
    centers = kmeans_balanced.fit(kb, trainset, params.n_lists, res=res)
    labels = kmeans_balanced.predict(centers, trainset, metric=kb_metric, res=res).long()

    rotation = make_rotation_matrix(gen, rot_dim, dim, params.force_random_rotation).to(device)
    centers_rot = torch.matmul(centers, rotation.T)
    resid = torch.matmul(trainset - centers[labels], rotation.T)
    k_pq = 1 << params.pq_bits
    if params.codebook_kind == CODEBOOK_PER_SUBSPACE:
        subvecs = resid.reshape(-1, pq_dim, pq_len).permute(1, 0, 2).contiguous()
        codebook = _train_codebooks_lloyd(gen, subvecs, k_pq, _LLOYD_ITERS)
    else:
        pooled, wts = _pool_per_cluster(resid, labels, params.n_lists, pq_dim, pq_len, k_pq)
        codebook = _train_codebooks_lloyd(gen, pooled, k_pq, _LLOYD_ITERS, wts)
    del trainset, resid

    dtype = _DECODED_DTYPES[_resolve_decoded_dtype(params, n, rot_dim, pq_dim, device)]
    L = params.n_lists
    index = Index(
        params.metric, params.codebook_kind, params.pq_bits, centers, centers_rot, rotation,
        codebook,
        torch.zeros((L, 8, pq_dim), dtype=torch.uint8, device=device),
        torch.full((L, 8), -1, dtype=torch.int32, device=device),
        torch.zeros((L,), dtype=torch.int32, device=device),
        torch.zeros((L, 8, rot_dim), dtype=dtype, device=device),
        torch.zeros((L, 8), dtype=torch.float32, device=device),
        headroom=not params.conservative_memory_allocation,
    )
    if params.add_data_on_build:
        index = extend(index, dataset, torch.arange(n, dtype=torch.int32), res=res)
    return index


def _extend_fast(index: Index, codes, labels: np.ndarray, new_ids):
    """Append into spare list capacity without touching existing rows, or
    None when a centroid group is out of room — or when an int8 cache would
    clip the new rows at its frozen scale (the repack rescales)."""
    centers = index.centers.cpu().numpy()
    if index._group_inverse is None:
        index._group_inverse = centroid_group_inverse(centers)
    alloc = allocate_append_slots(centers, index.list_sizes.cpu().numpy(), index.list_cap,
                                  labels, group_inverse=index._group_inverse)
    if alloc is None:
        return None
    slab, slots, counts_new = alloc
    dev = index.centers.device
    lj = torch.from_numpy(slab).to(dev)
    sj = torch.from_numpy(slots).to(dev)
    y = _rows_y(index.codebook, index.centers_rot, codes, lj, index.per_cluster)
    if index.list_data.dtype == torch.int8 and float(y.abs().max()) > 127.0 * index.scan_scale:
        return None
    stored, y2 = _store(y, index.list_data.dtype, index.scan_scale)
    fields = [t.clone() for t in (index.list_codes, index.list_index, index.list_data,
                                  index.list_y2)]
    for field, value in zip(fields, (codes, new_ids, stored, y2)):
        field[lj, sj] = value
    new = Index(
        index.metric, index.codebook_kind, index.pq_bits, index.centers, index.centers_rot,
        index.rotation, index.codebook, fields[0], fields[1],
        index.list_sizes + torch.from_numpy(counts_new).to(dev, torch.int32),
        fields[2], fields[3], index.scan_scale, headroom=index.headroom,
    )
    new._group_inverse = index._group_inverse
    return new


@traced("ivf_pq.extend")
def extend(index: Index, new_vectors, new_indices=None, *,
           res: Optional[Resources] = None) -> Index:
    """Encode and add rows: predict + encode one tile at a time (a numpy
    input is uploaded tile by tile), then append into spare capacity or
    repack every row."""
    if index.paged is not None:
        raise ValueError(
            "extend() on a paged index is unsupported: paged serving routes growth "
            "through side buffers and re-paginates at compaction"
        )
    res = ensure(res)
    dev = index.centers.device
    n = new_vectors.shape[0]
    kb_metric = "inner_product" if DISTANCE_TYPES[index.metric] == "inner_product" else "sqeuclidean"
    tile = max(1, res.workspace_rows(
        4 * (index.rot_dim * 3 + index.pq_dim * index.pq_n_centers), cap=1 << 18))
    codes, labels = [], []
    for s in range(0, n, tile):
        xt = as_f32(new_vectors[s:s + tile], dev)
        lt = kmeans_balanced.predict(index.centers, xt, metric=kb_metric, res=res)
        codes.append(_encode(index.rotation, index.centers, index.codebook, xt, lt,
                             index.codebook_kind))
        labels.append(lt)
    if not codes:
        return index
    return _extend_encoded(index, torch.cat(codes), torch.cat(labels).cpu().numpy(),
                           new_indices)


def _extend_encoded(index: Index, codes, labels: np.ndarray, new_indices=None) -> Index:
    """Append already-encoded rows (codes [n, pq_dim] uint8 on the device,
    coarse labels numpy): the assembly half of :func:`extend`."""
    dev = index.centers.device
    n = codes.shape[0]
    old_n = index.size
    if new_indices is None:
        new_indices = torch.arange(old_n, old_n + n, dtype=torch.int32)
    new_ids = torch.as_tensor(new_indices).to(device=dev, dtype=torch.int32)
    if n and old_n:
        fast = _extend_fast(index, codes, labels, new_ids)
        if fast is not None:
            return fast

    old_codes, old_ids, old_labels = unpack_lists(index.list_codes, index.list_index)
    if old_codes.shape[0] == 0:
        all_codes, all_ids, all_labels = codes, new_ids, labels
    else:
        all_codes = torch.cat([old_codes, codes])
        all_ids = torch.cat([old_ids, new_ids])
        all_labels = np.concatenate([old_labels.cpu().numpy(), labels])
    uniq, all_labels = merge_split_lists(index.centers.cpu().numpy(), all_labels)
    uniq_t = torch.from_numpy(uniq).to(dev)
    codebook = index.codebook[uniq_t] if index.per_cluster else index.codebook
    list_codes, list_index, list_sizes, list_data, list_y2, cmap, scale = _assemble_lists(
        all_codes, all_ids, all_labels, len(uniq), codebook, index.codebook_kind,
        index.centers_rot[uniq_t], index.list_data.dtype, headroom=index.headroom,
    )
    cmap_t = uniq_t[torch.from_numpy(cmap).to(dev)]
    return Index(
        index.metric, index.codebook_kind, index.pq_bits, index.centers[cmap_t],
        index.centers_rot[cmap_t], index.rotation,
        index.codebook[cmap_t] if index.per_cluster else index.codebook,
        list_codes, list_index, list_sizes, list_data, list_y2, scale,
        headroom=index.headroom,
    )


def with_decoded_dtype(index: Index, decoded_dtype: str) -> Index:
    """The same index with its scan cache rebuilt from the codes at
    another storage type ("bfloat16", "float32", "int8") — what
    :func:`load` does for a saved index — so one build serves every
    storage leg."""
    validation.check_in(decoded_dtype, _DECODED_DTYPES, "decoded_dtype")
    list_data, list_y2, scale = _decode_lists(
        index.codebook, index.codebook_kind, index.centers_rot, index.list_codes,
        index.list_index, _DECODED_DTYPES[decoded_dtype],
    )
    return Index(index.metric, index.codebook_kind, index.pq_bits, index.centers,
                 index.centers_rot, index.rotation, index.codebook, index.list_codes,
                 index.list_index, index.list_sizes, list_data, list_y2, scale,
                 headroom=index.headroom)


def _lists(index: Index, queries: torch.Tensor, n_probes: int):
    """(list_data, list_y2, list_index) of a search of ``queries``: a paged
    index's scan cache is the ``PagedLists`` view, its probed pages made
    resident (``_common.paged_lists_for_search``)."""
    data = index.list_data
    if index.paged is not None:
        data = _common.paged_lists_for_search(index, queries, DISTANCE_TYPES[index.metric],
                                              n_probes)
    return data, index.list_y2, index.list_index


def scan_kwargs(index: Index, lut_dtype: str = "float32") -> dict:
    """The storage-leg arguments of the ivf_scan kernels for this index."""
    return {"scan_dtype": lut_dtype, "scan_scale": index.scan_scale}


def _rotate(index: Index, queries: torch.Tensor) -> torch.Tensor:
    return torch.matmul(queries, index.rotation.T)


def probe_major_scan_inputs(index: Index, queries: torch.Tensor, n_probes: int, k: int,
                            bucket: int):
    """(the positional arguments of ``ivf_scan_probe_major`` for one
    probe-major block, bucket_pair); add :func:`scan_kwargs`."""
    return _common.probe_major_scan_inputs(
        queries, _rotate(index, queries), index.centers, _lists(index, queries, n_probes),
        DISTANCE_TYPES[index.metric], n_probes, k, bucket)


def query_major_scan_inputs(index: Index, queries: torch.Tensor, n_probes: int, k: int):
    """The positional arguments of ``ivf_scan_query_major`` for one
    query-major block; add :func:`scan_kwargs`."""
    return _common.query_major_scan_inputs(
        queries, _rotate(index, queries), index.centers, _lists(index, queries, n_probes),
        DISTANCE_TYPES[index.metric], n_probes, k)


@traced("ivf_pq.search")
def search(params: SearchParams, index: Index, queries, k: int, *, sample_filter=None,
           deleted_mask=None, res: Optional[Resources] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (distances [q, k] f32, indices [q, k] int32): PQ
    approximations — pass the ids to ``neighbors.refine`` for exact
    distances.  Id -1 appears only when the probed lists hold fewer than k
    rows (distance +inf).  ``sample_filter`` / ``deleted_mask``: as
    ``ivf_flat.search``."""
    validation.check_in(params.internal_distance_dtype, ("float32", "bfloat16"),
                        "internal_distance_dtype")
    validation.check_in(params.lut_dtype, ("float32", "bfloat16"), "lut_dtype")
    validation.check_in(params.strategy, ("auto", "query_major", "probe_major"), "strategy")
    res = ensure(res)
    res.device  # raises without a card unless the caller asked for the CPU
    pass_filter = _common.resolve_pass_filter(sample_filter, deleted_mask)
    queries = as_f32(queries, index.centers.device)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(f"queries shape {tuple(queries.shape)} vs index dim {index.dim}")
    n_probes = min(params.n_probes, index.n_lists)
    if k > n_probes * index.list_cap:
        raise ValueError(
            f"k={k} exceeds the candidate pool n_probes*list_cap="
            f"{n_probes}*{index.list_cap}; raise n_probes")
    metric = DISTANCE_TYPES[index.metric]
    with _common.search_lists(index, queries, metric, n_probes, index.list_y2) as lists:
        if params.internal_distance_dtype == "bfloat16":
            v, i = _search_bf16_distance(index, queries, int(k), n_probes, metric, lists,
                                         params.lut_dtype, pass_filter, res.workspace_rows)
            return _common.postprocess(v, metric), i
        v, i = _common.scan_search(
            queries, int(k), n_probes, params.strategy, index.centers, lists, metric,
            lambda qt: _rotate(index, qt), scan_kwargs(index, params.lut_dtype),
            res.workspace_limit_bytes, pass_filter,
        )
    return _common.postprocess(v, metric), i


def _search_bf16_distance(index: Index, queries: torch.Tensor, k: int, n_probes: int,
                          metric: str, lists, lut_dtype: str, pass_filter, workspace_rows):
    """A search with ``internal_distance_dtype="bfloat16"``: raft_tpu's XLA
    body (``_search_jit``), which raft_tpu keeps off its Pallas scans, in
    plain PyTorch ops on the lists' device.  Per query tile: coarse select,
    the probed rows gathered, ``ip = q_rot . y`` summed in f32, then the
    score in raft_tpu's dtypes: for a float cache ``ip`` (of bf16 inputs
    when ``lut_dtype`` is bf16) is rounded to bf16 and ``y2 - 2 ip + q2``
    runs in bf16 with ``y2`` and ``q2`` rounded to bf16, each operation
    rounding; for the int8 cache ``ip`` stays f32 (raft_tpu's
    ``int8_scored_ip``), so the sum promotes to f32 after ``y2`` and ``q2``
    are rounded; inner product is ``-ip``.  Then the filter mask (+inf, id
    -1) and ``select_k`` over every probed slot.  Both schedules rank these
    same scores; raft_tpu's probe-major merge can order ties otherwise.
    Returns raw scores and ids."""
    data, list_y2, list_index = lists
    dev = data.device
    per_row = isinstance(pass_filter, RowFilter)
    words = None if pass_filter is None else pass_filter.words.to(dev)
    if per_row:
        validation.expects(words.shape[0] == queries.shape[0],
                           f"row filter has {words.shape[0]} rows for {queries.shape[0]} queries")
    int8 = data.dtype == torch.int8
    cap = data.shape[1]
    itemsize = 1 if int8 else (2 if lut_dtype == "bfloat16" else 4)
    per_q = n_probes * cap * (index.rot_dim * itemsize + 12)
    tile = int(min(max(queries.shape[0], 1), workspace_rows(per_q, cap=1024)))
    bf16 = torch.bfloat16
    stamp_kernel_path("torch")
    vs, is_ = [], []
    for s in range(0, queries.shape[0], tile):
        qt = queries[s:s + tile]
        probes = _common.coarse_select(qt, index.centers, metric, n_probes).long()
        qr = _rotate(index, qt)                                              # [t, rot]
        dec = gather_lists(data, probes)                                     # [t, p, cap, rot]
        ids = list_index[probes]                                             # [t, p, cap]
        if int8:
            ip = int8_scored_ip(qr[:, None, None, :], dec, index.scan_scale)[:, :, 0, :]
        else:
            qs = qr.to(bf16).to(torch.float32) if lut_dtype == "bfloat16" else qr
            rows = dec.to(torch.float32)
            if lut_dtype == "bfloat16":
                rows = rows.to(bf16).to(torch.float32)
            ip = torch.einsum("td,tpcd->tpc", qs, rows).to(bf16)
        if metric == "inner_product":
            scores = (-ip).to(torch.float32)
        else:
            q2 = (qr * qr).sum(dim=1).to(bf16)
            scores = (list_y2[probes].to(bf16) - 2.0 * ip + q2[:, None, None]).to(torch.float32)
        fw = None if words is None else (words[s:s + tile] if per_row else words)
        invalid = (_common.invalid_mask_rows(ids, fw) if per_row
                   else _common.invalid_mask(ids, fw))
        scores = torch.where(invalid, torch.full_like(scores, float("inf")), scores)
        ids = torch.where(invalid, torch.full_like(ids, -1), ids)
        v, i = select_k(scores.reshape(qt.shape[0], -1), k, select_min=True,
                        input_indices=ids.reshape(qt.shape[0], -1))
        vs.append(v)
        is_.append(i)
    if not vs:
        return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    return torch.cat(vs), torch.cat(is_)


def _pack_bits(codes: np.ndarray, pq_bits: int) -> np.ndarray:
    """uint8 codes (< 2**pq_bits) [rows, pq_dim] → a little-endian
    bitstream per row (raft_tpu's file layout)."""
    bits = np.unpackbits(codes[..., None], axis=-1, count=8, bitorder="little")
    bits = bits[..., :pq_bits].reshape(codes.shape[0], -1)
    return np.packbits(bits, axis=-1, bitorder="little")


def _unpack_bits(packed: np.ndarray, pq_dim: int, pq_bits: int) -> np.ndarray:
    bits = np.unpackbits(packed, axis=-1, bitorder="little")[:, : pq_dim * pq_bits]
    bits = bits.reshape(packed.shape[0], pq_dim, pq_bits)
    full = np.zeros((packed.shape[0], pq_dim, 8), np.uint8)
    full[..., :pq_bits] = bits
    return np.packbits(full, axis=-1, bitorder="little")[..., 0]


@traced("ivf_pq.save")
def save(filename: str, index: Index) -> None:
    lc = index.list_codes.cpu().numpy()
    L, cap, pq_dim = lc.shape
    ser.save_tree(
        filename, "ivf_pq", _SERIALIZATION_VERSION,
        {
            "metric": index.metric,
            "codebook_kind": index.codebook_kind,
            "pq_bits": index.pq_bits,
            "pq_dim": pq_dim,
            "list_cap": cap,
            "decoded_dtype": index.decoded_dtype,
            "headroom": int(index.headroom),
        },
        {
            "centers": index.centers,
            "centers_rot": index.centers_rot,
            "rotation": index.rotation,
            "codebook": index.codebook,
            "list_codes_packed": _pack_bits(lc.reshape(L * cap, pq_dim), index.pq_bits),
            "list_index": index.list_index,
            "list_sizes": index.list_sizes,
        },
    )


def from_numpy(arrays, scalars, *, res: Optional[Resources] = None) -> Index:
    """An Index from what raft_tpu's ``ivf_pq.save`` writes (``arrays``:
    centers, centers_rot, rotation, codebook, list_codes_packed,
    list_index, list_sizes; ``scalars``: metric, codebook_kind, pq_bits,
    pq_dim, list_cap, decoded_dtype, headroom).  The scan cache is rebuilt
    from the codes, as raft_tpu's ``load`` does."""
    dev = ensure(res).device
    L = arrays["centers"].shape[0]
    cap, pq_dim = int(scalars["list_cap"]), int(scalars["pq_dim"])
    codes = _unpack_bits(np.asarray(arrays["list_codes_packed"]), pq_dim,
                         int(scalars["pq_bits"])).reshape(L, cap, pq_dim)
    dtype_name = scalars.get("decoded_dtype", "bfloat16")
    validation.check_in(dtype_name, _DECODED_DTYPES, "decoded_dtype")
    t = {name: torch.from_numpy(np.array(arrays[name])).to(dev)  # writable copies
         for name in ("centers", "centers_rot", "rotation", "codebook", "list_index",
                      "list_sizes")}
    list_codes = torch.from_numpy(codes).to(dev)
    list_index = t["list_index"].to(torch.int32)
    list_data, list_y2, scale = _decode_lists(
        t["codebook"], scalars["codebook_kind"], t["centers_rot"], list_codes, list_index,
        _DECODED_DTYPES[dtype_name],
    )
    return Index(scalars["metric"], scalars["codebook_kind"], int(scalars["pq_bits"]),
                 t["centers"], t["centers_rot"], t["rotation"], t["codebook"], list_codes,
                 list_index, t["list_sizes"].to(torch.int32), list_data, list_y2, scale,
                 headroom=bool(scalars.get("headroom", 1)))


@traced("ivf_pq.load")
def load(filename: str, *, res: Optional[Resources] = None) -> Index:
    scalars, arrays = ser.load_tree(filename, "ivf_pq", _SERIALIZATION_VERSION)
    return from_numpy(arrays, scalars, res=res)
