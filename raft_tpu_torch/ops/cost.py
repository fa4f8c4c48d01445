"""Cost of the slice's kernels, and the least time an H100 could take for
them.

Two families:

- ``*_work``: the work a call needs at its inputs — each input byte read
  once, each output byte written once, and the operations of the function
  itself (2·d flops per scored (query, row) pair, one comparison per
  selected-from score), counting only real rows where the data decides.
  This is what a kernel's bound is taken from.
- ``*_cost``: raft_tpu's own formulas (``raft_tpu.ops.cost``), which count
  the TPU kernels' schedule (padded list capacity, k-round selection, all
  buckets) and so over-count the work; kept for comparison.

:func:`bound_ms` turns either into the larger of bytes over the memory rate
and operations over the card's peak rate for the arithmetic the work needs
(``KernelCost.compute``): f32 FMA for f32 compute on any storage, the
dense bf16 tensor-core rate for bf16 products, the int8 rate for int8
products — whatever instructions a kernel happens to use.  Rates from
NVIDIA's H100 SXM data sheet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch

#: H100 SXM: HBM3 rate, and dense peak operations per second by arithmetic
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_PEAK_OPS = {"float32": H100_F32_FLOPS, "bfloat16": 989e12, "int8": 1979e12}


@dataclass(frozen=True)
class KernelCost:
    flops: int
    bytes_accessed: int
    #: the arithmetic the operations need: "float32", "bfloat16" or "int8"
    compute: str = "float32"


def select_k_cost(rows: int, n: int, k: int, *, itemsize: int = 4) -> KernelCost:
    """k rounds of masked min-extraction over [rows, n]."""
    flops = 6 * rows * n * k
    bytes_accessed = rows * n * (itemsize + 8) + rows * k * (itemsize + 4)
    return KernelCost(int(flops), int(bytes_accessed))


def ivf_scan_cost(n_blocks: int, g: int, cap: int, rot: int, kk: int, *,
                  itemsize: int = 4, cap_w: int = 0) -> KernelCost:
    """Both scan schedules: per (block, list) a [g, cap] score tile against
    [cap, rot] rows plus the fold; ``n_blocks`` counts buckets or
    (query, probe) steps.  A filtered leg reads ``cap_w`` filter words per
    block besides."""
    per_block = 2 * g * cap * rot + 6 * kk * (kk + cap) * g
    flops = n_blocks * per_block
    bytes_accessed = n_blocks * (
        cap * rot * itemsize + cap * 8 + g * rot * 4 + cap_w * 4
    ) + n_blocks * g * kk * 8
    return KernelCost(int(flops), int(bytes_accessed))


def cagra_traverse_cost(tile: int, width: int, deg: int, d: int, itopk: int, *,
                        itemsize: int = 4) -> KernelCost:
    """One fused CAGRA hop, per (query, parent): scoring deg neighbour rows
    (2·deg·d), the dedup membership (deg·itopk) and an itopk-round fold
    over itopk + deg candidates; every parent slot counted live."""
    per_parent = 2 * deg * d + deg * itopk + 6 * itopk * (itopk + deg)
    flops = tile * width * per_parent
    bytes_accessed = tile * width * (deg * d * itemsize + deg * 4) + tile * (
        d * itemsize + 3 * itopk * 4 * 2)
    return KernelCost(int(flops), int(bytes_accessed))


def fused_knn_cost(n_q: int, n: int, d: int, k: int, *, itemsize: int = 4) -> KernelCost:
    """Tiled brute-force distance + running top-k."""
    flops = n_q * n * (2 * d + 6 * k)
    bytes_accessed = (
        (n_q + n) * d * itemsize
        + n * itemsize
        + n_q * k * (itemsize + 4)
    )
    return KernelCost(int(flops), int(bytes_accessed))


def fused_argmin_cost(n: int, n_centers: int, d: int, *, itemsize: int = 4) -> KernelCost:
    """1-NN assignment: 2·d MACs per (row, center) pair plus the running
    argmin."""
    flops = n * n_centers * (2 * d + 3)
    bytes_accessed = (
        (n + n_centers) * d * itemsize
        + n_centers * itemsize
        + n * (itemsize + 4)
    )
    return KernelCost(int(flops), int(bytes_accessed))


def select_k_work(rows: int, n: int, k: int, *, with_ids: bool = False,
                  itemsize: int = 4) -> KernelCost:
    """Row-wise top-k of [rows, n]: each score (and its id, when ids are
    passed) read once, [rows, k] values and ids written, one comparison
    per score."""
    bytes_accessed = rows * n * (itemsize + (4 if with_ids else 0)) + rows * k * 8
    return KernelCost(int(rows * n), int(bytes_accessed))


def fused_knn_work(n_q: int, n: int, d: int, k: int) -> KernelCost:
    """Brute-force kNN: 2·d flops per (query, row) pair; queries, rows and
    row norms read once, [n_q, k] values and ids written."""
    bytes_accessed = (n_q + n) * d * 4 + n * 4 + n_q * k * 8
    return KernelCost(int(n_q * n * 2 * d), int(bytes_accessed))


def fused_argmin_work(n: int, n_centers: int, d: int) -> KernelCost:
    """1-NN assignment: 2·d flops per (row, center) pair; x and the centers
    read once at 4 bytes a value, the center norms once, and an f32 score
    and an int32 id written per row."""
    bytes_accessed = (n + n_centers) * d * 4 + n_centers * 4 + n * 8
    return KernelCost(int(n * n_centers * 2 * d), int(bytes_accessed))


def scan_work(probes: torch.Tensor, list_rows: torch.Tensor, d: int,
              out_rows: int, kk: int, *, itemsize: int = 4,
              compute: str = "float32", cap_w: int = 0,
              query_fid=None) -> KernelCost:
    """IVF list scan over the (query, probe) pairs of ``probes`` [q, p]:
    2·d operations per (pair, real row of the probed list) in ``compute``
    arithmetic; the real rows (d values of ``itemsize`` bytes, an f32 norm
    and an int32 id) of each distinct probed list read once, each query (d
    f32 and its norm) and probe id read once, ``out_rows`` x ``kk`` values
    and ids written.  ``list_rows`` [n_lists] counts each list's real
    rows.  A filtered leg reads the ``cap_w`` filter words of each distinct
    probed list once, or with ``query_fid`` [q] (each query's plane of a
    filter table) those of each distinct (plane, list) pair, and the fids."""
    probes = probes.long()
    rows = list_rows.long().to(probes.device)
    pair_rows = int(rows[probes].sum())
    lists = torch.unique(probes)
    list_bytes = int(rows[lists].sum()) * (d * itemsize + 8)
    q, p = probes.shape
    filter_bytes = 0
    if cap_w:
        if query_fid is None:
            filter_bytes = 4 * cap_w * lists.numel()
        else:
            plane_list = query_fid.long().to(probes.device)[:, None] * rows.numel() + probes
            filter_bytes = 4 * cap_w * torch.unique(plane_list).numel() + 4 * q
    bytes_accessed = (list_bytes + filter_bytes + q * (d + 1) * 4 + q * p * 4
                      + out_rows * kk * 8)
    return KernelCost(int(pair_rows * 2 * d), int(bytes_accessed), compute)


def scan_bucket_work(bucket_list: torch.Tensor, q2_gathered: torch.Tensor,
                     list_rows: torch.Tensor, d: int, kk: int, *, itemsize: int = 4,
                     compute: str = "float32", cap_w: int = 0,
                     pages_per_list: int = 0) -> KernelCost:
    """The probe-major scan from its own inputs: buckets of gathered queries
    (``bucket_list`` [B] list ids, ``q2_gathered`` [B, G], +inf at padding).
    2·d operations per (live query, real row of its bucket's list); the
    real rows of each distinct probed list read once (and its ``cap_w``
    filter words), each live gathered query (d f32 and its norm) and each
    bucket's list id read once, ``kk`` values and ids written per live
    query; a paged leg also reads ``pages_per_list`` table entries per live
    bucket."""
    live = torch.isfinite(q2_gathered)
    per_bucket = live.sum(dim=1)
    rows = list_rows.long().to(bucket_list.device)[bucket_list.long()]
    lists = torch.unique(bucket_list[per_bucket > 0].long())
    n_live = int(per_bucket.sum())
    list_rows_read = int(list_rows.long().to(lists.device)[lists].sum())
    bytes_accessed = (list_rows_read * (d * itemsize + 8) + 4 * cap_w * lists.numel()
                      + n_live * (d + 1) * 4 + bucket_list.numel() * 4 + n_live * kk * 8
                      + 4 * int((per_bucket > 0).sum()) * pages_per_list)
    return KernelCost(int((per_bucket * rows).sum()) * 2 * d, int(bytes_accessed), compute)


def cagra_hop_work(live: torch.Tensor, fetched: torch.Tensor, deg: int, d: int, itopk: int, *,
                   itemsize: int = 4, paged: bool = False, width: int = 0) -> KernelCost:
    """CAGRA hops over a tile of queries in one launch, one hop from
    ``width`` given parents or a whole walk (``width`` 0: the launch picks
    the parents), from what the launch really read: ``live`` [tile] each
    query's live parents and ``fetched`` [tile] the candidate rows they
    needed (a candidate that is -1, repeats an earlier slot of its list or
    already sits in the buffer is dropped unread; ``kernels.cagra_traverse``
    returns both).  Each live parent's graph row (deg int32) and each
    fetched row at the dataset's stored width (paged: and its int32
    page-table entry) read once, 4·d flops a fetched row (q·v and |v|^2);
    each query row (d f32) and its given parent ids read once, and the
    [tile, itopk] buffer (f32 value, int32 id, one flag byte) read and
    written once."""
    tile = int(live.shape[0])
    n_live = int(live.long().sum())
    n_rows = int(fetched.long().sum())
    bytes_accessed = (n_live * deg * 4 + n_rows * (d * itemsize + (4 if paged else 0))
                      + tile * (d + width) * 4 + 2 * tile * itopk * 9)
    return KernelCost(int(n_rows * 4 * d), int(bytes_accessed))


def scan_paged_work(probes: torch.Tensor, list_rows: torch.Tensor, d: int, out_rows: int,
                    kk: int, *, blocks: int, pages_per_list: int, **kw) -> KernelCost:
    """A paged leg of either scan: :func:`scan_work` at the same inputs plus
    the page-table reads, one int32 per (block, page of its list), where
    ``blocks`` counts the live buckets (probe-major) or the (query, probe)
    pairs (query-major)."""
    w = scan_work(probes, list_rows, d, out_rows, kk, **kw)
    return dataclasses.replace(w, bytes_accessed=w.bytes_accessed
                               + 4 * int(blocks) * int(pages_per_list))


def csr_spmm_work(n_rows: int, nnz: int, x_rows: int, cols: int) -> KernelCost:
    """kernels/csr_spmm.py: indptr, the live slots' indices and values, x
    and the output each once; a multiply and an add a (slot, column)."""
    bytes_accessed = 4 * (n_rows + 1) + 8 * nnz + 4 * x_rows * cols + 4 * n_rows * cols
    return KernelCost(int(2 * nnz * cols), int(bytes_accessed))


def bound_ms(cost: KernelCost) -> tuple:
    """(least milliseconds on an H100, "bytes" or "operations")."""
    t_bytes = cost.bytes_accessed / H100_BYTES_PER_S * 1e3
    t_ops = cost.flops / H100_PEAK_OPS[cost.compute] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# per-call capture: a kernel wrapper notes its cost where it launches, and a
# caller that opened a capture() scope collects the notes (raft_tpu's
# capture / note)

_tls = threading.local()


@contextlib.contextmanager
def capture() -> Iterator[List[Tuple[str, KernelCost]]]:
    """Collect every :func:`note` issued on this thread while the scope is
    open; nested scopes shadow (the inner scope owns the notes)."""
    prev = getattr(_tls, "notes", None)
    _tls.notes = []
    try:
        yield _tls.notes
    finally:
        _tls.notes = prev


def note(name: str, cost) -> None:
    """Record one kernel launch's cost (a no-op outside a :func:`capture`
    scope, so wrappers call it unconditionally).  ``cost`` may be a
    callable returning the :class:`KernelCost`: it is called only inside a
    scope (a cost that reads the device, such as the real rows of probed
    lists, then costs nothing outside one)."""
    notes = getattr(_tls, "notes", None)
    if notes is not None:
        notes.append((name, cost() if callable(cost) else cost))


def noted_total(notes: List[Tuple[str, KernelCost]]) -> Optional[KernelCost]:
    """Sum of a capture scope's notes (None when nothing was noted); the
    arithmetic is "float32" unless every note shares another."""
    if not notes:
        return None
    kinds = {c.compute for _, c in notes}
    return KernelCost(sum(c.flops for _, c in notes), sum(c.bytes_accessed for _, c in notes),
                      kinds.pop() if len(kinds) == 1 else "float32")


def ops_seconds(notes: List[Tuple[str, KernelCost]], peaks=None) -> float:
    """The least seconds the notes' operations take at the card's peak rate
    for each note's arithmetic (``peaks``: compute → ops/s, default
    :data:`H100_PEAK_OPS`)."""
    peaks = H100_PEAK_OPS if peaks is None else peaks
    return sum(c.flops / peaks[c.compute] for _, c in notes)
