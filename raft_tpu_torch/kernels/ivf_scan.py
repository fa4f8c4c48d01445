"""IVF list scans: ``csrc/ivf_scan.cu`` and the plain versions (counterpart
of ``raft_tpu.kernels.ivf_scan``).

Payload-agnostic like raft_tpu's: ivf_flat feeds raw f32 rows and their
squared norms, ivf_pq its decoded scan cache (f32, bf16 or int8) and the
norms of the stored values (zeroed at padding slots; the kernels mask by
``ids < 0``).

- probe-major: per bucket (one list, G queries), each query's top-kk by
  (score, slot);
- query-major: per query, the top-kk over its P probed lists by
  (score, p * cap + slot).

Each storage type is one leg of raft_tpu's ``_score_against_list``, with a
C entry and a launch count of its own (``ivf_scan_<schedule>``, ``_bf16``,
``_int8``, ``_u8``, ``_s8``):

- f32 / bf16 rows: with ``scan_dtype`` "float32" or "highest" the rows are
  upcast and every dot product is summed in f32; with "bfloat16" (ivf_pq's
  ``lut_dtype``) both operands are rounded to bf16 first;
- int8 rows of a scaled cache (values int8 x ``scan_scale``, IVF-PQ): each
  query is quantized (``toolkit.quantize_queries_i8``), the int8 products
  summed exactly, and the sum rescaled by (query scale x ``scan_scale``);
- uint8 rows, and int8 rows with ``scan_scale=None``: raw values (IVF-Flat
  over an 8-bit dataset).  raft_tpu scans them upcast to f32 at
  ``scan_dtype`` "highest" on its XLA leg; here they take the f32 legs'
  product on the upcast rows (``_u8`` / ``_s8``, paged too).

Paged lists (``store.PagedLists``, kernel #4 and the same read in
query-major): ``list_data`` may be a pool [slots, page_rows, d] behind a
page table ``page_slot [L * ppl]``; row c of list l is then row c % page_rows
of slot ``page_slot[l * ppl + c // page_rows]``.  Only the row address
changes: ids, norms and filter words stay indexed by (list, slot) on the
logical capacity ppl * page_rows, and the result is bitwise the monolithic
scan's on the same rows.  Each paged leg has a launch count of its own,
``_paged`` after the storage suffix (``ivf_scan_probe_major_bf16_paged``,
``ivf_scan_query_major_paged_fid``).  raft_tpu's paged Pallas leg folds
page by page and serves kk <= page_rows without filters
(``paged_scan_supported``); it computes the same function, so the one leg
here serves any kk <= 2048, filtered or not, and query-major too (raft_tpu
gathers paged query-major batches on XLA).

Filters (``_score_against_list``'s filtered leg): ``list_filter`` holds
each list's pass bits packed per slot (:func:`pack_list_filter`, [L,
cap_w] int32 words, cap_w = ceil(cap / 32)); on query-major it may instead
be a table of planes [F, L, cap_w] (:func:`pack_list_filter_table`), with
``query_fid`` [Q] naming each query's plane.  Each filtered leg has a
launch count of its own: ``_filt`` (one plane) and ``_fid`` (per-query
planes) after the storage suffix.

Scores: L2 (y2 - 2 ip) + q2, inner product -ip, cosine
1 - ip * rsqrt(max(q2, 1e-24)) * rsqrt(max(y2, 1e-24)).  Invalid slots
(id < 0, or a pass bit of 0) and padding queries (q2 = +inf) score +inf; a
+inf score comes out with id -1.  A kk past the rows scanned (cap, or P *
cap) gives +inf / -1 tails, as raft_tpu's scans do.  Unlike the TPU kernel, query-major needs no multiple-of-8
query count and takes any (P, cap): it streams lists and holds no
per-query score scratch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch import kernels as _k
from raft_tpu_torch.core.bitset import WORD_BITS, _n_words, pack_bits, unpack_words
from raft_tpu_torch.kernels.toolkit import int8_scored_ip, sequential_dot, topk_by_position
from raft_tpu_torch.ops import cost as _cost
from raft_tpu_torch.store.paged import PagedLists, gather_lists

#: deepest kk; raft_tpu's Pallas scans bound kk only by one (G, kk) f32 +
#: int32 VMEM block
MAX_KK = 2048
#: deepest kk probe-major folds into lists (csrc/topk.cuh kRegK); past it
#: it folds into candidate arrays over a workspace (probe_major_workspace).
#: Query-major folds into a candidate array in shared memory at every kk
_LIST_KK = 128
_METRICS = {"sqeuclidean": 0, "euclidean": 0, "inner_product": 1, "cosine": 2}
#: storage dtype → suffix of its kernel's name (int8: the scaled cache's
#: leg; raw int8 rows, ``scan_scale=None``, take "_s8")
_LEGS = {torch.float32: "", torch.bfloat16: "_bf16", torch.int8: "_int8", torch.uint8: "_u8"}
#: the legs whose rows hold raw 8-bit values
_RAW8 = ("_u8", "_s8")
#: "float32" and "highest" both compute in f32 (raft_tpu's names)
SCAN_DTYPES = ("float32", "highest", "bfloat16")
#: score elements the plain versions materialize per chunk
_PLAIN_CHUNK_ELEMS = 1 << 26
#: query-major blocks a small batch's probes are split for, per SM
#: (``kernels.grid_splits``): an SM holds 2 (256 threads with ~84 KB of
#: shared memory at kk = 10, ~107 KB at kk = 2048, __launch_bounds__(256,
#: 2)), and two waves of them even out lists of unequal length; more parts
#: gain little at small kk and pay for their merge at deep kk
QM_PER_SM = 4


def scan_supported(metric: str, list_data, kk: int) -> bool:
    """Routing gate of both scan kernels: f32, bf16, int8 or uint8 storage
    (a tensor or ``PagedLists``), L2 / inner product / cosine,
    ``kk <= 2048``."""
    return list_data.dtype in _LEGS and metric in _METRICS and 0 < kk <= MAX_KK


def storage_leg(dtype, scan_scale=1.0) -> str:
    """The suffix of the storage leg for rows of ``dtype``: "", "_bf16",
    "_int8" (a scaled int8 cache), "_s8" (raw int8 rows: ``scan_scale``
    None) or "_u8"."""
    if dtype == torch.int8 and scan_scale is None:
        return "_s8"
    return _LEGS[dtype]


def kernel_name(schedule: str, list_data, list_filter=None, query_fid=None,
                scan_scale=1.0) -> str:
    """The launch-count name of ``schedule``'s ("probe_major" /
    "query_major") kernel for ``list_data``'s storage type (raw int8 rows
    with ``scan_scale=None``), paging (``_paged`` for a ``PagedLists``) and
    filter leg (none, ``_filt`` or ``_fid``)."""
    paged = "_paged" if isinstance(list_data, PagedLists) else ""
    leg = "" if list_filter is None else "_filt" if query_fid is None else "_fid"
    return f"ivf_scan_{schedule}{storage_leg(list_data.dtype, scan_scale)}{paged}{leg}"


def probe_major_workspace(B: int, G: int, kk: int) -> Tuple[int, int, int]:
    """Shape [B, G, extra] of the probe-major kernel's candidate workspace:
    past kk = 128 each query's candidate array is its output row (kk
    entries) and then ``extra`` = kk more: at most one compaction (a
    warp's radix select, O(kk + extra)) per kk - 63 survivors, and the
    workspace no larger than the outputs [B, G, kk]; (0, 0, 0) up to kk =
    128, where the lists in shared memory need none."""
    return (0, 0, 0) if kk <= _LIST_KK else (B, G, kk)


def pack_list_filter(list_index: torch.Tensor, filter_words: torch.Tensor) -> torch.Tensor:
    """The pass bit of every (list, slot) packed per list: [L, cap_w] int32
    words from the filter's words over ids [W] (raft_tpu's
    ``pack_list_filter``).  Padding slots (id < 0) pack as fail; an id past
    the filter's words reads its last word, as raft_tpu's clamped gather
    does."""
    return pack_list_filter_table(list_index, filter_words[None])[0]


def pack_list_filter_table(list_index: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """:func:`pack_list_filter` of every row of a filter table [F, W]:
    [F, L, cap_w] int32, the query-major scan's planes for ``query_fid``.
    Rows are packed in groups so that the [rows, L, cap] intermediates stay
    near ``_PLAIN_CHUNK_ELEMS`` elements."""
    table = table.to(list_index.device)
    L, cap = list_index.shape
    safe = list_index.long().clamp(min=0)
    word_at = (safe // WORD_BITS).clamp(max=table.shape[1] - 1)
    shift = (safe % WORD_BITS).to(torch.int32)
    real = list_index >= 0
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, L * cap))
    out = torch.empty((table.shape[0], L, _n_words(cap)), dtype=torch.int32,
                      device=list_index.device)
    for s in range(0, table.shape[0], step):
        ok = ((table[s:s + step][:, word_at] >> shift) & 1 == 1) & real
        out[s:s + step] = pack_bits(ok)
    return out


def _check_filter(list_filter, query_fid, list_index, n_queries):
    """Shapes of a filter leg: [L, cap_w] words, or with ``query_fid`` [Q]
    an [F, L, cap_w] table."""
    if list_filter is None:
        if query_fid is not None:
            raise ValueError("query_fid needs a list_filter table")
        return
    L, cap = list_index.shape
    plane = (L, _n_words(cap))
    if list_filter.dtype != torch.int32:
        raise ValueError(f"list_filter words must be int32, got {list_filter.dtype}")
    if query_fid is None:
        if tuple(list_filter.shape) != plane:
            raise ValueError(f"list_filter must be [n_lists, cap_w] = {plane}, "
                             f"got {tuple(list_filter.shape)}")
        return
    if list_filter.ndim != 3 or tuple(list_filter.shape[1:]) != plane:
        raise ValueError(f"query_fid needs a list_filter table [F, {plane[0]}, {plane[1]}], "
                         f"got {tuple(list_filter.shape)}")
    if tuple(query_fid.shape) != (n_queries,):
        raise ValueError(f"query_fid must be [{n_queries}], got {tuple(query_fid.shape)}")


def _ip(q: torch.Tensor, rows: torch.Tensor, scan_dtype: str, scan_scale):
    """q·y of f32 queries [..., M, d] against stored rows [..., N, d]: the
    leg of ``_score_against_list`` that ``rows``' type, ``scan_scale``
    (None: raw 8-bit rows) and ``scan_dtype`` select."""
    if rows.dtype == torch.int8 and scan_scale is not None:
        return int8_scored_ip(q, rows, scan_scale)
    y = rows.to(torch.float32)
    if scan_dtype == "bfloat16":
        q = q.to(torch.bfloat16).to(torch.float32)
        y = y.to(torch.bfloat16).to(torch.float32)
    return sequential_dot(q, y)


def _scores(ip, q2, y2, ids, metric, passing=None):
    """ip [..., M, N], q2 [..., M, 1], y2 / ids / passing (the slots' pass
    bits, or None) [..., 1, N] → masked scores."""
    if metric == "inner_product":
        s = -ip
    elif metric == "cosine":
        qn_inv = torch.rsqrt(torch.clamp(q2, min=1e-24))
        vn_inv = torch.rsqrt(torch.clamp(y2, min=1e-24))
        s = 1.0 - ip * qn_inv * vn_inv
    else:
        s = y2 - 2.0 * ip + q2
    invalid = (ids < 0) | torch.isinf(q2)
    if passing is not None:
        invalid = invalid | ~passing
    return torch.where(invalid, torch.full_like(s, float("inf")), s)


def _finish(vals, ids):
    return vals, torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))


def _topk(sc, kk):
    """topk_by_position of the scores [..., N], padded with +inf to kk
    columns where N < kk (``_finish`` gives the pads id -1)."""
    v, pos = topk_by_position(sc, kk)
    short = kk - v.shape[-1]
    if short > 0:
        v = torch.nn.functional.pad(v, (0, short), value=float("inf"))
        pos = torch.nn.functional.pad(pos, (0, short))
    return v, pos


def ivf_scan_probe_major_torch(bucket_list, q_gathered, q2_gathered, list_data,
                               list_y2, list_index, kk: int, *,
                               metric: str = "sqeuclidean", scan_dtype: str = "highest",
                               scan_scale=1.0, list_filter=None):
    """Plain probe-major scan, buckets in chunks of bounded size; a
    ``PagedLists`` is read through its page table (``gather_lists``)."""
    B, G, d = q_gathered.shape
    cap = list_data.shape[1]
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, G * cap))
    vs, is_ = [], []
    for s in range(0, B, step):
        bl = bucket_list[s:s + step].long()
        ip = _ip(q_gathered[s:s + step].to(torch.float32), gather_lists(list_data, bl),
                 scan_dtype, scan_scale)                           # [b, G, cap]
        ids = list_index[bl][:, None, :]                           # [b, 1, cap]
        passing = None if list_filter is None else unpack_words(list_filter[bl], cap)[:, None]
        sc = _scores(ip, q2_gathered[s:s + step][:, :, None],
                     list_y2[bl][:, None, :], ids, metric, passing)
        v, pos = _topk(sc, kk)
        vs.append(v)
        is_.append(torch.gather(ids.expand_as(sc), -1, pos))
    return _finish(torch.cat(vs), torch.cat(is_).to(torch.int32))


def query_major_parts(P: int, splits: int) -> Tuple[int, int]:
    """(probes a part, parts) when each query's P probes are cut into
    ``splits`` contiguous parts, as the kernel's launcher cuts them."""
    chunk = -(-P // max(1, splits))
    return chunk, -(-P // chunk)


def merge_parts_torch(part_v: torch.Tensor, part_i: torch.Tensor, kk: int):
    """Plain version of the kernels' second pass (``csrc/topk.cuh``
    merge_parts): rows of parts [Q, parts * kk], each part a sorted top-kk
    of a contiguous piece of the row's pool, parts in pool order → the kk
    smallest by (value, part, position in the part), which is (value,
    position in the pool); a +inf entry never enters (id -1)."""
    v, pos = _topk(part_v, kk)
    return _finish(v, torch.gather(part_i, -1, pos))


def ivf_scan_query_major_torch(probes, q, q2, list_data, list_y2, list_index,
                               kk: int, *, metric: str = "sqeuclidean",
                               scan_dtype: str = "highest", scan_scale=1.0,
                               list_filter=None, query_fid=None):
    """Plain query-major scan, queries in chunks of bounded size; a
    ``PagedLists`` is read through its page table (``gather_lists``)."""
    Q, P = probes.shape
    cap = list_data.shape[1]
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, P * cap * list_data.shape[2]))
    vs, is_ = [], []
    for s in range(0, Q, step):
        pr = probes[s:s + step].long()
        b = pr.shape[0]
        rows = gather_lists(list_data, pr).reshape(b, P * cap, -1)
        ip = _ip(q[s:s + step, None, :].to(torch.float32), rows, scan_dtype, scan_scale)
        ids = list_index[pr].reshape(b, 1, P * cap)
        passing = None
        if list_filter is not None:
            words = (list_filter[pr] if query_fid is None
                     else list_filter[query_fid[s:s + step].long()[:, None], pr])
            passing = unpack_words(words, cap).reshape(b, 1, P * cap)
        sc = _scores(ip, q2[s:s + step, None, None],
                     list_y2[pr].reshape(b, 1, P * cap), ids, metric, passing)
        v, pos = _topk(sc, kk)
        vs.append(v[:, 0])
        is_.append(torch.gather(ids, -1, pos)[:, 0])
    return _finish(torch.cat(vs), torch.cat(is_).to(torch.int32))


def _launch(name, schedule, leg, tensors, args, out_shape, kk):
    """Count launch ``name`` and launch the C entry of ``schedule`` for
    ``leg``, the storage type (``rt_ivf_scan_<schedule>[_bf16|_int8|_u8|_s8]``:
    one entry serves a storage type's unfiltered, filter and paged legs)
    with the pointers of ``tensors``, then ``args`` (ints, the scale,
    filter, page-table and workspace pointers), outputs and stream."""
    _k.require_cuda(name, *tensors)
    dev = tensors[0].device
    out_v = torch.empty(out_shape + (kk,), dtype=torch.float32, device=dev)
    out_i = torch.empty(out_shape + (kk,), dtype=torch.int32, device=dev)
    lib = _k.library()
    _k.count_launch(name)
    code = getattr(lib, f"rt_ivf_scan_{schedule}{leg}")(
        *(t.data_ptr() for t in tensors), *args,
        out_v.data_ptr(), out_i.data_ptr(), _k.stream_of(tensors[0]),
    )
    _k.check(name, code)
    return out_v, out_i


def _check(metric, list_data, list_y2, list_index, kk, scan_dtype, scan_scale):
    if not scan_supported(metric, list_data, kk):
        raise ValueError(
            f"ivf scan kernel serves {sorted(map(str, _LEGS))} storage, kk<={MAX_KK} and "
            f"metrics {sorted(_METRICS)}; got {list_data.dtype}, kk={kk}, {metric!r} "
            "(raft_tpu's Pallas scans bound kk only by one (G, kk) f32 + int32 VMEM block)"
        )
    if scan_dtype not in SCAN_DTYPES:
        raise ValueError(f"scan_dtype {scan_dtype!r} not in {SCAN_DTYPES}")
    if storage_leg(list_data.dtype, scan_scale) in _RAW8:
        if scan_dtype == "bfloat16":
            raise ValueError("raw 8-bit rows are scanned in f32 (scan_dtype 'highest'), "
                             "as raft_tpu scans IVF-Flat's 8-bit lists")
    L, cap, _ = list_data.shape
    if list_y2.shape != (L, cap) or list_index.shape != (L, cap):
        raise ValueError("list_y2 / list_index must be [n_lists, cap]")
    if isinstance(list_data, PagedLists) and (
            list_data.page_slot.ndim != 1
            or list_data.page_slot.shape[0] != L * list_data.pages_per_list):
        raise ValueError(f"page table must be [n_lists * pages_per_list] = "
                         f"[{L * list_data.pages_per_list}], got {tuple(list_data.page_slot.shape)}")


def _work_kw(list_data, list_index, scan_dtype, scan_scale, cap_w):
    """Keyword arguments of the ``ops.cost`` scan work of a launch."""
    leg = storage_leg(list_data.dtype, scan_scale)
    compute = ("int8" if leg == "_int8" else
               "bfloat16" if scan_dtype == "bfloat16" else "float32")
    return dict(list_rows=(list_index >= 0).sum(dim=1),
                itemsize=torch.empty(0, dtype=list_data.dtype).element_size(),
                compute=compute, cap_w=cap_w)


def _leg_arg(list_data, scan_dtype, scan_scale):
    """The leg's own argument: scan_scale (as f32) for a scaled int8
    cache, else whether to compute in bf16."""
    if storage_leg(list_data.dtype, scan_scale) == "_int8":
        return float(scan_scale)
    return int(scan_dtype == "bfloat16")


def _filter_args(list_filter, query_fid, dev, n_lists, cap):
    """(words, fid, n_lists, cap_w) of the C entries, with null pointers
    for an unfiltered scan; the tensors are kept alive by the caller."""
    if list_filter is None:
        return (None, None, n_lists, 0)
    _k.require_cuda("ivf_scan filter", list_filter,
                    *(() if query_fid is None else (query_fid,)))
    if list_filter.device != dev:
        raise ValueError(f"list_filter on {list_filter.device}, lists on {dev}")
    fid = None if query_fid is None else query_fid.data_ptr()
    return (list_filter.data_ptr(), fid, n_lists, _n_words(cap))


def _rows_args(list_data, dev):
    """(the row tensor, (page_slot, page_rows) of the C entries): the lists
    themselves with a null table, or a ``PagedLists``' pool and table."""
    if not isinstance(list_data, PagedLists):
        return list_data.contiguous(), (None, 0)
    table = list_data.page_slot
    if table.dtype != torch.int32:
        raise ValueError(f"page table must be int32, got {table.dtype}")
    _k.require_cuda("ivf_scan page table", table)
    if table.device != dev:
        raise ValueError(f"page table on {table.device}, queries on {dev}")
    return list_data.pool, (table.data_ptr(), list_data.page_rows)


def ivf_scan_probe_major(
    bucket_list: torch.Tensor,   # [B] int32 — list id per bucket
    q_gathered: torch.Tensor,    # [B, G, d] f32 — the bucket's queries
    q2_gathered: torch.Tensor,   # [B, G] f32 — |q|^2, +inf at padding
    list_data,                   # [L, cap, d] f32 / bf16 / int8, or PagedLists
    list_y2: torch.Tensor,       # [L, cap] f32 (0 at padding slots)
    list_index: torch.Tensor,    # [L, cap] int32 (-1 at padding slots)
    kk: int,
    *,
    metric: str = "sqeuclidean",
    scan_dtype: str = "highest",
    scan_scale: Optional[float] = 1.0,   # int8 cache: the value of one step; None: raw rows
    list_filter: Optional[torch.Tensor] = None,   # [L, cap_w] int32 pass words
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket (vals [B, G, kk], ids [B, G, kk]) score partials, through
    ``csrc/ivf_scan.cu``; CPU tensors take the plain version."""
    _check(metric, list_data, list_y2, list_index, kk, scan_dtype, scan_scale)
    _check_filter(list_filter, None, list_index, 0)
    if list_data.device.type == "cpu":
        return ivf_scan_probe_major_torch(
            bucket_list, q_gathered, q2_gathered, list_data, list_y2,
            list_index, kk, metric=metric, scan_dtype=scan_dtype, scan_scale=scan_scale,
            list_filter=list_filter,
        )
    B, G, d = q_gathered.shape
    L, cap, _ = list_data.shape
    dev = q_gathered.device
    rows, pages = _rows_args(list_data, dev)
    tensors = [t.contiguous() for t in (
        bucket_list.to(torch.int32), q_gathered.to(torch.float32),
        q2_gathered.to(torch.float32), rows, list_y2.to(torch.float32),
        list_index.to(torch.int32),
    )]
    filt = None if list_filter is None else list_filter.contiguous()
    words, _, _, cap_w = _filter_args(filt, None, dev, L, cap)
    ws_shape = probe_major_workspace(B, G, kk)
    ws_v = torch.empty(ws_shape, dtype=torch.float32, device=dev)
    ws_i = torch.empty(ws_shape, dtype=torch.int32, device=dev)
    wide = ws_shape[-1] > 0
    name = kernel_name("probe_major", list_data, filt, scan_scale=scan_scale)
    _cost.note(name, lambda: _cost.scan_bucket_work(
        tensors[0], tensors[2], d=d, kk=kk,
        pages_per_list=list_data.pages_per_list if pages[0] is not None else 0,
        **_work_kw(list_data, list_index, scan_dtype, scan_scale, cap_w)))
    return _launch(
        name, "probe_major",
        storage_leg(list_data.dtype, scan_scale), tensors,
        (B, G, cap, d, kk, _METRICS[metric], _leg_arg(list_data, scan_dtype, scan_scale),
         words, cap_w, *pages, ws_v.data_ptr() if wide else None,
         ws_i.data_ptr() if wide else None, ws_shape[-1]),
        (B, G), kk,
    )


def ivf_scan_query_major(
    probes: torch.Tensor,        # [Q, P] int32 — probed list ids
    q: torch.Tensor,             # [Q, d] f32
    q2: torch.Tensor,            # [Q] f32 — |q|^2 (+inf marks padding)
    list_data,                   # [L, cap, d] f32 / bf16 / int8, or PagedLists
    list_y2: torch.Tensor,       # [L, cap] f32
    list_index: torch.Tensor,    # [L, cap] int32
    kk: int,
    *,
    metric: str = "sqeuclidean",
    scan_dtype: str = "highest",
    scan_scale: Optional[float] = 1.0,
    list_filter: Optional[torch.Tensor] = None,   # [L, cap_w], or [F, L, cap_w] with query_fid
    query_fid: Optional[torch.Tensor] = None,     # [Q] int32 — each query's plane
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals [Q, kk], ids [Q, kk]) score partials through
    ``csrc/ivf_scan.cu``; CPU tensors take the plain version.  A small
    batch's probes are cut into parts (:func:`query_major_parts`, one block
    each, merged after as :func:`merge_parts_torch` does) so that it fills
    the card."""
    _check(metric, list_data, list_y2, list_index, kk, scan_dtype, scan_scale)
    _check_filter(list_filter, query_fid, list_index, probes.shape[0])
    if list_data.device.type == "cpu":
        return ivf_scan_query_major_torch(
            probes, q, q2, list_data, list_y2, list_index, kk, metric=metric,
            scan_dtype=scan_dtype, scan_scale=scan_scale, list_filter=list_filter,
            query_fid=query_fid,
        )
    Q, P = probes.shape
    L, cap, d = list_data.shape
    dev = q.device
    rows, pages = _rows_args(list_data, dev)
    tensors = [t.contiguous() for t in (
        probes.to(torch.int32), q.to(torch.float32), q2.to(torch.float32),
        rows, list_y2.to(torch.float32), list_index.to(torch.int32),
    )]
    filt = None if list_filter is None else list_filter.contiguous()
    fid = None if query_fid is None else query_fid.to(torch.int32).contiguous()
    splits = query_major_parts(P, _k.grid_splits(Q, P, dev,
                                                 per_sm=QM_PER_SM))[1]
    part_shape = (Q, splits * kk) if splits > 1 else (0,)
    part_v = torch.empty(part_shape, dtype=torch.float32, device=dev)
    part_i = torch.empty(part_shape, dtype=torch.int32, device=dev)
    name = kernel_name("query_major", list_data, filt, fid, scan_scale)
    def work():
        kw = _work_kw(list_data, list_index, scan_dtype, scan_scale,
                      0 if filt is None else _n_words(cap))
        if pages[0] is None:
            return _cost.scan_work(tensors[0], kw.pop("list_rows"), d, Q, kk, query_fid=fid,
                                   **kw)
        return _cost.scan_paged_work(tensors[0], kw.pop("list_rows"), d, Q, kk, blocks=Q * P,
                                     pages_per_list=list_data.pages_per_list, query_fid=fid,
                                     **kw)

    _cost.note(name, work)
    return _launch(
        name, "query_major",
        storage_leg(list_data.dtype, scan_scale), tensors,
        (Q, P, cap, d, kk, _METRICS[metric], splits,
         _leg_arg(list_data, scan_dtype, scan_scale),
         *_filter_args(filt, fid, dev, L, cap), *pages, part_v.data_ptr(), part_i.data_ptr()),
        (Q,), kk,
    )
