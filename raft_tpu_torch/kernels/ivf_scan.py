"""IVF list scans, unfiltered: ``csrc/ivf_scan.cu`` and the plain versions
(counterpart of ``raft_tpu.kernels.ivf_scan``).

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
``_int8``):

- f32 / bf16 rows: with ``scan_dtype`` "float32" or "highest" the rows are
  upcast and every dot product is summed in f32; with "bfloat16" (ivf_pq's
  ``lut_dtype``) both operands are rounded to bf16 first;
- int8 rows (values int8 x ``scan_scale``): each query is quantized
  (``toolkit.quantize_queries_i8``), the int8 products summed exactly, and
  the sum rescaled by (query scale x ``scan_scale``).

Scores: L2 (y2 - 2 ip) + q2, inner product -ip, cosine
1 - ip * rsqrt(max(q2, 1e-24)) * rsqrt(max(y2, 1e-24)).  Invalid slots
(id < 0) and padding queries (q2 = +inf) score +inf; a +inf score comes out
with id -1.  Unlike the TPU kernel, query-major needs no multiple-of-8
query count and takes any (P, cap): it streams lists and holds no
per-query score scratch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch import kernels as _k
from raft_tpu_torch.kernels.toolkit import int8_scored_ip, sequential_dot, topk_by_position

MAX_KK = 128
_METRICS = {"sqeuclidean": 0, "euclidean": 0, "inner_product": 1, "cosine": 2}
#: storage dtype → suffix of its kernel's name
_LEGS = {torch.float32: "", torch.bfloat16: "_bf16", torch.int8: "_int8"}
#: "float32" and "highest" both compute in f32 (raft_tpu's names)
SCAN_DTYPES = ("float32", "highest", "bfloat16")
#: score elements the plain versions materialize per chunk
_PLAIN_CHUNK_ELEMS = 1 << 26


def scan_supported(metric: str, list_data: torch.Tensor, kk: int) -> bool:
    """Routing gate of both scan kernels: f32, bf16 or int8 storage, L2 /
    inner product / cosine, ``kk <= 128`` (unfiltered is the caller's
    condition)."""
    return list_data.dtype in _LEGS and metric in _METRICS and 0 < kk <= MAX_KK


def kernel_name(schedule: str, list_data: torch.Tensor) -> str:
    """The launch-count name of ``schedule``'s ("probe_major" /
    "query_major") kernel for ``list_data``'s storage type."""
    return f"ivf_scan_{schedule}{_LEGS[list_data.dtype]}"


def _ip(q: torch.Tensor, rows: torch.Tensor, scan_dtype: str, scan_scale: float):
    """q·y of f32 queries [..., M, d] against stored rows [..., N, d]: the
    leg of ``_score_against_list`` that ``rows``' type and ``scan_dtype``
    select."""
    if rows.dtype == torch.int8:
        return int8_scored_ip(q, rows, scan_scale)
    y = rows.to(torch.float32)
    if scan_dtype == "bfloat16":
        q = q.to(torch.bfloat16).to(torch.float32)
        y = y.to(torch.bfloat16).to(torch.float32)
    return sequential_dot(q, y)


def _scores(ip, q2, y2, ids, metric):
    """ip [..., M, N], q2 [..., M, 1], y2 / ids [..., 1, N] → masked scores."""
    if metric == "inner_product":
        s = -ip
    elif metric == "cosine":
        qn_inv = torch.rsqrt(torch.clamp(q2, min=1e-24))
        vn_inv = torch.rsqrt(torch.clamp(y2, min=1e-24))
        s = 1.0 - ip * qn_inv * vn_inv
    else:
        s = y2 - 2.0 * ip + q2
    invalid = (ids < 0) | torch.isinf(q2)
    return torch.where(invalid, torch.full_like(s, float("inf")), s)


def _finish(vals, ids):
    return vals, torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))


def ivf_scan_probe_major_torch(bucket_list, q_gathered, q2_gathered, list_data,
                               list_y2, list_index, kk: int, *,
                               metric: str = "sqeuclidean", scan_dtype: str = "highest",
                               scan_scale: float = 1.0):
    """Plain probe-major scan, buckets in chunks of bounded size."""
    B, G, d = q_gathered.shape
    cap = list_data.shape[1]
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, G * cap))
    vs, is_ = [], []
    for s in range(0, B, step):
        bl = bucket_list[s:s + step].long()
        ip = _ip(q_gathered[s:s + step].to(torch.float32), list_data[bl], scan_dtype,
                 scan_scale)                                       # [b, G, cap]
        ids = list_index[bl][:, None, :]                           # [b, 1, cap]
        sc = _scores(ip, q2_gathered[s:s + step][:, :, None],
                     list_y2[bl][:, None, :], ids, metric)
        v, pos = topk_by_position(sc, kk)
        vs.append(v)
        is_.append(torch.gather(ids.expand_as(sc), -1, pos))
    return _finish(torch.cat(vs), torch.cat(is_).to(torch.int32))


def ivf_scan_query_major_torch(probes, q, q2, list_data, list_y2, list_index,
                               kk: int, *, metric: str = "sqeuclidean",
                               scan_dtype: str = "highest", scan_scale: float = 1.0):
    """Plain query-major scan, queries in chunks of bounded size."""
    Q, P = probes.shape
    cap = list_data.shape[1]
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, P * cap * list_data.shape[2]))
    vs, is_ = [], []
    for s in range(0, Q, step):
        pr = probes[s:s + step].long()
        b = pr.shape[0]
        rows = list_data[pr].reshape(b, P * cap, -1)
        ip = _ip(q[s:s + step, None, :].to(torch.float32), rows, scan_dtype, scan_scale)
        ids = list_index[pr].reshape(b, 1, P * cap)
        sc = _scores(ip, q2[s:s + step, None, None],
                     list_y2[pr].reshape(b, 1, P * cap), ids, metric)
        v, pos = topk_by_position(sc, kk)
        vs.append(v[:, 0])
        is_.append(torch.gather(ids, -1, pos)[:, 0])
    return _finish(torch.cat(vs), torch.cat(is_).to(torch.int32))


def _launch(name, tensors, args, out_shape, kk):
    """Count and launch ``rt_<name>`` with the pointers of ``tensors``, then
    ``args`` (ints, the scale, scratch pointers), outputs and stream."""
    _k.require_cuda(name, *tensors)
    dev = tensors[0].device
    out_v = torch.empty(out_shape + (kk,), dtype=torch.float32, device=dev)
    out_i = torch.empty(out_shape + (kk,), dtype=torch.int32, device=dev)
    lib = _k.library()
    _k.count_launch(name)
    code = getattr(lib, "rt_" + name)(
        *(t.data_ptr() for t in tensors), *args,
        out_v.data_ptr(), out_i.data_ptr(), _k.stream_of(tensors[0]),
    )
    _k.check(name, code)
    return out_v, out_i


def _check(metric, list_data, list_y2, list_index, kk, scan_dtype):
    if not scan_supported(metric, list_data, kk):
        raise ValueError(
            f"ivf scan kernel serves {sorted(map(str, _LEGS))} storage, kk<=128 and "
            f"metrics {sorted(_METRICS)}; got {list_data.dtype}, kk={kk}, {metric!r}"
        )
    if scan_dtype not in SCAN_DTYPES:
        raise ValueError(f"scan_dtype {scan_dtype!r} not in {SCAN_DTYPES}")
    L, cap, _ = list_data.shape
    if list_y2.shape != (L, cap) or list_index.shape != (L, cap):
        raise ValueError("list_y2 / list_index must be [n_lists, cap]")


def _leg_arg(list_data, scan_dtype, scan_scale):
    """The leg's own argument: scan_scale (as f32) for int8 rows, else
    whether to compute in bf16."""
    if list_data.dtype == torch.int8:
        return float(scan_scale)
    return int(scan_dtype == "bfloat16")


def ivf_scan_probe_major(
    bucket_list: torch.Tensor,   # [B] int32 — list id per bucket
    q_gathered: torch.Tensor,    # [B, G, d] f32 — the bucket's queries
    q2_gathered: torch.Tensor,   # [B, G] f32 — |q|^2, +inf at padding
    list_data: torch.Tensor,     # [L, cap, d] f32 / bf16 / int8
    list_y2: torch.Tensor,       # [L, cap] f32 (0 at padding slots)
    list_index: torch.Tensor,    # [L, cap] int32 (-1 at padding slots)
    kk: int,
    *,
    metric: str = "sqeuclidean",
    scan_dtype: str = "highest",
    scan_scale: float = 1.0,     # int8 storage: the value of one step
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket (vals [B, G, kk], ids [B, G, kk]) score partials, through
    ``csrc/ivf_scan.cu``; CPU tensors take the plain version."""
    _check(metric, list_data, list_y2, list_index, kk, scan_dtype)
    if list_data.device.type == "cpu":
        return ivf_scan_probe_major_torch(
            bucket_list, q_gathered, q2_gathered, list_data, list_y2,
            list_index, kk, metric=metric, scan_dtype=scan_dtype, scan_scale=scan_scale,
        )
    B, G, d = q_gathered.shape
    L, cap, _ = list_data.shape
    tensors = [t.contiguous() for t in (
        bucket_list.to(torch.int32), q_gathered.to(torch.float32),
        q2_gathered.to(torch.float32), list_data, list_y2.to(torch.float32),
        list_index.to(torch.int32),
    )]
    return _launch(
        kernel_name("probe_major", list_data), tensors,
        (B, G, cap, d, kk, _METRICS[metric], _leg_arg(list_data, scan_dtype, scan_scale)),
        (B, G), kk,
    )


def ivf_scan_query_major(
    probes: torch.Tensor,        # [Q, P] int32 — probed list ids
    q: torch.Tensor,             # [Q, d] f32
    q2: torch.Tensor,            # [Q] f32 — |q|^2 (+inf marks padding)
    list_data: torch.Tensor,     # [L, cap, d] f32 / bf16 / int8
    list_y2: torch.Tensor,       # [L, cap] f32
    list_index: torch.Tensor,    # [L, cap] int32
    kk: int,
    *,
    metric: str = "sqeuclidean",
    scan_dtype: str = "highest",
    scan_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals [Q, kk], ids [Q, kk]) score partials through
    ``csrc/ivf_scan.cu``; CPU tensors take the plain version."""
    _check(metric, list_data, list_y2, list_index, kk, scan_dtype)
    if list_data.device.type == "cpu":
        return ivf_scan_query_major_torch(
            probes, q, q2, list_data, list_y2, list_index, kk, metric=metric,
            scan_dtype=scan_dtype, scan_scale=scan_scale,
        )
    Q, P = probes.shape
    L, cap, d = list_data.shape
    tensors = [t.contiguous() for t in (
        probes.to(torch.int32), q.to(torch.float32), q2.to(torch.float32),
        list_data, list_y2.to(torch.float32), list_index.to(torch.int32),
    )]
    dev = tensors[0].device
    splits = _k.grid_splits(Q, P, dev)
    part_shape = (Q, splits * kk) if splits > 1 else (0,)
    part_v = torch.empty(part_shape, dtype=torch.float32, device=dev)
    part_i = torch.empty(part_shape, dtype=torch.int32, device=dev)
    return _launch(
        kernel_name("query_major", list_data), tensors,
        (Q, P, cap, d, kk, _METRICS[metric], splits,
         _leg_arg(list_data, scan_dtype, scan_scale), part_v.data_ptr(), part_i.data_ptr()),
        (Q,), kk,
    )
