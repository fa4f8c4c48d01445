"""IVF list scans, f32 storage, unfiltered: ``csrc/ivf_scan.cu`` and the
plain versions (counterpart of ``raft_tpu.kernels.ivf_scan``).

Payload-agnostic like raft_tpu's: ivf_flat feeds raw rows and their
squared norms (zeroed at padding slots; the kernels mask by ``ids < 0``).

- probe-major: per bucket (one list, G queries), each query's top-kk by
  (score, slot);
- query-major: per query, the top-kk over its P probed lists by
  (score, p * cap + slot).

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
from raft_tpu_torch.kernels.toolkit import sequential_dot, topk_by_position

MAX_KK = 128
_METRICS = {"sqeuclidean": 0, "euclidean": 0, "inner_product": 1, "cosine": 2}
#: score elements the plain versions materialize per chunk
_PLAIN_CHUNK_ELEMS = 1 << 26


def scan_supported(metric: str, list_data: torch.Tensor, kk: int) -> bool:
    """Routing gate of both scan kernels: f32 storage, L2 / inner product /
    cosine, ``kk <= 128`` (unfiltered is the caller's condition)."""
    return list_data.dtype == torch.float32 and metric in _METRICS and 0 < kk <= MAX_KK


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
                               metric: str = "sqeuclidean"):
    """Plain probe-major scan, buckets in chunks of bounded size."""
    B, G, d = q_gathered.shape
    cap = list_data.shape[1]
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, G * cap))
    vs, is_ = [], []
    for s in range(0, B, step):
        bl = bucket_list[s:s + step].long()
        rows = list_data[bl].to(torch.float32)                     # [b, cap, d]
        ip = sequential_dot(q_gathered[s:s + step].to(torch.float32), rows)
        ids = list_index[bl][:, None, :]                           # [b, 1, cap]
        sc = _scores(ip, q2_gathered[s:s + step][:, :, None],
                     list_y2[bl][:, None, :], ids, metric)
        v, pos = topk_by_position(sc, kk)
        vs.append(v)
        is_.append(torch.gather(ids.expand_as(sc), -1, pos))
    return _finish(torch.cat(vs), torch.cat(is_).to(torch.int32))


def ivf_scan_query_major_torch(probes, q, q2, list_data, list_y2, list_index,
                               kk: int, *, metric: str = "sqeuclidean"):
    """Plain query-major scan, queries in chunks of bounded size."""
    Q, P = probes.shape
    cap = list_data.shape[1]
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, P * cap * list_data.shape[2]))
    vs, is_ = [], []
    for s in range(0, Q, step):
        pr = probes[s:s + step].long()
        b = pr.shape[0]
        rows = list_data[pr].to(torch.float32).reshape(b, P * cap, -1)
        ip = sequential_dot(q[s:s + step, None, :].to(torch.float32), rows)
        ids = list_index[pr].reshape(b, 1, P * cap)
        sc = _scores(ip, q2[s:s + step, None, None],
                     list_y2[pr].reshape(b, 1, P * cap), ids, metric)
        v, pos = topk_by_position(sc, kk)
        vs.append(v[:, 0])
        is_.append(torch.gather(ids, -1, pos)[:, 0])
    return _finish(torch.cat(vs), torch.cat(is_).to(torch.int32))


def _launch(name, fn, ints, tensors, out_shape, kk, extra_ptrs=()):
    _k.require_cuda(name, *tensors)
    dev = tensors[0].device
    out_v = torch.empty(out_shape + (kk,), dtype=torch.float32, device=dev)
    out_i = torch.empty(out_shape + (kk,), dtype=torch.int32, device=dev)
    lib = _k.library()
    _k.count_launch(name)
    code = getattr(lib, fn)(
        *(t.data_ptr() for t in tensors), *ints, *(t.data_ptr() for t in extra_ptrs),
        out_v.data_ptr(), out_i.data_ptr(), _k.stream_of(tensors[0]),
    )
    _k.check(name, code)
    return out_v, out_i


def _check(metric, list_data, list_y2, list_index, kk):
    if not scan_supported(metric, list_data, kk):
        raise ValueError(
            f"ivf scan kernel serves f32 storage, kk<=128 and metrics "
            f"{sorted(_METRICS)}; got {list_data.dtype}, kk={kk}, {metric!r}"
        )
    L, cap, _ = list_data.shape
    if list_y2.shape != (L, cap) or list_index.shape != (L, cap):
        raise ValueError("list_y2 / list_index must be [n_lists, cap]")


def ivf_scan_probe_major(
    bucket_list: torch.Tensor,   # [B] int32 — list id per bucket
    q_gathered: torch.Tensor,    # [B, G, d] f32 — the bucket's queries
    q2_gathered: torch.Tensor,   # [B, G] f32 — |q|^2, +inf at padding
    list_data: torch.Tensor,     # [L, cap, d] f32
    list_y2: torch.Tensor,       # [L, cap] f32 (0 at padding slots)
    list_index: torch.Tensor,    # [L, cap] int32 (-1 at padding slots)
    kk: int,
    *,
    metric: str = "sqeuclidean",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket (vals [B, G, kk], ids [B, G, kk]) score partials, through
    ``csrc/ivf_scan.cu``; CPU tensors take the plain version."""
    _check(metric, list_data, list_y2, list_index, kk)
    if list_data.device.type == "cpu":
        return ivf_scan_probe_major_torch(
            bucket_list, q_gathered, q2_gathered, list_data, list_y2,
            list_index, kk, metric=metric,
        )
    B, G, d = q_gathered.shape
    L, cap, _ = list_data.shape
    tensors = [t.contiguous() for t in (
        bucket_list.to(torch.int32), q_gathered.to(torch.float32),
        q2_gathered.to(torch.float32), list_data, list_y2.to(torch.float32),
        list_index.to(torch.int32),
    )]
    return _launch(
        "ivf_scan_probe_major", "rt_ivf_scan_probe_major",
        (B, G, cap, d, kk, _METRICS[metric]), tensors, (B, G), kk,
    )


def ivf_scan_query_major(
    probes: torch.Tensor,        # [Q, P] int32 — probed list ids
    q: torch.Tensor,             # [Q, d] f32
    q2: torch.Tensor,            # [Q] f32 — |q|^2 (+inf marks padding)
    list_data: torch.Tensor,     # [L, cap, d] f32
    list_y2: torch.Tensor,       # [L, cap] f32
    list_index: torch.Tensor,    # [L, cap] int32
    kk: int,
    *,
    metric: str = "sqeuclidean",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals [Q, kk], ids [Q, kk]) score partials through
    ``csrc/ivf_scan.cu``; CPU tensors take the plain version."""
    _check(metric, list_data, list_y2, list_index, kk)
    if list_data.device.type == "cpu":
        return ivf_scan_query_major_torch(
            probes, q, q2, list_data, list_y2, list_index, kk, metric=metric,
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
    parts = (torch.empty(part_shape, dtype=torch.float32, device=dev),
             torch.empty(part_shape, dtype=torch.int32, device=dev))
    return _launch(
        "ivf_scan_query_major", "rt_ivf_scan_query_major",
        (Q, P, cap, d, kk, _METRICS[metric], splits), tensors, (Q,), kk, parts,
    )
