"""Fused brute-force kNN: ``csrc/fused_knn.cu`` and its plain version
(counterpart of ``raft_tpu.kernels.fused_knn``).

Scores are partial: ``l2`` gives |x|^2 - 2 q.x (add |q|^2 for the true
squared distance), ``ip`` gives -q.x.  Each query keeps the k smallest by
(score, dataset column), ascending; the lowest column wins a tie.  The
kernel appends the candidates below each query's threshold to arrays in
device memory that a radix select compacts (``csrc/fused_knn.cu``), and
gives the plain version's result bitwise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch import kernels as _k
from raft_tpu_torch.kernels.toolkit import cdiv, sequential_dot, topk_by_position
from raft_tpu_torch.ops import cost as _cost

#: deepest k; raft_tpu's Pallas kernel bounds k only by its VMEM blocks
MAX_K = 2048
#: queries per block of the kernel (csrc/tile_gemm.cuh kBM)
_TILE_Q = 64
#: fewest dataset rows one block's part may hold when a small batch is
#: split over more blocks
_MIN_PART_ROWS = 512
#: blocks an SM holds at once (the kernel's registers allow two)
_BLOCKS_PER_SM = 2


def _check(queries, dataset, dataset_sqnorms, k, mode):
    if mode not in ("l2", "ip"):
        raise ValueError(f"mode must be 'l2' or 'ip', got {mode!r}")
    if queries.ndim != 2 or dataset.ndim != 2 or queries.shape[1] != dataset.shape[1]:
        raise ValueError(
            f"queries {tuple(queries.shape)} and dataset {tuple(dataset.shape)} "
            "must be [*, d] with one d"
        )
    if dataset_sqnorms.shape != (dataset.shape[0],):
        raise ValueError(f"dataset_sqnorms must be [{dataset.shape[0]}]")
    if not 0 < k <= dataset.shape[0]:
        raise ValueError(f"k={k} must be in [1, {dataset.shape[0]}]")


def fused_l2_topk_torch(
    queries: torch.Tensor,
    dataset: torch.Tensor,
    dataset_sqnorms: torch.Tensor,
    k: int,
    *,
    mode: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the full [n_q, n] score matrix, then a stable sort."""
    _check(queries, dataset, dataset_sqnorms, k, mode)
    ip = sequential_dot(queries.to(torch.float32), dataset.to(torch.float32))
    if mode == "ip":
        scores = -ip
    else:
        scores = dataset_sqnorms.to(torch.float32)[None, :] - 2.0 * ip
    vals, pos = topk_by_position(scores, k)
    return vals, pos.to(torch.int32)


def fused_l2_topk(
    queries: torch.Tensor,
    dataset: torch.Tensor,
    dataset_sqnorms: torch.Tensor,
    k: int,
    *,
    mode: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (partial scores [n_q, k] f32, columns [n_q, k] int32),
    ascending, through ``csrc/fused_knn.cu``; CPU tensors take
    :func:`fused_l2_topk_torch`."""
    _check(queries, dataset, dataset_sqnorms, k, mode)
    if k > MAX_K:
        raise ValueError(f"fused_l2_topk serves k<={MAX_K}, got {k} (raft_tpu's Pallas kernel: "
                         "one (query tile, k) f32 + int32 VMEM block)")
    if queries.device.type == "cpu":
        return fused_l2_topk_torch(queries, dataset, dataset_sqnorms, k, mode=mode)
    q = queries.to(torch.float32).contiguous()
    x = dataset.to(torch.float32).contiguous()
    xx = dataset_sqnorms.to(torch.float32).contiguous()
    _k.require_cuda("fused_knn", q, x, xx)
    n_q, d = q.shape
    n = x.shape[0]
    splits = _k.wave_splits(cdiv(n_q, _TILE_Q), max(1, n // max(_MIN_PART_ROWS, k)),
                            _BLOCKS_PER_SM * _k.sm_count(q.device.index or 0))
    # one candidate array of `cap` slots per (query, part): k kept, and room
    # for a few tiles between compactions
    cap = max(2 * k, k + 256)
    out_v = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    part_v = torch.empty((n_q, splits, cap), dtype=torch.float32, device=q.device)
    part_i = torch.empty((n_q, splits, cap), dtype=torch.int32, device=q.device)
    counts = torch.empty((n_q, splits), dtype=torch.int32, device=q.device)
    lib = _k.library()
    _cost.note("fused_knn", lambda: _cost.fused_knn_work(n_q, n, d, k))
    _k.count_launch("fused_knn")
    code = lib.rt_fused_knn(
        q.data_ptr(), x.data_ptr(), xx.data_ptr(), n_q, n, d, k, int(mode == "ip"), splits, cap,
        part_v.data_ptr(), part_i.data_ptr(), counts.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), _k.stream_of(q),
    )
    _k.check("fused_knn", code)
    return out_v, out_i
