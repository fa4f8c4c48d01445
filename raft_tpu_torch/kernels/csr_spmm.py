"""Deterministic CSR x dense product: ``csrc/csr_spmm.cu`` and its plain
version.

``out[r, c] = sum over the slots s of row r, in slot order, of
data[s] * x[indices[s], c]``: each product rounds once, then joins the
running sum (which starts at +0.0), as raft_tpu's ``segment_sum`` of
``data * x[cols]`` adds a segment on the CPU.  It replaces no TPU kernel:
raft_tpu leaves these sums to XLA.  The port routes every sum lane of
``sparse`` (``spmm`` / ``spmv``, ``spmv_coo``, ``weighted_degree``,
``row_norm_csr``, the add / mean lane of duplicate reduction, densify with
repeated slots, the sparse row statistics) and ``ops.linalg``'s keyed row
sums through it, so one input gives one result on every run.
"""

from __future__ import annotations

import torch

from raft_tpu_torch import kernels as _k
from raft_tpu_torch.ops import cost as _cost

#: slots a window (and a round) of the one-column kernel (csrc/csr_spmm.cu kChunk)
WINDOW_SLOTS = 1024


def _check(indptr, indices, data, x):
    if indptr.ndim != 1 or indptr.numel() < 1 or indices.ndim != 1 or data.ndim != 1:
        raise ValueError("csr_spmm: indptr, indices and data must be 1-D (indptr [n + 1])")
    if x.ndim != 2:
        raise ValueError(f"csr_spmm: x must be [rows, cols], got {tuple(x.shape)}")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise ValueError("csr_spmm: indptr and indices must be int32")
    if data.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError("csr_spmm: data and x must be float32")
    if indices.shape[0] != data.shape[0]:
        raise ValueError("csr_spmm: indices and data must have one length")


def csr_spmm_torch(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain version: step j adds the j-th slot's product of every row
    that has one (rows taken in descending degree, so each step is a
    prefix), the kernel's order and rounding."""
    _check(indptr, indices, data, x)
    n, c = indptr.shape[0] - 1, x.shape[1]
    out = torch.zeros((n, c), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    deg = (indptr[1:] - indptr[:-1]).long()
    max_deg = int(deg.max())
    if max_deg == 0:
        return out
    order = torch.argsort(deg, descending=True, stable=True)
    start = indptr[:-1].long()[order]
    # active[j]: rows with more than j slots
    hist = torch.bincount(deg, minlength=max_deg + 1)
    active = (n - torch.cumsum(hist, 0)).tolist()
    acc = torch.zeros((n, c), dtype=torch.float32, device=x.device)
    for j in range(max_deg):
        a = active[j]
        s = start[:a] + j
        acc[:a] = acc[:a] + data[s][:, None] * x[indices[s].long()]
    out[order] = acc
    return out


def csr_spmm(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """[n_rows, cols] f32 sums through ``csrc/csr_spmm.cu`` (stamps
    ``kernel_path`` "cuda"); CPU tensors take :func:`csr_spmm_torch`
    ("torch").  ``indices`` must lie within x's rows (callers
    build them so; the kernel does not check).  One column: a block takes
    the rows that start in a window of 1,024 slots, one thread summing each
    row from the block's shared products; a row of more than 1,024 slots
    gets a block of its own, in the first wave.  More columns: a warp a
    (row, 32 columns), a lane a column; rows of more than 256 slots stream
    through a cp.async ring, a block a (row, 128 columns), first."""
    _check(indptr, indices, data, x)
    if x.device.type == "cpu":
        _k.stamp_kernel_path("torch")
        return csr_spmm_torch(indptr, indices, data, x)
    _k.require_cuda("csr_spmm", indptr, indices, data, x)
    _k.stamp_kernel_path("cuda")
    n, c = indptr.shape[0] - 1, x.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n == 0 or c == 0:
        return out.zero_()
    _cost.note("csr_spmm", lambda: _cost.csr_spmm_work(n, int(indptr[-1]), x.shape[0], c))
    lib = _k.library()
    # the plan the card builds from indptr (csrc/csr_spmm.cu): each window's
    # rows, then the long rows and their counts
    cap = indices.shape[0]
    plan = torch.empty(4 * (cap // WINDOW_SLOTS + 1) + 4 if c == 1 else n + 2,
                       dtype=torch.int32, device=x.device)
    _k.count_launch("csr_spmm")
    code = lib.rt_csr_spmm(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
                           x.data_ptr(), n, c, cap, plan.data_ptr(), out.data_ptr(),
                           _k.stream_of(x))
    _k.check("csr_spmm", code)
    return out


def row_sums(indptr: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[n] sums of consecutive groups of ``values`` (group r: slots
    indptr[r] .. indptr[r + 1]), each in slot order: :func:`csr_spmm`
    against a column of ones (a product by 1.0 is exact)."""
    zeros = torch.zeros(values.shape[0], dtype=torch.int32, device=values.device)
    ones = torch.ones((1, 1), dtype=torch.float32, device=values.device)
    return csr_spmm(indptr.to(torch.int32).contiguous(), zeros,
                    values.to(torch.float32).contiguous(), ones)[:, 0]
