"""Sparse structure ops: sort, dedupe, filter, row slicing, per-row top-k
(counterpart of ``raft_tpu.sparse.op``)."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.kernels import csr_spmm as _csr
from raft_tpu_torch.sparse.formats import COO, CSR, coo_order


def sort_coo(coo: COO) -> COO:
    """Row-major sort."""
    return coo.sorted_by_row()


def max_duplicates(coo: COO) -> COO:
    """Coincident (i, j) entries reduced to their max, compacted."""
    return _reduce_duplicates(coo, "max")


def sum_duplicates(coo: COO) -> COO:
    return _reduce_duplicates(coo, "add")


def _compact(coo: COO, keep: torch.Tensor, rows, cols, data) -> COO:
    """The kept slots moved to a prefix (stable), padding after them."""
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    nnz = int(keep.sum())
    n = coo.shape[0]
    return COO(
        torch.where(keep, rows, torch.full_like(rows, n))[order],
        torch.where(keep, cols, torch.zeros_like(cols))[order],
        torch.where(keep, data, torch.zeros_like(data))[order],
        coo.shape,
        nnz,
    )


def _reduce_duplicates(coo: COO, op: str) -> COO:
    """Row-major sort, coincident (i, j) groups reduced with ``op``
    (add / mean / max / min), compacted; syncs the host for the new nnz.
    The add / mean lanes sum each group in slot order
    (``kernels.csr_spmm.row_sums``), as raft_tpu's ``segment_sum``."""
    if op not in ("add", "mean", "max", "min"):
        raise ValueError(f"unknown reduce op {op}")
    n = coo.shape[0]
    order = coo_order(coo.rows, coo.cols, coo.valid, n)
    rows, cols, data, valid = (
        coo.rows[order], coo.cols[order], coo.data[order], coo.valid[order]
    )
    first = torch.ones_like(valid)
    first[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1]) | ~valid[1:]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    m = rows.shape[0]
    if op in ("add", "mean"):
        starts = torch.nonzero(first).squeeze(1)
        indptr = torch.cat([starts, torch.tensor([m], device=starts.device)])
        agg = _csr.row_sums(indptr, torch.where(valid, data, torch.zeros_like(data)))
        agg = agg.to(data.dtype)
        if op == "mean":
            cnt = torch.bincount(seg[valid], minlength=agg.shape[0])[:agg.shape[0]]
            agg = agg / torch.clamp(cnt.to(agg.dtype), min=1.0)
    else:
        fill = float("-inf") if op == "max" else float("inf")
        g = int(seg[-1]) + 1 if m else 0
        agg = torch.full((g,), fill, dtype=data.dtype, device=data.device)
        agg = agg.scatter_reduce(0, seg, torch.where(valid, data, torch.full_like(data, fill)),
                                 "amax" if op == "max" else "amin", include_self=True)
    keep = first & valid
    return _compact(coo, keep, rows, cols, agg[seg])


def filter_values(coo: COO, *, threshold: float) -> COO:
    """Entries with |value| <= threshold dropped; capacity kept."""
    keep = coo.valid & (coo.data.abs() > threshold)
    return _compact(coo, keep, coo.rows, coo.cols, coo.data)


def filter_degree(coo: COO, *, min_degree: int) -> COO:
    """Every entry of a row with fewer than ``min_degree`` entries dropped."""
    n = coo.shape[0]
    v = coo.valid
    deg = torch.bincount(coo.rows[v].long(), minlength=n)[:n]
    keep = v & (deg[torch.clamp(coo.rows.long(), 0, n - 1)] >= min_degree)
    return _compact(coo, keep, coo.rows, coo.cols, coo.data)


def slice_rows(csr: CSR, start: int, stop: int) -> CSR:
    """Rows [start, stop) as a compacted CSR (capacity changes)."""
    lo, hi = int(csr.indptr[start]), int(csr.indptr[stop])
    new_ptr = csr.indptr[start:stop + 1] - lo
    return CSR(new_ptr, csr.indices[lo:hi], csr.data[lo:hi], (stop - start, csr.shape[1]))


def row_op(csr: CSR, fn) -> CSR:
    """``fn(row_ids [cap], data [cap]) -> [cap]`` applied per slot;
    padding slots stay 0."""
    rows = csr.row_ids()
    out = fn(rows, csr.data)
    data = torch.where(csr.valid, out, torch.zeros_like(out))
    return CSR(csr.indptr, csr.indices, data, csr.shape, csr.nnz)


def select_k(csr: CSR, k: int, *, select_min: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of the stored values: (values [n_rows, k] f32,
    col ids [n_rows, k] int32); rows with fewer than k entries pad with
    +-inf / -1.  Two stable sorts (by value, then by row) rank the slots
    of each row, as raft_tpu's; a tie keeps slot order."""
    n_rows = csr.shape[0]
    rows = csr.row_ids()
    worst = float("inf") if select_min else float("-inf")
    vals = torch.where(csr.valid, csr.data.to(torch.float32),
                       torch.full((csr.cap,), worst, device=csr.device))
    key_vals = vals if select_min else -vals
    order1 = torch.argsort(key_vals, stable=True)
    order2 = torch.argsort(rows[order1], stable=True)
    order = order1[order2]
    sorted_rows = rows[order].long()
    pos = torch.arange(csr.cap, device=csr.device)
    rank = pos - csr.indptr.long()[torch.clamp(sorted_rows, 0, n_rows)]
    keep = (sorted_rows < n_rows) & (rank < k)
    out_v = torch.full((n_rows, k), worst, dtype=torch.float32, device=csr.device)
    out_i = torch.full((n_rows, k), -1, dtype=torch.int32, device=csr.device)
    r, c = sorted_rows[keep], rank[keep]
    out_v[r, c] = vals[order][keep]
    out_i[r, c] = csr.indices[order][keep]
    return out_v, out_i
