"""Sparse linear algebra (counterpart of ``raft_tpu.sparse.linalg``): spmm,
sddmm, masked matmul, transpose, symmetrize, Laplacian, degree, norms.

raft_tpu's gather + ``segment_sum`` programs become gathers plus
``kernels.csr_spmm`` for every sum lane: the kernel adds each row's terms
in slot order, the order raft_tpu's segment sum adds them, and gives one
result on the card run after run (atomic scatter-adds do not).  Max / min
lanes and integer counts are exact in any order and stay plain scatters.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.kernels import csr_spmm as _csr
from raft_tpu_torch.sparse.formats import COO, CSR, coo_order


def _ones(n: int, device) -> torch.Tensor:
    return torch.ones((n, 1), dtype=torch.float32, device=device)


def spmm(csr: CSR, b: torch.Tensor) -> torch.Tensor:
    """CSR x dense -> dense [n_rows, cols]: out[r] = sum of data[s] *
    b[indices[s]] over the row's slots, in slot order (``csr_spmm``)."""
    b = torch.as_tensor(b).to(device=csr.device, dtype=torch.float32).contiguous()
    data = csr.data.to(torch.float32).contiguous()
    return _csr.csr_spmm(csr.indptr.contiguous(), csr.indices.contiguous(), data, b)


def spmv(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    x = torch.as_tensor(x).to(device=csr.device)
    return spmm(csr, x[:, None])[:, 0]


def sddmm(csr: CSR, a: torch.Tensor, b: torch.Tensor, *, alpha=1.0, beta=0.0) -> CSR:
    """Sampled dense-dense product: out_data[e] = alpha (A[row e] . B[col e])
    + beta data[e]; b is [n_cols, d]."""
    rows = torch.clamp(csr.row_ids(), 0, csr.shape[0] - 1).long()
    av = a[rows]
    bv = b[csr.indices.long()]
    vals = alpha * torch.sum(av * bv, dim=1) + beta * csr.data
    vals = torch.where(csr.valid, vals, torch.zeros_like(vals))
    return CSR(csr.indptr, csr.indices, vals, csr.shape, csr.nnz)


def masked_matmul(mask: COO, a: torch.Tensor, b: torch.Tensor) -> COO:
    """A . B^T evaluated only at the mask's positions."""
    r = torch.clamp(mask.rows.long(), 0, a.shape[0] - 1)
    c = torch.clamp(mask.cols.long(), 0, b.shape[0] - 1)
    vals = torch.sum(a[r] * b[c], dim=1)
    vals = torch.where(mask.valid, vals, torch.zeros_like(vals))
    return COO(mask.rows, mask.cols, vals, mask.shape, mask.nnz)


def transpose(csr: CSR) -> CSR:
    """CSR^T by a stable sort by column."""
    coo_rows = csr.row_ids()
    n_rows, n_cols = csr.shape
    v = csr.valid
    order = coo_order(csr.indices, torch.where(v, coo_rows, torch.zeros_like(coo_rows)), v,
                      n_cols)
    new_cols = torch.where(v[order], coo_rows[order], torch.zeros_like(coo_rows))
    counts = torch.bincount(csr.indices[v].long(), minlength=n_cols)[:n_cols]
    indptr = torch.zeros(n_cols + 1, dtype=torch.int32, device=csr.device)
    indptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    data = torch.where(v[order], csr.data[order], torch.zeros_like(csr.data))
    return CSR(indptr, new_cols, data, (n_cols, n_rows), csr.nnz)


def symmetrize(coo: COO, *, op: str = "max") -> COO:
    """A and A^T combined with max / min / add / mean at each (i, j):
    twice the slots (the live ones to a prefix), then the shared duplicate
    reduction of ``sparse.op`` (host-synced for the new nnz)."""
    from raft_tpu_torch.sparse.op import _reduce_duplicates

    if coo.shape[0] != coo.shape[1]:
        raise ValueError("symmetrize needs a square matrix")
    rows = torch.cat([coo.rows, coo.cols])
    cols = torch.cat([coo.cols, coo.rows])
    data = torch.cat([coo.data, coo.data])
    live = torch.cat([coo.valid, coo.valid])
    order = torch.argsort((~live).to(torch.int8), stable=True)
    both = COO(rows[order], cols[order], data[order], coo.shape, 2 * coo.nnz)
    return _reduce_duplicates(both, op)


def laplacian(adj: COO, *, normalized: bool = False) -> COO:
    """L = D - A, or I - D^-1/2 A D^-1/2 (normalized), as a COO: the
    adjacency's slots, then one diagonal slot per row."""
    n = adj.shape[0]
    if adj.shape[0] != adj.shape[1]:
        raise ValueError("laplacian needs a square matrix")
    deg_w = weighted_degree(adj)
    diag_r = torch.arange(n, dtype=torch.int32, device=adj.device)
    if normalized:
        inv_sqrt = torch.where(deg_w > 0, 1.0 / torch.sqrt(torch.clamp(deg_w, min=1e-30)),
                               torch.zeros_like(deg_w))
        r = torch.clamp(adj.rows.long(), 0, n - 1)
        c = torch.clamp(adj.cols.long(), 0, n - 1)
        off = -adj.data * inv_sqrt[r] * inv_sqrt[c]
        diag_v = torch.where(deg_w > 0, torch.ones_like(deg_w), torch.zeros_like(deg_w))
    else:
        off = -adj.data
        diag_v = deg_w
    rows = torch.cat([adj.rows, diag_r])
    cols = torch.cat([adj.cols, diag_r])
    data = torch.cat([torch.where(adj.valid, off, torch.zeros_like(off)), diag_v.to(off.dtype)])
    live = torch.cat([adj.valid, torch.ones(n, dtype=torch.bool, device=adj.device)])
    order = torch.argsort((~live).to(torch.int8), stable=True)
    return COO(rows[order], cols[order], data[order], adj.shape, adj.nnz + n)


def spmv_coo(coo: COO, x: torch.Tensor) -> torch.Tensor:
    """COO matrix-vector product: each row's live slots summed in slot
    order (``csr_spmm`` over the container's cached ``row_view``)."""
    indptr, cols, data = coo.row_view()
    x = torch.as_tensor(x).to(device=coo.device, dtype=torch.float32).contiguous()
    return _csr.csr_spmm(indptr, cols, data, x[:, None])[:, 0]


def degree(coo: COO) -> torch.Tensor:
    """Per-row count of live entries (int32)."""
    n = coo.shape[0]
    return torch.bincount(coo.rows[coo.valid].long(), minlength=n)[:n].to(torch.int32)


def weighted_degree(coo: COO) -> torch.Tensor:
    """Per-row sum of edge weights in slot order (the d vector of spectral
    methods): ``spmv_coo`` against ones (a product by 1.0 is exact)."""
    return spmv_coo(coo, torch.ones(coo.shape[1], device=coo.device)).to(coo.data.dtype)


def row_norm_csr(csr: CSR, *, norm_type: str = "l2") -> torch.Tensor:
    """Per-row l1 / l2 (squared: the sum of squares, as raft_tpu) / linf
    norms."""
    v = csr.data.to(torch.float32)
    if norm_type == "linf":
        rows = csr.row_ids().long()
        m = torch.full((csr.shape[0] + 1,), float("-inf"), device=csr.device)
        m = m.scatter_reduce(0, rows, torch.where(csr.valid, v.abs(),
                                                  torch.full_like(v, float("-inf"))),
                             "amax", include_self=True)[:-1]
        return torch.clamp(m, min=0.0)
    if norm_type == "l1":
        v = v.abs()
    elif norm_type == "l2":
        v = v * v
    else:
        raise ValueError(f"unknown norm {norm_type}")
    return _csr.row_sums(csr.indptr, v)
