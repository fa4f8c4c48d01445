"""Format conversions (counterpart of ``raft_tpu.sparse.convert``)."""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.formats import COO, CSR


def coo_to_csr(coo: COO) -> CSR:
    """COO -> CSR by a row-major sort (stable: (row, col), then slot)."""
    s = coo.sorted_by_row()
    n_rows = coo.shape[0]
    v = s.valid
    counts = torch.bincount(s.rows[v].long(), minlength=n_rows)[:n_rows]
    indptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=coo.device)
    indptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return CSR(indptr, s.cols, torch.where(v, s.data, torch.zeros_like(s.data)), coo.shape,
               coo.nnz)


def csr_to_coo(csr: CSR) -> COO:
    """CSR -> COO row expansion."""
    return COO(csr.row_ids(), csr.indices, csr.data, csr.shape, csr.nnz)


def dense_to_csr(m, *, tol: float = 0.0, device=None) -> CSR:
    return CSR.from_dense(m, tol=tol, device=device)


def dense_to_coo(m, *, tol: float = 0.0, device=None) -> COO:
    return COO.from_dense(m, tol=tol, device=device)


def csr_to_dense(csr: CSR) -> torch.Tensor:
    return csr.to_dense()


def coo_to_dense(coo: COO) -> torch.Tensor:
    return coo.to_dense()
