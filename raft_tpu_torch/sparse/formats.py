"""Sparse matrix containers: COO and CSR (counterpart of
``raft_tpu.sparse.formats``).

raft_tpu's containers carry a *fixed capacity* of slots with a valid count
``nnz``: slots past ``nnz`` are padding (COO padding rows are the
``n_rows`` sentinel, values 0).  The port keeps that layout so raft_tpu's
arrays, as numpy, construct a container unchanged.  Tensors stay on their
device; numpy arrays go to ``device`` (default: the default Resources',
``cuda``).  Structure-mutating ops (dedupe, filter) build new containers
and sync the host for the new ``nnz``, as raft_tpu's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import resolve_device, to_device
from raft_tpu_torch.kernels import csr_spmm as _csr


def coo_order(rows, cols, valid, n_rows):
    """Row-major (row, col) order with invalid slots last: two stable
    sorts (by col, then by row), as raft_tpu's ``coo_order``."""
    order = torch.argsort(cols, stable=True)
    r = torch.where(valid, rows, torch.full_like(rows, n_rows))[order]
    return order[torch.argsort(r, stable=True)]


def _as(x, dtype, device) -> torch.Tensor:
    t = to_device(x, device)
    return t if dtype is None else t.to(dtype)


def _dense_from_slots(shape, rows, cols, vals, keep) -> torch.Tensor:
    """zeros(shape) plus ``vals`` at (rows, cols) where ``keep``: raft_tpu's
    ``out.at[r, c].add(...)``.  Slots that share a position are summed in
    slot order (``kernels.csr_spmm.row_sums`` over the stably sorted
    positions); a position held once is written (0 + v, so -0.0 reads
    +0.0 as the add gives)."""
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    idx = torch.nonzero(keep).squeeze(1)
    if idx.numel() == 0:
        return out
    key = rows[idx].long() * shape[1] + cols[idx].long()
    v = vals[idx]
    order = torch.argsort(key, stable=True)
    k_s = key[order]
    first = torch.ones_like(k_s, dtype=torch.bool)
    first[1:] = k_s[1:] != k_s[:-1]
    if bool(first.all()):
        out.view(-1)[key] = v + 0.0
    else:
        starts = torch.nonzero(first).squeeze(1)
        indptr = torch.cat([starts, torch.tensor([k_s.numel()], device=k_s.device)])
        out.view(-1)[k_s[starts]] = _csr.row_sums(indptr, v[order]).to(vals.dtype)
    return out


class COO:
    """Coordinate-format sparse matrix.

    rows / cols: [cap] int32 (padding rows = n_rows, cols = 0)
    data:        [cap] float
    nnz:         int <= cap
    """

    def __init__(self, rows, cols, data, shape: Tuple[int, int], nnz=None, *, device=None):
        dev = resolve_device(device, rows, cols, data)
        self.rows = _as(rows, torch.int32, dev)
        self.cols = _as(cols, torch.int32, dev)
        self.data = _as(data, None, dev)
        self.shape = tuple(int(s) for s in shape)
        self.nnz = int(nnz) if nnz is not None else int(self.rows.shape[0])
        self._row_view = None

    @property
    def cap(self) -> int:
        return int(self.rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def valid(self) -> torch.Tensor:
        """[cap] bool mask of live slots."""
        return torch.arange(self.cap, device=self.device) < self.nnz

    def to(self, device) -> "COO":
        """The same matrix on ``device`` (itself when already there)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return COO(self.rows, self.cols, self.data, self.shape, self.nnz, device=device)

    @classmethod
    def from_dense(cls, m, *, tol: float = 0.0, device=None) -> "COO":
        """Dense -> COO, entries with |value| > tol in row-major order."""
        dev = resolve_device(device, m)
        m = torch.as_tensor(m) if isinstance(m, torch.Tensor) else torch.from_numpy(np.asarray(m))
        m = m.to(dev)
        r, c = torch.nonzero(m.abs() > tol, as_tuple=True)
        return cls(r.to(torch.int32), c.to(torch.int32), m[r, c], tuple(m.shape))

    def to_dense(self) -> torch.Tensor:
        return _dense_from_slots(self.shape, self.rows, self.cols, self.data, self.valid
                                 & (self.rows < self.shape[0]))

    def sorted_by_row(self) -> "COO":
        """Row-major (then col) order with padding at the end."""
        order = coo_order(self.rows, self.cols, self.valid, self.shape[0])
        return COO(self.rows[order], self.cols[order], self.data[order], self.shape, self.nnz)

    def row_view(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(indptr [n_rows + 1], cols, values) of the live slots stably
        sorted by row: each row's slots keep their slot order, the order in
        which raft_tpu's ``segment_sum`` adds them.  Computed once per
        container and arrays (the Lanczos matvec reuses it); replacing
        ``rows``, ``cols`` or ``data`` recomputes it."""
        key = (id(self.rows), id(self.cols), id(self.data), self.nnz)
        if self._row_view is None or self._row_view[0] != key:
            n = self.shape[0]
            v = self.valid & (self.rows < n)
            idx = torch.nonzero(v).squeeze(1)
            r = self.rows[idx]
            order = idx[torch.argsort(r, stable=True)]
            counts = torch.bincount(r.long(), minlength=n)
            indptr = torch.zeros(n + 1, dtype=torch.int32, device=self.device)
            indptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
            self._row_view = (key, (indptr, self.cols[order].contiguous(),
                                    self.data[order].to(torch.float32).contiguous()))
        return self._row_view[1]


class CSR:
    """Compressed-sparse-row matrix.

    indptr:  [n_rows + 1] int32 (indptr[n_rows] == nnz)
    indices: [cap] int32 column ids (padding = 0)
    data:    [cap] float (padding = 0)
    """

    def __init__(self, indptr, indices, data, shape: Tuple[int, int], nnz=None, *, device=None):
        dev = resolve_device(device, indptr, indices, data)
        self.indptr = _as(indptr, torch.int32, dev)
        self.indices = _as(indices, torch.int32, dev)
        self.data = _as(data, None, dev)
        self.shape = tuple(int(s) for s in shape)
        self.nnz = int(nnz) if nnz is not None else int(self.indices.shape[0])

    @property
    def cap(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @property
    def valid(self) -> torch.Tensor:
        return torch.arange(self.cap, device=self.device) < self.nnz

    def to(self, device) -> "CSR":
        """The same matrix on ``device`` (itself when already there)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return CSR(self.indptr, self.indices, self.data, self.shape, self.nnz, device=device)

    def row_ids(self) -> torch.Tensor:
        """Per-slot row ids [cap] (padding slots -> n_rows)."""
        slots = torch.arange(self.cap, device=self.device, dtype=torch.int32)
        rows = torch.searchsorted(self.indptr, slots, right=True) - 1
        return torch.where(self.valid, rows.to(torch.int32),
                           torch.full_like(slots, self.shape[0]))

    @classmethod
    def from_dense(cls, m, *, tol: float = 0.0, device=None) -> "CSR":
        dev = resolve_device(device, m)
        m = torch.as_tensor(m) if isinstance(m, torch.Tensor) else torch.from_numpy(np.asarray(m))
        m = m.to(dev)
        mask = m.abs() > tol
        indptr = torch.zeros(m.shape[0] + 1, dtype=torch.int32, device=dev)
        indptr[1:] = torch.cumsum(mask.sum(1), 0).to(torch.int32)
        r, c = torch.nonzero(mask, as_tuple=True)
        return cls(indptr, c.to(torch.int32), m[r, c], tuple(m.shape))

    def to_dense(self) -> torch.Tensor:
        return _dense_from_slots(self.shape, self.row_ids(), self.indices, self.data,
                                 self.valid)
