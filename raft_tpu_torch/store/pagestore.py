"""Fixed-size page layout over a host row tensor (counterpart of
``raft_tpu.store.pagestore``).

The "Ragged Paged Attention" recipe (PAPERS.md): ragged per-entity state
(here: IVF lists, IVF-PQ scan caches, dataset rows) is stored as fixed-
size pages addressed through an int32 page table, so residency and
movement operate on uniform blocks instead of per-list ragged buffers.

A :class:`PageStore` is the *cold tier*: host pages that remain the
authoritative copy of every row.  It owns one contiguous padded buffer;
``pages`` and the flat ``data`` tensor are views of the same memory, so
an index keeps its familiar monolithic host view (e.g. ``list_data [L,
cap, d]``) aliased onto the paged layout with zero copy and zero
double-counting.  The buffer is pinned (page-locked) memory when CUDA is
available, so that a page's upload to the card is an asynchronous DMA
straight from it; plain memory otherwise.  Tensors rather than numpy
arrays, because bf16 rows have no numpy type.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PageStore"]


def _as_host_tensor(rows) -> torch.Tensor:
    if isinstance(rows, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(rows))
    if isinstance(rows, torch.Tensor):
        return rows.detach()
    return torch.as_tensor(np.asarray(rows))


class PageStore:
    """Host pages over ``rows [n, ...]`` with ``page_rows`` rows/page.

    Attributes
    ----------
    data : torch.Tensor
        ``[n_pages * page_rows, ...]`` on the CPU — the padded flat buffer
        (rows past ``n_rows`` are zeros).  Views of this buffer are what
        the owning index aliases as its monolithic host tensors.
    pages : torch.Tensor
        ``[n_pages, page_rows, ...]`` — a view of ``data``.
    page_table : torch.Tensor
        ``[n_pages] int32`` logical→storage page map.  Identity today;
        kept so a compacting writer can relocate pages without touching
        logical addresses.
    """

    def __init__(self, rows, page_rows: int):
        rows = _as_host_tensor(rows)
        if rows.ndim < 1:
            raise ValueError("rows must have at least one dimension")
        if page_rows < 1:
            raise ValueError(f"page_rows must be >= 1, got {page_rows}")
        n = rows.shape[0]
        self.n_rows = int(n)
        self.page_rows = int(page_rows)
        n_pages = max(1, -(-n // page_rows))
        payload = tuple(rows.shape[1:])
        self.data = torch.zeros((n_pages * page_rows,) + payload, dtype=rows.dtype,
                                pin_memory=torch.cuda.is_available())
        self.data[:n] = rows
        self.pages = self.data.view((n_pages, page_rows) + payload)
        self.page_table = torch.arange(n_pages, dtype=torch.int32)

    @property
    def n_pages(self) -> int:
        return self.pages.shape[0]

    @property
    def page_bytes(self) -> int:
        return int(self.pages[0].nbytes)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def nbytes(self) -> int:
        return int(self.data.nbytes) + int(self.page_table.nbytes)

    def _identity(self) -> bool:
        return torch.equal(self.page_table, torch.arange(self.n_pages, dtype=torch.int32))

    def page(self, i: int) -> torch.Tensor:
        """One logical page's rows (a view, page-table indirected)."""
        return self.pages[int(self.page_table[i])]

    def gather(self, page_ids) -> torch.Tensor:
        """Rows of several logical pages, ``[len(page_ids), page_rows, ...]``."""
        ids = torch.as_tensor(np.asarray(page_ids, np.int64))
        return self.pages[self.page_table[ids].long()]

    def to_array(self) -> torch.Tensor:
        """The original (unpadded) rows — a view when the page table is
        identity, a gathered copy after relocation."""
        if self._identity():
            return self.data[: self.n_rows]
        flat = self.pages[self.page_table.long()].reshape(self.data.shape)
        return flat[: self.n_rows]
