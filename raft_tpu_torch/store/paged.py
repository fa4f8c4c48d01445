"""Paged device views + per-backend pagination (counterpart of
``raft_tpu.store.paged``).

Two views stand in for the monolithic device payload inside the existing
search paths:

- :class:`PagedLists` stands in for a padded-list tensor ``[L, cap,
  payload]`` (ivf_flat ``list_data``, ivf_pq's decoded scan cache).
  ``gather_lists(ld, bl)`` replaces the ``ld[bl]`` gather of the plain
  scans: for a paged view it routes each list through the device page
  table (``pool[page_slot[list * ppl + j]]``), producing rows bitwise equal
  to the monolithic gather for resident pages; the scan kernels read the
  same rows through the same table (``csrc/ivf_scan.cu``).
- :class:`PagedRows` stands in for a flat row matrix ``[n, d]`` (the cagra
  dataset); ``decode(ids)`` is the page-table translation of a row gather,
  and the hop kernel's paged leg reads rows the same way
  (``csrc/cagra_hop.cu``).

A slot of −1 (a page not resident) reads slot 0 in both the plain versions
and the kernels, as raft_tpu's kernels clamp it: in-bounds, and never
scanned, because a search makes the pages it probes resident first.

:func:`paginate_index` converts a built backend index *in place*: the big
payload moves to a host :class:`~raft_tpu_torch.store.pagestore.PageStore`
(cold tier, aliased back onto the index as its monolithic host tensor, so
``save`` writes it unchanged) fronted by a budget-sized
:class:`~raft_tpu_torch.store.tiered.TieredStore` hot pool on the index's
device at ``index.paged``.  List capacity is repadded to a page multiple
with the build's own padding values (ids −1, IVF-Flat norms +inf, IVF-PQ
norms 0, rows 0), so the extra slots lose every selection exactly like
build padding does.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.store.budget import MemoryBudget, default_budget
from raft_tpu_torch.store.pagestore import PageStore
from raft_tpu_torch.store.tiered import TieredStore

__all__ = [
    "PagedLists",
    "PagedRows",
    "gather_lists",
    "pages_for_lists",
    "paginate_index",
    "default_page_rows",
]

_log = logging.getLogger(__name__)

#: backends paginate_index understands (module basename of the Index type)
PAGED_KINDS = ("ivf_flat", "ivf_pq", "brute_force", "cagra")


def default_page_rows() -> int:
    return int(_env.env_int("RAFT_TPU_PAGE_ROWS", 1024))


class PagedLists:
    """Device view of a paged ``[L, cap, payload]`` padded-list tensor:
    ``pool [slots, page_rows, payload]`` and ``page_slot [L *
    pages_per_list] int32``.  ``shape`` / ``dtype`` / ``device`` mirror the
    monolithic tensor so call sites that read them stay untouched."""

    def __init__(self, pool: torch.Tensor, page_slot: torch.Tensor, pages_per_list: int):
        self.pool = pool
        self.page_slot = page_slot
        self.pages_per_list = int(pages_per_list)

    @property
    def shape(self):
        ppl = self.pages_per_list
        return (self.page_slot.shape[0] // ppl, ppl * self.pool.shape[1]) + tuple(
            self.pool.shape[2:])

    @property
    def dtype(self) -> torch.dtype:
        return self.pool.dtype

    @property
    def device(self) -> torch.device:
        return self.pool.device

    @property
    def page_rows(self) -> int:
        return self.pool.shape[1]


class PagedRows:
    """Device view of a paged flat row matrix ``[n, d]`` with a
    ``decode(ids) -> f32 rows`` page-table gather."""

    def __init__(self, pool: torch.Tensor, page_slot: torch.Tensor, n_rows: int):
        self.pool = pool
        self.page_slot = page_slot
        self.n_rows = int(n_rows)

    @property
    def shape(self):
        return (self.n_rows,) + tuple(self.pool.shape[2:])

    @property
    def dtype(self) -> torch.dtype:
        return self.pool.dtype

    @property
    def device(self) -> torch.device:
        return self.pool.device

    @property
    def page_rows(self) -> int:
        return self.pool.shape[1]

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows for ``ids`` (clipped like the dense gather), upcast f32."""
        pr = self.pool.shape[1]
        ids = ids.long().clamp(0, self.n_rows - 1)
        page = ids // pr
        slot = self.page_slot[page].long().clamp(min=0)
        return self.pool[slot, ids - page * pr].to(torch.float32)


def gather_lists(list_data, lists: torch.Tensor) -> torch.Tensor:
    """``list_data[lists]`` with page-table indirection when paged.

    ``lists`` is any int tensor of list ids; the result appends ``(cap,
    payload...)`` to its shape, exactly like the monolithic gather."""
    if isinstance(list_data, PagedLists):
        ppl = list_data.pages_per_list
        lists = lists.long()
        pages = lists[..., None] * ppl + torch.arange(ppl, device=lists.device)
        rows = list_data.pool[list_data.page_slot[pages].long().clamp(min=0)]
        return rows.reshape(tuple(lists.shape) + tuple(list_data.shape[1:]))
    return list_data[lists.long()]


def pages_for_lists(lists, pages_per_list: int) -> np.ndarray:
    """The page ids covering ``lists`` (host-side prefetch keying)."""
    lists = np.asarray(lists, np.int64).reshape(-1)
    return (lists[:, None] * pages_per_list + np.arange(pages_per_list)).ravel()


# -- pagination ---------------------------------------------------------------
def _kind_of(index) -> str:
    return type(index).__module__.rsplit(".", 1)[-1]


def _repad(t: torch.Tensor, cap2: int, fill) -> torch.Tensor:
    """Grow dimension 1 (list capacity) to ``cap2`` with ``fill``."""
    L, cap = t.shape[:2]
    if cap == cap2:
        return t
    out = torch.full((L, cap2) + tuple(t.shape[2:]), fill, dtype=t.dtype, device=t.device)
    out[:, :cap] = t
    return out


def _paginate_lists(index, page_rows: int, name: str, budget: Optional[MemoryBudget], *,
                    y2_attr: str, y2_fill) -> TieredStore:
    """Shared IVF pagination: page ``list_data``, repad the per-slot
    sidecars to the page-aligned capacity, alias the cold tier back as the
    monolithic host view."""
    ld = index.list_data
    L, cap = ld.shape[:2]
    ppl = max(1, -(-cap // page_rows))
    cap2 = ppl * page_rows
    payload = tuple(ld.shape[2:])
    store = PageStore(_repad(ld.cpu(), cap2, 0).reshape((L * cap2,) + payload), page_rows)
    tiered = TieredStore(store, name=name, budget=budget, device=index.centers.device)
    tiered.pages_per_list = ppl
    index.list_data = store.data.view((L, cap2) + payload)
    index.list_index = _repad(index.list_index, cap2, -1)
    setattr(index, y2_attr, _repad(getattr(index, y2_attr), cap2, y2_fill))
    index.paged = tiered
    return tiered


def _paginate_rows(index, page_rows: int, name: str, budget: Optional[MemoryBudget],
                   device: torch.device) -> TieredStore:
    rows = index.dataset
    store = PageStore(rows, page_rows)
    tiered = TieredStore(store, name=name, budget=budget, device=device)
    index.dataset = store.data[: rows.shape[0]]
    index.paged = tiered
    return tiered


def paginate_index(
    index,
    *,
    page_rows: Optional[int] = None,
    budget: Optional[MemoryBudget] = "default",  # type: ignore[assignment]
    name: str = "index",
) -> TieredStore:
    """Convert a built backend index to paged storage in place.

    The payload tensor moves to host pages (cold tier, authoritative:
    ``save`` reads it unchanged) behind a budget-sized device hot pool at
    ``index.paged``, on the device the index lives on.  Afterwards the
    index's ``list_data`` (IVF) or ``dataset`` (brute force, CAGRA) is a
    host tensor at the page-aligned capacity; IVF-PQ's codes move to the
    host too.  Idempotent.

    brute_force/cagra scan arbitrary rows per dispatch, so their whole
    payload must fit the hot pool (identity-pinned at first search;
    ``BudgetExceeded`` otherwise).  The IVF backends scan only the
    coarse-probed lists' pages and serve payloads larger than the hot
    pool.
    """
    if getattr(index, "paged", None) is not None:
        return index.paged
    kind = _kind_of(index)
    if kind not in PAGED_KINDS:
        raise ValueError(
            f"paginate_index: unsupported index kind {kind!r} (supported: {PAGED_KINDS})"
        )
    pr = int(page_rows) if page_rows else default_page_rows()
    if pr < 8 or pr % 8:
        raise ValueError(f"page_rows must be a positive multiple of 8, got {pr}")
    if budget == "default":
        budget = default_budget()

    if kind == "ivf_flat":
        tiered = _paginate_lists(index, pr, name, budget, y2_attr="list_norms",
                                 y2_fill=float("inf"))
        index._scan_norms = None
    elif kind == "ivf_pq":
        cap = index.list_data.shape[1]
        ppl = max(1, -(-cap // pr))
        # codes ride the cold tier only: they are not on the scan path
        # (the decoded list_data cache is)
        index.list_codes = _repad(index.list_codes.cpu(), ppl * pr, 0)
        tiered = _paginate_lists(index, pr, name, budget, y2_attr="list_y2", y2_fill=0.0)
    else:  # brute_force / cagra: flat dataset rows
        ds = getattr(index, "dataset", None)
        if not isinstance(ds, torch.Tensor) or ds.ndim != 2:
            raise ValueError(
                f"paginate_index: {kind} index has no dense [n, d] dataset to page"
            )
        device = index.graph.device if kind == "cagra" else ds.device
        tiered = _paginate_rows(index, pr, name, budget, device)
    _log.debug("paginate_index: kind=%s name=%s pages=%d page_rows=%d slots=%d",
               kind, name, tiered.n_pages, pr, tiered.slots)
    return tiered
