"""raft_tpu_torch.store — paged index storage with host/device tiering
(counterpart of ``raft_tpu.store``).

Monolithic device tensors cap index size at device memory.  This package
stores the big payloads (IVF lists, IVF-PQ decode caches, dataset rows) as
fixed-size *pages* behind an int32 page table instead:

- :mod:`~raft_tpu_torch.store.pagestore` — host cold tier: the
  authoritative padded page buffer (pinned when CUDA is available),
  aliased back onto the index as its monolithic host view.
- :mod:`~raft_tpu_torch.store.tiered` — the device hot pool: a device
  tensor + device page table with clock eviction, demand admission
  (``ensure_resident``) and bounded async prefetch keyed by the
  coarse-probe result; pages are written in place on the caller's stream.
- :mod:`~raft_tpu_torch.store.budget` — hard memory admission:
  reservations either fit ``RAFT_TPU_PAGE_HBM_BUDGET_MB`` or raise a loud
  :class:`BudgetExceeded`.
- :mod:`~raft_tpu_torch.store.paged` — paged views (:class:`PagedLists` /
  :class:`PagedRows`) that substitute for the monolithic payload in the
  search paths and the scan and hop kernels, plus :func:`paginate_index`
  to convert a built index in place.

A paginated index's ``search`` reads through the pager; raft_tpu's
serving-layer gate (``RAFT_TPU_PAGED``) is not ported.
"""

from raft_tpu_torch.store.budget import (
    BudgetExceeded,
    MemoryBudget,
    default_budget,
    set_default_budget,
)
from raft_tpu_torch.store.paged import (
    PagedLists,
    PagedRows,
    gather_lists,
    pages_for_lists,
    paginate_index,
)
from raft_tpu_torch.store.pagestore import PageStore
from raft_tpu_torch.store.tiered import TieredStore

__all__ = [
    "BudgetExceeded",
    "MemoryBudget",
    "PageStore",
    "PagedLists",
    "PagedRows",
    "TieredStore",
    "default_budget",
    "gather_lists",
    "pages_for_lists",
    "paginate_index",
    "set_default_budget",
]
