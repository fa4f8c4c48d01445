"""Typed reads of the ``RAFT_TPU_*`` settings the port honours (the
accessors of ``raft_tpu.core.env`` it needs, with raft_tpu's semantics).

- ``RAFT_TPU_PAGE_HBM_BUDGET_MB``: the default device-memory budget of
  paged indexes (``store.budget``); unset means no budget.
- ``RAFT_TPU_PAGE_ROWS``: rows per page of ``store.paginate_index``
  (default 1024).
- ``RAFT_TPU_PAGE_PREFETCH_DEPTH``: the bounded prefetch queue of a
  ``store.TieredStore`` (default 2).
"""

from __future__ import annotations

import os
from typing import Optional


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """``int(os.environ[name])``; unset or blank reads as ``default``."""
    value = os.environ.get(name)
    if value is None or not value.strip():
        return default
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}={value!r} is not an integer") from None
