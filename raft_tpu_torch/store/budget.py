"""Hard memory-budget accounting for the paged store (counterpart of
``raft_tpu.store.budget``, whole).

"Memory Safe Computations with XLA Compiler" (PAPERS.md) makes the
memory bound a first-class constraint the compiler must respect instead
of an observed-after-the-fact gauge.  This module is the serving-side
equivalent: a :class:`MemoryBudget` is a process-wide ledger of device
bytes *reserved* by named owners (one per
:class:`~raft_tpu_torch.store.tiered.TieredStore` hot pool), and every
reservation either fits or raises a loud :class:`BudgetExceeded` — never
an opaque device OOM mid-dispatch.

The default budget comes from ``RAFT_TPU_PAGE_HBM_BUDGET_MB``; unset
means "no budget" (``default_budget()`` returns ``None``) and the paged
store sizes its hot pool to hold every page, which preserves the
monolithic path's behavior exactly.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from raft_tpu_torch.core import env as _env

__all__ = [
    "BudgetExceeded",
    "MemoryBudget",
    "default_budget",
    "set_default_budget",
]


class BudgetExceeded(RuntimeError):
    """A reservation (or residency request) does not fit the budget.

    Raised instead of letting the allocation proceed toward a device
    OOM — the message carries the ledger snapshot so the operator sees
    *which* owners hold the budget, not just that it ran out.
    """


class MemoryBudget:
    """Thread-safe byte ledger with hard admission.

    ``reserve`` is the only growing operation and it is all-or-nothing:
    the ledger never over-commits, so a successful reservation is a
    guarantee the bytes were inside the limit at grant time.
    """

    def __init__(self, limit_bytes: int):
        if limit_bytes <= 0:
            raise ValueError(f"limit_bytes must be positive, got {limit_bytes}")
        self.limit_bytes = int(limit_bytes)
        self._lock = threading.Lock()
        self._owners: Dict[str, int] = {}

    # -- ledger ops ----------------------------------------------------------
    def reserve(self, owner: str, nbytes: int) -> None:
        """Grow ``owner``'s reservation by ``nbytes`` or raise."""
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"nbytes must be non-negative, got {nbytes}")
        with self._lock:
            used = sum(self._owners.values())
            if used + nbytes > self.limit_bytes:
                raise BudgetExceeded(
                    f"memory budget exceeded: {owner!r} requested {nbytes}B "
                    f"with {self.limit_bytes - used}B of {self.limit_bytes}B "
                    f"remaining (owners: {dict(self._owners)})"
                )
            self._owners[owner] = self._owners.get(owner, 0) + nbytes

    def release(self, owner: str, nbytes: Optional[int] = None) -> None:
        """Shrink ``owner``'s reservation (all of it when ``nbytes`` is
        ``None``).  Releasing an unknown owner is a no-op — weakref
        finalizers may fire after an explicit release."""
        with self._lock:
            held = self._owners.get(owner)
            if held is None:
                return
            if nbytes is None or nbytes >= held:
                del self._owners[owner]
            else:
                self._owners[owner] = held - int(nbytes)

    # -- queries -------------------------------------------------------------
    def would_fit(self, nbytes: int) -> bool:
        """Whether a new ``nbytes`` reservation would be granted now."""
        with self._lock:
            return sum(self._owners.values()) + int(nbytes) <= self.limit_bytes

    def reserved(self) -> int:
        with self._lock:
            return sum(self._owners.values())

    def remaining(self) -> int:
        with self._lock:
            return max(0, self.limit_bytes - sum(self._owners.values()))

    def snapshot(self) -> Dict[str, object]:
        """JSON-safe ledger state for ``healthz()`` / stats surfaces."""
        with self._lock:
            used = sum(self._owners.values())
            return {
                "limit_bytes": self.limit_bytes,
                "reserved_bytes": used,
                "remaining_bytes": max(0, self.limit_bytes - used),
                "utilization": used / self.limit_bytes,
                "owners": dict(self._owners),
            }


_UNSET = object()
_default = _UNSET
_default_lock = threading.Lock()


def default_budget() -> Optional[MemoryBudget]:
    """The process budget from ``RAFT_TPU_PAGE_HBM_BUDGET_MB`` (``None``
    when unset).  Created once on first read so reservations accumulate
    on one ledger; tests swap it with :func:`set_default_budget`."""
    global _default
    with _default_lock:
        if _default is _UNSET:
            mb = _env.env_int("RAFT_TPU_PAGE_HBM_BUDGET_MB")
            _default = MemoryBudget(mb << 20) if mb else None
        return _default


def set_default_budget(
    budget: Optional[MemoryBudget],
) -> Optional[MemoryBudget]:
    """Replace the process budget; returns the previous one.  Pass
    ``None`` to clear; the next ``default_budget()`` after a clear
    re-reads the environment only if the sentinel is restored via
    ``set_default_budget(_UNSET)``-style test fixtures — in practice
    tests set an explicit budget and restore the captured previous."""
    global _default
    with _default_lock:
        prev = None if _default is _UNSET else _default
        _default = budget
        return prev
