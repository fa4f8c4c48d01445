"""Two-tier page residency: a device hot pool over host cold pages
(counterpart of ``raft_tpu.store.tiered``).

The hot tier is ONE device tensor ``pool [slots, page_rows, ...]`` plus a
device page table ``page_slot [n_pages] int32`` (−1 = not resident), with
host mirrors of both (the device tensors are never read back).

Residency is demand-driven and clock-evicted:

- :meth:`ensure_resident` — blocking admission: the caller's pages are
  resident when it returns (a paged IVF search calls it with the pages of
  the coarse-probed lists).  Counts hits and misses.
- :meth:`prefetch` — async warm-start: a bounded daemon queue
  (``RAFT_TPU_PAGE_PREFETCH_DEPTH``) fetches pages off the caller's
  thread; a full queue drops the hint (prefetch is advisory).
- :meth:`evict` — clock (second-chance) victim selection over slots;
  runs implicitly when admission needs room.  An evict-then-refetch inside
  the thrash window counts in ``thrash`` — the sign that the hot pool is
  undersized — and publishes a ``page_thrash`` bus event (``obs.events``),
  at most one per store every ``_THRASH_DEBOUNCE_S`` seconds.

Hits, misses and evictions are also counted in the obs registry, as
raft_tpu names them: ``raft_tpu_page_{hits,misses,evictions}_total
{index=<name>}``; the three entry points are traced (``store.pager.ensure``,
``.prefetch``, ``.evict``).

Placing pages.  raft_tpu rebuilds the pool functionally on every admission
(``pool.at[slots].set(rows)``: a new array, which doubles as a snapshot
for in-flight searches).  At full width that is a 1.1 GB copy per
admission, so here the missing pages are written *in place*: each page
(or run of consecutive pages into consecutive slots) is one
``copy_(non_blocking=True)`` straight from the pinned host pages into its
slot, and the page table is rewritten with ``index_put_`` — exactly the
missing pages, with no shape padding (raft_tpu pads the scatter to a power
of two for XLA's compile cache; eager PyTorch has none).  The writes are
made under the store's lock on the CUDA stream that was current where the
admission was asked for (the prefetch thread adopts the stream of the
:meth:`prefetch` call), so they queue behind the scans already enqueued
there and ahead of the ones that follow: stream order takes the place of
raft_tpu's snapshot.  A prefetch hint queued before the latest blocking
admission is dropped unrun: it could otherwise evict a page that admission
promised to a scan not yet enqueued.

Searches from several threads.  A search of a partial pool holds
:meth:`search_guard` from its admission until its scans are enqueued, so
that no other search's admission evicts (and overwrites) one of its pages
in between.  On the card the guard also orders streams: it is entered by
making the caller's stream wait on an event recorded after each other
stream's last guarded search, so that a later admission's in-place page
writes cannot overtake a scan still queued on another stream, and a scan
cannot read a page whose upload is still queued there.  A pool that holds
every page is pinned once (:meth:`pin_identity`) and never changes again,
so its searches take no guard and no per-call synchronisation.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
import uuid
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.resources import ensure
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.store.budget import BudgetExceeded, MemoryBudget
from raft_tpu_torch.store.pagestore import PageStore

__all__ = ["TieredStore"]

_log = logging.getLogger(__name__)

#: fetches within this many admissions of the eviction count as thrash
_THRASH_WINDOW = 256
#: minimum seconds between page_thrash events per store
_THRASH_DEBOUNCE_S = 5.0


def _runs(src: np.ndarray, dst: np.ndarray):
    """(src0, dst0, length) of the maximal runs where both ``src`` and
    ``dst`` step by one: each run is one contiguous copy."""
    start = 0
    for i in range(1, len(src) + 1):
        if i == len(src) or src[i] != src[i - 1] + 1 or dst[i] != dst[i - 1] + 1:
            yield int(src[start]), int(dst[start]), i - start
            start = i


def _prefetch_worker(store_ref, q: "queue.Queue") -> None:
    """The prefetch thread: holds its store only weakly, so that a dropped
    store is collected (and its budget released) with the thread parked
    on the queue."""
    while True:
        item = q.get()
        try:
            store = store_ref()
            if store is None:
                return
            store._prefetch_one(*item)
            del store
        except Exception:  # advisory: the blocking admission still runs
            _log.debug("async prefetch failed", exc_info=True)
        finally:
            q.task_done()


class TieredStore:
    """Device hot pool + host cold tier over one :class:`PageStore`.

    ``device``: where the pool lives (default: ``Resources()``'s, "cuda",
    which raises without a card).
    """

    def __init__(
        self,
        store: PageStore,
        *,
        name: str = "index",
        budget: Optional[MemoryBudget] = None,
        max_slots: Optional[int] = None,
        prefetch_depth: Optional[int] = None,
        device: Union[str, torch.device, None] = None,
    ):
        self.store = store
        self.name = name
        self.page_rows = store.page_rows
        self.device = torch.device(device) if device is not None else ensure(None).device
        n_pages = store.n_pages
        page_bytes = store.page_bytes
        slots = n_pages if max_slots is None else min(n_pages, int(max_slots))

        self._budget = budget
        self._budget_key = f"pager:{name}:{uuid.uuid4().hex[:8]}"
        if budget is not None:
            # size the pool to what the budget grants (hard admission):
            # page_slot + pool bytes charge the ledger together
            affordable = (budget.remaining() - 4 * n_pages) // max(page_bytes, 1)
            slots = min(slots, int(affordable))
            if slots < 1:
                raise BudgetExceeded(
                    f"pager {name!r}: budget cannot hold a single "
                    f"{page_bytes}B page (remaining "
                    f"{budget.remaining()}B of {budget.limit_bytes}B)"
                )
            budget.reserve(self._budget_key, slots * page_bytes + 4 * n_pages)
            # release on GC so a dropped index returns its budget even
            # without an explicit close()
            self._finalizer = weakref.finalize(self, budget.release, self._budget_key)
        self.slots = slots

        payload = tuple(store.pages.shape[2:])
        self.pool = torch.zeros((slots, store.page_rows) + payload, dtype=store.dtype,
                                device=self.device)
        self.page_slot = torch.full((n_pages,), -1, dtype=torch.int32, device=self.device)

        # host mirrors (the device tensors are never read back)
        self._resident = np.full(n_pages, -1, np.int32)   # page -> slot
        self._slot_page = np.full(slots, -1, np.int32)    # slot -> page
        self._ref = np.zeros(slots, bool)                 # clock ref bits
        self._hand = 0
        self._free = list(range(slots))
        self._pinned = False
        self._lock = threading.RLock()
        #: blocking admissions so far; a prefetch hint older than the last
        #: one is dropped (see the module docstring)
        self._admissions = 0

        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefetched = 0
        self.thrash = 0
        self._fetch_seq = 0
        self._evicted_at: Dict[int, int] = {}
        self._last_thrash_t = -1e9

        depth = prefetch_depth
        if depth is None:
            depth = _env.env_int("RAFT_TPU_PAGE_PREFETCH_DEPTH", 2)
        self._prefetch_q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._prefetch_thread: Optional[threading.Thread] = None
        #: held by a search from its admission to its scans' enqueue
        self._search_lock = threading.RLock()
        #: CUDA stream handle → event recorded after its last guarded search
        self._scan_events: Dict[int, "torch.cuda.Event"] = {}

    # -- sizing --------------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return self.store.n_pages

    @property
    def resident_count(self) -> int:
        with self._lock:
            return int((self._resident >= 0).sum())

    @property
    def nbytes(self) -> int:
        """Device bytes of the hot tier (pool + device page table)."""
        return int(self.pool.nbytes) + int(self.page_slot.nbytes)

    def close(self) -> None:
        """Release the budget reservation early (idempotent)."""
        if self._budget is not None:
            self._budget.release(self._budget_key)

    # -- residency -----------------------------------------------------------
    def _normalize(self, pages) -> np.ndarray:
        arr = np.unique(np.asarray(pages, np.int64).ravel())
        return arr[(arr >= 0) & (arr < self.n_pages)]

    def _current_stream(self):
        return torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

    @traced("store.pager.ensure")
    def ensure_resident(self, pages: Sequence[int]) -> None:
        """Blocking admission: every listed page is resident on return (on
        the caller's current stream).

        Raises :class:`BudgetExceeded` when the request alone exceeds the
        hot pool — the loud alternative to thrashing every dispatch.
        """
        pages = self._normalize(pages)
        if pages.size == 0:
            return
        with self._lock:
            self._admissions += 1
            slot_of = self._resident[pages]
            present = slot_of >= 0
            hits = int(present.sum())
            missing = pages[~present]
            self.hits += hits
            if hits:
                self._ref[slot_of[present]] = True
                self._counter("raft_tpu_page_hits_total", hits)
            if missing.size == 0:
                return
            if pages.size > self.slots:
                raise BudgetExceeded(
                    f"pager {self.name!r}: {pages.size} pages requested "
                    f"but the hot pool holds {self.slots} "
                    f"(page_rows={self.page_rows}); raise "
                    "RAFT_TPU_PAGE_HBM_BUDGET_MB or RAFT_TPU_PAGE_ROWS"
                )
            self.misses += missing.size
            self._counter("raft_tpu_page_misses_total", int(missing.size))
            # pages of THIS admission may not be victimized mid-batch —
            # the clock's second sweep would otherwise evict a page the
            # caller was just promised (ref bits only survive one wrap)
            protected = np.zeros(self.slots, bool)
            protected[slot_of[present]] = True
            self._fetch(missing, protected, self._current_stream())

    @contextlib.contextmanager
    def search_guard(self):
        """Hold for one search of a partial pool, from its admission until
        its scans are enqueued (see the module docstring): searches of one
        store run their admit → view → launch one after another, and on the
        card the caller's stream first waits for every other stream's last
        guarded search."""
        with self._search_lock:
            stream = self._current_stream()
            if stream is not None:
                for handle, event in self._scan_events.items():
                    if handle != stream.cuda_stream:
                        stream.wait_event(event)
            try:
                yield
            finally:
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
                    self._scan_events[stream.cuda_stream] = event

    @traced("store.pager.prefetch")
    def prefetch(self, pages: Sequence[int]) -> bool:
        """Async warm-start keyed by the coarse-probe result.  Returns
        whether the hint was accepted (a full queue drops it)."""
        pages = self._normalize(pages)
        if pages.size == 0:
            return True
        with self._lock:
            pages = pages[self._resident[pages] < 0]
            seq = self._admissions
        if pages.size == 0:
            return True
        self._ensure_worker()
        try:
            self._prefetch_q.put_nowait((pages, seq, self._current_stream()))
            return True
        except queue.Full:
            return False

    @traced("store.pager.evict")
    def evict(self, count: int = 1) -> List[int]:
        """Clock-evict up to ``count`` pages; returns the evicted page
        ids.  Pinned stores refuse (their views alias slot order)."""
        with self._lock:
            if self._pinned:
                raise RuntimeError(
                    f"pager {self.name!r} is pinned (identity placement); "
                    "eviction would corrupt aliased views"
                )
            evicted: List[int] = []
            occupied = int((self._slot_page >= 0).sum())
            for _ in range(min(count, occupied)):
                slot = self._clock_victim()
                if slot is None:
                    break
                evicted.append(self._evict_slot(slot))
                self._free.append(slot)
            if evicted:
                with self._on(self._current_stream()):
                    self._write_slots(np.asarray(evicted, np.int64),
                                      np.full(len(evicted), -1, np.int32))
            return evicted

    def pin_identity(self) -> None:
        """Upload every page into its identity slot (slot i holds page
        i) in one transfer.  After pinning, ``pool.reshape(-1, ...)`` is
        bitwise the padded flat host tensor — the placement brute_force /
        cagra views rely on.  Requires a full-size pool."""
        with self._lock:
            if self._pinned:
                return
            if self.slots < self.n_pages:
                raise BudgetExceeded(
                    f"pager {self.name!r}: identity pinning needs "
                    f"{self.n_pages} slots, pool holds {self.slots}; this "
                    "backend requires the whole payload resident — raise "
                    "RAFT_TPU_PAGE_HBM_BUDGET_MB"
                )
            self.misses += self.n_pages
            self._counter("raft_tpu_page_misses_total", self.n_pages)
            with self._on(self._current_stream()):
                if self.store._identity():
                    self.pool.copy_(self.store.pages, non_blocking=True)
                else:
                    self.pool.copy_(self.store.pages[self.store.page_table.long()])
                self.page_slot.copy_(torch.arange(self.n_pages, dtype=torch.int32))
            self._resident = np.arange(self.n_pages, dtype=np.int32)
            self._slot_page = np.arange(self.slots, dtype=np.int32)
            self._ref[:] = True
            self._free = []
            self._pinned = True

    def view(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pool, page_slot): the live device tensors (see the module
        docstring for why stream order keeps them consistent)."""
        with self._lock:
            return self.pool, self.page_slot

    def counters(self) -> Tuple[int, int, int]:
        """One consistent ``(hits, misses, resident)`` read."""
        with self._lock:
            return self.hits, self.misses, int((self._resident >= 0).sum())

    def resident_pages(self) -> np.ndarray:
        """Resident page ids ordered by slot (replaying ``ensure_resident``
        over this restores the placement)."""
        with self._lock:
            order = np.argsort(self._resident[self._resident >= 0])
            pages = np.flatnonzero(self._resident >= 0).astype(np.int32)
            return pages[order]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            resident = int((self._resident >= 0).sum())
            return {
                "name": self.name,
                "n_pages": self.n_pages,
                "slots": self.slots,
                "page_rows": self.page_rows,
                "resident": resident,
                "host_only": self.n_pages - resident,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "prefetched": self.prefetched,
                "thrash": self.thrash,
                "pinned": self._pinned,
                "hot_bytes": self.nbytes,
                "cold_bytes": self.store.nbytes,
            }

    # -- internals (lock held) -----------------------------------------------
    def _on(self, stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _fetch(self, missing: np.ndarray, protected: Optional[np.ndarray], stream) -> None:
        """Admit ``missing`` pages (none currently resident).
        ``protected`` slots (the admission's hit pages) are never
        victimized; slots claimed here join the protected set."""
        if protected is None:
            protected = np.zeros(self.slots, bool)
        slots = np.empty(missing.size, np.int32)
        evicted: List[int] = []
        for i, page in enumerate(missing):
            if self._free:
                slot = self._free.pop()
            else:
                slot = self._clock_victim(protected)
                if slot is None:  # pragma: no cover - guarded by caller
                    raise BudgetExceeded(
                        f"pager {self.name!r}: no evictable slot (slots={self.slots})"
                    )
                evicted.append(self._evict_slot(slot))
            slots[i] = slot
            protected[slot] = True
            self._slot_page[slot] = page
            self._resident[page] = slot
            self._ref[slot] = True
        self._fetch_seq += missing.size
        self._note_thrash(missing)

        storage = self.store.page_table[torch.from_numpy(missing)].numpy()
        with self._on(stream):
            for src, dst, n in _runs(storage, slots):
                self.pool[dst:dst + n].copy_(self.store.pages[src:src + n], non_blocking=True)
            self._write_slots(
                np.concatenate([np.asarray(evicted, np.int64), missing]),
                np.concatenate([np.full(len(evicted), -1, np.int32), slots]),
            )

    def _write_slots(self, pages: np.ndarray, slots: np.ndarray) -> None:
        """Rewrite page→slot entries of the device table (evictions ride as
        −1 values); the pages are distinct."""
        idx = torch.from_numpy(pages.astype(np.int64)).to(self.device, non_blocking=True)
        val = torch.from_numpy(slots.astype(np.int32)).to(self.device, non_blocking=True)
        self.page_slot.index_put_((idx,), val)

    def _clock_victim(self, protected: Optional[np.ndarray] = None) -> Optional[int]:
        """Second-chance sweep: clear ref bits until an unreferenced,
        unprotected occupied slot comes around."""
        for _ in range(3 * self.slots):
            slot = self._hand
            self._hand = (self._hand + 1) % self.slots
            if self._slot_page[slot] < 0:
                continue
            if protected is not None and protected[slot]:
                continue
            if self._ref[slot]:
                self._ref[slot] = False
                continue
            return slot
        return None

    def _evict_slot(self, slot: int) -> int:
        page = int(self._slot_page[slot])
        self._slot_page[slot] = -1
        self._resident[page] = -1
        self._ref[slot] = False
        self._evicted_at[page] = self._fetch_seq
        self.evictions += 1
        self._counter("raft_tpu_page_evictions_total", 1)
        return page

    def _note_thrash(self, fetched: np.ndarray) -> None:
        """Count evict-then-refetch inside the window (the pool is too
        small for the working set) and publish it, debounced, as a
        ``page_thrash`` event."""
        n = 0
        for page in fetched:
            seq = self._evicted_at.pop(int(page), None)
            if seq is not None and self._fetch_seq - seq <= _THRASH_WINDOW:
                n += 1
        if not n:
            return
        self.thrash += n
        now = time.monotonic()
        if now - self._last_thrash_t < _THRASH_DEBOUNCE_S:
            return
        self._last_thrash_t = now
        try:
            from raft_tpu_torch.obs import events as _events

            _events.publish(
                "page_thrash",
                f"pager {self.name!r}: {n} pages refetched within "
                f"{_THRASH_WINDOW} admissions of eviction "
                f"(slots={self.slots}, pages={self.n_pages})",
                index=self.name, pages=int(n), slots=int(self.slots),
                n_pages=int(self.n_pages),
            )
        except Exception:  # observability must never break a search
            _log.debug("page_thrash publish failed", exc_info=True)

    def _counter(self, name: str, value: int) -> None:
        from raft_tpu_torch.obs.registry import default_registry

        default_registry().counter(name).inc(float(value), index=self.name)

    # -- async prefetch ------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._prefetch_thread is not None and self._prefetch_thread.is_alive():
            return
        t = threading.Thread(
            target=_prefetch_worker,
            args=(weakref.ref(self), self._prefetch_q),
            name=f"raft-tpu-torch-pager-{self.name}",
            daemon=True,
        )
        self._prefetch_thread = t
        t.start()

    def _prefetch_one(self, pages: np.ndarray, seq: int, stream) -> None:
        with self._lock:
            if seq != self._admissions:
                return  # a blocking admission came after the hint
            missing = pages[self._resident[pages] < 0]
            if missing.size and missing.size <= self.slots and not self._pinned:
                self._fetch(missing, None, stream)
                self.prefetched += missing.size
