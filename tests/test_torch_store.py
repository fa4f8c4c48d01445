"""Port parity of ``raft_tpu_torch.store``'s building blocks, each case of
``tests/test_store.py`` on the port (pools on the CPU), plus raft_tpu's
``TieredStore`` and the port's driven through one scripted sequence: the
same slot count, victims, placement, counters and pool contents.

* :class:`MemoryBudget` — hard all-or-nothing admission, named-owner
  ledger, loud :class:`BudgetExceeded` with the snapshot in the message;
* :class:`PageStore` — the cold tier: padded flat buffer, ``pages`` and
  ``data`` views of one memory, page-table-indirected reads;
* :class:`TieredStore` — the hot pool: demand admission, clock eviction
  with in-admission protection, thrash counting, async prefetch (a hint
  older than the last blocking admission is dropped), identity pinning,
  budget-sized slots, in-place page writes.
"""

import os
import gc

import numpy as np
import pytest
import torch

from raft_tpu_torch.store import (
    BudgetExceeded,
    MemoryBudget,
    PageStore,
    TieredStore,
    default_budget,
    set_default_budget,
)
from raft_tpu_torch.store import budget as budget_mod
from raft_tpu_torch.store.tiered import _runs

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# MemoryBudget


def test_budget_reserve_release_roundtrip():
    b = MemoryBudget(1000)
    b.reserve("a", 400)
    b.reserve("b", 300)
    assert b.reserved() == 700
    assert b.remaining() == 300
    assert b.would_fit(300) and not b.would_fit(301)
    b.release("a", 100)
    assert b.reserved() == 600
    b.release("a")
    assert b.reserved() == 300
    b.release("nope")
    assert b.reserved() == 300


def test_budget_reserve_is_all_or_nothing():
    b = MemoryBudget(100)
    b.reserve("a", 60)
    with pytest.raises(BudgetExceeded) as exc:
        b.reserve("b", 50)
    assert "'a': 60" in str(exc.value)
    assert "40B of 100B remaining" in str(exc.value)
    assert b.reserved() == 60
    b.reserve("b", 40)


def test_budget_rejects_bad_args():
    with pytest.raises(ValueError):
        MemoryBudget(0)
    b = MemoryBudget(10)
    with pytest.raises(ValueError):
        b.reserve("a", -1)


def test_budget_snapshot_is_json_shape():
    b = MemoryBudget(200)
    b.reserve("pool", 50)
    assert b.snapshot() == {
        "limit_bytes": 200,
        "reserved_bytes": 50,
        "remaining_bytes": 150,
        "utilization": 0.25,
        "owners": {"pool": 50},
    }


def test_default_budget_swap_and_restore():
    mine = MemoryBudget(123)
    prev = set_default_budget(mine)
    try:
        assert default_budget() is mine
    finally:
        set_default_budget(prev)
    assert default_budget() is prev


def test_default_budget_reads_the_environment_once(monkeypatch):
    monkeypatch.setattr(budget_mod, "_default", budget_mod._UNSET)
    monkeypatch.setenv("RAFT_TPU_PAGE_HBM_BUDGET_MB", "3")
    b = default_budget()
    assert b.limit_bytes == 3 << 20
    monkeypatch.setenv("RAFT_TPU_PAGE_HBM_BUDGET_MB", "7")
    assert default_budget() is b
    monkeypatch.setattr(budget_mod, "_default", budget_mod._UNSET)
    monkeypatch.setenv("RAFT_TPU_PAGE_HBM_BUDGET_MB", " ")
    assert default_budget() is None


# ---------------------------------------------------------------------------
# PageStore


def test_pagestore_layout_and_views():
    rows = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    ps = PageStore(rows, page_rows=4)
    assert ps.n_pages == 3
    assert tuple(ps.data.shape) == (12, 3)
    assert tuple(ps.pages.shape) == (3, 4, 3)
    np.testing.assert_array_equal(ps.data[:10].numpy(), rows)
    assert not ps.data[10:].any()
    ps.pages[1, 0, 0] = 99.0
    assert ps.data[4, 0] == 99.0
    assert ps.page_bytes == 4 * 3 * 4
    assert ps.nbytes == ps.data.nbytes + ps.page_table.nbytes
    assert ps.data.device.type == "cpu"


def test_pagestore_gather_and_to_array():
    rows = np.arange(20, dtype=np.int32).reshape(10, 2)
    ps = PageStore(rows, page_rows=4)
    assert torch.equal(ps.page(1), ps.pages[1])
    g = ps.gather([2, 0])
    assert torch.equal(g[0], ps.pages[2]) and torch.equal(g[1], ps.pages[0])
    out = ps.to_array()
    np.testing.assert_array_equal(out.numpy(), rows)
    assert out.data_ptr() == ps.data.data_ptr()     # a view, not a copy
    ps2 = PageStore(rows, page_rows=5)
    ps2.page_table = ps2.page_table.flip(0).contiguous()
    ps2.pages[:] = ps2.pages.flip(0).clone()
    np.testing.assert_array_equal(ps2.to_array().numpy(), rows)


def test_pagestore_keeps_bf16_rows_bitwise():
    rows = torch.randn(13, 6, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    ps = PageStore(rows, page_rows=8)
    assert ps.dtype == torch.bfloat16 and ps.page_bytes == 8 * 6 * 2
    assert torch.equal(ps.to_array(), rows)


def test_pagestore_rejects_bad_args():
    with pytest.raises(ValueError):
        PageStore(np.zeros(8), page_rows=0)
    with pytest.raises(ValueError):
        PageStore(np.float32(3.0), page_rows=4)


# ---------------------------------------------------------------------------
# TieredStore


def _tiered(n_rows=64, page_rows=8, d=4, **kw):
    rows = np.arange(n_rows * d, dtype=np.float32).reshape(n_rows, d)
    return TieredStore(PageStore(rows, page_rows), name="t", device="cpu", **kw), rows


def _device_page(tiered, page):
    pool, page_slot = tiered.view()
    return pool[int(page_slot[page])]


def test_ensure_resident_hits_misses_and_view():
    t, _rows = _tiered()
    assert t.n_pages == 8 and t.slots == 8
    t.ensure_resident([0, 3])
    assert t.stats()["misses"] == 2 and t.stats()["hits"] == 0
    assert t.resident_count == 2
    t.ensure_resident([3, 5])
    st = t.stats()
    assert st["misses"] == 3 and st["hits"] == 1
    for p in (0, 3, 5):
        assert torch.equal(_device_page(t, p), t.store.pages[p])
    assert int(t.view()[1][1]) == -1
    np.testing.assert_array_equal(np.sort(t.resident_pages()), [0, 3, 5])


def test_request_larger_than_pool_is_loud():
    t, _ = _tiered(max_slots=3)
    with pytest.raises(BudgetExceeded, match="4 pages requested"):
        t.ensure_resident([0, 1, 2, 3])
    t.ensure_resident([0, 1, 2])
    assert t.resident_count == 3


def test_clock_eviction_and_protection():
    t, _ = _tiered(max_slots=4)
    t.ensure_resident([0, 1, 2, 3])
    t.ensure_resident([4, 5, 6, 7])
    st = t.stats()
    assert st["evictions"] == 4 and st["resident"] == 4
    np.testing.assert_array_equal(np.sort(t.resident_pages()), [4, 5, 6, 7])
    for p in (4, 5, 6, 7):
        assert torch.equal(_device_page(t, p), t.store.pages[p])
    assert (t.view()[1][:4] == -1).all()


def test_explicit_evict_returns_page_ids():
    t, _ = _tiered(max_slots=4)
    t.ensure_resident([0, 1, 2])
    out = t.evict(2)
    assert len(out) == 2 and set(out) <= {0, 1, 2}
    assert t.resident_count == 1
    assert (t.view()[1][out] == -1).all()
    assert len(t.evict(10)) == 1
    assert t.resident_count == 0


def test_thrash_counter_fires_on_refetch_within_window():
    t, _ = _tiered(max_slots=2)
    for _ in range(4):
        t.ensure_resident([0, 1])
        t.ensure_resident([2, 3])
    st = t.stats()
    assert st["thrash"] > 0
    assert st["evictions"] >= 6


def test_prefetch_is_async_and_counted():
    t, _ = _tiered()
    assert t.prefetch([1, 2]) is True
    t._prefetch_q.join()
    assert t.resident_count == 2
    assert t.stats()["prefetched"] == 2
    assert t.prefetch([1, 2]) is True
    assert t.stats()["prefetched"] == 2
    assert torch.equal(_device_page(t, 2), t.store.pages[2])


def test_prefetch_hint_older_than_an_admission_is_dropped():
    """A hint queued before a blocking admission is dropped unrun: run
    later, it could evict a page that admission promised to a scan not yet
    enqueued."""
    t, _ = _tiered(max_slots=2)
    gate = t._lock
    with gate:                                   # hold the worker off
        assert t.prefetch([4, 5]) is True
        t.ensure_resident([0, 1])
    t._prefetch_q.join()
    np.testing.assert_array_equal(np.sort(t.resident_pages()), [0, 1])
    assert t.prefetched == 0 and t.evictions == 0


def test_pin_identity_bitwise_and_refusals():
    t, rows = _tiered()
    t.ensure_resident([5])
    t.pin_identity()
    assert t.stats()["pinned"] is True
    pool, page_slot = t.view()
    assert torch.equal(page_slot, torch.arange(8, dtype=torch.int32))
    assert torch.equal(pool.reshape(-1, rows.shape[1]), t.store.data)
    t.pin_identity()
    with pytest.raises(RuntimeError, match="pinned"):
        t.evict(1)
    small, _ = _tiered(max_slots=4)
    with pytest.raises(BudgetExceeded, match="identity pinning"):
        small.pin_identity()


def test_budget_sizes_slots_and_close_releases():
    rows = np.zeros((64, 4), np.float32)
    store = PageStore(rows, 8)
    budget = MemoryBudget(3 * store.page_bytes + 4 * store.n_pages)
    t = TieredStore(store, name="b", budget=budget, device="cpu")
    assert t.slots == 3
    assert budget.reserved() == 3 * store.page_bytes + 4 * store.n_pages
    t.close()
    assert budget.reserved() == 0
    t.close()
    tiny = MemoryBudget(10)
    with pytest.raises(BudgetExceeded, match="single"):
        TieredStore(store, name="tiny", budget=tiny, device="cpu")


def test_dropped_store_returns_its_budget():
    """The prefetch thread holds its store weakly, so a store dropped with
    its thread parked on the queue is collected and its reservation
    released."""
    store = PageStore(np.zeros((64, 4), np.float32), 8)
    budget = MemoryBudget(10 * store.page_bytes)
    t = TieredStore(store, name="gc", budget=budget, device="cpu")
    t.prefetch([1])
    t._prefetch_q.join()
    assert budget.reserved() > 0
    del t
    gc.collect()
    assert budget.reserved() == 0


def test_stats_and_nbytes_account_both_tiers():
    t, _ = _tiered(max_slots=4)
    st = t.stats()
    assert st["slots"] == 4 and st["n_pages"] == 8
    assert st["host_only"] == 8 and st["resident"] == 0
    assert st["hot_bytes"] == t.nbytes
    assert st["cold_bytes"] == t.store.nbytes
    pool, page_slot = t.view()
    assert t.nbytes == pool.nbytes + page_slot.nbytes


def test_pages_are_written_in_place():
    """Admissions and evictions rewrite the pool and the table in place:
    the tensors a view handed out stay the store's tensors."""
    t, _ = _tiered(max_slots=3)
    pool, page_slot = t.view()
    t.ensure_resident([0, 1, 2])
    t.ensure_resident([5, 6])
    t.evict(1)
    assert t.view()[0] is pool and t.view()[1] is page_slot
    for p in t.resident_pages():
        assert torch.equal(pool[int(page_slot[p])], t.store.pages[p])


def test_tiered_store_needs_a_device_choice_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredStore(PageStore(np.zeros((8, 2), np.float32), 8))


@pytest.mark.parametrize("src,dst,runs", [
    ([3], [7], [(3, 7, 1)]),
    ([0, 1, 2, 5], [4, 5, 6, 7], [(0, 4, 3), (5, 7, 1)]),
    ([0, 1, 2], [2, 1, 0], [(0, 2, 1), (1, 1, 1), (2, 0, 1)]),
])
def test_page_copies_coalesce_runs(src, dst, runs):
    assert list(_runs(np.asarray(src), np.asarray(dst))) == runs


# ---------------------------------------------------------------------------
# raft_tpu's TieredStore and the port's, one scripted sequence


SEQUENCES = {
    # a pool of 5 slots over 16 pages: fills, second chances, protected hits
    "mixed": [("ensure", [0, 1, 2]), ("ensure", [3, 4]), ("ensure", [0, 5, 6]),
              ("evict", 2), ("ensure", [7, 8, 1]), ("ensure", [2, 3, 4, 9]),
              ("evict", 1), ("ensure", [10, 11, 12, 13, 14]), ("ensure", [0, 12, 15])],
    # ping-pong working sets: thrash
    "pingpong": [("ensure", [0, 1, 2])] + [("ensure", s) for s in ([3, 4, 5], [0, 1, 2]) * 4],
    # single pages cycling past the pool, with explicit evictions between
    "cycle": [op for p in range(16) for op in (("ensure", [p, (p + 7) % 16]), ("evict", p % 2))],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_tiered_store_matches_raft_tpu(name):
    """Equal slots, the same victims at every evict, the same placement
    (resident pages by slot, the device tables) and the same counters after
    every step; the pools hold the same rows in the same slots."""
    from raft_tpu.store import MemoryBudget as JMemoryBudget
    from raft_tpu.store import PageStore as JPageStore
    from raft_tpu.store import TieredStore as JTieredStore

    rows = np.random.default_rng(3).standard_normal((16 * 8, 6)).astype(np.float32)
    limit = 5 * (8 * 6 * 4) + 4 * 16 + 7     # five 192-byte pages and the table
    jb, tb = JMemoryBudget(limit), MemoryBudget(limit)
    j = JTieredStore(JPageStore(rows, 8), name="j", budget=jb)
    t = TieredStore(PageStore(rows, 8), name="t", budget=tb, device="cpu")
    assert j.slots == t.slots == 5 and jb.reserved() == tb.reserved()
    for op, arg in SEQUENCES[name]:
        if op == "ensure":
            j.ensure_resident(arg)
            t.ensure_resident(arg)
        else:
            assert j.evict(arg) == t.evict(arg)
        np.testing.assert_array_equal(j.resident_pages(), t.resident_pages())
        np.testing.assert_array_equal(np.asarray(j.view()[1]), t.view()[1].numpy())
        for key in ("hits", "misses", "evictions", "thrash", "resident"):
            assert j.stats()[key] == t.stats()[key], (op, arg, key)
    np.testing.assert_array_equal(np.asarray(j.view()[0]), t.view()[0].numpy())
    assert t.evictions > 0


def test_concurrent_admissions_keep_the_placement_consistent():
    """Threads admitting, prefetching and evicting on one store (more
    threads than cores, a short switch interval): afterwards the host
    mirrors are one bijection, the device table agrees with them, and
    every resident page's slot holds its rows."""
    import os
    import sys
    import threading

    t, _ = _tiered(n_rows=32 * 8, page_rows=8, max_slots=12)
    n_threads = 2 * (os.cpu_count() or 2) + 2
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(60):
                op = rng.integers(3)
                pages = rng.choice(32, size=rng.integers(1, 6), replace=False)
                if op == 0:
                    t.ensure_resident(pages)
                elif op == 1:
                    t.prefetch(pages)
                else:
                    t.evict(int(rng.integers(1, 4)))
        except Exception as exc:  # collected and asserted below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    t._prefetch_q.join()
    assert errors == []
    resident = np.flatnonzero(t._resident >= 0)
    assert len(resident) == t.resident_count <= t.slots
    for page in resident:
        slot = int(t._resident[page])
        assert t._slot_page[slot] == page
        assert int(t.view()[1][page]) == slot
        assert torch.equal(t.view()[0][slot], t.store.pages[page])
    assert (t.view()[1][t._resident < 0] == -1).all()
    assert t.misses + t.prefetched == t.evictions + len(resident)
