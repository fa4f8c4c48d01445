"""Paged search through the port's entry points (``raft_tpu_torch.store``)
on raft_tpu's fixture sizes (``tests/test_store_paged_index.py``: N 400, D
24, 8-row pages, 16 lists):

* a paginated index's search is **bitwise** the port's monolithic search of
  the same index, on all four backends, unfiltered and filtered, both IVF
  schedules, every IVF-PQ scan cache and ``lut_dtype``;
* against raft_tpu's paged search of the index raft_tpu built and saved:
  ids equal, distances within 1e-6 relative (raft_tpu's own paged IVF-PQ
  search differs from its monolithic one by an ulp: XLA sums the paged
  gather in another order);
* an IVF index served over budget evicts and still matches; the dense
  backends raise ``BudgetExceeded``; ``extend`` is refused; kk past the
  page rows; ``page_rows`` not a multiple of 8 raises; a prefetch, search,
  evict, search sequence; ``save`` writes raft_tpu's format;
* the plain paged scan against raft_tpu's paged Pallas scan, and the plain
  paged hop against raft_tpu's paged Pallas hop (interpret mode), on
  scattered page placements.
"""

import os
import copy
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.kernels.cagra_traverse import cagra_fused_hop as j_hop
from raft_tpu.kernels.ivf_scan import ivf_scan_probe_major as j_probe_major
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.store import PagedLists as JPagedLists
from raft_tpu.store import PagedRows as JPagedRows
from raft_tpu.store import paginate_index as j_paginate
from raft_tpu_torch import kernels
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.kernels import cagra_traverse as ct
from raft_tpu_torch.kernels import ivf_scan as tscan
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.store import (
    BudgetExceeded,
    MemoryBudget,
    PagedLists,
    gather_lists,
    paginate_index,
)

from _torch_parity import assert_topk_match, hop_inputs, paged_lists, paged_rows

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
N, D, K = 400, 24, 10
PR = 8
KINDS = ("brute_force", "ivf_flat", "ivf_pq", "cagra")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((16, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def masks():
    rng = np.random.default_rng(5)
    return {"keep": rng.random(N) < 0.5, "dead": rng.random(N) < 0.1}


@pytest.fixture(scope="module")
def saved(corpus, tmp_path_factory):
    """raft_tpu's indexes (built with raft_tpu's fixture parameters), their
    files, and the port's indexes loaded from those files."""
    x, _ = corpus
    d = tmp_path_factory.mktemp("paged")
    built = {
        "ivf_flat": jivf.build(jivf.IndexParams(n_lists=16), x),
        "ivf_pq": jpq.build(jpq.IndexParams(n_lists=16, pq_dim=24, pq_bits=8), x),
        "cagra": jcagra.build(jcagra.IndexParams(graph_degree=32), x),
    }
    out = {}
    for kind, idx in built.items():
        jmod, tmod = {"ivf_flat": (jivf, tivf), "ivf_pq": (jpq, tpq),
                      "cagra": (jcagra, tcagra)}[kind]
        path = str(d / kind)
        jmod.save(path, idx)
        out[kind] = (idx, path, tmod.load(path, res=CPU))
    out["brute_force"] = (jbf.build(x), None, tbf.build(x, res=CPU))
    return out


def _search(kind, index, q, k, *, strategy="auto", sp=None, **kw):
    if kind == "brute_force":
        return tbf.search(index, q, k, res=CPU, **kw)
    if kind == "cagra":
        return tcagra.search(sp or tcagra.SearchParams(itopk_size=128), index, q, k, res=CPU,
                             **kw)
    mod = tivf if kind == "ivf_flat" else tpq
    params = sp or mod.SearchParams(n_probes=16, strategy=strategy)
    return mod.search(params, index, q, k, res=CPU, **kw)


def _filter(name, masks):
    if name == "bitset":
        return {"sample_filter": Bitset.from_mask(masks["keep"], device="cpu")}
    if name == "tomb":
        return {"deleted_mask": Bitset.from_mask(masks["dead"], device="cpu")}
    return {}


def _bitwise(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _paged_copy(index, **kw):
    paged = copy.copy(index)
    tiered = paginate_index(paged, page_rows=kw.pop("page_rows", PR), **kw)
    return paged, tiered


# ---------------------------------------------------------------------------
# paged vs monolithic, bitwise


@pytest.mark.parametrize("filt", ["none", "bitset", "tomb"])
@pytest.mark.parametrize("kind", KINDS)
def test_paged_search_bitwise_equals_monolithic(saved, corpus, masks, kind, filt):
    _, q = corpus
    mono = saved[kind][2]
    paged, tiered = _paged_copy(mono, budget=None, name=f"bitwise:{kind}")
    assert tiered is paged.paged and tiered.n_pages > 1
    payload = paged.dataset if kind in ("brute_force", "cagra") else paged.list_data
    assert payload.device.type == "cpu" and tiered.pool.device.type == "cpu"
    kw = _filter(filt, masks)
    for strategy in (("query_major", "probe_major") if kind.startswith("ivf") else ("auto",)):
        _bitwise(_search(kind, paged, q, K, strategy=strategy, **kw),
                 _search(kind, mono, q, K, strategy=strategy, **kw))
    assert kernels.consume_kernel_path() == "torch"
    # idempotent: a second paginate returns the same pager, untouched
    assert paginate_index(paged) is tiered


@pytest.mark.parametrize("decoded,lut", [("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                                         ("float32", "float32"), ("int8", "float32")])
def test_paged_ivf_pq_storage_legs_bitwise(saved, corpus, masks, decoded, lut):
    _, q = corpus
    mono = tpq.with_decoded_dtype(saved["ivf_pq"][2], decoded)
    paged, _ = _paged_copy(mono, budget=None)
    assert paged.list_data.dtype == mono.list_data.dtype
    assert paged.list_codes.device.type == "cpu"
    for strategy in ("query_major", "probe_major"):
        sp = tpq.SearchParams(n_probes=16, strategy=strategy, lut_dtype=lut)
        for kw in ({}, _filter("bitset", masks)):
            _bitwise(_search("ivf_pq", paged, q, K, sp=sp, **kw),
                     _search("ivf_pq", mono, q, K, sp=sp, **kw))


@pytest.mark.parametrize("kind", ("ivf_flat", "ivf_pq"))
def test_kk_past_the_page_rows(saved, corpus, kind):
    """k = 20 > 8 page rows: raft_tpu's paged Pallas leg folds per page and
    stops at kk = page_rows; the port's one leg serves any kk."""
    _, q = corpus
    mono = saved[kind][2]
    paged, _ = _paged_copy(mono, budget=None)
    for strategy in ("query_major", "probe_major"):
        _bitwise(_search(kind, paged, q, 20, strategy=strategy),
                 _search(kind, mono, q, 20, strategy=strategy))


# ---------------------------------------------------------------------------
# against raft_tpu's paged search


@pytest.mark.parametrize("kind", KINDS)
def test_paged_search_matches_raft_tpu_paged(saved, corpus, kind):
    """Both packages paginate the index raft_tpu saved (8-row pages, no
    budget) and search it: ids equal, distances within 1e-6 relative."""
    x, q = corpus
    jidx, path, tidx = saved[kind]
    jmod, tmod = {"brute_force": (jbf, tbf), "ivf_flat": (jivf, tivf), "ivf_pq": (jpq, tpq),
                  "cagra": (jcagra, tcagra)}[kind]
    jpaged = jbf.build(x) if kind == "brute_force" else jmod.load(path)
    j_paginate(jpaged, page_rows=PR, budget=None, name=f"raft:{kind}")
    tpaged, _ = _paged_copy(tidx, budget=None)
    if kind == "brute_force":
        jv, ji = jbf.search(jpaged, q, K)
        tv, ti = tbf.search(tpaged, q, K, res=CPU)
    elif kind == "cagra":
        jsp, tsp = jcagra.SearchParams(itopk_size=128), tcagra.SearchParams(itopk_size=128)
        seeds = np.asarray(jcagra.make_seed_ids(jsp, jidx, jnp.asarray(q), K))
        jv, ji = jcagra.search(jsp, jpaged, q, K, seed_ids=seeds)
        tv, ti = tcagra.search(tsp, tpaged, q, K, seed_ids=seeds, res=CPU)
    else:
        jv, ji = jmod.search(jmod.SearchParams(n_probes=16), jpaged, q, K)
        tv, ti = tmod.search(tmod.SearchParams(n_probes=16), tpaged, q, K, res=CPU)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ("ivf_flat", "ivf_pq", "cagra"))
def test_save_of_a_paged_index_loads_in_raft_tpu(saved, corpus, kind, tmp_path):
    """``save`` writes the host view at the page-aligned capacity in
    raft_tpu's format: raft_tpu loads it and finds what the port finds."""
    _, q = corpus
    tmod, jmod = {"ivf_flat": (tivf, jivf), "ivf_pq": (tpq, jpq), "cagra": (tcagra, jcagra)}[kind]
    paged, _ = _paged_copy(saved[kind][2], budget=None)
    tmod.save(str(tmp_path / kind), paged)
    back = jmod.load(str(tmp_path / kind))
    if kind == "cagra":
        np.testing.assert_array_equal(np.asarray(back.dataset), paged.dataset.numpy())
        return
    assert back.list_cap == paged.list_cap and back.list_cap % PR == 0
    jv, ji = jmod.search(jmod.SearchParams(n_probes=16), back, q, K)
    tv, ti = tmod.search(tmod.SearchParams(n_probes=16), paged, q, K, res=CPU)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# budgets, refusals, residency sequences


def _ivf_page_budget(index, frac: float) -> MemoryBudget:
    """A budget granting ``frac`` of the index's pages (the TieredStore
    admission formula run backwards, as raft_tpu's test sizes it)."""
    ld = index.list_data
    ppl = -(-ld.shape[1] // PR)
    n_pages = ld.shape[0] * ppl
    page_bytes = PR * int(np.prod(ld.shape[2:])) * ld.element_size()
    slots = max(1, int(frac * n_pages))
    return MemoryBudget(slots * page_bytes + 4 * n_pages)


@pytest.mark.parametrize("kind", ("ivf_flat", "ivf_pq"))
def test_ivf_serves_payload_larger_than_hot_pool(saved, corpus, kind):
    """Slots < pages, a query at a time: every search bitwise the
    monolithic one while the clock pager evicts."""
    _, q = corpus
    mono = saved[kind][2]
    paged, tiered = _paged_copy(mono, budget=_ivf_page_budget(mono, 0.6), name=f"over:{kind}")
    assert tiered.slots < tiered.n_pages
    mod = tivf if kind == "ivf_flat" else tpq
    sp = mod.SearchParams(n_probes=4)
    for row in q:
        _bitwise(mod.search(sp, paged, row[None], K, res=CPU),
                 mod.search(sp, mono, row[None], K, res=CPU))
    st = tiered.stats()
    assert st["misses"] > 0 and st["evictions"] > 0, st


def _search_from_threads(search, batches, n_threads=4, rounds=3):
    """Each of ``n_threads`` threads runs ``search`` over every batch
    ``rounds`` times, all starting together; returns each thread's results
    in batch order."""
    barrier = threading.Barrier(n_threads)
    results = [[] for _ in range(n_threads)]
    errors = []

    def worker(t):
        try:
            barrier.wait()
            for r in range(rounds):
                # threads walk the batches from different starting points, so
                # their admissions evict one another's pages
                for b in range(len(batches)):
                    i = (b + t * len(batches) // n_threads + r) % len(batches)
                    results[t].append((i, search(batches[i])))
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    return results


@pytest.mark.parametrize("kind", ("ivf_flat", "ivf_pq"))
def test_threads_searching_one_index_over_budget(saved, corpus, kind):
    """Four threads searching one index whose pool holds 60 % of its pages,
    in batches of two queries: every result bitwise the single-thread
    search (each search holds the store's guard from its admission until
    its scans are enqueued, so no other thread's admission evicts a page
    between them)."""
    _, q = corpus
    mono = saved[kind][2]
    paged, tiered = _paged_copy(mono, budget=_ivf_page_budget(mono, 0.6), name=f"thr:{kind}")
    assert tiered.slots < tiered.n_pages
    mod = tivf if kind == "ivf_flat" else tpq
    sp = mod.SearchParams(n_probes=4)
    batches = [q[s:s + 2] for s in range(0, len(q), 2)]
    want = [mod.search(sp, mono, b, K, res=CPU) for b in batches]
    for per_thread in _search_from_threads(lambda b: mod.search(sp, paged, b, K, res=CPU),
                                           batches):
        for i, got in per_thread:
            _bitwise(got, want[i])
    assert tiered.stats()["evictions"] > 0


def test_batch_whose_pages_exceed_the_pool_is_loud(saved, corpus):
    _, q = corpus
    mono = saved["ivf_flat"][2]
    paged, tiered = _paged_copy(mono, budget=_ivf_page_budget(mono, 0.3))
    with pytest.raises(BudgetExceeded, match="pages requested"):
        tivf.search(tivf.SearchParams(n_probes=16), paged, q, K, res=CPU)


@pytest.mark.parametrize("kind", ("brute_force", "cagra"))
def test_dense_backends_fail_loud_when_over_budget(saved, corpus, kind):
    _, q = corpus
    n_pages = -(-N // PR)
    paged, _ = _paged_copy(saved[kind][2], budget=MemoryBudget(3 * PR * D * 4 + 4 * n_pages))
    with pytest.raises(BudgetExceeded, match="identity pinning"):
        _search(kind, paged, q, K)


@pytest.mark.parametrize("kind", ("ivf_flat", "ivf_pq"))
def test_extend_on_paged_index_is_refused(saved, corpus, kind):
    x, _ = corpus
    paged, _ = _paged_copy(saved[kind][2], budget=None)
    mod = tivf if kind == "ivf_flat" else tpq
    with pytest.raises(ValueError, match="paged"):
        mod.extend(paged, x[:4], res=CPU)


@pytest.mark.parametrize("page_rows", [4, 12, 1001])
def test_page_rows_must_be_a_multiple_of_8(saved, page_rows):
    with pytest.raises(ValueError, match="multiple of 8"):
        paginate_index(copy.copy(saved["ivf_flat"][2]), page_rows=page_rows)


def test_unsupported_index_kind_is_refused():
    with pytest.raises(ValueError, match="unsupported index kind"):
        paginate_index(object(), page_rows=PR)


def test_default_page_rows_come_from_the_environment(saved, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PAGE_ROWS", "16")
    paged = copy.copy(saved["brute_force"][2])
    assert paginate_index(paged, budget=None).page_rows == 16


def test_prefetch_search_evict_search(saved, corpus):
    """A prefetch, then a search, then an evict, then a search: each result
    equals the monolithic one (pages move in place, in stream order)."""
    _, q = corpus
    mono = saved["ivf_flat"][2]
    paged, tiered = _paged_copy(mono, budget=_ivf_page_budget(mono, 0.6))
    sp = tivf.SearchParams(n_probes=4)
    assert tiered.prefetch(range(tiered.n_pages // 2))
    tiered._prefetch_q.join()
    assert tiered.prefetched > 0
    for i, row in enumerate(q[:6]):
        _bitwise(tivf.search(sp, paged, row[None], K, res=CPU),
                 tivf.search(sp, mono, row[None], K, res=CPU))
        assert len(tiered.evict(5 + i)) > 0
    assert tiered.evictions > 0


def test_pinned_pool_is_the_dataset_bitwise(saved):
    """After identity pinning the flat pool is the rows: brute force relies
    on it."""
    paged, tiered = _paged_copy(saved["brute_force"][2], budget=None)
    tbf.search(paged, np.zeros((1, D), np.float32), 1, res=CPU)
    assert tiered.stats()["pinned"]
    assert torch.equal(tiered.pool.reshape(-1, D)[:N], saved["brute_force"][2].dataset)


def test_ivf_sidecars_repadded_with_the_builds_padding(saved):
    mono = saved["ivf_flat"][2]
    paged, tiered = _paged_copy(mono, page_rows=16, budget=None)
    cap, cap2 = mono.list_cap, paged.list_cap
    assert cap2 % 16 == 0 and cap2 >= cap
    assert torch.equal(paged.list_data[:, :cap], mono.list_data)
    assert (paged.list_index[:, cap:] == -1).all() and torch.isinf(paged.list_norms[:, cap:]).all()
    pq = saved["ivf_pq"][2]
    ppq, _ = _paged_copy(pq, page_rows=16, budget=None)
    assert (ppq.list_y2[:, pq.list_cap:] == 0).all() and (ppq.list_codes[:, pq.list_cap:] == 0).all()
    # the monolithic index is left as it was
    assert mono.list_data.shape[1] == cap and mono.paged is None


# ---------------------------------------------------------------------------
# kernel level: plain paged legs against raft_tpu's paged Pallas legs


@pytest.mark.parametrize("storage,scan_dtype", [("float32", "highest"), ("bfloat16", "float32"),
                                                ("bfloat16", "bfloat16"), ("int8", "float32")])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_plain_paged_scan_matches_pallas_paged(storage, scan_dtype, metric):
    """The plain probe-major scan over a scattered PagedLists against
    raft_tpu's ``_ivf_scan_probe_major_paged`` (interpret mode) over the
    same placement, kk = page_rows; and bitwise the plain scan of the
    monolithic lists."""
    rng = np.random.default_rng(7)
    L, cap, d, B, G = 6, 40, 16, 7, 16
    data = rng.standard_normal((L, cap, d)).astype(np.float32)
    ids = np.arange(L * cap, dtype=np.int32).reshape(L, cap)
    for l in range(L):
        ids[l, cap - 5 * l:] = -1
    data[ids < 0] = 0.0
    scale = 0.0173 if storage == "int8" else 1.0
    if storage == "int8":
        t_data = torch.from_numpy(np.clip(np.rint(data / 0.25), -127, 127).astype(np.int8))
    else:
        t_data = torch.from_numpy(data).to(getattr(torch, storage))
    vals = t_data.to(torch.float32) * (scale if storage == "int8" else 1.0)
    y2 = torch.where(torch.from_numpy(ids) >= 0, (vals * vals).sum(-1), torch.zeros(()))
    paged = paged_lists(t_data, PR, 3)
    assert not torch.equal(paged.page_slot, torch.arange(paged.page_slot.numel(),
                                                         dtype=torch.int32))
    bl = rng.integers(0, L, B).astype(np.int32)
    qg = (rng.standard_normal((B, G, d)) * 0.5).astype(np.float32)
    q2g = (qg * qg).sum(-1).astype(np.float32)
    q2g[:, 11:] = np.inf
    args = (torch.from_numpy(bl), torch.from_numpy(qg), torch.from_numpy(q2g))
    kw = dict(metric=metric, scan_dtype=scan_dtype, scan_scale=scale)
    got = tscan.ivf_scan_probe_major(*args, paged, y2, torch.from_numpy(ids), PR, **kw)
    _bitwise(got, tscan.ivf_scan_probe_major(*args, t_data, y2, torch.from_numpy(ids), PR, **kw))
    j_pool = jnp.asarray(paged.pool.to(torch.float32).numpy()).astype(
        {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[storage])
    ref = j_probe_major(jnp.asarray(bl), jnp.asarray(qg), jnp.asarray(q2g),
                        JPagedLists(j_pool, jnp.asarray(paged.page_slot.numpy()),
                                    paged.pages_per_list),
                        jnp.asarray(y2.numpy()), jnp.asarray(ids), PR, interpret=True, **kw)
    assert_topk_match(*got, *ref, atol=1e-4)


@pytest.mark.parametrize("schedule", ["probe_major", "query_major"])
def test_plain_paged_scans_read_through_the_table(schedule):
    """Both plain scans over a scattered PagedLists (filtered too) are
    bitwise the monolithic plain scans, and ``gather_lists`` is the
    monolithic gather."""
    g = torch.Generator().manual_seed(2)
    L, cap, d = 5, 32, 12
    data = torch.randn(L, cap, d, generator=g)
    ids = torch.arange(L * cap, dtype=torch.int32).reshape(L, cap)
    ids[:, 27:] = -1
    y2 = torch.where(ids >= 0, (data * data).sum(-1), torch.zeros(()))
    paged = paged_lists(data, PR, 8)
    lists = torch.tensor([[4, 0], [2, 2]])
    assert torch.equal(gather_lists(paged, lists), data[lists])
    words = tscan.pack_list_filter(ids, Bitset.from_mask(torch.rand(L * cap, generator=g) < 0.5,
                                                         device="cpu").words)
    if schedule == "probe_major":
        qg = torch.randn(6, 9, d, generator=g)
        args = (torch.randint(0, L, (6,), generator=g, dtype=torch.int32), qg, (qg * qg).sum(-1))
    else:
        q = torch.randn(11, d, generator=g)
        args = (torch.randint(0, L, (11, 3), generator=g, dtype=torch.int32), q, (q * q).sum(1))
    scan = getattr(tscan, f"ivf_scan_{schedule}")
    for kw in ({}, {"list_filter": words}):
        _bitwise(scan(*args, paged, y2, ids, 12, **kw), scan(*args, data, y2, ids, 12, **kw))
    assert tscan.kernel_name(schedule, paged, words) == f"ivf_scan_{schedule}_paged_filt"


@pytest.mark.parametrize("metric,dtype", [("sqeuclidean", "float32"),
                                          ("inner_product", "float32"),
                                          ("sqeuclidean", "bfloat16")])
def test_plain_paged_hop_matches_pallas_paged(metric, dtype):
    """The plain hop over a scattered PagedRows: bitwise the dense plain
    hop, and against raft_tpu's ``_hop_kernel_paged`` (interpret mode) on
    the same placement: ids and flags equal, values within rtol 1e-5 / atol
    1e-4 (the two sum |v|^2 in other orders)."""
    x, graph, q, parents, buf_d, buf_i, explored = hop_inputs(3, metric)
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    paged = paged_rows(x, PR, 5)
    got = ct.cagra_fused_hop(paged, graph, q, parents, buf_d, buf_i, explored, metric=metric)
    assert kernels.consume_kernel_path() == "torch"
    dense = ct.cagra_fused_hop(x, graph, q, parents, buf_d, buf_i, explored, metric=metric)
    for a, b in zip(got, dense):
        assert torch.equal(a, b)
    j_pool = jnp.asarray(paged.pool.to(torch.float32).numpy()).astype(getattr(jnp, dtype))
    ref = j_hop(JPagedRows(j_pool, jnp.asarray(paged.page_slot.numpy()), paged.n_rows),
                *(jnp.asarray(t.numpy()) for t in (graph, q, parents, buf_d, buf_i, explored)),
                metric=metric, interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert ct.traverse_supported(paged, buf_d.shape[1])


def test_paged_views_mirror_the_monolithic_shapes():
    data = torch.zeros(3, 16, 5, dtype=torch.bfloat16)
    paged = paged_lists(data, PR, 1)
    assert isinstance(paged, PagedLists)
    assert paged.shape == (3, 16, 5) and paged.dtype == torch.bfloat16
    assert paged.page_rows == PR and paged.device.type == "cpu"
    rows = paged_rows(torch.randn(21, 4), PR, 2)
    assert rows.shape == (21, 4) and rows.page_rows == PR
    ids = torch.tensor([0, 20, 25, -3])
    assert torch.equal(rows.decode(ids)[2], rows.decode(torch.tensor([20]))[0])


def test_paged_views_with_a_short_page_table_are_refused():
    data = torch.zeros(3, 16, 5)
    short = PagedLists(paged_lists(data, PR, 1).pool, torch.zeros(5, dtype=torch.int32), 2)
    args = (torch.zeros(1, dtype=torch.int32), torch.zeros(1, 2, 5), torch.zeros(1, 2))
    with pytest.raises(ValueError, match="list_y2|page table"):
        tscan.ivf_scan_probe_major(*args, short, torch.zeros(3, 16), torch.zeros(3, 16,
                                   dtype=torch.int32), 4)
    x, *rest = hop_inputs(4, "sqeuclidean")
    rows = paged_rows(x, PR, 3)
    rows.page_slot = rows.page_slot[:-1]
    with pytest.raises(ValueError, match="cannot hold"):
        ct.cagra_fused_hop(rows, *rest, metric="sqeuclidean")
