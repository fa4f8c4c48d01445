"""Port parity of ``serve.SearchService`` on the CPU: answers equal a direct
``search`` of the same queries (single and batched requests, pipeline
depth 1 and 2, each query alone), overload (deadlines, shedding, degraded
effort), hot swap, ``stats()`` / ``healthz()`` / ``prometheus()`` keys
against raft_tpu's service, ``compact_now`` on IVF-Flat held by ids to
raft_tpu's compaction of the same state (other kinds by recall), the
per-thread build counter, and every refused option naming its ROADMAP
item.  No test reads the clock against a bound; every thread is joined
with a timeout."""

import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from raft_tpu import serve as jserve
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.serve import compactor as jcompactor
from raft_tpu.serve import mutation as jmut
from raft_tpu.serve import overload as joverload
from raft_tpu.serve import registry as jregistry
from raft_tpu_torch import obs
from raft_tpu_torch import serve
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import device_events
from raft_tpu_torch.serve import compactor as tcompactor
from raft_tpu_torch.serve import metrics as tmetrics
from raft_tpu_torch.serve import overload as toverload
from raft_tpu_torch.serve import registry as tregistry
from raft_tpu_torch.stats.metrics import recall_at_k

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
N, D, K = 500, 20, 10
JOIN_S = 120


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((24, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def flat(data):
    x, _ = data
    return tflat.build(tflat.IndexParams(n_lists=10, kmeans_n_iters=5), x, res=CPU)


SP = tflat.SearchParams(n_probes=4)


def _service(flat, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_delay_ms", 1.0)
    svc = serve.SearchService(k=K, **kw)
    svc.add_index("a", serve.MutableIndex(flat, search_params=SP), warmup=True)
    return svc


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()


@pytest.mark.parametrize("depth", [1, 2])
def test_answers_equal_direct_search_of_each_query_alone(flat, data, depth):
    """Single-query and 3-row requests from four client threads: every
    answer equals ``ivf_flat.search`` of that query alone, bitwise; the
    batches fill pow2 buckets and no kernel build lands on the dispatch
    thread after warmup."""
    _, q = data
    svc = _service(flat, pipeline_depth=depth)
    try:
        got = {}

        def client(lo):
            futs = [(i, svc.submit("a", q[i])) for i in range(lo, lo + 3)]
            futs.append(("b", svc.submit("a", q[lo + 3: lo + 6])))
            for key, f in futs:
                got[(lo, key)] = f.result(JOIN_S)

        threads = [threading.Thread(target=client, args=(lo,)) for lo in (0, 6, 12, 18)]
        for t in threads:
            t.start()
        _join(threads)
        for (lo, key), (dist, ids) in got.items():
            rows = [key] if key != "b" else list(range(lo + 3, lo + 6))
            for r, row in enumerate(rows):
                wv, wi = tflat.search(SP, flat, q[row:row + 1], K, res=CPU)
                d, i = (dist, ids) if key != "b" else (dist[r], ids[r])
                np.testing.assert_array_equal(i, wi[0].numpy())
                np.testing.assert_array_equal(d, wv[0].numpy())
        st = svc.stats("a")
        assert st["requests"] == 16 and st["recompiles"] == 0
        assert st["pipeline_depth"] == depth and st["inflight_peak"] <= depth
        assert set(st["kernel_paths"]) == {"torch"}
        assert set(int(b) for b in st["bucket_fill"]) <= {1, 2, 4, 8}
    finally:
        svc.stop()


def test_depth_two_results_are_bitwise_depth_one(flat, data):
    """The same request stream at pipeline depth 1 and 2 (start=False and
    flush: fixed batching) gives the same bytes."""
    _, q = data
    outs = []
    for depth in (1, 2):
        svc = _service(flat, pipeline_depth=depth, start=False)
        try:
            futs = [svc.submit("a", q[i:i + 1 + i % 3]) for i in range(0, 20, 2)]
            svc.flush()
            outs.append([f.result(0) for f in futs])
        finally:
            svc.stop()
    for (d1, i1), (d2, i2) in zip(*outs):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1.view(np.int32), d2.view(np.int32))


def test_mutations_between_batches_and_hot_swap(flat, data):
    """Upserts and deletes are visible to the next batch; a hot swap bumps
    the version and the next batch is answered by the successor."""
    x, q = data
    svc = _service(flat)
    try:
        mi = svc.get("a")
        ids = mi.upsert(q[:3] + np.float32(1e-3))
        assert ids.tolist() == [N, N + 1, N + 2]
        _, got = svc.search("a", q[:3], timeout=JOIN_S)
        assert got[:, 0].tolist() == ids.tolist()
        mi.delete(ids[:1])
        _, got = svc.search("a", q[:1], timeout=JOIN_S)
        assert N not in got
        other = tbf.build(x[::-1].copy(), res=CPU)
        assert svc.swap("a", other) == 2
        d, i = svc.search("a", q[:4], timeout=JOIN_S)
        wd, wi = tbf.knn(x[::-1].copy(), q[:4], K, res=CPU)
        np.testing.assert_array_equal(i, wi.numpy())
        assert svc.stats("a")["version"] == 2 and svc.stats("a")["kind"] == "brute_force"
    finally:
        svc.stop()


def test_overload_deadlines_shedding_and_degraded_effort(flat, data):
    """A request past its deadline resolves with DeadlineExceeded at the
    cut; the admission decisions equal raft_tpu's on the same requests and
    synthetic clock; the degraded ladder's params equal raft_tpu's; a
    service pinned at effort level 1 answers as ``search`` at half the
    probes."""
    _, q = data
    svc = _service(flat, start=False, overload=True)
    try:
        late = svc.submit("a", q[0], deadline_s=1e-4)
        ok = svc.submit("a", q[1])
        time.sleep(0.01)
        svc.flush()
        with pytest.raises(serve.DeadlineExceeded):
            late.result(0)
        assert ok.result(0)[1].shape == (K,)
        assert svc.stats("a")["deadline_expired"] == 1
        with svc.effort_arbiter("a").pinned(1):
            fut = svc.submit("a", q[2:6])
            svc.flush()
            _, i = fut.result(0)
        _, wi = tflat.search(tflat.SearchParams(n_probes=2), flat, q[2:6], K, res=CPU)
        np.testing.assert_array_equal(i, wi.numpy())
    finally:
        svc.stop()

    class Req:
        def __init__(self, p, t, deadline=None):
            self.priority, self.t_submit, self.deadline = p, t, deadline
            self.future = __import__("concurrent.futures").futures.Future()

    cfg = dict(admit_wait_s=0.1, queue_factor=2.0)
    for wait, rows in ((0.05, 1), (0.15, 1), (0.25, 40), (0.5, 1)):
        decisions = []
        for mod in (toverload, joverload):
            ctrl = mod.AdmissionController(mod.OverloadConfig(**cfg), name="parity")
            batch = [Req(p, 100.0 - wait) for p in (0, 1, 2, 3)] + [Req(1, 100.0, 99.0)]
            dec = ctrl.decide(batch, queue_rows=rows, max_batch=8, now=100.0)
            decisions.append((dec.level, [batch.index(r) for r in dec.admitted],
                              [batch.index(r) for r in dec.shed],
                              [batch.index(r) for r in dec.expired]))
            ctrl.close()
        assert decisions[0] == decisions[1], (wait, rows)
    for level in (1, 2, 3):
        got = toverload.derive_degraded_params(tpq.SearchParams(n_probes=20), level)
        want = joverload.derive_degraded_params(
            __import__("raft_tpu.neighbors.ivf_pq", fromlist=["x"]).SearchParams(n_probes=20),
            level)
        assert (got.n_probes, got.lut_dtype) == (want.n_probes, want.lut_dtype)
        got = toverload.derive_degraded_params(tcagra.SearchParams(itopk_size=128), level)
        assert got.itopk_size == max(32, 128 >> level)
    mgr = toverload.DegradedModeManager(toverload.OverloadConfig(degrade_after_s=1.0,
                                                                 restore_after_s=2.0))
    jmgr = joverload.DegradedModeManager(joverload.OverloadConfig(degrade_after_s=1.0,
                                                                  restore_after_s=2.0))
    steps = [(True, 0.0), (True, 1.1), (True, 2.2), (False, 2.5), (False, 4.6), (False, 6.7)]
    assert [mgr.step(o, now=t) for o, t in steps] == [jmgr.step(o, now=t) for o, t in steps]


def _jservice():
    """raft_tpu's service over a brute-force index of the same shape."""
    x = np.random.default_rng(22).standard_normal((64, D)).astype(np.float32)
    svc = jserve.SearchService(k=K, max_batch=2, max_delay_ms=1.0, compaction=True,
                               pipeline_depth=2)
    svc.pause_compaction()
    svc.add_index("b", jbf.build(x), warmup=True)
    svc.search("b", x[0], timeout=JOIN_S)
    return svc


def test_stats_healthz_prometheus_metrics_keys_match_raft_tpu():
    x = np.random.default_rng(22).standard_normal((64, D)).astype(np.float32)
    jsvc = _jservice()
    tsvc = serve.SearchService(k=K, max_batch=2, max_delay_ms=1.0, compaction=True,
                               pipeline_depth=2)
    tsvc.pause_compaction()
    try:
        tsvc.add_index("b", tbf.build(x, res=CPU), warmup=True)
        tsvc.search("b", x[0], timeout=JOIN_S)
        js, ts = jsvc.stats("b"), tsvc.stats("b")
        assert set(ts) == set(js)
        assert set(ts["stages"]) == set(js["stages"])
        jh, th = jsvc.healthz(), tsvc.healthz()
        assert set(th) == set(jh) and th["status"] == jh["status"] == "OK"
        assert set(th["indexes"]["b"]["checks"]) == set(jh["indexes"]["b"]["checks"])
        assert jsvc.readyz() == tsvc.readyz()
        assert set(tsvc.metrics()) >= {"indexes", "health", "registry", "perf"}

        def families(text):
            """Serving metric families with a series of index "b" (the
            process registries also hold other tests' series; the cost
            accounting's gauges are XLA's in raft_tpu and the kernels'
            notes in the port, obs.cost)."""
            out = set()
            for line in text.splitlines():
                if ('index="b"' in line and not line.startswith("#") and line.startswith(
                        ("raft_tpu_serve_", "raft_tpu_health", "raft_tpu_index_",
                         "raft_tpu_perf_", "raft_tpu_compaction_", "raft_tpu_explain"))):
                    name = line.split("{")[0]
                    for suffix in ("_bucket", "_count", "_sum"):
                        name = name[: -len(suffix)] if name.endswith(suffix) else name
                    out.add(name)
            return out

        jp, tp = families(jsvc.prometheus()), families(tsvc.prometheus())
        # the measured roofline gauge needs the work the kernels note, and
        # on the CPU the plain versions note none
        assert tp <= jp and jp - tp <= {"raft_tpu_perf_roofline_utilization"}
        assert 'raft_tpu_serve_requests_total{index="b"}' in tsvc.prometheus()
    finally:
        jsvc.stop()
        tsvc.stop()


def _fake_service(reg):
    """What a Compactor reads of its service, without batchers."""
    def no_batcher(name):
        raise KeyError(name)

    return types.SimpleNamespace(registry=reg, _batcher=no_batcher, _ks={}, k=K)


def _mutate(mi, x, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    mi.upsert(x[:20] + rng.standard_normal((20, D)).astype(np.float32) * np.float32(0.1))
    mi.delete(np.arange(0, N, 7))
    mi.upsert(x[40:45] * np.float32(0.9), ids=[3, N + 1, 600, 601, 602])


def test_compaction_of_ivf_flat_matches_raft_tpu_by_ids(data, tmp_path):
    """raft_tpu and the port compact the same IVF-Flat state (extend into
    an empty clone with the trained centers): the promoted shadows answer
    with equal ids, the gate measured equal recalls, and later mutations
    of a retired index forward to the successor."""
    x, q = data
    j = jflat.build(jflat.IndexParams(n_lists=10, kmeans_n_iters=5), x)
    jflat.save(str(tmp_path / "f.idx"), j)
    jm = jmut.MutableIndex(j, search_params=jflat.SearchParams(n_probes=6))
    tm = serve.MutableIndex(tflat.load(str(tmp_path / "f.idx"), res=CPU),
                            search_params=tflat.SearchParams(n_probes=6))
    results = []
    for mi, reg_mod, comp_mod in ((jm, jregistry, jcompactor), (tm, tregistry, tcompactor)):
        _mutate(mi, x)
        reg = reg_mod.IndexRegistry()
        reg.register("a", mi)
        # the gate's slack widened for this small, hard (Gaussian) data: the
        # point is that both packages promote and agree
        comp = comp_mod.Compactor(_fake_service(reg), comp_mod.CompactionPolicy(
            chunk_rows=64, gate_queries=16, recall_slack=0.1))
        res = comp.trigger_now("a")
        comp.stop()
        assert res["status"] == "promoted", res
        results.append((res, reg))
    (jres, jreg), (tres, treg) = results
    for key in ("rows", "folded_deletes", "folded_side_rows", "serving_recall",
                "shadow_recall", "version"):
        assert tres[key] == jres[key], key
    jv, ji = jreg.get("a").search(q, K)
    tv, ti = treg.get("a").search(q, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)
    assert treg.get("a").pending_mutations() == (0, 0)
    tm.upsert(q[:1], ids=[900])      # the retired index forwards to the successor
    assert treg.get("a").contains(900) and not tm.contains(901)


@pytest.mark.parametrize("kind,floor", [("brute_force", 1.0), ("ivf_pq", 0.8), ("cagra", 0.7)])
def test_compact_now_other_kinds_by_recall(kind, floor, data):
    """compact_now through the service: promoted, ids stable (upserted rows
    still found by their ids), recall@10 against brute force over the live
    rows at raft_tpu's compaction floors."""
    x, q = data
    if kind == "brute_force":
        mi = serve.MutableIndex(tbf.build(x, res=CPU))
    elif kind == "ivf_pq":
        mi = serve.MutableIndex(
            tpq.build(tpq.IndexParams(n_lists=10, pq_dim=20, kmeans_n_iters=5), x, res=CPU),
            search_params=tpq.SearchParams(n_probes=10))
    else:
        mi = serve.MutableIndex(
            tcagra.build(tcagra.IndexParams(graph_degree=32, build_algo="brute_force"), x,
                         res=CPU), search_params=tcagra.SearchParams(itopk_size=64))
    svc = serve.SearchService(k=K, max_batch=8, max_delay_ms=1.0, cost_accounting=False,
                              compaction=serve.CompactionPolicy(chunk_rows=64, gate_queries=16,
                                                                recall_slack=0.1))
    svc.pause_compaction()
    try:
        svc.add_index("c", mi, warmup=True)
        _mutate(svc.get("c"), x)
        rows, gids = svc.get("c").live_vectors()
        res = svc.compact_now("c")
        assert res["status"] == "promoted", res
        assert svc.stats("c")["version"] == 2 and svc.get("c").pending_mutations() == (0, 0)
        _, i = svc.search("c", q[:8], timeout=JOIN_S)
        _, want = tbf.knn(rows, q[:8], K, res=CPU)
        assert recall_at_k(i, gids[want.numpy()], K) >= floor
        assert svc.drain_compaction(timeout=JOIN_S)
        assert svc.healthz()["indexes"]["c"]["checks"]["compaction"]["status"] == "OK"
    finally:
        svc.stop()


def test_build_counter_is_per_thread_and_counts_hot_path_builds(flat, data):
    """Kernel builds and library loads count on the thread that made them:
    one on another thread leaves the dispatch bracket at 0; one inside a
    dispatch after warmup counts as a hot-path recompile and publishes
    ``hot_recompile``."""
    _, q = data
    tmetrics.install_compile_listener()
    before_total, before_here = tmetrics.compile_count(), tmetrics.compile_count(thread=True)
    t = threading.Thread(target=device_events.record, args=("backend_compile",))
    t.start()
    _join([t])
    assert tmetrics.compile_count() == before_total + 1
    assert tmetrics.compile_count(thread=True) == before_here
    calls = []

    def search_fn(queries):
        calls.append(queries.shape[0])
        if len(calls) == 5:          # the first dispatch after a 4-bucket warmup
            device_events.record("cache_miss")
        return tflat.search(SP, flat, queries, K, res=CPU)

    seen = []
    sub = obs.subscribe(lambda e: seen.append(e), kinds=frozenset({"hot_recompile"}))
    b = serve.MicroBatcher(search_fn, D, max_batch=8, pipeline_depth=1, start=False,
                           cost_accounting=False, device="cpu")
    try:
        assert b.warmup() == 0 and calls == [1, 2, 4, 8]
        f = b.submit(q[0])
        b.flush()
        assert f.result(0)[1].shape == (K,)
        assert b.metrics.recompiles == 1 and len(seen) == 1
    finally:
        sub.unsubscribe()
        b.stop()


def test_flight_explain_and_perf_ledger_see_served_batches(flat, data, tmp_path):
    _, q = data
    obs.flight.reset()
    svc = _service(flat)
    try:
        svc.search("a", q[:2], timeout=JOIN_S)
        plan = svc.explain("a", q[3])
        assert plan["kernel_path"] == "torch" and plan["outcome"]["outcome"] == "ok"
        assert plan["probe"]["n_probes"] == 4 and len(plan["results"]["ids"]) == K
        recs = [r for r in obs.flight.records() if r.get("index") == "a"]
        assert recs and all(r["kernel_path"] == "torch" for r in recs)
        path = obs.flight.dump(str(tmp_path), reason="manual")
        assert os.path.exists(path) and os.path.exists(path.replace(".json", ".trace.json"))
        keys = {(h["index"], h["kernel_path"]) for h in obs.default_ledger().top_hotspots(50)}
        assert ("a", "torch") in keys
    finally:
        svc.stop()


def test_refused_options_name_their_roadmap_item(flat, monkeypatch):
    for kw, item in ((dict(replicas=object()), "item 7"), (dict(auditor=object()), "item 5b"),
                     (dict(slo=True), "item 5b"), (dict(autotune=True), "item 5b"),
                     (dict(gateway=True), "item 5b")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
            serve.SearchService(**kw)
    for env in ("RAFT_TPU_AUTOTUNE", "RAFT_TPU_GATEWAY"):
        monkeypatch.setenv(env, "1")
        with pytest.raises(NotImplementedError, match="item 5b"):
            serve.SearchService()
        monkeypatch.delenv(env)
    for name in ("ShardedIndex", "ReplicaGroup", "build_sharded"):
        with pytest.raises(NotImplementedError, match="item 7"):
            getattr(serve, name)
    with pytest.raises(NotImplementedError, match="item 7"):
        serve.HedgedDispatcher([lambda q: q, lambda q: q])
    with pytest.raises(NotImplementedError, match="item 7"):
        serve.MicroBatcher(lambda q: q, D, hedger=object(), device="cpu")
    svc = serve.SearchService(compaction=True, start=False)
    try:
        with pytest.raises(NotImplementedError, match="item 7"):
            svc.compactor.rebuild_sharded("a")
        fake = type("ShardedIndex", (), {})()
        with pytest.raises(NotImplementedError, match="item 7"):
            svc.add_index("s", fake)
        with pytest.raises(NotImplementedError, match="item 7"):
            tregistry.IndexRegistry().register("s", fake)
        with pytest.raises(NotImplementedError, match="item 5b"):
            svc.attach_auditor(object())
    finally:
        svc.stop()
