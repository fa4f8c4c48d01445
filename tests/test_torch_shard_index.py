"""The port's ``serve.shard.ShardedIndex`` against raft_tpu's, four shards
in both packages: IVF-Flat (a raft_tpu-built index, saved and loaded into
the port) and brute force give raft_tpu's ids, and exhaustive probing the
single index's; IVF-PQ recall against the single search is at least 0.99;
tombstones fold; a per-query ``RowFilter`` over global ids is honoured;
``merge_dtype_from_env`` parses and rejects as raft_tpu's does; the
registry and ``SearchService`` serve and hot-swap a sharded index, and the
ragged searcher's sharded branch answers."""

import os

import numpy as np
import pytest
import torch

from raft_tpu import comms as jc
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.serve import shard as jshard
from raft_tpu_torch import comms as tc
from raft_tpu_torch import kernels, obs, serve
from raft_tpu_torch.core.bitset import RowFilter
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force, cagra
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.serve import shard as tshard
from raft_tpu_torch.stats.metrics import recall_at_k

from _torch_parity import assert_topk_match

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

S = 4
K = 10
CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    centers = (rng.random((12, 24)).astype(np.float32) - 0.5) * 6
    x = centers[rng.integers(0, 12, 1203)] + rng.standard_normal((1203, 24)).astype(np.float32)
    q = centers[rng.integers(0, 12, 32)] + rng.standard_normal((32, 24)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def tcomms():
    return tc.local_comms(devices=["cpu"] * S)


@pytest.fixture(scope="module")
def jcomms():
    return jc.local_comms(S)


@pytest.fixture(scope="module")
def flat_pair(corpus, tmp_path_factory):
    x, _ = corpus
    jidx = jivf.build(jivf.IndexParams(n_lists=18, kmeans_n_iters=4), x)
    path = str(tmp_path_factory.mktemp("flat") / "ivf_flat.idx")
    jivf.save(path, jidx)
    return jidx, tivf.load(path, res=CPU)


def test_ivf_flat_matches_raft_and_the_single_index(corpus, flat_pair, jcomms, tcomms):
    x, q = corpus
    jidx, tidx = flat_pair
    for n_probes in (2, 18):
        jsh = jshard.ShardedIndex.from_index(jidx, jcomms, merge_dtype=None,
                                             search_params=jivf.SearchParams(n_probes=n_probes))
        tsh = tshard.ShardedIndex.from_index(tidx, tcomms, merge_dtype=None,
                                             search_params=tivf.SearchParams(n_probes=n_probes))
        v_ref, i_ref = jsh.search(q, K)
        v, i = tsh.search(q, K)
        assert kernels.consume_kernel_path() == "sharded"
        assert_topk_match(v, i, v_ref, i_ref, rtol=1e-5, atol=1e-4)
    # exhaustive probing: the single index's search
    v1, i1 = tivf.search(tivf.SearchParams(n_probes=18), tidx, q, K, res=CPU)
    assert_topk_match(v, i, v1, i1, rtol=1e-5, atol=1e-4)
    assert tsh.n_shards == S and tsh.kind == "ivf_flat" and tsh.size == x.shape[0]
    assert tsh._shard_stats["lists"] == [5, 5, 4, 4]
    info = tsh.explain_contributions(i.numpy())
    assert info["available"] and sum(info["per_shard"]) == int((i >= 0).sum())


def test_brute_force_and_cagra_rows_match_raft(corpus, jcomms, tcomms):
    x, q = corpus
    from raft_tpu.neighbors import brute_force as jbf

    jsh = jshard.ShardedIndex.from_index(jbf.build(x), jcomms, merge_dtype=None)
    tsh = tshard.ShardedIndex.from_index(brute_force.build(x, res=CPU), tcomms,
                                         merge_dtype=None)
    v_ref, i_ref = jsh.search(q, K)
    v, i = tsh.search(q, K)
    assert_topk_match(v, i, v_ref, i_ref, rtol=1e-5, atol=1e-4)
    # 1203 rows over 4 shards of 301: the last shard holds 300
    assert [s["index"].size for s in tsh.shards] == [301, 301, 301, 300]
    cg = cagra.build(cagra.IndexParams(graph_degree=8, intermediate_graph_degree=16,
                                       build_algo="brute_force"), x, res=CPU)
    csh = tshard.ShardedIndex.from_index(cg, tcomms, merge_dtype=None, cagra_mode="brute")
    cv, ci = csh.search(q, K)
    assert torch.equal(ci, i) and torch.equal(cv, v)
    with pytest.raises(NotImplementedError, match="item 7b"):
        tshard.ShardedIndex.from_index(cg, tcomms, cagra_mode="graph")


def test_ivf_pq_recall_against_the_single_search(corpus, tcomms):
    x, q = corpus
    idx = tpq.build(tpq.IndexParams(n_lists=16, pq_dim=24, pq_bits=8), x, res=CPU)
    sp = tpq.SearchParams(n_probes=16)
    _, i_ref = tpq.search(sp, idx, q, K, res=CPU)
    tsh = tshard.ShardedIndex.from_index(idx, tcomms, search_params=sp, merge_dtype=None)
    _, i = tsh.search(q, K)
    assert recall_at_k(i.numpy(), i_ref.numpy(), K) >= 0.99


def test_bf16_merge_keeps_recall(corpus, flat_pair, tcomms):
    _, q = corpus
    _, tidx = flat_pair
    sp = tivf.SearchParams(n_probes=18)
    _, i32 = tshard.ShardedIndex.from_index(tidx, tcomms, search_params=sp,
                                            merge_dtype=None).search(q, K)
    _, i16 = tshard.ShardedIndex.from_index(tidx, tcomms, search_params=sp,
                                            merge_dtype=torch.bfloat16).search(q, K)
    assert recall_at_k(i16.numpy(), i32.numpy(), K) >= 0.95


@pytest.mark.parametrize("value", [None, "float32", "F32", " bf16 ", "bfloat16", "fp16"])
def test_merge_dtype_from_env_matches_raft(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("RAFT_TPU_SHARD_MERGE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("RAFT_TPU_SHARD_MERGE_DTYPE", value)
    try:
        want = jshard.merge_dtype_from_env()
    except ValueError:
        with pytest.raises(ValueError, match="not understood"):
            tshard.merge_dtype_from_env()
        return
    got = tshard.merge_dtype_from_env()
    assert (got is None) == (want is None)
    if got is not None:
        assert got == torch.bfloat16 and np.dtype(want).name == "bfloat16"


def test_tombstones_fold_as_raft(corpus, flat_pair, jcomms, tcomms):
    x, q = corpus
    jidx, tidx = flat_pair
    from raft_tpu.serve.mutation import MutableIndex as JMutable

    dead = np.random.default_rng(3).choice(x.shape[0], 200, replace=False)
    jm = JMutable(jidx, search_params=jivf.SearchParams(n_probes=18))
    jm.delete(dead)
    for kind_idx in (tidx, brute_force.build(x, res=CPU)):
        tm = serve.MutableIndex(kind_idx, search_params=(
            tivf.SearchParams(n_probes=18) if kind_idx is tidx else None))
        tm.delete(dead)
        tsh = tshard.ShardedIndex.from_index(tm, tcomms, merge_dtype=None)
        assert tsh.size == x.shape[0] - 200
        v, i = tsh.search(q, K)
        assert not np.isin(i.numpy(), dead).any()
        vm, im = tm.search(q, K)
        assert_topk_match(v, i, vm, im, rtol=1e-5, atol=1e-4)
    v_ref, i_ref = jshard.ShardedIndex.from_index(jm, jcomms, merge_dtype=None).search(q, K)
    tm = serve.MutableIndex(tidx, search_params=tivf.SearchParams(n_probes=18))
    tm.delete(dead)
    v, i = tshard.ShardedIndex.from_index(tm, tcomms, merge_dtype=None).search(q, K)
    assert_topk_match(v, i, v_ref, i_ref, rtol=1e-5, atol=1e-4)
    # live side rows and a remapped id space are refused
    tm.upsert(x[:3])
    with pytest.raises(ValueError, match="side-buffer"):
        tshard.ShardedIndex.from_index(tm, tcomms)


def test_per_query_row_filter_over_global_ids(corpus, flat_pair, tcomms):
    x, q = corpus
    _, tidx = flat_pair
    rng = np.random.default_rng(5)
    masks = rng.random((q.shape[0], x.shape[0])) < 0.3
    rf = RowFilter.from_mask_rows(torch.from_numpy(masks), device="cpu")
    dead = rng.choice(x.shape[0], 50, replace=False)
    for idx, sp in ((tidx, tivf.SearchParams(n_probes=18)), (brute_force.build(x, res=CPU), None)):
        tm = serve.MutableIndex(idx, search_params=sp)
        tm.delete(dead)
        tsh = tshard.ShardedIndex.from_index(tm, tcomms, merge_dtype=None)
        v, i = tsh.search(q, K, sample_filter=rf)
        ids = i.numpy()
        rows = np.repeat(np.arange(q.shape[0]), K).reshape(-1, K)
        ok = ids >= 0
        assert masks[rows[ok], ids[ok]].all() and not np.isin(ids, dead).any()
        # the same filter (tombstones cleared) on the single index
        allowed = masks.copy()
        allowed[:, dead] = False
        if sp is None:
            v1, i1 = brute_force.knn(x, q, K, sample_filter=RowFilter.from_mask_rows(
                torch.from_numpy(allowed), device="cpu"), res=CPU)
        else:
            v1, i1 = tivf.search(sp, idx, q, K, sample_filter=RowFilter.from_mask_rows(
                torch.from_numpy(allowed), device="cpu"), res=CPU)
        fin = np.isfinite(v1.numpy())
        np.testing.assert_allclose(v.numpy()[fin], v1.numpy()[fin], rtol=1e-5, atol=1e-4)
    with pytest.raises(TypeError, match="RowFilter"):
        tsh.search(q, K, sample_filter=object())


def test_registry_and_service_serve_and_swap_a_sharded_index(corpus, flat_pair, tcomms):
    x, q = corpus
    _, tidx = flat_pair
    sp = tivf.SearchParams(n_probes=4)
    a = tshard.ShardedIndex.from_index(tidx, tcomms, search_params=sp, merge_dtype=None)
    b = tshard.ShardedIndex.from_index(brute_force.build(x, res=CPU), tcomms, merge_dtype=None)
    reg = serve.IndexRegistry()
    assert reg.register("s", a) == 1 and reg.swap("s", b) == 2 and reg.get("s") is b
    svc = serve.SearchService(k=K, max_batch=8, max_delay_ms=1.0)
    try:
        svc.add_index("s", a, warmup=True)
        futs = [svc.submit("s", q[r]) for r in range(q.shape[0])]
        got = [f.result(timeout=60) for f in futs]
        for r, (dv, di) in enumerate(got):
            v1, i1 = a.search(q[r:r + 1], K)
            assert np.array_equal(np.asarray(di).reshape(-1), i1.numpy()[0])
        assert svc.swap("s", b) == 2
        dv, di = svc.search("s", q[:1])
        assert np.array_equal(np.asarray(di).reshape(-1), b.search(q[:1], K)[1].numpy()[0])
        st = svc.stats("s")
        assert st["kind"] == "brute_force" and st["side_rows"] == 0
    finally:
        svc.stop()
    reg_text = obs.to_prometheus()
    assert "raft_tpu_shard_live_bytes" in reg_text and "raft_tpu_sharded_search_seconds" in \
        reg_text


def test_ragged_sharded_branch_answers(corpus, flat_pair, tcomms):
    x, q = corpus
    _, tidx = flat_pair
    sp = tivf.SearchParams(n_probes=18)
    tsh = tshard.ShardedIndex.from_index(tidx, tcomms, search_params=sp, merge_dtype=None)
    svc = serve.SearchService(k=K, max_batch=8, max_delay_ms=1.0,
                              ragged=serve.RaggedSpec(k_max=K))
    try:
        svc.add_index("r", tsh)
        mask = np.zeros(x.shape[0], bool)
        mask[::3] = True
        fid = svc.register_filter("r", mask)
        svc.warmup("r")
        futs = [svc.submit("r", q[r], k=1 + r % K, fid=fid if r % 2 else 0)
                for r in range(16)]
        for r, f in enumerate(futs):
            dv, di = f.result(timeout=60)
            di = np.asarray(di).reshape(-1)
            assert di.shape[0] == 1 + r % K
            if r % 2:
                assert mask[di[di >= 0]].all()
            else:
                assert np.array_equal(di, tsh.search(q[r:r + 1], K)[1].numpy()[0][:di.shape[0]])
    finally:
        svc.stop()


def test_bytes_gauges_and_skew_probe(corpus, flat_pair, tcomms):
    _, q = corpus
    _, tidx = flat_pair
    tsh = tshard.ShardedIndex.from_index(tidx, tcomms, search_params=tivf.SearchParams(
        n_probes=4), merge_dtype=None, label="skew")
    per = tsh.per_shard_bytes()
    assert len(per) == S and sum(per) == tsh.device_bytes() and min(per) > 0
    single = sum(t.numel() * t.element_size() for t in vars(tidx).values()
                 if isinstance(t, torch.Tensor))
    assert max(per) < single
    out = tsh.measure_shard_skew(q, K)
    assert len(out["per_shard_s"]) == S and out["skew"] >= 1.0
    assert tsh.pending_mutations() == (0, 0)
    for call in (lambda: tsh.upsert(q), lambda: tsh.delete([0]), lambda: tsh.save("x")):
        with pytest.raises(NotImplementedError):
            call()


@pytest.mark.cuda
def test_sharded_index_on_four_shards_of_one_card(corpus):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, q = corpus
    c = tc.local_comms(devices=["cuda:0"] * 4)
    idx = tivf.build(tivf.IndexParams(n_lists=18), x, res=Resources())
    sp = tivf.SearchParams(n_probes=18)
    kernels.reset_launch_counts()
    v, i = tshard.ShardedIndex.from_index(idx, c, search_params=sp).search(q, K)
    v1, i1 = tivf.search(sp, idx, q, K)
    assert torch.equal(i.cpu(), i1.cpu())
    n = kernels.launch_counts()
    assert n["select_k"] > 0 and n["ivf_scan_query_major"] >= 4
