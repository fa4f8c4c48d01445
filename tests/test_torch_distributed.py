"""The port's sharded algorithms (``comms.distributed`` and the sharded
k-means fits) against raft_tpu's on the same seeded inputs, four shards in
both packages: ``sharded_knn`` ids equal but at value ties; sharded
IVF-Flat over a raft_tpu-built index (saved, then loaded into the port)
equal on both schedules; sharded IVF-PQ recall at least 0.99 of
raft_tpu's; ``kmeans_step`` and both ``fit_sharded`` from injected centers
within 1e-4 of raft_tpu's (the port assigns by the fused argmin, #7, so
only near ties could split them), and two port runs bitwise equal."""

import os

import jax
import numpy as np
import pytest
import torch

from raft_tpu import comms as jc
from raft_tpu.cluster import kmeans as jkm
from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.comms import distributed as jd
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import comms as tc
from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.comms import distributed as td
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force, cagra
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.stats.metrics import recall_at_k

from _torch_parity import assert_topk_match

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

S = 4
CPU = Resources(device="cpu")


def _blobs(n, d, n_q, seed, n_centers=16):
    """Centred Gaussian blobs (see tests/test_torch_ivf_flat.py)."""
    rng = np.random.default_rng(seed)
    centers = (rng.random((n_centers, d)).astype(np.float32) - 0.5) * 6
    x = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, n_centers, n_q)] + rng.standard_normal((n_q, d)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32), centers


@pytest.fixture(scope="module")
def data():
    return _blobs(2400, 16, 256, 0)


@pytest.fixture(scope="module")
def jcomms():
    return jc.local_comms(S)


@pytest.fixture(scope="module")
def tcomms():
    return tc.local_comms(devices=["cpu"] * S)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "l1"])
def test_sharded_knn_matches_raft(data, jcomms, tcomms, metric):
    x, q, _ = data
    v_ref, i_ref = jd.sharded_knn(jcomms, x, q, 10, metric=metric)
    v, i = td.sharded_knn(tcomms, torch.from_numpy(x), torch.from_numpy(q), 10, metric=metric)
    assert_topk_match(v, i, v_ref, i_ref, rtol=1e-5, atol=1e-4)
    # and the single-device search
    v1, i1 = brute_force.knn(x, q, 10, metric=metric, res=CPU)
    assert_topk_match(v, i, v1, i1, rtol=1e-5, atol=1e-4)


def test_sharded_knn_pads_short_shards_as_raft(data, jcomms, tcomms):
    x, q, _ = data
    x = x[:40]                       # 10 rows a shard, k = 16: each shard pads 6
    v_ref, i_ref = jd.sharded_knn(jcomms, x, q, 16)
    v, i = td.sharded_knn(tcomms, [torch.from_numpy(p) for p in np.split(x, S)],
                          torch.from_numpy(q), 16)
    assert_topk_match(v, i, v_ref, i_ref, rtol=1e-5, atol=1e-4)


def _raft_ivf_flat(x, n_lists, tmp_path):
    jidx = jivf.build(jivf.IndexParams(n_lists=n_lists, kmeans_n_iters=4), x)
    path = str(tmp_path / "ivf_flat.idx")
    jivf.save(path, jidx)
    return jidx, tivf.load(path, res=CPU)


def test_sharded_ivf_flat_matches_raft(data, jcomms, tcomms, tmp_path):
    x, q, _ = data
    n_lists = 22                     # two padding lists over 4 shards
    jidx, tidx = _raft_ivf_flat(x, n_lists, tmp_path)
    jsh = jd.shard_ivf_flat_index(jcomms, jidx)
    tsh = td.shard_ivf_flat_index(tcomms, tidx)
    # both schedules find the exact top-k of the probed lists: each port
    # schedule against raft_tpu's query-major one
    v_ref, i_ref = jd.sharded_ivf_flat_search(jcomms, jsh, q, 10, n_probes=3,
                                              strategy="query_major")
    for strategy in ("query_major", "probe_major"):
        v, i = td.sharded_ivf_flat_search(tcomms, tsh, q, 10, n_probes=3, strategy=strategy)
        assert_topk_match(v, i, v_ref, i_ref, rtol=1e-5, atol=1e-4)
    # exhaustive probing equals the exact search
    v, i = td.sharded_ivf_flat_search(tcomms, tsh, q, 10, n_probes=n_lists)
    v1, i1 = brute_force.knn(x, q, 10, res=CPU)
    assert_topk_match(v, i, v1, i1, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="candidate pool"):
        td.sharded_ivf_flat_search(tcomms, tsh, q, 10_000, n_probes=1)


@pytest.fixture(scope="module")
def pq_pair(data, tmp_path_factory):
    x, _, _ = data
    jidx = jpq.build(jpq.IndexParams(n_lists=24, pq_dim=8, kmeans_n_iters=4), x)
    path = str(tmp_path_factory.mktemp("pq") / "ivf_pq.idx")
    jpq.save(path, jidx)
    return jidx, tpq.load(path, res=CPU)


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16"])
def test_sharded_ivf_pq_recall_within_raft(data, jcomms, tcomms, lut_dtype, pq_pair):
    x, q, _ = data
    jidx, tidx = pq_pair
    _, gt = brute_force.knn(x, q, 10, res=CPU)
    gt = gt.numpy()
    jsh = jd.shard_ivf_pq_index(jcomms, jidx)
    tsh = td.shard_ivf_pq_index(tcomms, tidx)
    _, i_ref = jd.sharded_ivf_pq_search(jcomms, jsh, q, 10, n_probes=4, lut_dtype=lut_dtype,
                                        strategy="query_major")
    _, i = td.sharded_ivf_pq_search(tcomms, tsh, q, 10, n_probes=4, lut_dtype=lut_dtype,
                                    strategy="query_major")
    r_ref = recall_at_k(np.asarray(i_ref), gt, 10)
    r = recall_at_k(i.numpy(), gt, 10)
    assert r >= 0.99 * r_ref, (r, r_ref)
    assert (i.numpy() >= 0).all()


def test_sharded_ivf_pq_build_is_the_single_device_build(data, tcomms):
    x, _, _ = data
    params = tpq.IndexParams(n_lists=16, pq_dim=8, kmeans_n_iters=4)
    single = tpq.build(params, x, res=CPU)
    sharded = td.sharded_ivf_pq_build(tcomms, torch.from_numpy(x), params, res=CPU)
    for name in ("centers", "codebook", "list_codes", "list_index", "list_sizes", "list_data",
                 "list_y2"):
        assert torch.equal(getattr(sharded, name), getattr(single, name)), name


@pytest.fixture(scope="module")
def cagra_index(data):
    x, _, _ = data
    return cagra.build(cagra.IndexParams(graph_degree=16, intermediate_graph_degree=32,
                                         build_algo="brute_force"), x, res=CPU)


@pytest.mark.parametrize("n_q", [256, 101])       # 101: the last shard pads
def test_sharded_cagra_search_is_the_single_device_search(data, tcomms, cagra_index, n_q):
    _, q, _ = data
    sp = cagra.SearchParams(itopk_size=32)
    v1, i1 = cagra.search(sp, cagra_index, q[:n_q], 10, res=CPU)
    v, i = td.sharded_cagra_search(tcomms, cagra_index, q[:n_q], 10, params=sp, res=CPU)
    assert torch.equal(i, i1) and torch.equal(v, v1)


def test_sharded_cagra_build_is_split_invariant(data):
    x, q, _ = data
    params = cagra.IndexParams(graph_degree=8, intermediate_graph_degree=16,
                               nn_descent_niter=3)
    two = td.sharded_cagra_build(tc.local_comms(devices=["cpu"] * 2), params, x[:900],
                                 max_cluster_rows=256, res=CPU)
    four = td.sharded_cagra_build(tc.local_comms(devices=["cpu"] * 4), params, x[:900],
                                  max_cluster_rows=256, res=CPU)
    assert torch.equal(two.graph, four.graph)
    assert two.graph.shape == (900, 8) and int(two.graph.min()) >= 0
    _, i = cagra.search(cagra.SearchParams(), four, q[:64], 10, res=CPU)
    _, gt = brute_force.knn(x[:900], q[:64], 10, res=CPU)
    assert recall_at_k(i.numpy(), gt.numpy(), 10) >= 0.8


def test_kmeans_step_matches_raft(data, jcomms, tcomms):
    x, _, _ = data
    c0 = x[::150][:16]
    c_ref, in_ref = jd.kmeans_step(jcomms, x, c0)
    c, inertia = td.kmeans_step(tcomms, torch.from_numpy(x), torch.from_numpy(c0))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(inertia), float(in_ref), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_stats_is_a_float64_update(data, tcomms, weighted):
    """The one statistic every sharded k-means update takes: packed sums |
    weights | inertia over the shards equal a float64 pass over all rows
    by the same labels (within f32 rounding), and the labels are the
    nearest centres."""
    x, _, _ = data
    c0 = torch.from_numpy(x[::150][:16])
    xt = torch.from_numpy(x)
    w = (torch.from_numpy(np.random.default_rng(3).random(x.shape[0]).astype(np.float32))
         if weighted else torch.ones(x.shape[0]))
    packed, labels = td.lloyd_stats(tcomms, tcomms.shard(xt), tcomms.shard(w), c0)
    lab = torch.cat(labels)
    d64 = torch.cdist(xt.double(), c0.double()) ** 2
    assert torch.equal(lab, d64.argmin(dim=1))
    w64 = w.double()
    sums = torch.zeros(16, x.shape[1], dtype=torch.float64).index_add_(
        0, lab, xt.double() * w64[:, None])
    counts = torch.zeros(16, dtype=torch.float64).index_add_(0, lab, w64)
    inertia = float((w64 * d64.gather(1, lab[:, None])[:, 0]).sum())
    assert packed.shape == (16, x.shape[1] + 2)
    np.testing.assert_allclose(packed[:, :-2].double().numpy(), sums.numpy(), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(packed[:, -2].double().numpy(), counts.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(packed[0, -1]), inertia, rtol=1e-5)
    assert not bool(packed[1:, -1].any())


def test_kmeans_fit_converges(data, tcomms):
    x, _, _ = data
    c, hist = td.kmeans_fit(tcomms, torch.from_numpy(x), 16, n_iters=8, n_init=2, seed=3)
    finite = hist[torch.isfinite(hist)]
    assert c.shape == (16, 16) and finite.numel() >= 2
    assert bool((finite[1:] <= finite[:-1] * (1 + 1e-6)).all())
    c2, hist2 = td.kmeans_fit(tcomms, torch.from_numpy(x), 16, n_iters=8, n_init=2, seed=3)
    assert torch.equal(c, c2) and torch.equal(hist, hist2)


@pytest.mark.parametrize("reduce_dtype", ["float32", "bfloat16", "int8"])
def test_kmeans_fit_sharded_matches_raft(data, jcomms, tcomms, reduce_dtype):
    x, _, _ = data
    init = x[::150][:16]
    params_j = jkm.KMeansParams(n_clusters=16, max_iter=12, tol=1e-6, init="array")
    params_t = tkm.KMeansParams(n_clusters=16, max_iter=12, tol=1e-6, init="array")
    c_ref, in_ref, it_ref = jkm.fit_sharded(jcomms, params_j, x, init_centers=init,
                                            reduce_dtype=reduce_dtype)
    c, inertia, it = tkm.fit_sharded(tcomms, params_t, torch.from_numpy(x), init_centers=init,
                                     reduce_dtype=reduce_dtype)
    tol = 1e-4 if reduce_dtype == "float32" else 2e-2
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(inertia), float(in_ref), rtol=1e-4)
    if reduce_dtype == "float32":
        assert it == int(it_ref)
        # the single-device fit from the same init
        c1, _, _ = tkm.fit(params_t, x, init_centers=init, res=CPU)
        np.testing.assert_allclose(c.numpy(), c1.numpy(), rtol=1e-4, atol=1e-4)
    again = tkm.fit_sharded(tcomms, params_t, torch.from_numpy(x), init_centers=init,
                            reduce_dtype=reduce_dtype)
    assert torch.equal(c, again[0]) and torch.equal(inertia, again[1])


def test_kmeans_fit_sharded_own_init_and_weights(data, tcomms):
    x, _, _ = data
    params = tkm.KMeansParams(n_clusters=16, max_iter=10, seed=5)
    w = np.ones(x.shape[0], np.float32)
    w[-100:] = 0.0                     # zero-weight padding rows never seed or pull
    c, inertia, _ = tkm.fit_sharded(tcomms, params, torch.from_numpy(x),
                                    torch.from_numpy(w), reduce_dtype="float32")
    c2, inertia2, _ = tkm.fit_sharded(tcomms, params, torch.from_numpy(x),
                                      torch.from_numpy(w), reduce_dtype="float32")
    assert torch.equal(c, c2) and float(inertia) == float(inertia2)
    cost = tkm.cluster_cost(x[:-100], c, res=CPU)
    np.testing.assert_allclose(float(inertia), float(cost), rtol=1e-4)
    with pytest.raises(ValueError, match="init_centers"):
        tkm.fit_sharded(tcomms, tkm.KMeansParams(init="array"), torch.from_numpy(x))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_kmeans_balanced_fit_sharded_matches_raft(data, jcomms, tcomms, metric):
    x, _, blob_centers = data
    init = blob_centers + 0.1          # one start near each blob: no cluster starves
    pj = jkb.KMeansBalancedParams(n_iters=6, metric=metric)
    pt = tkb.KMeansBalancedParams(n_iters=6, metric=metric)
    c_ref, l_ref = jkb.fit_sharded(jcomms, pj, x, 16, init_centers=init,
                                   reduce_dtype="float32")
    c, labels = tkb.fit_sharded(tcomms, pt, torch.from_numpy(x), 16, init_centers=init,
                                reduce_dtype="float32")
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-4, atol=1e-4)
    got = torch.cat(labels).numpy()
    assert got.shape == (x.shape[0],)
    assert (got == np.asarray(l_ref)).mean() >= 0.999
    again = tkb.fit_sharded(tcomms, pt, torch.from_numpy(x), 16, init_centers=init,
                            reduce_dtype="float32")
    assert torch.equal(c, again[0]) and all(torch.equal(a, b) for a, b in zip(labels, again[1]))


def test_kmeans_balanced_fit_sharded_seeds_itself(data, tcomms):
    x, _, _ = data
    pt = tkb.KMeansBalancedParams(n_iters=5, seed=2)
    c, labels = tkb.fit_sharded(tcomms, pt, torch.from_numpy(x), 16)
    c2, _ = tkb.fit_sharded(tcomms, pt, torch.from_numpy(x), 16)
    assert torch.equal(c, c2)
    counts = np.bincount(torch.cat(labels).numpy(), minlength=16)
    assert counts.min() > 0
    single = tkb.fit(pt, x, 16, res=CPU)
    cost = lambda cc: float(tkm.cluster_cost(x, cc, res=CPU))  # noqa: E731
    assert cost(c) <= 1.05 * cost(single)


@pytest.mark.cuda
def test_sharded_paths_reach_the_kernels_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from raft_tpu_torch import kernels

    x, q, _ = _blobs(20_000, 32, 256, 1)
    c = tc.local_comms(devices=["cuda:0"] * 4)
    kernels.reset_launch_counts()
    td.sharded_knn(c, torch.from_numpy(x).cuda(), torch.from_numpy(q).cuda(), 10)
    idx = tivf.build(tivf.IndexParams(n_lists=64), x, res=Resources())
    td.sharded_ivf_flat_search(c, td.shard_ivf_flat_index(c, idx), q, 10, n_probes=8)
    td.kmeans_step(c, torch.from_numpy(x).cuda(), torch.from_numpy(x[:64]).cuda())
    n = kernels.launch_counts()
    assert n["fused_knn"] >= 4 and n["select_k"] > 0 and n["fused_argmin"] >= 4
    assert n["ivf_scan_probe_major"] + n["ivf_scan_query_major"] >= 4
