"""Port parity: NN-descent of ``raft_tpu_torch`` against raft_tpu's — the
merge bitwise, one iteration fed raft_tpu's threefry draws, the
reverse-edge rule where edges collide, the builds' graph recall, the batch
build's host half on injected plans, and CAGRA's NN-descent build algos.

Data is centred and of unit scale: distances are |x|^2 + |y|^2 - 2 x.y,
summed in another order by each package, so their difference grows with
|x|^2 (ROADMAP, ground rules)."""

import os
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.neighbors import nn_descent as jnn
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import nn_descent as tnn
from raft_tpu_torch.stats.metrics import recall_at_k

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
#: the distance tolerance: each package sums |x|^2 + |y|^2 - 2 x.y in its own order
RTOL, ATOL = 1e-5, 1e-4


def _blobs(n, d, seed=0, blobs=20):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(blobs, d))
    x = (centers[rng.integers(0, blobs, n)] + rng.normal(size=(n, d))).astype(np.float32)
    return x - x.mean(axis=0)


@pytest.fixture(scope="module")
def data():
    return _blobs(2000, 16)


def _graph_recall(graph, x, k):
    """Recall of each row's first k neighbours against its exact k nearest
    (itself excluded)."""
    exact = tnn.build_exact(x, k, res=CPU).graph.numpy()
    return recall_at_k(np.asarray(graph)[:, :k], exact)


def test_merge_dedup_bitwise_raft():
    """Duplicates (inside a list and across the two), -1 ids and +inf
    distances: the same ids, distances and update count."""
    rng = np.random.default_rng(1)
    n, k = 64, 12
    ids_a = rng.integers(-1, 40, (n, k)).astype(np.int32)
    ids_b = rng.integers(-1, 40, (n, 3 * k)).astype(np.int32)
    d_a = rng.random((n, k)).astype(np.float32)
    d_b = rng.random((n, 3 * k)).astype(np.float32)
    d_a[rng.random((n, k)) < 0.2] = np.inf
    d_b[rng.random((n, 3 * k)) < 0.2] = np.inf
    d_b[:, 5] = d_a[:, 2]            # value ties across the lists
    want = jnn._merge_dedup(jnp.asarray(ids_a), jnp.asarray(d_a), jnp.asarray(ids_b),
                            jnp.asarray(d_b), k)
    got = tnn._merge_dedup(*map(torch.from_numpy, (ids_a, d_a, ids_b, d_b)), k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


def test_reverse_edge_rule_matches_raft_on_collisions():
    """raft_tpu's jitted ``rev.at[tgt, slot].set(src, mode="drop")`` with
    many edges per bucket keeps the last edge in row-major order: the port's
    rule, on a graph with -1 holes."""
    rng = np.random.default_rng(2)
    n, k, s = 300, 24, 4                    # ~ k / s edges collide in each bucket
    g = rng.integers(-1, n, (n, k)).astype(np.int32)
    g[:, :3] = 7                            # a hub: hundreds of edges into row 7
    slot = rng.integers(0, s, (n, k)).astype(np.int32)

    @jax.jit
    def raft_rule(g, slot):
        rev = jnp.full((n, s), -1, jnp.int32)
        src = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, k))
        tgt = jnp.where(g >= 0, g, n)
        return rev.at[tgt.ravel(), slot.ravel()].set(src.ravel(), mode="drop")

    want = np.asarray(raft_rule(jnp.asarray(g), jnp.asarray(slot)))
    got = tnn.reverse_sample(torch.from_numpy(g), torch.from_numpy(slot), s).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[7] >= 0).all()


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_one_iteration_fed_raft_draws(data, metric):
    """The starting graph and one iteration from raft_tpu's own key splits
    (``_init_graph``, ``_nn_descent_iter``): ids equal on >= 99.9 % of slots,
    distances within RTOL / ATOL."""
    x = data
    n, k, s = x.shape[0], 32, 8
    key = jax.random.PRNGKey(3)
    k_init, key = jax.random.split(key)
    gi, gd = jnn._init_graph(k_init, jnp.asarray(x), metric, k)
    init = np.asarray(jax.random.randint(k_init, (n, k), 0, n, jnp.int32))
    ti, td = tnn.init_graph(torch.from_numpy(x), torch.from_numpy(init), metric, k, 256)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(gi))
    np.testing.assert_allclose(td.numpy(), np.asarray(gd), rtol=RTOL, atol=ATOL)

    _, k_it = jax.random.split(key)
    ji, jd, _ = jnn._nn_descent_iter(k_it, jnp.asarray(x), gi, gd, metric, s, 256)
    k1, k2 = jax.random.split(k_it)
    cols = np.asarray(jax.random.randint(k1, (n, s), 0, k))
    slot = np.asarray(jax.random.randint(k2, (n, k), 0, s))
    pi, pd, upd = tnn.nn_descent_iter(
        torch.from_numpy(x), torch.from_numpy(np.asarray(gi)), torch.from_numpy(np.asarray(gd)),
        torch.from_numpy(cols), torch.from_numpy(slot), metric, 100)
    ji, jd = np.asarray(ji), np.asarray(jd)
    assert (pi.numpy() == ji).mean() >= 0.999
    same = pi.numpy() == ji
    np.testing.assert_allclose(pd.numpy()[same], jd[same], rtol=RTOL, atol=ATOL)
    assert upd > 0


def test_build_and_build_batch_recall_within_001_of_raft(data):
    """Graph recall of the in-memory and the batch build (several clusters)
    within 0.01 of raft_tpu's at n = 2,000, d = 16."""
    x = data
    p = dict(graph_degree=16, intermediate_graph_degree=32, max_iterations=5)
    tb = tnn.build(tnn.IndexParams(**p), x, res=CPU)
    jb = jnn.build(jnn.IndexParams(**p), x)
    r_t, r_j = _graph_recall(tb.graph, x, 10), _graph_recall(jb.graph, x, 10)
    assert abs(r_t - r_j) <= 0.01 and r_t > 0.8, (r_t, r_j)
    assert tb.graph.shape == (2000, 16) and 1 <= len(tb.updates) <= 5
    again = tnn.build(tnn.IndexParams(**p), x, res=CPU)
    assert torch.equal(again.graph, tb.graph)          # one seed, one graph

    tbb = tnn.build_batch(tnn.IndexParams(**p), x, max_cluster_rows=1536, res=CPU)
    jbb = jnn.build_batch(jnn.IndexParams(**p), x, max_cluster_rows=1536)
    r_t, r_j = _graph_recall(tbb.graph, x, 10), _graph_recall(jbb.graph, x, 10)
    assert abs(r_t - r_j) <= 0.01 and r_t > 0.8, (r_t, r_j)


def test_batch_plan_merge_finalize_bitwise_raft_on_injected_plans(data, monkeypatch):
    """With one set of centres in both packages (their k-means seeds
    differ), ``plan_batches`` gives the same plan; folding the same local
    graphs through ``merge_local_graph`` and ``finalize_global_graph``
    gives the same global graph."""
    from raft_tpu.cluster import kmeans_balanced as jkb
    from raft_tpu_torch.cluster import kmeans_balanced as tkb

    x = data
    pool = x[np.random.default_rng(4).choice(x.shape[0], 64, replace=False)].copy()
    monkeypatch.setattr(jkb, "fit", lambda p, t, c, **kw: jnp.asarray(pool[:c]))
    monkeypatch.setattr(tkb, "fit", lambda p, t, c, **kw: torch.from_numpy(pool[:c]))
    params = dict(graph_degree=8, intermediate_graph_degree=16)
    jp = jnn.plan_batches(jnn.IndexParams(**params), x, max_cluster_rows=1024)
    tp = tnn.plan_batches(tnn.IndexParams(**params), x, max_cluster_rows=1024, res=CPU)
    assert len(tp["batches"]) == len(jp["batches"]) >= 4
    for a, b in zip(tp["batches"], jp["batches"]):
        np.testing.assert_array_equal(a, b)
    assert (tp["pad_m"], tp["k_out"]) == (jp["pad_m"], jp["k_out"])
    np.testing.assert_array_equal(tp["sentinel"], jp["sentinel"])
    assert vars(tp["local_params"]) == vars(jp["local_params"])
    np.testing.assert_array_equal(tnn.pad_batch(x, tp["batches"][1], tp),
                                  jnn.pad_batch(x, jp["batches"][1], jp))

    rng = np.random.default_rng(5)
    n, k_out, pad_m = x.shape[0], tp["k_out"], tp["pad_m"]
    g = [np.full((n, k_out), -1, np.int32), np.full((n, k_out), np.inf, np.float32)]
    h = [a.copy() for a in g]
    for rows in tp["batches"]:
        li = rng.integers(-1, pad_m, (pad_m, k_out)).astype(np.int32)
        ld = np.sort(rng.random((pad_m, k_out)).astype(np.float32), axis=1)
        tnn.merge_local_graph(*g, rows, torch.from_numpy(li), torch.from_numpy(ld), tp)
        jnn.merge_local_graph(*h, rows, jnp.asarray(li), jnp.asarray(ld), jp)
        np.testing.assert_array_equal(g[0], h[0])
        np.testing.assert_array_equal(g[1], h[1])
    tf, jf = tnn.finalize_global_graph(*g), jnn.finalize_global_graph(*h)
    np.testing.assert_array_equal(tf.graph.numpy(), np.asarray(jf.graph))
    np.testing.assert_array_equal(tf.distances.numpy(), np.asarray(jf.distances))


@pytest.mark.parametrize("algo", ["nn_descent", "nn_descent_batch"])
def test_cagra_build_nn_descent_serves(algo):
    """``cagra.build(build_algo=...)`` builds (it raised before this slice)
    and the search finds what the exact-graph build finds."""
    x = _blobs(1200, 16, seed=6)
    q = x[:40] + 0.1
    kw = dict(graph_degree=16, intermediate_graph_degree=24, nn_descent_niter=6)
    idx = tcagra.build(tcagra.IndexParams(build_algo=algo, **kw), x, res=CPU)
    assert idx.graph.shape == (1200, 16) and int(idx.graph.min()) >= 0
    _, got = tcagra.search(tcagra.SearchParams(), idx, q, 10, res=CPU)
    _, gt = tbf.knn(x, q, 10, res=CPU)
    assert recall_at_k(got.numpy(), gt.numpy()) >= 0.95
