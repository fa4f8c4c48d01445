"""Port parity of ``neighbors.ball_cover`` on the CPU: one seed draws
bitwise raft_tpu's landmarks; the labels (ball membership) and radii agree
within rtol 1e-5 / atol 1e-4; ``knn_query`` is exact at ``n_probes = L``
on both scan schedules; at the default probes the port searches raft_tpu's
own index (its six arrays carried across) to raft_tpu's ids, values within
rtol 1e-5 / atol 1e-4 and ids equal except at near-ties; euclidean is the
root of sqeuclidean; haversine; ``all_knn_query``; and ``eps_nn`` equal to
``extras.epsilon_neighborhood``, to raft_tpu's ``eps_nn`` and to numpy, in
sqeuclidean, euclidean and haversine (mirrors
``tests/test_neighbors_extras.py``'s ball-cover cases)."""

import os

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ball_cover as jbc
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ball_cover, brute_force, extras

from _torch_parity import assert_topk_match

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.random((3000, 16), dtype=np.float32)
    q = rng.random((300, 16), dtype=np.float32)
    return x, q


def _sphere(n, seed):
    """(lat, lon) radians: half uniform, half in 8 tight clusters."""
    rng = np.random.default_rng(seed)
    u = np.stack([np.arcsin(rng.uniform(-1, 1, n // 2)), rng.uniform(-np.pi, np.pi, n // 2)], 1)
    centres = np.stack([np.arcsin(rng.uniform(-0.9, 0.9, 8)), rng.uniform(-3, 3, 8)], 1)
    c = centres[rng.integers(0, 8, n - n // 2)] + rng.normal(0, 0.05, (n - n // 2, 2))
    return np.concatenate([u, c]).astype(np.float32)


def _haversine(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    sdlat = np.sin((b[:, 0] - a[:, None, 0]) / 2)
    sdlon = np.sin((b[:, 1] - a[:, None, 1]) / 2)
    h = sdlat ** 2 + np.cos(a[:, None, 0]) * np.cos(b[:, 0]) * sdlon ** 2
    return 2 * np.arcsin(np.sqrt(np.clip(h, 0, 1)))


def _carried(jidx):
    """raft_tpu's index arrays as the port's index on the CPU."""
    return ball_cover.BallCoverIndex(
        jidx.metric, *(np.array(a) for a in (jidx.landmarks, jidx.list_vecs, jidx.list_index,
                                               jidx.list_sizes, jidx.radii)), res=CPU)


def _labels(list_index, n):
    ids = np.asarray(list_index)
    out = np.full(n, -1)
    lst, _ = np.nonzero(ids >= 0)
    out[ids[ids >= 0]] = lst
    return out


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "haversine"])
def test_build_matches_raft_tpu(data, metric):
    x = _sphere(2000, 1) if metric == "haversine" else data[0]
    j = jbc.build(x, metric=metric, n_landmarks=40, seed=3)
    t = ball_cover.build(x, metric=metric, n_landmarks=40, seed=3, res=CPU)
    assert t.metric == j.metric
    np.testing.assert_array_equal(t.landmarks.numpy(), np.asarray(j.landmarks))
    np.testing.assert_array_equal(_labels(t.list_index, len(x)), _labels(j.list_index, len(x)))
    np.testing.assert_array_equal(t.list_sizes.numpy(), np.asarray(j.list_sizes))
    np.testing.assert_array_equal(t.list_index.numpy(), np.asarray(j.list_index))
    np.testing.assert_array_equal(t.list_vecs.numpy(), np.asarray(j.list_vecs))
    np.testing.assert_allclose(t.radii.numpy(), np.asarray(j.radii), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_queries", [40, 300])   # query-major, probe-major
def test_knn_query_probing_every_ball_is_exact(data, n_queries):
    x, q = data
    q = q[:n_queries]
    idx = ball_cover.build(x, n_landmarks=50, res=CPU)
    v, i = ball_cover.knn_query(idx, q, 10, n_probes=50, res=CPU)
    gv, gi = jbf.knn(x, q, 10)
    assert_topk_match(v.numpy(), i.numpy(), np.asarray(gv), np.asarray(gi), rtol=RTOL, atol=ATOL)
    bv, bi = brute_force.knn(x, q, 10, res=CPU)
    assert_topk_match(v.numpy(), i.numpy(), bv.numpy(), bi.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_queries", [40, 300])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_default_probes_match_raft_tpu_on_its_own_index(data, n_queries, metric):
    x, q = data
    j = jbc.build(x, metric=metric)
    jv, ji = jbc.knn_query(j, q[:n_queries], 10)
    v, i = ball_cover.knn_query(_carried(j), q[:n_queries], 10, res=CPU)
    assert_topk_match(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji), rtol=RTOL, atol=ATOL)
    # the approximate mode's recall, as raft_tpu's test holds it
    _, gt = jbf.knn(x, q[:n_queries], 10)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i.numpy(), np.asarray(gt))])
    assert recall >= 0.9, recall


def test_euclidean_is_the_root_of_sqeuclidean(data):
    x, q = data
    sq = ball_cover.build(x, n_landmarks=40, res=CPU)
    eu = ball_cover.build(x, metric="euclidean", n_landmarks=40, res=CPU)
    for n_queries in (40, 300):
        vs, i_s = ball_cover.knn_query(sq, q[:n_queries], 10, res=CPU)
        ve, i_e = ball_cover.knn_query(eu, q[:n_queries], 10, res=CPU)
        assert torch.equal(i_s, i_e)
        assert torch.equal(ve, torch.sqrt(vs))


def test_haversine(data):
    pts = _sphere(2000, 2)
    q = pts[:60] + np.float32(0.01)
    j = jbc.build(pts, metric="haversine", n_landmarks=30)
    t = _carried(j)
    # every ball probed: exact against float64 brute force
    v, i = ball_cover.knn_query(t, q, 5, n_probes=30, res=CPU)
    ref = _haversine(q, pts)
    gt = np.argsort(ref, axis=1)[:, :5]
    np.testing.assert_allclose(v.numpy(), np.take_along_axis(ref, gt, 1), rtol=0, atol=1e-5)
    assert (i.numpy() == gt).mean() >= 0.99
    # default probes: raft_tpu's ids on its own index
    jv, ji = jbc.knn_query(j, q, 5)
    v, i = ball_cover.knn_query(t, q, 5, res=CPU)
    assert_topk_match(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji), rtol=RTOL, atol=ATOL)


def test_all_knn_query(data):
    x, _ = data
    j = jbc.build(x[:500], n_landmarks=22)
    jv, ji = jbc.all_knn_query(j, 5, n_probes=22)
    t = _carried(j)
    v, i = ball_cover.all_knn_query(t, 5, n_probes=22, res=CPU)
    np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(500))
    assert_topk_match(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji), rtol=RTOL, atol=ATOL)
    v2, i2 = ball_cover.knn_query(t, x[:500], 5, n_probes=22, res=CPU)
    assert torch.equal(v, v2) and torch.equal(i, i2)


@pytest.mark.parametrize("metric,eps", [("sqeuclidean", 1.0), ("euclidean", 1.0),
                                        ("haversine", 0.3)])
def test_eps_nn(data, metric, eps):
    if metric == "haversine":
        x = _sphere(1500, 4)
        q = x[:50] + np.float32(0.02)
        d = _haversine(q, x)
    else:
        x, q = data[0][:1500], data[1][:50]
        d = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
        if metric == "euclidean":
            d = np.sqrt(d)
    j = jbc.build(x, metric=metric, n_landmarks=20)
    adj, deg = ball_cover.eps_nn(_carried(j), q, eps, res=CPU)
    assert int(deg.sum()) > 0
    np.testing.assert_array_equal(adj.numpy(), d <= eps)
    np.testing.assert_array_equal(deg.numpy(), (d <= eps).sum(1))
    jadj, jdeg = jbc.eps_nn(j, q, eps)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    own, _ = ball_cover.eps_nn(ball_cover.build(x, metric=metric, n_landmarks=20, res=CPU), q, eps,
                               res=CPU)
    assert torch.equal(own, adj)
    if metric != "haversine":
        eps_sq = eps ** 2 if metric == "euclidean" else eps
        eadj, edeg = extras.epsilon_neighborhood(q, x, eps_sq, res=CPU)
        assert torch.equal(eadj, adj) and torch.equal(edeg, deg)


def test_eps_nn_pruning_keeps_hits_on_the_ball_boundary():
    """Queries placed on the triangle-inequality bound of their balls (a
    landmark's farthest member at exactly the pruning distance): no hit is
    pruned by rounding."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((800, 8)) * 10).astype(np.float32)
    idx = ball_cover.build(x, n_landmarks=16, res=CPU)
    q = x[rng.choice(800, 40, replace=False)] + np.float32(1e-3)
    for eps in (0.0, 1e-6, 4.0, 50.0):
        adj, _ = ball_cover.eps_nn(idx, q, eps, res=CPU)
        eadj, _ = extras.epsilon_neighborhood(q, x, eps, res=CPU)
        assert torch.equal(adj, eadj), eps


@pytest.mark.parametrize("metric", ["sqeuclidean", "haversine"])
@pytest.mark.parametrize("workspace", [1, 1 << 16])
def test_eps_nn_in_tiles_of_balls(data, metric, workspace):
    """Workspaces that split the surviving balls into many tiles (one ball a
    tile at 1 byte) give the one-tile answer; an eps equal to a pair's own
    float64 distance keeps that pair (its f32 distance is re-decided)."""
    if metric == "haversine":
        x = _sphere(1200, 4)
        q = x[:40] + np.float32(0.01)
        d = _haversine(q, x)
        eps = 0.25
    else:
        x, q = data[0][:1200], data[1][:40]
        d = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
        eps = float(np.sort(d[0])[30])       # query 0's 31st neighbour, exactly
    idx = ball_cover.build(x, metric=metric, n_landmarks=24, res=CPU)
    one, one_deg = ball_cover.eps_nn(idx, q, eps, res=CPU)
    small = Resources(device="cpu", workspace_limit_bytes=workspace)
    adj, deg = ball_cover.eps_nn(idx, q, eps, res=small)
    assert torch.equal(adj, one) and torch.equal(deg, one_deg)
    np.testing.assert_array_equal(adj.numpy(), d <= eps)
    if metric == "sqeuclidean":
        assert int(deg[0]) == 31
