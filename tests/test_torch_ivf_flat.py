"""Port parity of IVF-Flat: a raft_tpu-built index saved and loaded into
``raft_tpu_torch`` searches like raft_tpu's fused (Pallas, interpret mode)
legs; the port's own build reaches raft_tpu's recall; k-means predict and
one balancing step agree on injected state."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu_torch import kernels
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.stats.metrics import recall_at_k

CPU = Resources(device="cpu")


def _blobs(n, d, n_q, seed, n_centers=24):
    """Gaussian blobs centred near the origin: |x|^2 stays of the order of
    the distances, so a value tolerance of rtol 1e-5 measures summation
    order (XLA's dot against the port's sequential one), not the
    cancellation in |y|^2 - 2 q.y + |q|^2 that far-off blobs would add."""
    rng = np.random.default_rng(seed)
    centers = (rng.random((n_centers, d)).astype(np.float32) - 0.5) * 6
    x = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, n_centers, n_q)] + rng.standard_normal((n_q, d)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _blobs(3000, 32, 512, 0)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine"])
def test_search_parity_on_a_raft_built_index(data, metric, tmp_path, monkeypatch):
    x, q = data
    jidx = jivf.build(jivf.IndexParams(n_lists=32, kmeans_n_iters=4, metric=metric), x)
    path = str(tmp_path / "ivf_flat.idx")
    jivf.save(path, jidx)
    tidx = tivf.load(path, res=CPU)
    assert tidx.metric == metric and tidx.list_cap == jidx.list_cap
    sp_j = jivf.SearchParams(n_probes=4)
    sp_t = tivf.SearchParams(n_probes=4)
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    for n_q in (64, 512):  # query-major, then probe-major
        v_ref, i_ref = jivf.search(sp_j, jidx, q[:n_q], 10)
        v, i = tivf.search(sp_t, tidx, torch.from_numpy(q[:n_q]), 10, res=CPU)
        assert kernels.consume_kernel_path() == "torch"
        assert v.dtype == torch.float32 and i.dtype == torch.int32
        assert (i.numpy() == np.asarray(i_ref)).mean() >= 0.999, (metric, n_q)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-4)


def test_strategies_agree_and_from_numpy(data, tmp_path):
    x, q = data
    jidx = jivf.build(jivf.IndexParams(n_lists=16, kmeans_n_iters=3), x)
    arrays = {name: np.asarray(getattr(jidx, name)) for name in
              ("centers", "list_data", "list_index", "list_sizes", "list_norms")}
    tidx = tivf.from_numpy(arrays, "sqeuclidean", res=CPU)
    outs = [tivf.search(tivf.SearchParams(n_probes=5, strategy=s), tidx, q[:300], 7, res=CPU)
            for s in ("query_major", "probe_major")]
    assert torch.equal(outs[0][1], outs[1][1])
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-4)
    # save → load round trip, and the port's file loads into raft_tpu
    path = str(tmp_path / "port.idx")
    tivf.save(path, tidx)
    back = tivf.load(path, res=CPU)
    for name in arrays:
        assert torch.equal(getattr(back, name), getattr(tidx, name)), name
    jback = jivf.load(path)
    np.testing.assert_array_equal(np.asarray(jback.list_index), arrays["list_index"])


def test_own_build_recall_matches_raft(data):
    x, q = data
    q = q[:200]
    d2 = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :10]
    params = dict(n_lists=32, kmeans_n_iters=10)
    jidx = jivf.build(jivf.IndexParams(**params), x)
    tidx = tivf.build(tivf.IndexParams(**params), x, res=CPU)
    assert tidx.size == x.shape[0]
    _, ji = jivf.search(jivf.SearchParams(n_probes=3), jidx, q, 10)
    _, ti = tivf.search(tivf.SearchParams(n_probes=3), tidx, q, 10, res=CPU)
    r_j, r_t = recall_at_k(np.asarray(ji), gt), recall_at_k(ti, gt)
    assert r_t >= r_j - 0.02, (r_t, r_j)


def test_extend_appends_and_finds_new_rows(data):
    x, _ = data
    idx = tivf.build(tivf.IndexParams(n_lists=16, kmeans_n_iters=3), x[:2500], res=CPU)
    new = tivf.extend(idx, x[2500:2540], np.arange(10_000, 10_040), res=CPU)
    assert new.size == 2540 and new.list_cap == idx.list_cap  # append fast path
    _, i = tivf.search(tivf.SearchParams(n_probes=16), new, x[2500:2540], 1, res=CPU)
    assert (i[:, 0].numpy() == np.arange(10_000, 10_040)).all()
    with pytest.raises(NotImplementedError):
        tivf.search(tivf.SearchParams(), new, x[:4], 3, sample_filter=object(), res=CPU)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
def test_predict_labels_equal(metric):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2000, 24)).astype(np.float32)
    centers = rng.standard_normal((40, 24)).astype(np.float32)
    ref = np.asarray(jkb.predict(centers, x, metric=metric))
    got = tkb.predict(centers, x, metric=metric, res=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_one_balancing_step_matches_on_injected_centers():
    # balanced, well-separated blobs: no cluster starves, so no draw happens
    rng = np.random.default_rng(6)
    k, per, d = 8, 100, 16
    centers = rng.random((k, d)).astype(np.float32) * 20
    x = (np.repeat(centers, per, 0) + rng.standard_normal((k * per, d))).astype(np.float32)
    c0 = (centers + 0.5 * rng.standard_normal((k, d))).astype(np.float32)
    w = np.ones(k * per, np.float32)
    jc, jl = jkb._balanced_iterations(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(c0),
                                      jnp.asarray(w), 1, k, "sqeuclidean", 1 << 16)
    tc, tl = tkb._balanced_iterations(torch.Generator().manual_seed(0), torch.from_numpy(x),
                                      torch.from_numpy(c0), torch.from_numpy(w), 1, k,
                                      "sqeuclidean", 1 << 16)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_draw_rows_past_the_multinomial_limit():
    """Seed rows are drawn without replacement ∝ weight over any row count
    (``torch.multinomial`` refuses more than 2**24 categories)."""
    n = (1 << 24) + 3
    w = torch.ones((1, n))
    w[0, : n // 2] = 0.0
    a = tkb.draw_rows(torch.Generator().manual_seed(0), w, 16)
    b = tkb.draw_rows(torch.Generator().manual_seed(0), w, 16)
    assert a.shape == (1, 16) and torch.equal(a, b)
    assert len(set(a[0].tolist())) == 16
    assert bool(((a >= n // 2) & (a < n)).all())       # weight 0 is never drawn
    few = tkb.draw_rows(torch.Generator().manual_seed(1), torch.ones((3, 5)), 8)
    assert few.shape == (3, 8) and bool(((few >= 0) & (few < 5)).all())  # with replacement


def test_hierarchical_fit_is_balanced():
    x, _ = _blobs(4000, 16, 1, 7, n_centers=64)
    params = tkb.KMeansBalancedParams(n_iters=5)
    centers = tkb.fit(params, x, 300, res=CPU)  # > mesocluster_threshold: hierarchy
    assert centers.shape == (300, 16) and bool(torch.isfinite(centers).all())
    sizes = np.bincount(tkb.predict(centers, x, res=CPU).numpy(), minlength=300)
    assert sizes.max() <= 8 * 4000 / 300


def test_common_helpers_match_raft():
    from raft_tpu.neighbors import _common as jc
    from raft_tpu_torch.neighbors import _common as tc

    rng = np.random.default_rng(8)
    probes = rng.integers(0, 12, size=(50, 4)).astype(np.int32)
    for got, ref in zip(tc.invert_probes(torch.from_numpy(probes), 12, 16)[:3],
                        jc.invert_probes(jnp.asarray(probes), 12, 16)[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    labels = rng.integers(0, 10, size=700)
    labels[:200] = 3  # one oversized list to split
    for max_cap in (None, 64):
        got = tc.compute_list_layout(labels, 10, max_cap=max_cap, headroom=True)
        if max_cap is None:
            ref = jc.compute_list_layout(labels, 10, max_cap=None, headroom=True)
        else:  # raft_tpu's numpy route (its native layout pass may order slots otherwise)
            split, cmap = jc.split_oversized_lists(labels, 10, max_cap)
            ref = jc.compute_list_layout(split, len(cmap), max_cap=None, headroom=True)
            ref = (ref[0], ref[1], ref[2], cmap, min(ref[4], jc.round_up(max_cap, 8)))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for args in [("auto", 1000, 20, 64, 300, 32, 1 << 28, 10),
                 ("auto", 100, 20, 64, 300, 32, 1 << 28, 10),
                 ("probe_major", 5000, 8, 1024, 900, 128, 1 << 20, 10)]:
        assert tc.select_scan_strategy(*args) == jc.select_scan_strategy(*args)
    assert tc.default_max_cap(1_000_000, 1024) == jc.default_max_cap(1_000_000, 1024)
    centers = np.repeat(rng.standard_normal((5, 3)).astype(np.float32), 2, 0)
    got = tc.merge_split_lists(centers, np.arange(10) % 7)
    ref = jc.merge_split_lists(centers, np.arange(10) % 7)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    ids = torch.tensor([[3, -1, 0]], dtype=torch.int32)
    assert tc.invalid_mask(ids).tolist() == [[False, True, False]]
