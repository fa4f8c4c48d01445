"""Port parity: flat k-means (``raft_tpu_torch.cluster.kmeans``) against
raft_tpu's on the same numpy inputs.  With the same initial centers
(``init="array"``) the Lloyd loops run the same steps: labels and
``n_iter`` equal, centers and inertia within rtol 1e-5 (sums in another
order).  kmeans++ draws from a torch.Generator, not raft_tpu's threefry, so
it is held to reproducibility and to raft_tpu's inertia within 10 %."""

import os
import numpy as np
import pytest
import torch

from raft_tpu import cluster as jcluster
from raft_tpu.cluster import kmeans as jkm
from raft_tpu_torch import cluster as tcluster
from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.core.resources import Resources

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _blobs(n=600, d=12, k=6, seed=0, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 3
    labels = rng.integers(0, k, n)
    x = centers[labels] + spread * rng.standard_normal((n, d))
    return (x - x.mean(0)).astype(np.float32)


def _init(x, k, seed=1):
    return x[np.random.default_rng(seed).choice(len(x), k, replace=False)]


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fit_with_array_init_matches_raft_tpu(metric, weighted):
    x = _blobs()
    c0 = _init(x, 6)
    w = np.random.default_rng(2).uniform(0.5, 2.0, len(x)).astype(np.float32) if weighted else None
    params = dict(n_clusters=6, init="array", max_iter=50, tol=1e-6, metric=metric,
                  batch_samples=128)   # several assignment tiles
    jc, ji, jn = jkm.fit(jkm.KMeansParams(**params), x, w, init_centers=c0)
    tc, ti, tn = tkm.fit(tkm.KMeansParams(**params), x, w, init_centers=c0, res=CPU)
    assert tn == int(jn)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    kw = {"metric": metric}
    np.testing.assert_array_equal(tkm.predict(tc, x, res=CPU, **kw).numpy(),
                                  np.asarray(jkm.predict(jc, x, **kw)))


def test_fit_stops_at_max_iter_and_records_each_inertia():
    x = _blobs(seed=3, spread=1.5)
    c0 = _init(x, 8, seed=4)
    params = dict(n_clusters=8, init="array", max_iter=3, tol=0.0)
    _, ji, jn = jkm.fit(jkm.KMeansParams(**params), x, init_centers=c0)
    history = []
    _, ti, tn = tkm.fit(tkm.KMeansParams(**params), x, init_centers=c0, history=history,
                        res=CPU)
    assert tn == int(jn) == 3 and len(history) == 3
    assert history[0] >= history[1] >= history[2] >= float(ti)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


def test_predict_transform_cluster_cost_match_raft_tpu():
    x = _blobs(seed=5)
    c = _init(x, 6, seed=6)
    np.testing.assert_array_equal(tkm.predict(c, x, batch_samples=100, res=CPU).numpy(),
                                  np.asarray(jkm.predict(c, x, batch_samples=100)))
    np.testing.assert_allclose(tkm.transform(c, x, res=CPU).numpy(),
                               np.asarray(jkm.transform(c, x)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(tkm.cluster_cost(x, c, batch_samples=100, res=CPU)),
                               float(jkm.cluster_cost(x, c, batch_samples=100)), rtol=1e-5)


@pytest.mark.parametrize("with_labels", [False, True])
def test_compute_new_centroids_matches_raft_tpu(with_labels):
    x = _blobs(seed=7)
    c = _init(x, 6, seed=8)
    c[5] = 100.0   # a cluster no row joins keeps its center
    w = np.random.default_rng(9).uniform(0.5, 2.0, len(x)).astype(np.float32)
    labels = np.asarray(jkm.predict(c, x)) if with_labels else None
    want = np.asarray(jkm.compute_new_centroids(x, c, labels, w))
    got = tkm.compute_new_centroids(x, c, labels, w, res=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[5] == 100.0).all()


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_seeded_inits_are_reproducible_and_near_raft_tpu(init):
    x = _blobs(n=800, k=6, seed=10)
    params = dict(n_clusters=6, init=init, n_init=3, seed=11, max_iter=100)
    a = tkm.fit(tkm.KMeansParams(**params), x, res=CPU)
    b = tkm.fit(tkm.KMeansParams(**params), x, res=CPU)
    assert torch.equal(a[0], b[0]) and float(a[1]) == float(b[1]) and a[2] == b[2]
    if init == "kmeans++":
        _, ji, _ = jkm.fit(jkm.KMeansParams(**params), x)
        assert float(a[1]) <= 1.10 * float(ji)
    else:   # distinct rows of x; random seeds may share a blob, so no quality bar
        c0 = tkm.fit(tkm.KMeansParams(**{**params, "max_iter": 0, "n_init": 1}), x, res=CPU)[0]
        rows = {tuple(r) for r in x}
        assert len({tuple(r) for r in c0.numpy()} & rows) == 6
    centers = tkm.kmeans_plus_plus_init(torch.Generator().manual_seed(0), torch.from_numpy(x), 6)
    assert centers.shape == (6, 12) and len(np.unique(centers.numpy(), axis=0)) == 6


def test_fit_predict_and_the_checks():
    x = _blobs(seed=12)
    c, labels, inertia, n_iter = tkm.fit_predict(tkm.KMeansParams(n_clusters=6, seed=1), x,
                                                 res=CPU)
    assert labels.shape == (600,) and labels.dtype == torch.int32 and n_iter >= 2
    np.testing.assert_allclose(float(tkm.cluster_cost(x, c, res=CPU)), float(inertia), rtol=1e-5)
    with pytest.raises(ValueError, match="init_centers"):
        tkm.fit(tkm.KMeansParams(init="array"), x, res=CPU)
    with pytest.raises(ValueError, match="sqeuclidean/cosine"):
        tkm.fit(tkm.KMeansParams(metric="l1"), x, res=CPU)


def test_exports_match_raft_tpu():
    ported = {"KMeansParams", "fit", "predict", "fit_predict", "transform", "cluster_cost",
              "compute_new_centroids", "kmeans_plus_plus_init", "kmeans_balanced",
              "spectral", "find_k", "SingleLinkageOutput", "single_linkage"}
    # every name of raft_tpu's but fit_sharded (multi-GPU: ROADMAP Queue 1 item 7)
    assert set(tcluster.__all__) == ported == set(jcluster.__all__) - {"fit_sharded"}
    for name in ported - {"kmeans_balanced", "spectral", "find_k", "SingleLinkageOutput",
                          "single_linkage"}:
        assert getattr(tcluster, name) is getattr(tkm, name)
