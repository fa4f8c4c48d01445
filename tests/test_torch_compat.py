"""The port's pylibraft-compatible surface (``raft_tpu_torch.compat.pylibraft``)
on the CPU, mirroring ``tests/test_compat.py``: pylibraft's documented
calls run unmodified, each equal to the direct port call it wraps (and to
raft_tpu's compat call where both are deterministic), with output
conversion, ``device_ndarray``, the array wrappers, the decorators and the
logger bridge.  The default Resources is the CPU for each test."""

import logging
import os

import numpy as np
import pytest
import scipy.spatial.distance as sd
import torch

from raft_tpu.compat.pylibraft import config as jconfig
from raft_tpu.compat.pylibraft import distance as jdistance
from raft_tpu.compat.pylibraft import matrix as jmatrix
from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.compat.pylibraft import (
    cluster,
    common,
    config,
    distance,
    matrix,
    neighbors,
    random,
)
from raft_tpu_torch.core import resources
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.distance import fused_nn, pairwise
from raft_tpu_torch.neighbors import ball_cover, brute_force, cagra, extras, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.ops import matrix as omatrix
from raft_tpu_torch.random import datagen

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


@pytest.fixture(autouse=True)
def on_the_cpu():
    before = resources.default_resources() if resources._default is not None else None
    resources.set_default_resources(CPU)
    yield
    config.set_output_as("torch")
    resources.set_default_resources(before)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _eq(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else torch.equal(a, b)


def test_quickstart_pairwise_distance(rng):
    inp = rng.random((500, 29), dtype=np.float32)
    handle = common.DeviceResources()
    out = distance.pairwise_distance(inp, inp, metric="euclidean", handle=handle)
    handle.sync()
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert torch.equal(out, pairwise.pairwise_distance(inp, metric="euclidean", res=CPU))
    np.testing.assert_allclose(out.numpy(), sd.cdist(inp, inp), rtol=1e-3, atol=1e-4)
    y = rng.random((40, 29), dtype=np.float32)
    np.testing.assert_allclose(distance.pairwise_distance(inp, y, metric="cosine").numpy(),
                               np.asarray(jdistance.pairwise_distance(inp, y, metric="cosine")),
                               rtol=1e-5, atol=1e-5)


def test_fused_nn_argmin(rng):
    x = rng.random((100, 8), dtype=np.float32)
    y = rng.random((30, 8), dtype=np.float32)
    out = distance.fused_l2_nn_argmin(x, y)
    assert torch.equal(out, fused_nn.fused_l2_nn_argmin(x, y, res=CPU))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jdistance.fused_l2_nn_argmin(x, y)))
    for metric in ("euclidean", "cosine"):
        assert torch.equal(distance.fused_distance_nn_argmin(x, y, metric=metric),
                           fused_nn.fused_distance_nn_argmin(x, y, metric=metric, res=CPU))
    assert distance.DISTANCE_TYPES == sorted(pairwise.DISTANCE_TYPES)


def test_select_k(rng):
    scores = rng.random((10, 50), dtype=np.float32)
    vals, idx = matrix.select_k(scores, 5)
    assert _eq((vals, idx), omatrix.select_k(torch.from_numpy(scores), 5))
    jv, ji = jmatrix.select_k(scores, 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    vals, idx = matrix.select_k(scores, 5, select_min=False)
    np.testing.assert_array_equal(idx.numpy(), np.argsort(-scores, axis=1)[:, :5])


def test_kmeans_surface(rng):
    x = rng.random((400, 8), dtype=np.float32)
    params = cluster.KMeansParams(n_clusters=5, seed=0)
    centroids, inertia, n_iter = cluster.kmeans.fit(params, x)
    want = kmeans.fit(params, x, res=CPU)
    assert torch.equal(centroids, want[0]) and inertia == float(want[1]) and n_iter == want[2]
    cost = cluster.kmeans.cluster_cost(x, centroids)
    np.testing.assert_allclose(cost, inertia, rtol=1e-3)
    assert cost == float(kmeans.cluster_cost(x, centroids, res=CPU))
    newc = cluster.compute_new_centroids(x, centroids)
    assert torch.equal(newc, kmeans.compute_new_centroids(x, centroids, res=CPU))
    assert cluster.fit is cluster.kmeans.fit


def test_neighbors_roundtrip(tmp_path, rng):
    x = rng.random((2000, 16), dtype=np.float32)
    q = rng.random((20, 16), dtype=np.float32)
    assert _eq(neighbors.brute_force.knn(x, q, 10), brute_force.knn(x, q, 10, res=CPU))
    _, gt = neighbors.brute_force.knn(x, q, 10)
    fp = neighbors.ivf_flat.IndexParams(n_lists=20, kmeans_n_iters=4)
    fl = neighbors.ivf_flat.build(fp, x)
    sp = neighbors.ivf_flat.SearchParams(n_probes=20)
    assert _eq(neighbors.ivf_flat.search(sp, fl, q, 10),
               ivf_flat.search(sp, ivf_flat.build(fp, x, res=CPU), q, 10, res=CPU))
    ext = neighbors.ivf_flat.extend(fl, x[:50], np.arange(2000, 2050, dtype=np.int32))
    assert ext.size == 2050
    params = neighbors.ivf_pq.IndexParams(n_lists=20, pq_dim=8)
    index = neighbors.ivf_pq.build(params, x)
    psp = neighbors.ivf_pq.SearchParams(n_probes=20)
    _, cand = neighbors.ivf_pq.search(psp, index, q, 40)
    assert torch.equal(cand, ivf_pq.search(psp, index, q, 40, res=CPU)[1])
    d, ref = neighbors.refine(x, q, cand, 10)
    assert _eq((d, ref), refine(x, q, cand, 10, res=CPU))
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ref.numpy(), gt.numpy())])
    assert recall > 0.9
    fn = str(tmp_path / "pq.idx")
    neighbors.ivf_pq.save(fn, index)
    loaded = neighbors.ivf_pq.load(fn)
    assert torch.equal(cand, neighbors.ivf_pq.search(psp, loaded, q, 40)[1])
    assert neighbors.ivf_pq.extend(index, x[:10], np.arange(2000, 2010, dtype=np.int32)).size == 2010


def test_cagra_and_hnsw(tmp_path, rng):
    x = rng.random((1500, 16), dtype=np.float32)
    q = rng.random((20, 16), dtype=np.float32)
    params = neighbors.cagra.IndexParams(graph_degree=16, intermediate_graph_degree=32,
                                         build_algo="brute_force")
    index = neighbors.cagra.build(params, x)
    assert torch.equal(index.graph, cagra.build(params, x, res=CPU).graph)
    sp = neighbors.cagra.SearchParams()
    d, i = neighbors.cagra.search(sp, index, q, 5)
    assert _eq((d, i), cagra.search(sp, index, q, 5, res=CPU))
    fn = str(tmp_path / "c.idx")
    neighbors.cagra.save(fn, index)
    assert _eq(neighbors.cagra.search(sp, neighbors.cagra.load(fn), q, 5), (d, i))
    h = neighbors.hnsw.from_cagra(index, str(tmp_path / "h.hnsw"))
    d2, i2 = neighbors.hnsw.search(h, q, 5)
    assert i2.shape == (20, 5)
    h2 = neighbors.hnsw.load(str(tmp_path / "h.hnsw"), 16)
    assert _eq(neighbors.hnsw.search(h2, q, 5), (d2, i2))


def test_rbc_and_eps(rng):
    x = rng.random((800, 8), dtype=np.float32)
    q = rng.random((10, 8), dtype=np.float32)
    idx = neighbors.rbc.build(x, n_landmarks=20)
    own = ball_cover.build(x, n_landmarks=20, res=CPU)
    assert torch.equal(idx.list_index, own.list_index) and torch.equal(idx.radii, own.radii)
    d, i = neighbors.rbc.query(idx, q, 5)
    assert _eq((d, i), ball_cover.knn_query(own, q, 5, res=CPU))
    adj, deg = neighbors.rbc.eps_query(idx, q, 0.5)
    assert _eq((adj, deg), ball_cover.eps_nn(own, q, 0.5, res=CPU))
    adj2, deg2 = neighbors.eps_neighborhood(q, x, 0.5)
    assert adj2.shape == (10, 800) and _eq((adj2, deg2), (adj, deg))
    assert _eq((adj2, deg2), extras.epsilon_neighborhood(q, x, 0.5, res=CPU))


def test_rmat():
    edges = random.rmat(4, 4, 1000, seed=1)
    assert edges.shape == (1000, 2)
    assert int(edges.max()) < 16 and int(edges.min()) >= 0
    want = datagen.rmat(torch.Generator().manual_seed(1), 4, 4, 1000, res=CPU)
    assert torch.equal(edges, want)
    assert torch.equal(random.rmat(4, 4, 1000, seed=1), edges)


def test_output_conversion_hook(rng):
    x = rng.random((10, 4), dtype=np.float32)
    assert config.get_output_as() == "torch"
    assert isinstance(distance.pairwise_distance(x, x), torch.Tensor)
    config.set_output_as("numpy")
    out = distance.pairwise_distance(x, x)
    assert isinstance(out, np.ndarray)
    v, i = matrix.select_k(x, 2)
    assert isinstance(v, np.ndarray) and isinstance(i, np.ndarray)
    seen = []
    config.set_output_as(lambda a: (seen.append(1), a.numpy())[1])
    distance.pairwise_distance(x, x)
    assert seen
    for bad in ("jax", "cupy"):
        with pytest.raises(ValueError):
            config.set_output_as(bad)
    # raft_tpu's hook took "jax"; the port's refuses it (and raft_tpu's keeps its own)
    assert jconfig.get_output_as() == "jax"


def test_device_ndarray(rng):
    a = rng.random((5, 3), dtype=np.float32)
    d = common.device_ndarray(a)
    assert d.shape == (5, 3) and d.dtype == np.float32
    np.testing.assert_array_equal(d.copy_to_host(), a)
    np.testing.assert_array_equal(np.asarray(d), a)
    assert d.array.device.type == "cpu"
    out = distance.pairwise_distance(d, d)
    assert out.shape == (5, 5)
    e = common.device_ndarray.empty((2, 4), np.int32)
    assert e.shape == (2, 4) and e.dtype == np.int32
    with pytest.raises(ValueError):
        common.device_ndarray.empty((2, 2), order="F")


def test_inputs_are_taken_without_a_copy(rng):
    t = torch.from_numpy(rng.random((6, 3), dtype=np.float32))
    assert common.to_device_array(t).data_ptr() == t.data_ptr()
    assert common.to_device_array(t, "cpu").data_ptr() == t.data_ptr()

    class DLPackOnly:
        def __init__(self, tensor):
            self._t = tensor

        def __dlpack__(self, *args, **kwargs):
            return self._t.__dlpack__(*args, **kwargs)

        def __dlpack_device__(self):
            return self._t.__dlpack_device__()

    assert common.to_device_array(DLPackOnly(t)).data_ptr() == t.data_ptr()
    assert common.to_device_array([[1.0, 2.0]]).shape == (1, 2)


def test_cai_wrapper_and_decorators():
    w = common.cai_wrapper(np.ones((3, 4), np.float32))
    assert w.shape == (3, 4) and w.dtype == np.float32 and w.c_contiguous
    w2 = common.cai_wrapper(common.device_ndarray(np.zeros((2, 2))))
    assert w2.shape == (2, 2) and w2.dtype == np.float64
    assert not common.cai_wrapper(torch.zeros(4, 6).T).c_contiguous
    assert common.ai_wrapper is common.cai_wrapper and common.Handle is common.DeviceResources
    calls = {}

    @common.auto_sync_handle
    def fn(x, handle=None):
        calls["handle"] = handle
        return x

    assert fn(5) == 5
    assert isinstance(calls["handle"], common.DeviceResources)
    mine = common.DeviceResources()
    fn(6, mine)
    assert calls["handle"] is mine

    @common.auto_convert_output
    def gn():
        return torch.ones(3), "meta", [torch.zeros(1)], {"a": torch.ones(2)}

    config.set_output_as("numpy")
    out, meta, lst, dct = gn()
    assert isinstance(out, np.ndarray) and meta == "meta"
    assert isinstance(lst[0], np.ndarray) and isinstance(dct["a"], np.ndarray)


def test_handle_sync_is_a_cancellation_point():
    import threading

    from raft_tpu_torch.core import interruptible

    handle = common.DeviceResources()
    t = threading.Thread(target=interruptible.cancel, args=(threading.get_ident(),))
    t.start()
    t.join()
    with pytest.raises(InterruptedError):
        handle.sync()
    handle.sync()


def test_logger_bridge_and_algorithm_logs(caplog):
    from raft_tpu_torch.core import native
    from raft_tpu_torch.core.logger import bridge_native

    assert bridge_native() == native.available()
    if native.available():
        native.log_set_level(6)
        with caplog.at_level(logging.DEBUG, logger="raft_tpu_torch"):
            native.log(4, "from the native core")
        assert any("from the native core" in r.message for r in caplog.records)
