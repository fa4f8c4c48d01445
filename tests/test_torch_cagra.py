"""Port parity: CAGRA of ``raft_tpu_torch`` against raft_tpu's — the graph
``optimize`` bitwise, the exact kNN graph, search on an index raft_tpu
built (one set of seed ids for both, raft_tpu's fused hop in interpret
mode), the file format both ways, the port's own builds at raft_tpu's
recall thresholds, and the options this slice does not serve."""

import os
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import nn_descent as jnn
from raft_tpu_torch import kernels
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import nn_descent as tnn
from raft_tpu_torch.neighbors._common import sorted_id_dedup
from raft_tpu_torch.stats.metrics import recall_at_k
from raft_tpu_torch.store import paginate_index

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def data():
    """Clustered rows (20 blobs, std 2) and queries near data rows."""
    rng = np.random.default_rng(0)
    centers = rng.uniform(-10, 10, (20, 32))
    x = (centers[rng.integers(0, 20, 1200)] + rng.normal(0, 2.0, (1200, 32))).astype(np.float32)
    q = (x[rng.choice(1200, 48, replace=False)] + rng.normal(0, 1.0, (48, 32))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def raft_index(data):
    x, _ = data
    return jcagra.build(jcagra.IndexParams(intermediate_graph_degree=48, graph_degree=16,
                                           build_algo="brute_force"), x)


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("workspace", [256 << 20, 1 << 20])   # 1 MiB: 8-row prune tiles
def test_optimize_matches_raft_bitwise(data, holes, workspace):
    x, _ = data
    knn = np.asarray(jnn.build_exact(x, 32).graph).copy()
    if holes:
        knn[::7, 25:] = -1       # rows missing their tail neighbours
    want = np.asarray(jcagra.optimize(jnp.asarray(knn), 16))
    got = tcagra.optimize(knn, 16, res=Resources(device="cpu", workspace_limit_bytes=workspace))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sorted_id_dedup_matches_raft():
    from raft_tpu.neighbors._common import sorted_id_dedup as j_dedup

    ids = np.random.default_rng(1).integers(-1, 20, size=(6, 40)).astype(np.int32)
    order, dup = sorted_id_dedup(torch.from_numpy(ids))
    j_order, j_dup = j_dedup(jnp.asarray(ids))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(dup.numpy(), np.asarray(j_dup))


def test_build_exact_matches_raft():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1000, 24)).astype(np.float32)   # tie-free
    want = jnn.build_exact(x, 20)
    got = tnn.build_exact(x, 20, res=CPU)
    np.testing.assert_array_equal(got.graph.numpy(), np.asarray(want.graph))
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(want.distances),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
def test_search_parity_on_a_raft_built_index(data, metric, tmp_path, monkeypatch):
    """raft_tpu builds and saves, the port loads; with one set of seed ids
    the two searches agree: ids on >= 99% of slots, values within rtol
    1e-5 / atol 1e-4.  The rows are scaled to |v|^2 ~ 80 so that the two
    summation orders of |q|^2 + |v|^2 - 2 q.v stay inside that tolerance."""
    x, q = (a * np.float32(0.25) for a in data)
    jidx = jcagra.build(jcagra.IndexParams(metric=metric, intermediate_graph_degree=48,
                                           graph_degree=16, build_algo="brute_force"), x)
    path = str(tmp_path / "cagra.idx")
    jcagra.save(path, jidx)
    tidx = tcagra.load(path, res=CPU)
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    for itopk in (32, 64):
        jsp, tsp = jcagra.SearchParams(itopk_size=itopk), tcagra.SearchParams(itopk_size=itopk)
        seeds = np.asarray(jcagra.make_seed_ids(jsp, jidx, jnp.asarray(q), 10))
        jd, ji = jcagra.search(jsp, jidx, q, 10, seed_ids=seeds)
        td, ti = tcagra.search(tsp, tidx, q, 10, seed_ids=seeds, res=CPU)
        assert kernels.consume_kernel_path() == "torch"
        assert (ti.numpy() == np.asarray(ji)).mean() >= 0.99
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)


def test_entry_seeds_and_build_parameters_match_raft(raft_index, data):
    _, q = data
    jidx = raft_index
    want = np.asarray(jcagra._entry_seeds(jnp.asarray(q), jidx.entry_centers,
                                          jidx.entry_ids, 16, "sqeuclidean"))
    got = tcagra._entry_seeds(torch.from_numpy(q), torch.from_numpy(np.array(jidx.entry_centers)),
                              torch.from_numpy(np.array(jidx.entry_ids)), 16, "sqeuclidean")
    np.testing.assert_array_equal(got.numpy(), want)
    for n in (100, 1200, 20_000, 1_000_000, 50_000_000):
        assert tcagra._auto_entry_points(n) == jcagra._auto_entry_points(n)
    for n, d in ((1500, 32), (20_000, 96), (1_000_000, 128)):
        jip, jsp, jk = jcagra._graph_build_ivf_pq_params(jcagra.IndexParams(), n, d)
        tip, tsp, tk = tcagra._graph_build_ivf_pq_params(tcagra.IndexParams(), n, d)
        assert (tip.n_lists, tip.kmeans_trainset_fraction, tsp.n_probes, tk) == (
            jip.n_lists, jip.kmeans_trainset_fraction, jsp.n_probes, jk)
        assert tcagra._graph_build_qtile(CPU, n, d) == jcagra._graph_build_qtile(
            __import__("raft_tpu.core.resources", fromlist=["Resources"]).Resources(), n, d)
    assert tcagra._graph_build_ivf_pq_params(tcagra.IndexParams(), 1_000_000, 128)[2] == 258


def test_save_load_both_directions(raft_index, data, tmp_path, monkeypatch):
    x, q = data
    # raft_tpu's file, saved without its rows, into the port
    path = str(tmp_path / "raft_nodata.idx")
    jcagra.save(path, raft_index, include_dataset=False)
    tidx = tcagra.load(path, dataset=x, res=CPU)
    np.testing.assert_array_equal(tidx.graph.numpy(), np.asarray(raft_index.graph))
    np.testing.assert_array_equal(tidx.entry_ids.numpy(), np.asarray(raft_index.entry_ids))
    np.testing.assert_array_equal(tidx.entry_centers.numpy(),
                                  np.asarray(raft_index.entry_centers))
    # the port's own build, saved by the port, into raft_tpu
    own = tcagra.build(tcagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                                          build_algo="brute_force"), x, res=CPU)
    path = str(tmp_path / "port.idx")
    tcagra.save(path, own)
    back = jcagra.load(path)
    np.testing.assert_array_equal(np.asarray(back.graph), own.graph.numpy())
    np.testing.assert_array_equal(np.asarray(back.dataset), x)
    np.testing.assert_array_equal(np.asarray(back.entry_ids), own.entry_ids.numpy())
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    sp = tcagra.SearchParams(itopk_size=32)
    seeds = tcagra.make_seed_ids(sp, own, torch.from_numpy(q), 10)
    _, ji = jcagra.search(jcagra.SearchParams(itopk_size=32), back, q, 10,
                          seed_ids=seeds.numpy())
    _, ti = tcagra.search(sp, own, q, 10, seed_ids=seeds, res=CPU)
    assert (ti.numpy() == np.asarray(ji)).mean() >= 0.99
    # a bf16 dataset round-trips through the port (raw 2-byte words)
    bf = tcagra.from_graph(own.metric, own.dataset.to(torch.bfloat16), own.graph, res=CPU)
    path = str(tmp_path / "bf16.idx")
    tcagra.save(path, bf)
    again = tcagra.load(path, res=CPU)
    assert again.dataset.dtype == torch.bfloat16 and torch.equal(again.dataset, bf.dataset)
    assert again.entry_centers is None


@pytest.mark.parametrize("build_algo,thresholds", [
    ("brute_force", ((32, 0.85), (64, 0.95))),
    ("ivf_pq", ((64, 0.8),)),
])
def test_port_built_graph_invariants_and_recall(data, build_algo, thresholds):
    """raft_tpu's tests/test_cagra.py gates: the graph has no -1, no self
    edge and no repeated edge in a row, and recall@10 meets its
    thresholds."""
    x, q = data
    idx = tcagra.build(tcagra.IndexParams(intermediate_graph_degree=48, graph_degree=16,
                                          build_algo=build_algo), x, res=CPU)
    g = idx.graph.numpy()
    n = x.shape[0]
    assert g.shape == (n, 16) and (g >= 0).all() and (g < n).all()
    assert (g != np.arange(n)[:, None]).all()
    assert all(len(set(row.tolist())) == len(row) for row in g)
    c = idx.entry_centers.shape[0]
    assert c == 256 and idx.entry_ids.shape == (c,)
    _, gt = tbf.knn(x, q, 10, res=CPU)
    for itopk, floor in thresholds:
        _, i = tcagra.search(tcagra.SearchParams(itopk_size=itopk), idx, q, 10, res=CPU)
        assert recall_at_k(i, gt, 10) >= floor, (itopk, recall_at_k(i, gt, 10))


def test_seed_ids_search_plan_and_auto_build_algo(raft_index, data):
    x, q = data
    tidx = tcagra.from_graph("sqeuclidean", x, np.asarray(raft_index.graph),
                             np.asarray(raft_index.entry_centers),
                             np.asarray(raft_index.entry_ids), res=CPU)
    sp = tcagra.SearchParams()
    seeds = tcagra.make_seed_ids(sp, tidx, torch.from_numpy(q), 10)
    assert seeds.shape == (48, 16 + 64) and seeds.dtype == torch.int32
    assert bool(((seeds >= 0) & (seeds < x.shape[0])).all())
    assert torch.equal(seeds, tcagra.make_seed_ids(sp, tidx, torch.from_numpy(q), 10))
    no_entries = tcagra.from_graph("sqeuclidean", x, tidx.graph, res=CPU)
    assert tcagra.make_seed_ids(sp, no_entries, torch.from_numpy(q), 10).shape == (48, 128)
    # raft_tpu's plan: itopk, hops, query tile
    assert tcagra.search_plan(sp, tidx, 10_000, 10) == (64, 64, 512)
    assert tcagra.search_plan(sp, no_entries, 64, 10)[:2] == (64, 128)
    assert tcagra.search_plan(tcagra.SearchParams(itopk_size=16, max_iterations=4), tidx,
                              64, 10) == (16, 4, 64)
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert tcagra.resolve_build_algo("auto", 8192, cpu) == "brute_force"
    assert tcagra.resolve_build_algo("auto", 8193, cpu) == "ivf_pq"
    assert tcagra.resolve_build_algo("auto", 131_072, card) == "brute_force"
    assert tcagra.resolve_build_algo("auto", 1_000_000, card) == "ivf_pq"


def test_not_in_slice_options_raise(raft_index, data, tmp_path):
    x, q = data
    tidx = tcagra.from_graph("sqeuclidean", x, np.asarray(raft_index.graph), res=CPU)
    sp = tcagra.SearchParams()
    # filters are served (tests/test_torch_filtered_search.py); what is
    # neither a Bitset nor a RowFilter is refused
    with pytest.raises(TypeError, match="Bitset"):
        tcagra.search(sp, tidx, q, 10, sample_filter=object(), res=CPU)
    with pytest.raises(TypeError, match="Bitset"):
        tcagra.search(sp, tidx, q, 10, deleted_mask=object(), res=CPU)
    # int8 / uint8 datasets are served (test_8bit_index_parity_with_raft); f16 is not
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcagra.build(tcagra.IndexParams(build_algo="brute_force"), x.astype(np.float16), res=CPU)
    # the NN-descent builds, compress and hnsw are served since slice 11
    # (tests/test_torch_nn_descent.py, test_torch_vpq.py, test_torch_hnsw.py)
    from raft_tpu_torch.neighbors import hnsw  # noqa: F401

    assert callable(tcagra.compress)
    # random ball cover is served since slice 16 (tests/test_torch_ball_cover.py)
    from raft_tpu_torch.neighbors import ball_cover

    assert callable(ball_cover.build) and callable(ball_cover.knn_query)
    # paged datasets are served since slice 5 (tests/test_torch_paged_search.py)
    paged = copy.copy(tidx)
    paginate_index(paged, page_rows=8, budget=None)
    for a, b in zip(tcagra.search(sp, paged, q[:8], 10, res=CPU),
                    tcagra.search(sp, tidx, q[:8], 10, res=CPU)):
        assert torch.equal(a, b)
    # a VPQ-compressed index saved by raft_tpu loads (tests/test_torch_vpq.py)
    path = str(tmp_path / "vpq.idx")
    jcagra.save(path, jcagra.compress(raft_index))
    assert tcagra.load(path, res=CPU).dataset.shape == tuple(raft_index.dataset.shape)
    with pytest.raises(ValueError):
        tcagra.build(tcagra.IndexParams(metric="cosine"), x, res=CPU)


@pytest.fixture(scope="module")
def data8():
    """BIGANN-like 8-bit rows: 20 blobs in 0..255, queries near data rows."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(40, 200, (20, 32))
    x = np.clip(np.round(centers[rng.integers(0, 20, 1200)] + rng.normal(0, 12, (1200, 32))),
                0, 255)
    q = np.clip(np.round(x[rng.choice(1200, 48, replace=False)]
                         + rng.normal(0, 6, (48, 32))), 0, 255)
    return x, q.astype(np.float32)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_8bit_index_parity_with_raft(data8, dtype, tmp_path, monkeypatch):
    """CAGRA over uint8 / int8 rows: raft_tpu builds, saves; the port loads
    the rows in their dtype and searches with raft_tpu's seed ids; recall
    against the 8-bit oracle within 0.005 of raft_tpu's (raft_tpu promises
    recall only, kernels/cagra_traverse.py:34-37).  The port's own build
    keeps 1 byte a value, gives raft_tpu's exact graph, and its file loads
    in raft_tpu with the rows in their dtype."""
    x, q = data8
    shift = 0 if dtype == np.uint8 else 128
    x8, q8 = (x - shift).astype(dtype), q - shift
    params = dict(intermediate_graph_degree=48, graph_degree=16, build_algo="brute_force")
    jidx = jcagra.build(jcagra.IndexParams(**params), x8)
    path = str(tmp_path / "cagra8.idx")
    jcagra.save(path, jidx)
    tidx = tcagra.load(path, res=CPU)
    assert tidx.dataset.dtype == torch.from_numpy(x8).dtype
    assert np.array_equal(tidx.dataset.numpy(), x8)
    _, gt = tbf.knn(x8, q8, 10, res=CPU)
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    for itopk in (16, 64):
        jsp, tsp = jcagra.SearchParams(itopk_size=itopk), tcagra.SearchParams(itopk_size=itopk)
        seeds = np.asarray(jcagra.make_seed_ids(jsp, jidx, jnp.asarray(q8), 10))
        _, ji = jcagra.search(jsp, jidx, q8, 10, seed_ids=seeds)
        _, ti = tcagra.search(tsp, tidx, q8, 10, seed_ids=seeds, res=CPU)
        assert kernels.consume_kernel_path() == "torch"
        assert abs(recall_at_k(ti, gt, 10) - recall_at_k(np.asarray(ji), gt, 10)) <= 0.005
    own = tcagra.build(tcagra.IndexParams(**params), x8, res=CPU)
    assert own.dataset.dtype == tidx.dataset.dtype and own.dataset.element_size() == 1
    np.testing.assert_array_equal(own.graph.numpy(), np.asarray(jidx.graph))
    assert own.entry_ids.shape == jidx.entry_ids.shape
    path = str(tmp_path / "port8.idx")
    tcagra.save(path, own)
    back = jcagra.load(path)
    assert np.asarray(back.dataset).dtype == dtype and np.array_equal(np.asarray(back.dataset), x8)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_8bit_ivf_pq_build_filters_and_pages(data8, dtype):
    """The IVF-PQ graph build over 8-bit rows (its refine converts a tile of
    rows at a time) meets raft_tpu's recall gate; filtered and paged
    searches of an 8-bit index are served, the paged one bitwise the dense
    one."""
    from raft_tpu_torch.core.bitset import Bitset

    x, q = data8
    shift = 0 if dtype == np.uint8 else 128
    x8, q8 = (x - shift).astype(dtype), q - shift
    idx = tcagra.build(tcagra.IndexParams(intermediate_graph_degree=48, graph_degree=16,
                                          build_algo="ivf_pq"), x8, res=CPU)
    assert idx.dataset.element_size() == 1
    _, gt = tbf.knn(x8, q8, 10, res=CPU)
    _, i = tcagra.search(tcagra.SearchParams(), idx, q8, 10, res=CPU)
    assert recall_at_k(i, gt, 10) >= 0.8
    keep = np.random.default_rng(8).random(x.shape[0]) < 0.5
    bits = Bitset.from_mask(torch.from_numpy(keep))
    _, fi = tcagra.search(tcagra.SearchParams(), idx, q8, 10, sample_filter=bits, res=CPU)
    assert keep[fi.numpy()[fi.numpy() >= 0]].all()
    paged = copy.copy(idx)
    paginate_index(paged, page_rows=64, budget=None)
    for a, b in zip(tcagra.search(tcagra.SearchParams(), paged, q8, 10, res=CPU),
                    tcagra.search(tcagra.SearchParams(), idx, q8, 10, res=CPU)):
        assert torch.equal(a, b)
