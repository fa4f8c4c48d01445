"""Port parity of filtered search through the entry points: ``ivf_flat``,
``ivf_pq``, ``brute_force`` and ``cagra`` with a ``Bitset``, tombstones,
both, and a ``RowFilter`` with and without its descriptor, on indexes
raft_tpu built and saved, against raft_tpu's own filtered searches
(``RAFT_TPU_PALLAS=1`` for its kernel legs; a RowFilter without a
descriptor takes raft_tpu's XLA fallback)."""

import os
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.core import bitset as jbs
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import kernels
from raft_tpu_torch.core import bitset as tbs
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors._common import resolve_pass_filter
from raft_tpu_torch.stats.metrics import recall_at_k

from _torch_parity import assert_topk_match

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
N, D = 3000, 32
N_FILTERS = 4


def _blobs(n, d, n_q, seed, n_centers=24):
    """Gaussian blobs near the origin (rtol 1e-5 then measures summation
    order, not cancellation)."""
    rng = np.random.default_rng(seed)
    centers = (rng.random((n_centers, d)).astype(np.float32) - 0.5) * 6
    x = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, n_centers, n_q)] + rng.standard_normal((n_q, d)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _blobs(N, D, 512, 0)


@pytest.fixture(scope="module")
def masks():
    """Pass masks over the N ids, all from one numpy seed: ``keep`` (50 %),
    ``dead`` (10 % tombstones), a table of N_FILTERS filters (30-70 %) and
    each query's filter id."""
    rng = np.random.default_rng(1)
    table = rng.random((N_FILTERS, N)) < np.linspace(0.3, 0.7, N_FILTERS)[:, None]
    return dict(keep=rng.random(N) < 0.5, dead=rng.random(N) < 0.1, table=table,
                fid=rng.integers(0, N_FILTERS, 512))


FILTERS = ["bitset", "tomb", "both", "table", "rows"]


def _filter_kwargs(kind, masks, n_q):
    """(raft_tpu's kwargs, the port's kwargs, the pass mask of each query
    [n_q or 1, N]) of filter ``kind``."""
    keep, dead, table, fid = masks["keep"], masks["dead"], masks["table"], masks["fid"][:n_q]
    n = keep.shape[0]
    if kind in ("bitset", "tomb", "both"):
        jkw, tkw = {}, {}
        passing = np.ones(n, bool)
        if kind != "tomb":
            jkw["sample_filter"] = jbs.Bitset.from_mask(jnp.asarray(keep))
            tkw["sample_filter"] = tbs.Bitset.from_mask(keep, device="cpu")
            passing &= keep
        if kind != "bitset":
            jkw["deleted_mask"] = jbs.Bitset.from_mask(jnp.asarray(dead))
            tkw["deleted_mask"] = tbs.Bitset.from_mask(dead, device="cpu")
            passing &= ~dead
        return jkw, tkw, passing[None]
    if kind == "table":
        words = np.asarray(jbs.RowFilter.from_mask_rows(jnp.asarray(table)).words)
        return (dict(sample_filter=jbs.RowFilter.from_table(words, fid, n)),
                dict(sample_filter=tbs.RowFilter.from_table(words, fid, n, device="cpu")),
                table[fid])
    rows = table[fid]
    return (dict(sample_filter=jbs.RowFilter.from_mask_rows(jnp.asarray(rows))),
            dict(sample_filter=tbs.RowFilter.from_mask_rows(rows, device="cpu")), rows)


def _assert_no_leak(ids, passing):
    """No returned id fails its query's filter; no id repeats in a row."""
    ids = np.asarray(ids)
    rows = np.arange(ids.shape[0])[:, None] % passing.shape[0]
    assert passing[rows, np.clip(ids, 0, None)][ids >= 0].all()
    for row in ids:
        real = row[row >= 0]
        assert len(np.unique(real)) == len(real)


def _queries(q, strategy):
    return q[:64] if strategy == "query_major" else q


@pytest.fixture(scope="module")
def flat_indexes(data, tmp_path_factory):
    jidx = jivf.build(jivf.IndexParams(n_lists=16, kmeans_n_iters=4), data[0])
    path = str(tmp_path_factory.mktemp("flat") / "ivf_flat.idx")
    jivf.save(path, jidx)
    return jidx, tivf.load(path, res=CPU)


@pytest.mark.parametrize("strategy", ["query_major", "probe_major"])
@pytest.mark.parametrize("kind", FILTERS)
def test_ivf_flat_filtered_search_matches_raft(data, masks, flat_indexes, kind, strategy,
                                               monkeypatch):
    jidx, tidx = flat_indexes
    q = _queries(data[1], strategy)
    jkw, tkw, passing = _filter_kwargs(kind, masks, q.shape[0])
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    v_ref, i_ref = jivf.search(jivf.SearchParams(n_probes=4, strategy=strategy), jidx, q, 10,
                               **jkw)
    v, i = tivf.search(tivf.SearchParams(n_probes=4, strategy=strategy), tidx,
                       torch.from_numpy(q), 10, res=CPU, **tkw)
    assert kernels.consume_kernel_path() == "torch"
    assert_topk_match(v, i, v_ref, i_ref, atol=1e-4)
    _assert_no_leak(i, passing)
    assert (i.numpy() >= 0).mean() > 0.99


@pytest.mark.parametrize("metric", ["inner_product", "cosine", "euclidean"])
def test_ivf_flat_filtered_search_metrics(data, masks, metric, tmp_path, monkeypatch):
    """The filter legs under each metric, both schedules."""
    x, q = data
    jidx = jivf.build(jivf.IndexParams(n_lists=16, kmeans_n_iters=3, metric=metric), x)
    path = str(tmp_path / "flat.idx")
    jivf.save(path, jidx)
    tidx = tivf.load(path, res=CPU)
    jkw, tkw, passing = _filter_kwargs("both", masks, 512)
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    for n_q in (64, 512):
        v_ref, i_ref = jivf.search(jivf.SearchParams(n_probes=4), jidx, q[:n_q], 10, **jkw)
        v, i = tivf.search(tivf.SearchParams(n_probes=4), tidx, torch.from_numpy(q[:n_q]), 10,
                           res=CPU, **tkw)
        assert_topk_match(v, i, v_ref, i_ref, atol=1e-4)
        _assert_no_leak(i, passing)


_PQ = {}


def _pq_indexes(x, tmp_path_factory, dtype):
    """raft_tpu's IVF-PQ index with its scan cache at ``dtype``, and the
    port's load of it (built once)."""
    if dtype not in _PQ:
        if "base" not in _PQ:
            _PQ["base"] = jpq.build(jpq.IndexParams(n_lists=16, pq_dim=16, kmeans_n_iters=4,
                                                    force_random_rotation=True), x)
        j = _PQ["base"]
        if dtype != "bfloat16":
            data, y2, scale = jpq._decode_lists(
                np.asarray(j.codebook), j.codebook_kind, np.asarray(j.centers_rot),
                np.asarray(j.list_codes), np.asarray(j.list_index), jpq._DECODED_DTYPES[dtype])
            j = jpq.Index(j.metric, j.codebook_kind, j.pq_bits, j.centers, j.centers_rot,
                          j.rotation, j.codebook, j.list_codes, j.list_index, j.list_sizes,
                          data, y2, scale, headroom=j.headroom)
        path = str(tmp_path_factory.mktemp("pq") / "ivf_pq.idx")
        jpq.save(path, j)
        _PQ[dtype] = (j, tpq.load(path, res=CPU))
    return _PQ[dtype]


def _pq_search(jidx, tidx, q, jkw, tkw, strategy="auto", lut_dtype="float32"):
    v_ref, i_ref = jpq.search(jpq.SearchParams(n_probes=4, strategy=strategy,
                                               lut_dtype=lut_dtype), jidx, q, 10, **jkw)
    v, i = tpq.search(tpq.SearchParams(n_probes=4, strategy=strategy, lut_dtype=lut_dtype),
                      tidx, torch.from_numpy(q), 10, res=CPU, **tkw)
    assert kernels.consume_kernel_path() == "torch"
    assert_topk_match(v, i, v_ref, i_ref, atol=1e-4)
    return i


@pytest.mark.parametrize("strategy", ["query_major", "probe_major"])
@pytest.mark.parametrize("kind", FILTERS)
def test_ivf_pq_filtered_search_matches_raft(data, masks, kind, strategy, tmp_path_factory,
                                             monkeypatch):
    jidx, tidx = _pq_indexes(data[0], tmp_path_factory, "bfloat16")
    q = _queries(data[1], strategy)
    jkw, tkw, passing = _filter_kwargs(kind, masks, q.shape[0])
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    _assert_no_leak(_pq_search(jidx, tidx, q, jkw, tkw, strategy), passing)


@pytest.mark.parametrize("dtype,lut_dtype", [("bfloat16", "bfloat16"), ("int8", "float32"),
                                             ("float32", "float32")])
@pytest.mark.parametrize("kind", ["both", "table"])
def test_ivf_pq_filtered_storage_legs_match_raft(data, masks, kind, dtype, lut_dtype,
                                                 tmp_path_factory, monkeypatch):
    """The filter legs on each scan cache and both product types, on the
    query-major schedule (serving batches)."""
    jidx, tidx = _pq_indexes(data[0], tmp_path_factory, dtype)
    jkw, tkw, passing = _filter_kwargs(kind, masks, 64)
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    _assert_no_leak(_pq_search(jidx, tidx, data[1][:64], jkw, tkw, lut_dtype=lut_dtype),
                    passing)


@pytest.mark.parametrize("kind", FILTERS)
def test_brute_force_filtered_matches_raft(data, masks, kind):
    x, q = data
    jkw, tkw, passing = _filter_kwargs(kind, masks, 200)
    v_ref, i_ref = jbf.knn(x, q[:200], 10, **jkw)
    v, i = tbf.knn(x, q[:200], 10, res=CPU, **tkw)
    assert kernels.consume_kernel_path() == "torch"
    assert_topk_match(v, i, v_ref, i_ref, atol=1e-4)
    _assert_no_leak(i, passing)
    assert bool((i >= 0).all())


@pytest.mark.parametrize("metric", ["inner_product", "euclidean"])
def test_brute_force_filtered_metrics_and_tiles(data, masks, metric):
    """Other metrics, and a workspace small enough for column tiles of 512
    rows and several query tiles: the same result as raft_tpu's."""
    x, q = data
    jkw, tkw, passing = _filter_kwargs("table", masks, 512)
    v_ref, i_ref = jbf.knn(x, q, 10, metric=metric, **jkw)
    v, i = tbf.knn(x, q, 10, metric=metric, res=Resources(device="cpu", workspace_limit_bytes=1),
                   **tkw)
    assert_topk_match(v, i, v_ref, i_ref, atol=1e-4)
    _assert_no_leak(i, passing)


def test_brute_force_fewer_passing_than_k(data):
    """Three passing rows for k = 5: the tail is +inf with id -1 (raft_tpu
    returns id 0 there, the id its running top-k starts from; ids of
    +inf slots are not compared)."""
    x, q = data
    keep = np.zeros(N, bool)
    keep[[5, 9, 2600]] = True
    v_ref, i_ref = jbf.knn(x, q[:4], 5, sample_filter=jbs.Bitset.from_mask(jnp.asarray(keep)))
    v, i = tbf.knn(x, q[:4], 5, sample_filter=tbs.Bitset.from_mask(keep, device="cpu"),
                   res=CPU)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(i.numpy()[:, :3], np.asarray(i_ref)[:, :3])
    assert torch.isinf(v[:, 3:]).all() and bool((i[:, 3:] == -1).all())


def test_filter_shape_errors(data, masks, flat_indexes):
    x, q = data
    _, tidx = flat_indexes
    rows = tbs.RowFilter.from_mask_rows(masks["table"][masks["fid"][:10]], device="cpu")
    with pytest.raises(ValueError, match="row filter has 10 rows"):
        tivf.search(tivf.SearchParams(n_probes=4), tidx, q[:12], 10, sample_filter=rows, res=CPU)
    with pytest.raises(ValueError, match="row filter has 10 rows"):
        tbf.knn(x, q[:12], 10, sample_filter=rows, res=CPU)
    with pytest.raises(ValueError, match="filter covers 100 ids"):
        tbf.knn(x, q[:12], 10, sample_filter=tbs.Bitset.create(100, device="cpu"), res=CPU)


@pytest.fixture(scope="module")
def cagra_indexes(data, tmp_path_factory):
    x = data[0][:1500] * np.float32(0.25)
    jidx = jcagra.build(jcagra.IndexParams(intermediate_graph_degree=48, graph_degree=16,
                                           build_algo="brute_force"), x)
    path = str(tmp_path_factory.mktemp("cagra") / "cagra.idx")
    jcagra.save(path, jidx)
    return x, jidx, tcagra.load(path, res=CPU)


@pytest.mark.parametrize("kind,pass_rate", [("bitset", 0.5), ("bitset", 0.01), ("tomb", None),
                                            ("table", None), ("rows", None)])
def test_cagra_filtered_search_matches_raft(data, cagra_indexes, kind, pass_rate):
    """One set of seed ids at the widened itopk for both packages: ids equal
    on >= 99 % of slots, recall within 0.01 of raft_tpu's against the
    filtered oracle; a 1 %-pass filter still fills most slots."""
    x, jidx, tidx = cagra_indexes
    n = x.shape[0]
    q = data[1][:48] * np.float32(0.25)
    rng = np.random.default_rng(2)
    table = rng.random((N_FILTERS, n)) < np.linspace(0.3, 0.7, N_FILTERS)[:, None]
    m = dict(keep=rng.random(n) < (pass_rate or 0.5), dead=rng.random(n) < 0.1, table=table,
             fid=rng.integers(0, N_FILTERS, 48))
    jkw, tkw, passing = _filter_kwargs(kind, m, 48)
    sp_j, sp_t = jcagra.SearchParams(itopk_size=32), tcagra.SearchParams(itopk_size=32)
    pf = resolve_pass_filter(tkw.get("sample_filter"), tkw.get("deleted_mask"))
    itopk, _, _ = tcagra.search_plan(sp_t, tidx, 48, 10, CPU, pf)
    # widened by the inverse pass rate to a power of two; 32× at most
    assert itopk & (itopk - 1) == 0 and 32 < itopk <= 1024
    assert (itopk == 1024) == (pass_rate == 0.01)
    seeds = np.asarray(jcagra.make_seed_ids(sp_j, jidx, jnp.asarray(q), 10, itopk=itopk))
    jd, ji = jcagra.search(sp_j, jidx, q, 10, seed_ids=seeds, **jkw)
    td, ti = tcagra.search(sp_t, tidx, q, 10, seed_ids=seeds, res=CPU, **tkw)
    assert kernels.consume_kernel_path() == "torch"
    assert (ti.numpy() == np.asarray(ji)).mean() >= 0.99
    fin = np.isfinite(np.asarray(jd))
    np.testing.assert_allclose(td.numpy()[fin], np.asarray(jd)[fin], rtol=1e-5, atol=1e-4)
    _assert_no_leak(ti, passing)
    _, gi = tbf.knn(x, q, 10, res=CPU, **tkw)
    assert abs(recall_at_k(ti, gi, 10) - recall_at_k(np.asarray(ji), gi, 10)) <= 0.01
    assert (ti.numpy() >= 0).mean() >= 0.9

