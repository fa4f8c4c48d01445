"""Port parity of the serving layer's data path: ``ops.matrix.mask_row_k`` /
``select_k(row_k=)`` bitwise against raft_tpu; ``serve.MutableIndex`` after
the same upserts and deletes against raft_tpu's on the same index (raft_tpu
builds and saves it, the port loads it): ids equal, distances within rtol
1e-5 / atol 1e-4, for brute force, IVF-Flat, IVF-PQ and CAGRA, unfiltered,
filtered and with per-row k; ``save`` / ``load`` in both directions; and
``RaggedSearcher`` on the same packed batch of per-row k and filter ids."""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.core.bitset import RowFilter as JRowFilter
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.ops import matrix as jmatrix
from raft_tpu.serve import mutation as jmut
from raft_tpu.serve import ragged as jragged
from raft_tpu.serve import registry as jregistry
from raft_tpu_torch.core.bitset import Bitset, RowFilter
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.ops import matrix as tmatrix
from raft_tpu_torch.serve import mutation as tmut
from raft_tpu_torch.serve import ragged as tragged
from raft_tpu_torch.serve import registry as tregistry

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
N, D, NQ, K = 600, 20, 16, 10
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    new = rng.standard_normal((14, D)).astype(np.float32)
    return x, q, new


def _pair(kind, x, tmp_path):
    """(raft_tpu MutableIndex, port MutableIndex) over one raft_tpu-built
    index, the port's loaded from raft_tpu's save."""
    path = str(tmp_path / f"{kind}.idx")
    if kind == "brute_force":
        j = jbf.build(x)
        jbf.save(path, j)
        return jmut.MutableIndex(j), tmut.MutableIndex(tbf.load(path, res=CPU))
    if kind == "ivf_flat":
        j = jflat.build(jflat.IndexParams(n_lists=12, kmeans_n_iters=6), x)
        jflat.save(path, j)
        return (jmut.MutableIndex(j, search_params=jflat.SearchParams(n_probes=5)),
                tmut.MutableIndex(tflat.load(path, res=CPU),
                                  search_params=tflat.SearchParams(n_probes=5)))
    if kind == "ivf_pq":
        j = jpq.build(jpq.IndexParams(n_lists=12, pq_dim=10, kmeans_n_iters=6), x)
        jpq.save(path, j)
        return (jmut.MutableIndex(j, search_params=jpq.SearchParams(n_probes=6)),
                tmut.MutableIndex(tpq.load(path, res=CPU),
                                  search_params=tpq.SearchParams(n_probes=6)))
    j = jcagra.build(jcagra.IndexParams(intermediate_graph_degree=48, graph_degree=32,
                                        build_algo="brute_force"), x)
    jcagra.save(path, j)
    # an effort at which both walks reach the exact top-k from their own
    # seeds (the random seeds come from two RNGs; the walk is held to
    # recall in general, test_torch_cagra.py)
    return (jmut.MutableIndex(j, search_params=jcagra.SearchParams(itopk_size=128)),
            tmut.MutableIndex(tcagra.load(path, res=CPU),
                              search_params=tcagra.SearchParams(itopk_size=128)))


def _mutate(mi, new):
    """The same mutation sequence on either package's MutableIndex."""
    auto = mi.upsert(new[:8])                          # fresh ids N..N+7
    mi.upsert(new[8:11], ids=[5, 7, N + 2])            # replaces two main rows and a side row
    mi.delete(np.concatenate([np.arange(0, N, 9), [N + 4]]))
    mi.upsert(new[11:], ids=[0, N + 20, N + 21])       # 0 was deleted: upsert revives it
    return np.asarray(auto)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _match(got, want):
    gv, gi = (_np(a) for a in got)
    wv, wi = (_np(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("algo", ["auto", "topk", "chunked"])
@pytest.mark.parametrize("select_min", [True, False])
def test_mask_row_k_and_select_k_row_k_match_raft_tpu(algo, select_min):
    """Row k masks after the selection on every route: values and ids
    bitwise raft_tpu's (ties and a few +-inf included)."""
    rng = np.random.default_rng(3)
    s = np.round(rng.standard_normal((9, 70)) * 2).astype(np.float32)
    s[rng.random(s.shape) < 0.03] = np.inf
    ids = rng.integers(0, 500, s.shape).astype(np.int32)
    row_k = rng.integers(0, 9, 9).astype(np.int32)
    jv, ji = jmatrix.select_k(jnp.asarray(s), 8, select_min=select_min,
                              input_indices=jnp.asarray(ids), algo=algo,
                              row_k=jnp.asarray(row_k))
    tv, ti = tmatrix.select_k(torch.from_numpy(s), 8, select_min=select_min,
                              input_indices=torch.from_numpy(ids), algo=algo,
                              row_k=torch.from_numpy(row_k))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
    mv, mi = tmatrix.mask_row_k(tv, ti, row_k, select_min=select_min)
    jmv, jmi = jmatrix.mask_row_k(jv, ji, jnp.asarray(row_k), select_min=select_min)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(jmi))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jmv))


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq", "cagra"])
def test_mutable_index_matches_raft_tpu(kind, data, tmp_path):
    """After the same upserts (fresh and explicit ids, a replaced side row)
    and deletes: the merged search unfiltered, with a Bitset filter over
    the global ids, with per-row k, and the mutation bookkeeping."""
    x, q, new = data
    jm, tm = _pair(kind, x, tmp_path)
    assert tm.kind == kind and tm.device == torch.device("cpu")
    np.testing.assert_array_equal(_mutate(tm, new), _mutate(jm, new))
    assert (tm.size, tm.generation, tm.pending_mutations()) == (
        jm.size, jm.generation, jm.pending_mutations())
    assert [tm.contains(i) for i in (0, 5, 9, N + 4, N + 20)] == \
        [jm.contains(i) for i in (0, 5, 9, N + 4, N + 20)]
    _match(tm.search(q, K), jm.search(q, K))
    mask = np.random.default_rng(4).random(N) < 0.6
    _match(tm.search(q, K, sample_filter=Bitset.from_mask(mask, device="cpu")),
           jm.search(q, K, sample_filter=JBitset.from_mask(jnp.asarray(mask))))
    row_k = np.arange(NQ, dtype=np.int32) % K + 1
    _match(tm.search(q, K, row_k=row_k), jm.search(q, K, row_k=jnp.asarray(row_k)))
    tv, tr = tm.live_vectors()
    jv, jr = jm.live_vectors()
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["ivf_flat", "cagra"])
def test_save_load_both_directions(kind, data, tmp_path):
    """A MutableIndex raft_tpu saved (tombstones, side buffer, counters)
    loads into the port and answers as raft_tpu's does; the port's save
    loads into raft_tpu and answers the same."""
    x, q, new = data
    jm, tm = _pair(kind, x, tmp_path)
    _mutate(jm, new)
    _mutate(tm, new)
    jm.save(str(tmp_path / "j.mut"))
    sp = tm.search_params
    from_raft = tmut.MutableIndex.load(str(tmp_path / "j.mut"), search_params=sp, res=CPU)
    assert (from_raft.generation, from_raft.pending_mutations(), from_raft._next_id) == (
        jm.generation, jm.pending_mutations(), jm._next_id)
    _match(from_raft.search(q, K), jm.search(q, K))
    tm.save(str(tmp_path / "t.mut"))
    from_port = jmut.MutableIndex.load(str(tmp_path / "t.mut"), search_params=jm.search_params)
    _match(tm.search(q, K), from_port.search(q, K))
    assert from_port.pending_mutations() == tm.pending_mutations()


def test_ragged_searcher_matches_raft_tpu_on_one_packed_batch(data, tmp_path):
    """One packed batch of per-row k and registered filter ids (fid 0 the
    all-pass row) through both RaggedSearchers over the same mutated
    IVF-Flat index: equal answers, no id failing its own row's filter, -1
    past each row's k."""
    x, q, new = data
    jm, tm = _pair("ivf_flat", x, tmp_path)
    _mutate(jm, new)
    _mutate(tm, new)
    rng = np.random.default_rng(5)
    masks = [rng.random(N) < rate for rate in (0.2, 0.5, 0.8)]
    spec_j, spec_t = jragged.RaggedSpec(k_max=K), tragged.RaggedSpec(k_max=K)
    out = {}
    for tag, reg_mod, spec, fr_cls, searcher_cls, mi in (
            ("j", jregistry, spec_j, jragged.FilterRegistry, jragged.RaggedSearcher, jm),
            ("t", tregistry, spec_t, tragged.FilterRegistry, tragged.RaggedSearcher, tm)):
        reg = reg_mod.IndexRegistry()
        reg.register("a", mi)
        freg = fr_cls(N)
        assert [freg.register(m) for m in masks] == [1, 2, 3]
        out[tag] = (searcher_cls(types.SimpleNamespace(registry=reg), "a", spec, freg), freg)
    row_k = rng.integers(1, K + 1, NQ).astype(np.int32)
    row_fid = rng.integers(0, 4, NQ).astype(np.int32)
    jd, ji = out["j"][0](jnp.asarray(q), jnp.asarray(row_k), jnp.asarray(row_fid))
    td, ti = out["t"][0](torch.from_numpy(q), torch.from_numpy(row_k), row_fid)
    _match((td, ti), (jd, ji))
    ti = ti.numpy()
    table = [np.ones(N, bool)] + masks
    for r in range(NQ):
        assert (ti[r, row_k[r]:] == -1).all()
        got = ti[r, :row_k[r]]
        main = got[(got >= 0) & (got < N)]
        assert table[row_fid[r]][main].all(), r
    np.testing.assert_array_equal(out["t"][1].snapshot()[0], out["j"][1].snapshot()[0])


def test_row_filter_from_table_checks_host_ids_before_upload():
    table = np.zeros((3, 2), np.uint32)
    with pytest.raises(ValueError, match="filter ids"):
        RowFilter.from_table(table, np.array([0, 3], np.int32), 40, device="cpu")
    rf = RowFilter.from_table(table, np.array([2, 0], np.int32), 40, device="cpu")
    assert rf.fid.tolist() == [2, 0] and tuple(rf.words.shape) == (2, 2)
    jr = JRowFilter.from_table(table, np.array([2, 0], np.int32), 40)
    np.testing.assert_array_equal(rf.words.numpy().view(np.uint32), np.asarray(jr.words))
