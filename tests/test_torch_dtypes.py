"""Port parity on low-precision datasets (the cases of raft_tpu's
``tests/test_dtypes.py`` that the port serves): IVF-Flat lists stay in the
dataset's dtype (int8, uint8, bf16) through build, save and load, and an
index raft_tpu saved searches in the port with raft_tpu's ids; brute force
keeps its dataset's dtype, scores 8-bit data exactly, and its save / load
reads and writes raft_tpu's format in both directions."""

import os
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.stats.metrics import recall_at_k as neighborhood_recall

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
_TORCH = {"int8": torch.int8, "uint8": torch.uint8, "bfloat16": torch.bfloat16}


def _int_data(dtype, n=3000, d=32, n_q=60, seed=0):
    """raft_tpu's clustered 8-bit fixture (``tests/test_dtypes.py``)."""
    rng = np.random.default_rng(seed)
    lo, hi = (0, 256) if dtype == np.uint8 else (-128, 128)
    centers = rng.integers(lo + 40, hi - 40, (40, d))
    x = np.clip(centers[rng.integers(0, 40, n)] + rng.integers(-20, 20, (n, d)), lo, hi - 1)
    q = np.clip(centers[rng.integers(0, 40, n_q)] + rng.integers(-20, 20, (n_q, d)), lo, hi - 1)
    return x.astype(dtype), q.astype(dtype)


def _dataset(name):
    """(raft_tpu's dataset, the port's, f32 queries)."""
    if name == "bfloat16":
        x, q = _int_data(np.int8)
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16), q.astype(np.float32))
    x, q = _int_data(np.dtype(name).type)
    return x, torch.from_numpy(x), q.astype(np.float32)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "bfloat16"])
def test_raft_tpu_saved_ivf_flat_loads_and_searches_with_its_ids(dtype, tmp_path):
    jx, _, q = _dataset(dtype)
    jidx = jivf.build(jivf.IndexParams(n_lists=16, kmeans_n_iters=4), jx)
    path = str(tmp_path / "ivf")
    jivf.save(path, jidx)
    idx = tivf.load(path, res=CPU)
    assert idx.list_data.dtype == _TORCH[dtype]
    for strategy in ("query_major", "probe_major"):
        jv, ji = jivf.search(jivf.SearchParams(n_probes=6, strategy=strategy), jidx, q, 10)
        tv, ti = tivf.search(tivf.SearchParams(n_probes=6, strategy=strategy), idx, q, 10,
                             res=CPU)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
def test_port_ivf_flat_keeps_dtype_and_loads_in_raft_tpu(dtype, tmp_path):
    """raft_tpu's ``test_ivf_flat_int_dataset`` in the port (lists in the
    input dtype, recall >= 0.95 against the 8-bit oracle), then the port's
    save loads in raft_tpu and searches there with the port's ids.  (A bf16
    save is the same npy format, but raft_tpu cannot load its own bf16
    saves: ``jnp.asarray`` refuses numpy's two-byte void arrays.)"""
    _, tx, q = _dataset(dtype)
    idx = tivf.build(tivf.IndexParams(n_lists=32, kmeans_n_iters=5), tx, res=CPU)
    assert idx.list_data.dtype == tx.dtype
    _, gt = tbf.knn(tx, torch.from_numpy(q).to(tx.dtype), 10, res=CPU)
    _, ti = tivf.search(tivf.SearchParams(n_probes=16), idx, q, 10, res=CPU)
    assert float(neighborhood_recall(ti.numpy(), gt.numpy())) >= 0.95
    path = str(tmp_path / "ivf")
    tivf.save(path, idx)
    jidx = jivf.load(path)
    assert jidx.list_data.dtype == np.dtype(dtype)
    _, ji = jivf.search(jivf.SearchParams(n_probes=16), jidx, q, 10)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_ivf_flat_extend_keeps_the_lists_dtype():
    _, tx, q = _dataset("uint8")
    idx = tivf.build(tivf.IndexParams(n_lists=16, kmeans_n_iters=3, add_data_on_build=False),
                     tx[:100], res=CPU)
    idx = tivf.extend(idx, tx[:2000], res=CPU)
    idx = tivf.extend(idx, tx[2000:], torch.arange(2000, 3000), res=CPU)
    assert idx.list_data.dtype == torch.uint8 and idx.size == 3000
    _, i = tivf.search(tivf.SearchParams(n_probes=16), idx, tx[:5].float(), 1, res=CPU)
    assert (i[:, 0].numpy() == np.arange(5)).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "l1"])
def test_brute_force_int_exact(dtype, metric):
    """raft_tpu's ``test_brute_force_int_exact``: 8-bit kNN equals the f32
    kNN of the same values, and raft_tpu's ids."""
    x, q = _int_data(dtype, n=2000, d=32, n_q=50)
    v, i = tbf.knn(x, q, 10, metric=metric, res=CPU)
    vf, i_f = tbf.knn(x.astype(np.float32), q.astype(np.float32), 10, metric=metric, res=CPU)
    np.testing.assert_allclose(v.numpy(), vf.numpy(), rtol=1e-5)
    assert float(neighborhood_recall(i.numpy(), i_f.numpy())) == 1.0
    _, ji = jbf.knn(x, q, 10, metric=metric)
    assert float(neighborhood_recall(i.numpy(), np.asarray(ji))) == 1.0


def test_brute_force_bf16_dataset():
    x, q = _int_data(np.uint8, n=2000, d=32, n_q=50)
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    idx = tbf.build(xb, res=CPU)
    assert idx.dataset.dtype == torch.bfloat16
    _, i = tbf.search(idx, q.astype(np.float32), 10, res=CPU)
    _, gt = tbf.knn(x.astype(np.float32), q.astype(np.float32), 10, res=CPU)
    assert float(neighborhood_recall(i.numpy(), gt.numpy())) >= 0.99


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int8])
@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
def test_brute_force_save_load_both_ways(dtype, metric, tmp_path):
    x, q = _int_data(np.uint8 if dtype == np.uint8 else np.int8, n=800, d=16, n_q=20)
    x = x.astype(dtype)
    qf = q.astype(np.float32)
    # raft_tpu → port
    jpath = str(tmp_path / "from_raft")
    jbf.save(jpath, jbf.build(x, metric=metric))
    t = tbf.load(jpath, res=CPU)
    assert t.metric == metric and t.dataset.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(t.dataset.numpy(), x)
    _, ji = jbf.search(jbf.build(x, metric=metric), qf, 10)
    _, ti = tbf.search(t, qf, 10, res=CPU)
    assert float(neighborhood_recall(ti.numpy(), np.asarray(ji))) == 1.0
    # port → raft_tpu
    tpath = str(tmp_path / "from_port")
    tbf.save(tpath, tbf.build(x, metric=metric, res=CPU))
    j = jbf.load(tpath)
    assert j.metric == metric and np.array_equal(np.asarray(j.dataset), x)


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
def test_paged_8bit_ivf_flat_matches_raft_tpu_paged_and_monolithic(dtype, tmp_path):
    """An 8-bit IVF-Flat index raft_tpu built and saved, paged by each
    package (8-row pages, no budget): the port's paged search gives raft_tpu's
    paged ids and values, and is bitwise the port's monolithic search, on
    both schedules (the paged ``_u8`` / ``_s8`` legs' plain versions)."""
    import copy

    from raft_tpu.store import paginate_index as j_paginate
    from raft_tpu_torch.store import paginate_index

    jx, _, q = _dataset(dtype)
    jidx = jivf.build(jivf.IndexParams(n_lists=16, kmeans_n_iters=4), jx)
    path = str(tmp_path / "ivf")
    jivf.save(path, jidx)
    jpaged = jivf.load(path)
    j_paginate(jpaged, page_rows=8, budget=None, name=f"raft:paged8:{dtype}")
    mono = tivf.load(path, res=CPU)
    paged = copy.copy(mono)
    paginate_index(paged, page_rows=8, budget=None, name=f"port:paged8:{dtype}")
    assert paged.list_data.dtype == _TORCH[dtype] and paged.paged.pool.dtype == _TORCH[dtype]
    for strategy in ("query_major", "probe_major"):
        jv, ji = jivf.search(jivf.SearchParams(n_probes=6, strategy=strategy), jpaged, q, 10)
        sp = tivf.SearchParams(n_probes=6, strategy=strategy)
        tv, ti = tivf.search(sp, paged, q, 10, res=CPU)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
        mv, mi = tivf.search(sp, mono, q, 10, res=CPU)
        assert torch.equal(tv, mv) and torch.equal(ti, mi)
    # the scan wrappers take the paged view (CPU tensors: their plain versions)
    from _torch_parity import paged_lists
    from raft_tpu_torch.kernels import ivf_scan as tscan

    rows, ids, y2 = paged.list_data, paged.list_index, paged.scan_norms
    view = paged_lists(rows, 8, 4)
    qt = torch.from_numpy(q)
    probes = torch.randint(0, 16, (q.shape[0], 5), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    args = (probes, qt, (qt * qt).sum(1))
    for metric in ("sqeuclidean", "inner_product"):
        want = tscan.ivf_scan_query_major_torch(*args, rows, y2, ids, 10, metric=metric,
                                                scan_scale=None)
        got = tscan.ivf_scan_query_major(*args, view, y2, ids, 10, metric=metric,
                                         scan_scale=None)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    qg = qt[:8][None].expand(3, 8, -1).contiguous()
    pm = (torch.tensor([0, 7, 15], dtype=torch.int32), qg, (qg * qg).sum(-1))
    want = tscan.ivf_scan_probe_major_torch(*pm, rows, y2, ids, 10, scan_scale=None)
    got = tscan.ivf_scan_probe_major(*pm, view, y2, ids, 10, scan_scale=None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
