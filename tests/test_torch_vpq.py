"""Port parity: VPQ-compressed CAGRA datasets of ``raft_tpu_torch`` against
raft_tpu's — raft_tpu builds and compresses an index and saves it; the port
loads it: ``decode`` bitwise, search recall within 0.005 of raft_tpu's on
the same loaded index and seeds (the walk's recall rule), the save / load
round trip both ways, and the port's own ``compress``."""

import os
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import vpq_dataset as jvpq
from raft_tpu_torch import kernels
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import vpq_dataset as tvpq
from raft_tpu_torch.stats.metrics import recall_at_k

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
VPQ = dict(vq_n_centers=16, pq_dim=8, kmeans_n_iters=6)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 16))
    x = (centers[rng.integers(0, 16, 1500)] + 0.3 * rng.normal(size=(1500, 16))).astype(np.float32)
    q = (x[rng.choice(1500, 60, replace=False)] + 0.1 * rng.normal(size=(60, 16))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def saved(data, tmp_path_factory):
    """raft_tpu's compressed index, saved in its format: (raft index, path)."""
    x, _ = data
    idx = jcagra.build(jcagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                                          build_algo="brute_force"), x)
    comp = jcagra.compress(idx, jvpq.VpqParams(**VPQ))
    path = str(tmp_path_factory.mktemp("vpq") / "vpq.idx")
    jcagra.save(path, comp)
    return comp, path


def test_decode_bitwise_raft(saved):
    comp, path = saved
    idx = tcagra.load(path, res=CPU)
    assert isinstance(idx.dataset, tvpq.VpqDataset) and idx.dataset.shape == comp.dataset.shape
    ids = np.random.default_rng(1).integers(-3, 1600, (40, 7)).astype(np.int32)   # clipped too
    np.testing.assert_array_equal(idx.dataset.decode(torch.from_numpy(ids)).numpy(),
                                  np.asarray(comp.dataset.decode(ids)))
    assert tvpq.compression_ratio(idx.dataset) == jvpq.compression_ratio(comp.dataset)


def test_search_recall_within_0005_of_raft(saved, data):
    """Both packages search the same loaded index from the same seed ids:
    recall@10 within 0.005; the port walks decoded rows on the plain walk
    and stamps "torch"."""
    comp, path = saved
    x, q = data
    idx = tcagra.load(path, res=CPU)
    sp = jcagra.SearchParams(itopk_size=32)
    seeds = np.asarray(jcagra.make_seed_ids(sp, comp, q, 10))
    _, want = jcagra.search(sp, comp, q, 10, seed_ids=seeds)
    kernels.consume_kernel_path()
    _, got = tcagra.search(tcagra.SearchParams(itopk_size=32), idx, q, 10, seed_ids=seeds,
                           res=CPU)
    assert kernels.consume_kernel_path() == "torch"
    _, gt = tbf.knn(x, q, 10, res=CPU)
    r_t, r_j = recall_at_k(got.numpy(), gt.numpy()), recall_at_k(np.asarray(want), gt.numpy())
    assert abs(r_t - r_j) <= 0.005 and r_t >= 0.5, (r_t, r_j)


def test_save_load_round_trip_both_ways(saved, tmp_path):
    import jax.numpy as jnp

    comp, path = saved
    idx = tcagra.load(path, res=CPU)
    mine = str(tmp_path / "port.idx")
    tcagra.save(mine, idx)
    back = tcagra.load(mine, res=CPU)
    ids = torch.arange(idx.size)
    assert torch.equal(back.dataset.decode(ids), idx.dataset.decode(ids))
    assert torch.equal(back.graph, idx.graph)
    raft_back = jcagra.load(mine)
    np.testing.assert_array_equal(np.asarray(raft_back.dataset.decode(jnp.arange(idx.size))),
                                  idx.dataset.decode(ids).numpy())


def test_port_compress_builds_and_searches(data):
    """The port's own VPQ build (its seeds are torch's): decoded rows close
    to the rows, the search's recall, and a second compress refused."""
    x, q = data
    idx = tcagra.build(tcagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                                          build_algo="brute_force"), x, res=CPU)
    comp = tcagra.compress(idx, tvpq.VpqParams(**VPQ), res=CPU)
    ds = comp.dataset
    assert ds.pq_codes.dtype == torch.uint8 and ds.vq_codes.dtype == torch.int32
    err = (ds.decode(torch.arange(idx.size)) - torch.from_numpy(x)).norm(dim=1)
    assert float(err.mean()) < 0.5 * float(torch.from_numpy(x).norm(dim=1).mean())
    _, got = tcagra.search(tcagra.SearchParams(), comp, q, 10, res=CPU)
    _, gt = tbf.knn(x, q, 10, res=CPU)
    assert recall_at_k(got.numpy(), gt.numpy()) >= 0.5
    with pytest.raises(ValueError, match="already compressed"):
        tcagra.compress(comp, res=CPU)
