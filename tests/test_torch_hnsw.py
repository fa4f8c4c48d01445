"""Port parity: hnswlib interop of ``raft_tpu_torch`` against raft_tpu's —
the exported bytes equal for the same index and seed (with and without the
upper levels, with delete flags), ``load`` of raft_tpu's file equal to
raft_tpu's ``load`` (the port also keeps the upper levels' elements as its
entry points), search recall within 0.005 of raft_tpu's walk from the same
seeds (random rows on a base-layer-only file; the upper levels' elements,
given to raft_tpu's loaded index as its entry-point table, on a file with
them), and ``load_native`` refused."""

import os
import numpy as np
import pytest

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import hnsw as jhnsw
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import hnsw as thnsw
from raft_tpu_torch.stats.metrics import recall_at_k
import torch

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(12, 16))
    x = (centers[rng.integers(0, 12, 1000)] + 0.4 * rng.normal(size=(1000, 16))).astype(np.float32)
    q = (x[rng.choice(1000, 50, replace=False)] + 0.1 * rng.normal(size=(50, 16))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """raft_tpu's index and the port's load of its save: (raft, port)."""
    x, _ = data
    raft = jcagra.build(jcagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                                           build_algo="brute_force", entry_points=0), x)
    path = str(tmp_path_factory.mktemp("cagra") / "c.idx")
    jcagra.save(path, raft)
    return raft, tcagra.load(path, res=CPU)


@pytest.mark.parametrize("hierarchy,deleted", [(True, None), (False, None), (True, "ids")])
def test_serialize_bytes_equal_raft(indexes, tmp_path, hierarchy, deleted):
    raft, port = indexes
    dele = None if deleted is None else np.array([3, 17, 999])
    a, b = str(tmp_path / "port.hnsw"), str(tmp_path / "raft.hnsw")
    thnsw.serialize_to_hnswlib(a, port, hierarchy=hierarchy, seed=5, deleted=dele, res=CPU)
    jhnsw.serialize_to_hnswlib(b, raft, hierarchy=hierarchy, seed=5, deleted=dele)
    got, want = open(a, "rb").read(), open(b, "rb").read()
    assert len(got) == len(want) and got == want


def test_load_of_raft_file_equals_raft_load(indexes, data, tmp_path):
    raft, _ = indexes
    path = str(tmp_path / "raft.hnsw")
    jhnsw.serialize_to_hnswlib(path, raft, seed=1, deleted=np.array([5, 6]))
    want, want_del = jhnsw.load(path, 16, return_deleted=True)
    got, got_del = thnsw.load(path, 16, return_deleted=True, res=CPU)
    np.testing.assert_array_equal(got.graph.numpy(), np.asarray(want.graph))
    np.testing.assert_array_equal(got.dataset.numpy(), np.asarray(want.dataset))
    np.testing.assert_array_equal(got_del.words.numpy().view(np.uint32),
                                  np.asarray(want_del.words))
    # the base layer is the CAGRA graph
    np.testing.assert_array_equal(got.graph.numpy(), np.asarray(raft.graph))
    # the entry points are the elements raft_tpu's writer put on level >= 1
    levels, _ = jhnsw._build_hierarchy(np.asarray(raft.dataset), 8, 1)
    np.testing.assert_array_equal(got.entry_ids.numpy(), np.flatnonzero(levels >= 1))
    np.testing.assert_array_equal(got.entry_centers.numpy(),
                                  np.asarray(raft.dataset)[levels >= 1])
    flat = str(tmp_path / "flat.hnsw")
    jhnsw.serialize_to_hnswlib(flat, raft, hierarchy=False)
    assert thnsw.load(flat, 16, res=CPU).entry_ids is None


@pytest.mark.parametrize("hierarchy", [False, True])
def test_search_recall_within_0005_of_raft(indexes, data, tmp_path, hierarchy):
    """The same walk in both packages, recall within 0.005: from random
    seeds on a base-layer-only file; with upper levels, raft_tpu's loaded
    index gets the port's entry-point table (the elements its own writer
    put on level >= 1), so both walks start from the same entry points."""
    raft, _ = indexes
    x, q = data
    path = str(tmp_path / "raft.hnsw")
    jhnsw.serialize_to_hnswlib(path, raft, hierarchy=hierarchy, seed=0)
    want_idx = jhnsw.load(path, 16)
    if hierarchy:
        levels, _ = jhnsw._build_hierarchy(np.asarray(raft.dataset), 8, 0)
        ids = np.flatnonzero(levels >= 1)
        want_idx = jcagra.from_graph(want_idx.metric, want_idx.dataset, want_idx.graph,
                                     np.asarray(want_idx.dataset)[ids], ids)
    _, want = jhnsw.search(want_idx, q, 10, ef=32)
    _, got = thnsw.search(thnsw.load(path, 16, res=CPU), q, 10, ef=32, res=CPU)
    _, gt = tbf.knn(x, q, 10, res=CPU)
    r_t, r_j = recall_at_k(got.numpy(), gt.numpy()), recall_at_k(np.asarray(want), gt.numpy())
    assert r_t >= 0.9 and abs(r_t - r_j) <= 0.005, (r_t, r_j)


def test_load_native_raises_naming_queue_1_item_6(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        thnsw.load_native(str(tmp_path / "x.hnsw"), 16)
