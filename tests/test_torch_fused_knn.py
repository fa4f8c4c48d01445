"""Port parity: the fused brute-force kNN plain version and
``brute_force.knn`` of ``raft_tpu_torch`` against raft_tpu's Pallas kernel
(interpret mode) and its routed ``brute_force.knn``."""

import os
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.kernels.fused_knn import fused_l2_topk as j_fused
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch import kernels
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.kernels.fused_knn import fused_l2_topk, fused_l2_topk_torch
from raft_tpu_torch.neighbors import brute_force as tbf

from _torch_parity import assert_topk_match

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _data(n, d, n_q, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n_q, d)).astype(np.float32))


@pytest.mark.parametrize("n,d,n_q,k", [(1500, 32, 40, 10), (700, 17, 9, 64)])
@pytest.mark.parametrize("mode", ["l2", "ip"])
def test_plain_matches_pallas_interpret(n, d, n_q, k, mode):
    x, q = _data(n, d, n_q, n + d)
    xx = (x * x).sum(1) if mode == "l2" else np.zeros(n, np.float32)
    v_ref, i_ref = j_fused(jnp.asarray(q), jnp.asarray(x), jnp.asarray(xx), k,
                           mode=mode, tile_q=64, tile_n=256, interpret=True)
    v, i = fused_l2_topk_torch(torch.from_numpy(q), torch.from_numpy(x),
                               torch.from_numpy(xx), k, mode=mode)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert_topk_match(v, i, v_ref, i_ref)
    # the wrapper takes the plain version for CPU tensors
    v2, i2 = fused_l2_topk(torch.from_numpy(q), torch.from_numpy(x),
                           torch.from_numpy(xx), k, mode=mode)
    assert torch.equal(v, v2) and torch.equal(i, i2)


# k 129 is CAGRA's exact graph build (intermediate degree 128 + the row
# itself); raft_tpu routes k > 128 past its Pallas kernel
@pytest.mark.parametrize("k", [10, 129, 258])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
def test_knn_matches_raft_routed(metric, k, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    x, q = _data(2000, 24, 33, 7)
    v_ref, i_ref = jbf.knn(x, q, k, metric=metric)
    v, i = tbf.knn(x, q, k, metric=metric, res=CPU)
    assert kernels.consume_kernel_path() == "torch"
    assert_topk_match(v, i, v_ref, i_ref, rtol=1e-5, atol=1e-4)


def test_knn_exact_self_neighbors_and_deep_k():
    x, _ = _data(600, 8, 1, 3)
    v, i = tbf.knn(torch.from_numpy(x), torch.from_numpy(x[:20]), 5, res=CPU)
    assert (i[:, 0].numpy() == np.arange(20)).all()
    # k past the kernel envelope (512) takes the plain version too
    v2, i2 = tbf.knn(x, x[:20], 550, res=CPU)
    assert i2.shape == (20, 550)
    assert torch.equal(i2[:, :5], i)


def test_knn_rejects_out_of_slice_inputs():
    x, q = _data(100, 4, 2, 5)
    with pytest.raises(ValueError, match="metric"):   # every DISTANCE_TYPES name is served
        tbf.knn(x, q, 3, metric="l3", res=CPU)
    with pytest.raises(TypeError, match="Bitset"):   # filters are Bitsets / RowFilters
        tbf.knn(x, q, 3, sample_filter=object(), res=CPU)
    with pytest.raises(ValueError):
        tbf.knn(x, q, 101, res=CPU)
    idx = tbf.build(x, metric="inner_product", res=CPU)
    v, i = tbf.search(idx, q, 3, res=CPU)
    assert (np.diff(v.numpy(), axis=1) <= 0).all()  # largest products first


@pytest.mark.parametrize("batch_size", [3, 16])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_batch_k_query_matches_raft(batch_size, metric):
    """``make_batch_k_query`` against raft_tpu's on the same index: each
    batch's values within rtol 1e-5 and ids equal away from near-ties,
    batches of growing k cut from one search at the cached k (bitwise that
    search's slice), and the iteration ends at the index size."""
    x, q = _data(90, 12, 7, 11)
    tq = tbf.make_batch_k_query(tbf.build(x, metric=metric, res=CPU), torch.from_numpy(q),
                                batch_size, res=CPU)
    jq = jbf.make_batch_k_query(jbf.build(jnp.asarray(x), metric=metric), jnp.asarray(q),
                                batch_size)
    t_batches, j_batches = list(tq), list(jq)
    assert [b.offset for b in t_batches] == [b.offset for b in j_batches]
    assert [b.size for b in t_batches] == [b.size for b in j_batches]
    assert sum(b.size for b in t_batches) == 90
    for tb, jb in zip(t_batches, j_batches):
        assert_topk_match(tb.distances(), tb.indices(), jb.distances(), jb.indices(),
                          rtol=1e-5, atol=1e-4)
    # a batch inside the cached k is the slice of one search at that k
    b = tq.batch(1, 2)
    v, i = tbf.search(tq.index, torch.from_numpy(q), tq._cached_k, res=CPU)
    assert torch.equal(b.indices(), i[:, 1:3]) and torch.equal(b.distances(), v[:, 1:3])
    assert tq.batch(90, 5).size == 0 and tq.batch(88, 5).size == 2
    with pytest.raises(Exception):
        tbf.make_batch_k_query(tq.index, torch.from_numpy(q), 0, res=CPU)
