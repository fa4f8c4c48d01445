"""Port parity: the CAGRA hop of ``raft_tpu_torch`` (plain version) against
raft_tpu's Pallas ``cagra_fused_hop`` in interpret mode, from identical
inputs; the fixed trip count of the port's search against raft_tpu's early
stop.  The hop kernel against its plain version on the card is in
``test_torch_package.py`` (the card's machine has no JAX)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.kernels.cagra_traverse import cagra_fused_hop as j_hop
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu_torch import kernels
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.kernels import cagra_traverse as ct
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.ops import cost

from _torch_parity import hop_inputs

CPU = Resources(device="cpu")


@pytest.mark.parametrize("metric,dtype", [("sqeuclidean", "float32"),
                                          ("inner_product", "float32"),
                                          ("sqeuclidean", "bfloat16")])
def test_hop_matches_pallas_interpret(metric, dtype):
    """One hop from identical inputs: ids and explored flags equal, values
    within rtol 1e-5 / atol 1e-4 (the two sum |v|^2 in other orders)."""
    x, graph, q, parents, buf_d, buf_i, explored = hop_inputs(3, metric)
    jx = jnp.asarray(x.numpy())
    if dtype == "bfloat16":
        x, jx = x.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    got = ct.cagra_fused_hop(x, graph, q, parents, buf_d, buf_i, explored, metric=metric)
    assert kernels.consume_kernel_path() == "torch"
    ref = j_hop(jx, *(jnp.asarray(t.numpy()) for t in (graph, q, parents, buf_d, buf_i, explored)),
                metric=metric, interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    # the hop changed the buffers, and the query without a parent kept its own
    assert not torch.equal(got[1], buf_i)
    assert torch.equal(got[0][0], buf_d[0]) and torch.equal(got[1][0], buf_i[0])


def test_hop_keeps_the_buffer_invariants():
    d, i, e = ct.cagra_fused_hop_torch(*hop_inputs(4, "sqeuclidean"), metric="sqeuclidean")
    assert (torch.diff(d, dim=1) >= 0).all()
    assert torch.equal(i < 0, torch.isinf(d)) and bool(e[torch.isinf(d)].all())
    for row in i:
        real = row[row >= 0]
        assert real.unique().numel() == real.numel()


def test_hop_rejects_what_it_does_not_serve():
    x, *args = hop_inputs(5, "sqeuclidean")
    with pytest.raises(ValueError):
        ct.cagra_fused_hop(x.to(torch.float16), *args, metric="sqeuclidean")
    with pytest.raises(ValueError):
        ct.cagra_fused_hop(x, *args, metric="cosine")
    with pytest.raises(ValueError):
        ct.cagra_fused_hop(x, args[0], args[1][:3], *args[2:], metric="sqeuclidean")
    assert ct.traverse_supported(torch.zeros(2, 2, dtype=torch.bfloat16), 512)
    assert not ct.traverse_supported(torch.zeros(2, 2), 513)
    assert not ct.traverse_supported(torch.zeros(2, 2, dtype=torch.int8), 64)


def test_hop_work_counts_live_parents():
    parents = torch.tensor([[3, -1], [-1, -1], [7, 2]], dtype=torch.int32)
    w = cost.cagra_traverse_work(parents, 64, 128, 32, itemsize=2)
    assert w.flops == 3 * 4 * 64 * 128
    assert w.bytes_accessed == 3 * 64 * (128 * 2 + 4) + 3 * (128 * 4 + 2 * 4) + 2 * 3 * 32 * 9
    raft = cost.cagra_traverse_cost(3, 2, 64, 128, 32, itemsize=2)
    assert raft.flops > w.flops and raft.bytes_accessed > w.bytes_accessed


def test_fixed_trip_count_equals_raft_early_stop(monkeypatch):
    """Groups of 8 rows linked only among themselves, and every query seeded
    inside one group: the frontier dies within 8 hops.  raft_tpu's loop
    stops there; the port runs all 40 hops and gives the same results."""
    rng = np.random.default_rng(6)
    n, d, deg, group = 800, 16, 4, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    base = (np.arange(n) // group * group)[:, None]
    graph = (base + (np.arange(n)[:, None] + 1 + np.arange(deg)[None, :]) % group).astype(np.int32)
    q = rng.standard_normal((20, d)).astype(np.float32)
    start = rng.integers(0, n // group, 20) * group
    seeds = (start[:, None] + rng.integers(0, group, (20, 16))).astype(np.int32)
    jidx = jcagra.from_graph("sqeuclidean", x, graph)
    tidx = tcagra.from_graph("sqeuclidean", x, graph, res=CPU)
    sp = dict(itopk_size=16, max_iterations=40, num_entry_centers=0)
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    jd, ji = jcagra.search(jcagra.SearchParams(**sp), jidx, q, 5, seed_ids=seeds)
    td, ti = tcagra.search(tcagra.SearchParams(**sp), tidx, q, 5, seed_ids=seeds, res=CPU)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    # the frontier really is exhausted after 8 hops: 32 more change nothing
    buf = tcagra.traverse_init(tidx.dataset, torch.from_numpy(q), torch.from_numpy(seeds), 16,
                               "sqeuclidean")
    after8 = tcagra.traverse_steps(tidx.dataset, tidx.graph, torch.from_numpy(q), *buf,
                                   steps=8, width=1, metric="sqeuclidean")
    assert bool((after8[2] | ~torch.isfinite(after8[0])).all())
    after40 = tcagra.traverse_steps(tidx.dataset, tidx.graph, torch.from_numpy(q), *after8,
                                    steps=32, width=1, metric="sqeuclidean")
    assert all(torch.equal(a, b) for a, b in zip(after8, after40))
    assert (ti >= 0).all() and (ti // group == torch.from_numpy(start)[:, None] // group).all()
