"""Port parity: the CAGRA hop of ``raft_tpu_torch`` (plain version) against
raft_tpu's Pallas ``cagra_fused_hop`` in interpret mode, from identical
inputs; the plain multi-hop walk against raft_tpu's ``traverse_steps`` (its
XLA body and its fused Pallas hop); the fixed trip count of the port's
search against raft_tpu's early stop.  The hop and walk kernels against
their plain versions on the card are in ``test_torch_package.py`` (the
card's machine has no JAX)."""

import os
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

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

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
    assert ct.traverse_supported(torch.zeros(2, 2, dtype=torch.int8), 64)
    assert ct.traverse_supported(torch.zeros(2, 2, dtype=torch.uint8), 64)
    assert not ct.traverse_supported(torch.zeros(2, 2, dtype=torch.float16), 64)


def test_hop_work_counts_live_parents():
    live = torch.tensor([1, 0, 2], dtype=torch.int32)
    fetched = torch.tensor([50, 0, 101], dtype=torch.int32)
    w = cost.cagra_hop_work(live, fetched, 64, 128, 32, itemsize=2, width=2)
    assert w.flops == 151 * 4 * 128
    assert w.bytes_accessed == (3 * 64 * 4 + 151 * 128 * 2 + 3 * (128 + 2) * 4
                                + 2 * 3 * 32 * 9)
    paged = cost.cagra_hop_work(live, fetched, 64, 128, 32, itemsize=2, width=2, paged=True)
    assert paged.bytes_accessed == w.bytes_accessed + 151 * 4
    raft = cost.cagra_traverse_cost(3, 2, 64, 128, 32, itemsize=2)
    assert raft.flops > w.flops and raft.bytes_accessed > w.bytes_accessed


@pytest.mark.parametrize("width", [1, 2])
def test_hop_reads_count_the_rows_it_needs(width):
    """The rows a hop reads: per live parent, the distinct real ids of its
    list that are not already in the buffer (with one parent, counted here
    by sets; with two, each parent's list against the buffer the first one
    left)."""
    x, graph, q, parents, buf_d, buf_i, explored = hop_inputs(6, "sqeuclidean", width=width)
    live, fetched = ct.cagra_hop_reads(x, graph, q, parents, buf_d, buf_i, explored,
                                       metric="sqeuclidean")
    assert torch.equal(live, (parents >= 0).sum(dim=1, dtype=torch.int32))
    # the graph repeats an id in every list: no live parent reads all deg rows
    assert bool((fetched < live * graph.shape[1])[live > 0].all())
    assert bool((fetched[live == 0] == 0).all())
    b_i = buf_i
    for w in range(width):
        one = parents[:, w:w + 1]
        want = torch.tensor([0 if p < 0 else len(set(graph[p].tolist()) - {-1} - set(row.tolist()))
                             for p, row in zip(one[:, 0].tolist(), b_i)], dtype=torch.int32)
        got = ct.cagra_hop_reads(x, graph, q, one, buf_d, b_i, explored,
                                 metric="sqeuclidean")[1]
        assert torch.equal(got, want)
        buf_d, b_i, explored = ct.cagra_fused_hop_torch(x, graph, q, one, buf_d, b_i, explored,
                                                        metric="sqeuclidean")
        fetched = fetched - got
    assert bool((fetched == 0).all())


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


def _walk_inputs(seed, metric, itopk, dtype, exhaust):
    """A tile's seed buffer and the rows it walks, from a numpy seed.  With
    ``exhaust`` the graph links rows only within groups of 8 and each
    query is seeded inside one group, so its frontier runs out after at
    most 8 hops; otherwise a random graph with a repeated id in every list
    and ~5 % missing neighbours (-1)."""
    rng = np.random.default_rng(seed)
    n, d, deg, tile = 400, 16, 8, 6
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((tile, d)).astype(np.float32)
    if exhaust:
        base = (np.arange(n) // 8 * 8)[:, None]
        graph = (base + (np.arange(n)[:, None] + 1 + np.arange(deg)[None, :]) % 8)
        start = rng.integers(0, n // 8, tile)[:, None] * 8
        seeds = start + rng.integers(0, 8, (tile, itopk + 8))
    else:
        graph = rng.integers(0, n, (n, deg))
        graph[:, -1] = graph[:, 0]
        graph[rng.random((n, deg)) < 0.05] = -1
        seeds = rng.integers(0, n, (tile, itopk + 8))
    graph, seeds = graph.astype(np.int32), seeds.astype(np.int32)
    tx = torch.from_numpy(x).to(dtype)
    buf = tcagra.traverse_init(tx, torch.from_numpy(q), torch.from_numpy(seeds), itopk, metric)
    return tx, torch.from_numpy(graph), torch.from_numpy(q), buf


@pytest.mark.parametrize("exhaust", [False, True])
@pytest.mark.parametrize("itopk", [16, 129])
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("metric,dtype", [("sqeuclidean", torch.float32),
                                          ("inner_product", torch.float32),
                                          ("sqeuclidean", torch.bfloat16)])
def test_walk_matches_raft_traverse_steps(metric, dtype, width, itopk, exhaust):
    """The plain walk (``cagra_traverse_steps``, the loop of pick and hop)
    against raft_tpu's ``traverse_steps`` on its XLA body and on its fused
    Pallas hop (interpret mode), from one seed buffer: ids and explored
    flags equal, values within rtol 1e-5 / atol 1e-4 (the two sum |v|^2 in
    other orders)."""
    from raft_tpu.neighbors.cagra import traverse_steps as j_steps

    steps = 12
    x, graph, q, buf = _walk_inputs(11, metric, itopk, dtype, exhaust)
    got = ct.cagra_traverse_steps(x, graph, q, *buf, steps=steps, width=width, metric=metric)
    assert kernels.consume_kernel_path() == "torch"
    jx = jnp.asarray(x.float().numpy())
    if dtype == torch.bfloat16:
        jx = jx.astype(jnp.bfloat16)
    j_args = [jnp.asarray(t.numpy()) for t in (graph, q, *buf)]
    for fused in (False, True):
        ref = j_steps(jx, *j_args, steps=steps, width=width, metric=metric, fused=fused)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-4)
    live, fetched = got[3], got[4]
    assert live.dtype == fetched.dtype == torch.int32 and bool((live > 0).all())
    assert bool((live <= steps * width).all())
    assert bool((fetched < live * graph.shape[1]).all())
    if exhaust:   # every frontier ran out before the last hop
        assert bool((live < steps).all()) and bool(got[2].all())
    else:
        assert bool((fetched > 0).all())


def test_walk_is_the_loop_of_pick_and_hop():
    """The plain walk against the hop-by-hop loop of neighbors.cagra."""
    x, graph, q, buf = _walk_inputs(12, "sqeuclidean", 32, torch.float32, False)
    got = ct.cagra_traverse_steps_torch(x, graph, q, *buf, steps=5, width=2, metric="sqeuclidean")
    b = buf
    live = fetched = 0
    for _ in range(5):
        parents, explored = tcagra.pick_parents(b[0], b[1], b[2], 2)
        reads = ct.cagra_hop_reads(x, graph, q, parents, b[0], b[1], explored,
                                   metric="sqeuclidean")
        live, fetched = live + reads[0], fetched + reads[1]
        b = ct.cagra_fused_hop_torch(x, graph, q, parents, b[0], b[1], explored,
                                     metric="sqeuclidean")
    assert all(torch.equal(a, c) for a, c in zip(got[:3], b))
    assert torch.equal(got[3], live) and torch.equal(got[4], fetched)


def test_walk_work_counts_the_hops_each_query_ran():
    """The walk's bound from the plain walk's own counts: the graph row of
    every live parent of every hop, and only the rows those hops needed."""
    x, graph, q, buf = _walk_inputs(14, "sqeuclidean", 32, torch.float32, False)
    _, _, _, live, fetched = ct.cagra_traverse_steps_torch(x, graph, q, *buf, steps=12, width=2,
                                                           metric="sqeuclidean")
    deg, d = graph.shape[1], x.shape[1]
    w = cost.cagra_hop_work(live, fetched, deg, d, 32)
    n_live, n_rows = int(live.sum()), int(fetched.sum())
    assert 0 < n_rows < n_live * deg   # repeats and ids already in the buffer go unread
    assert w.flops == n_rows * 4 * d
    assert w.bytes_accessed == (n_live * deg * 4 + n_rows * d * 4 + q.shape[0] * d * 4
                                + 2 * q.shape[0] * 32 * 9)
    # the walk of one hop from given parents is the single hop's work
    hop = cost.cagra_hop_work(live, fetched, deg, d, 32, width=1)
    assert hop.bytes_accessed == w.bytes_accessed + q.shape[0] * 4


def test_walk_rejects_what_it_does_not_serve():
    x, graph, q, buf = _walk_inputs(13, "sqeuclidean", 16, torch.float32, False)
    with pytest.raises(ValueError):
        ct.cagra_traverse_steps(x.to(torch.float16), graph, q, *buf, steps=2, width=1,
                                metric="sqeuclidean")
    with pytest.raises(ValueError):
        ct.cagra_traverse_steps(x, graph, q[:3], *buf, steps=2, width=1, metric="sqeuclidean")


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_8bit_walk_and_hop_are_the_f32_ones_on_upcast_rows(dtype, metric, paged):
    """The plain walk and hop over uint8 / int8 rows are bitwise the f32
    ones over the same rows converted to f32 (values, ids, flags, live
    parents, fetched rows), dense and through a scattered page table."""
    from _torch_parity import paged_rows

    x, graph, q, buf = _walk_inputs(21, metric, 32, torch.float32, False)
    rng = np.random.default_rng(22)
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    x8 = torch.from_numpy(rng.integers(lo, hi, tuple(x.shape))).to(dtype)
    rows8, rows32 = x8, x8.to(torch.float32)
    if paged:
        rows8, rows32 = paged_rows(x8, 16, 23), paged_rows(x8.to(torch.float32), 16, 23)
    buf = tcagra.traverse_init(rows32, q, torch.from_numpy(
        rng.integers(0, x.shape[0], (q.shape[0], 40)).astype(np.int32)), 32, metric)
    got = ct.cagra_traverse_steps(rows8, graph, q, *buf, steps=6, width=2, metric=metric)
    want = ct.cagra_traverse_steps(rows32, graph, q, *buf, steps=6, width=2, metric=metric)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    assert not torch.equal(got[1], buf[1])
    parents, explored = ct.pick_parents(*buf, 2)
    h8 = ct.cagra_fused_hop(rows8, graph, q, parents, buf[0], buf[1], explored, metric=metric)
    h32 = ct.cagra_fused_hop(rows32, graph, q, parents, buf[0], buf[1], explored, metric=metric)
    assert all(torch.equal(a, b) for a, b in zip(h8, h32))
    seeds = buf[1][:, :20]
    assert all(torch.equal(a, b) for a, b in zip(tcagra.traverse_init(rows8, q, seeds, 8, metric),
                                                 tcagra.traverse_init(rows32, q, seeds, 8, metric)))
