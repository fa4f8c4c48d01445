"""Shared pieces of the port's tests: a top-k result checked against
raft_tpu's, and the inputs of one CAGRA hop (no JAX here: the card's tests
use them too)."""

import numpy as np
import torch


def assert_topk_match(v, i, v_ref, i_ref, *, rtol=1e-5, atol=1e-5, gap=1e-4):
    """Values close (+inf where the reference is +inf); ids equal wherever
    the value is separated from its neighbors in the reference list by more
    than ``gap`` (near-ties may flip with f32 summation order)."""
    v, i = np.asarray(v), np.asarray(i)
    v_ref, i_ref = np.asarray(v_ref), np.asarray(i_ref)
    np.testing.assert_allclose(v, v_ref, rtol=rtol, atol=atol)
    padded = np.pad(v_ref.astype(np.float64), [(0, 0)] * (v_ref.ndim - 1) + [(1, 1)],
                    constant_values=np.inf)
    with np.errstate(invalid="ignore"):  # inf - inf between padding slots
        sep = (np.abs(padded[..., 1:-1] - padded[..., :-2]) > gap) & (
            np.abs(padded[..., 2:] - padded[..., 1:-1]) > gap)
    sep |= ~np.isfinite(v_ref)
    np.testing.assert_array_equal(i[sep], i_ref[sep])
    assert (i == i_ref).mean() >= 0.999


def hop_inputs(seed, metric, *, n=1500, d=48, deg=16, tile=24, itopk=32, width=2):
    """Inputs of one CAGRA hop, CPU tensors made from a numpy seed: (x, graph,
    queries, parents, buf_d, buf_i, explored).  The graph repeats an id in
    every list and misses ~5% of its neighbours (-1); the buffer comes from
    ``cagra.traverse_init``, with some slots already explored; ``width``
    parents per query are picked as the search picks them, none for the
    first query."""
    from raft_tpu_torch.neighbors import cagra

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((tile, d)).astype(np.float32))
    graph = rng.integers(0, n, size=(n, deg)).astype(np.int32)
    graph[:, deg - 1] = graph[:, 0]
    graph[rng.random((n, deg)) < 0.05] = -1
    seeds = torch.from_numpy(rng.integers(0, n, size=(tile, itopk + 8)).astype(np.int32))
    buf_d, buf_i, explored = cagra.traverse_init(x, q, seeds, itopk, metric)
    explored[:, 1::5] = True
    explored |= ~torch.isfinite(buf_d)
    front = torch.where(explored, torch.full_like(buf_d, float("inf")), buf_d)
    ppos = torch.sort(front, dim=1, stable=True).indices[:, :width]
    parents = torch.gather(buf_i, 1, ppos)
    parents[0] = -1
    return (x, torch.from_numpy(graph), q, parents, buf_d, buf_i,
            explored.scatter(1, ppos, True))
