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


def scattered_pages(rows, page_rows, seed, spare=3):
    """``rows`` [n, ...] (n a multiple of ``page_rows``) placed page by page
    into a pool with ``spare`` extra slots in a random order, the spare
    slots filled with noise: (pool [n_pages + spare, page_rows, ...],
    page_slot [n_pages] int32) — a placement no identity read can pass."""
    n_pages = rows.shape[0] // page_rows
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_pages + spare, generator=g)
    pages = rows.reshape((n_pages, page_rows) + tuple(rows.shape[1:]))
    pool = torch.zeros((n_pages + spare,) + tuple(pages.shape[1:]), dtype=rows.dtype)
    if rows.dtype == torch.int8:
        pool[:] = torch.randint(-127, 128, pool.shape, generator=g, dtype=torch.int8)
    else:
        pool[:] = torch.randn(pool.shape, generator=g).to(rows.dtype)
    pool[perm[:n_pages]] = pages
    return pool, perm[:n_pages].to(torch.int32)


def paged_lists(list_data, page_rows, seed):
    """A ``store.PagedLists`` over the lists [L, cap, d] (cap a multiple of
    ``page_rows``) with a scattered placement."""
    from raft_tpu_torch.store import PagedLists

    L, cap = list_data.shape[:2]
    pool, page_slot = scattered_pages(list_data.reshape((L * cap,) + tuple(list_data.shape[2:])),
                                      page_rows, seed)
    return PagedLists(pool, page_slot, cap // page_rows)


def paged_rows(x, page_rows, seed):
    """A ``store.PagedRows`` over the rows [n, d] (zero-padded to a page
    multiple) with a scattered placement."""
    from raft_tpu_torch.store import PagedRows

    n = x.shape[0]
    pad = -n % page_rows
    rows = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype)])
    pool, page_slot = scattered_pages(rows, page_rows, seed)
    return PagedRows(pool, page_slot, n)
