"""The CAGRA beam search's hops: ``csrc/cagra_hop.cu`` and the plain
versions (counterpart of ``raft_tpu.kernels.cagra_traverse``: the dense
leg, and the paged leg ``_hop_kernel_paged`` for a ``store.PagedRows``
dataset, whose rows are read through the page table).

- :func:`cagra_fused_hop`: one hop (raft_tpu's ``cagra_fused_hop``; launch
  counts ``cagra_fused_hop`` and ``cagra_fused_hop_paged``);
- :func:`cagra_traverse_steps`: a tile's whole walk, ``steps`` hops each
  picking its parents (:func:`pick_parents`) then hopping, in one launch
  (launch counts ``cagra_traverse`` and ``cagra_traverse_paged``); raft_tpu
  runs the same loop inside one jit (``neighbors.cagra.traverse_steps``).
  Its plain version is that loop over the plain pick and hop.

Both launch one kernel, the walk's; the single hop is its one-hop case
with the parents given.

A hop takes each query's ``width`` parents (−1: none) and folds their
neighbour lists into the query's candidate buffer ``(buf_d, buf_i,
explored)`` [tile, itopk], sorted ascending with id −1 at every +inf slot.
Per parent, in order: score the neighbour rows (squared L2 or −q·v, every
dot product one f32 sum in dimension order, ``toolkit.sequential_dot``,
over the rows converted exactly to f32: f32, bf16, uint8 or int8 rows);
score +inf a negative id, a missing parent, an id already in the live
merged buffer, and a repeat of an earlier slot of the same list; fold into
the buffer by (value, position), residents first (``toolkit.fold_topk``);
set the id of every +inf slot to −1.  A slot of the result is explored when
its id was explored in the input buffer, or when its value is +inf.

raft_tpu's Pallas hop computes the same function on f32 / bf16 rows; its
|v|^2 goes through a ones-contraction, so the two differ only in summation
order.  raft_tpu walks 8-bit rows in its XLA body (the rows of each hop
cast to f32); the port's kernel has 8-bit legs, counted under the same
launch names as the f32 and bf16 rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch import kernels as _k
from raft_tpu_torch.kernels.select_k import select_k_torch
from raft_tpu_torch.kernels.toolkit import fold_topk, sequential_dot
from raft_tpu_torch.ops import cost as _cost
from raft_tpu_torch.store.paged import PagedRows

#: widest candidate buffer the hop kernel serves (raft_tpu's MAX_ITOPK)
MAX_ITOPK = 512
_METRICS = ("sqeuclidean", "euclidean", "inner_product")
#: the row types of the hop kernel, and each one's code in the C entries
_DATASET_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2, torch.int8: 3}


def traverse_supported(dataset, itopk: int) -> bool:
    """Routing gate of the hop kernel: a dense f32, bf16, uint8 or int8
    dataset, or a ``PagedRows`` of one, and ``0 < itopk <= 512``."""
    return (
        isinstance(dataset, (torch.Tensor, PagedRows))
        and dataset.dtype in _DATASET_DTYPES
        and 0 < itopk <= MAX_ITOPK
    )


def _check(dataset, graph, queries, parents, buf_d, buf_i, explored, metric):
    if metric not in _METRICS:
        raise ValueError(f"cagra hop metric must be one of {_METRICS}, got {metric!r}")
    if isinstance(dataset, (torch.Tensor, PagedRows)) and dataset.dtype not in _DATASET_DTYPES:
        raise ValueError(f"cagra hop serves f32/bf16/uint8/int8 datasets, dense or paged, got "
                         f"{getattr(dataset, 'dtype', type(dataset))}")
    tile, itopk = buf_d.shape
    n, d = dataset.shape
    if isinstance(dataset, PagedRows) and dataset.page_slot.shape[0] * dataset.page_rows < n:
        raise ValueError(f"page table of {dataset.page_slot.shape[0]} pages of "
                         f"{dataset.page_rows} rows cannot hold {n} rows")
    if graph.ndim != 2 or graph.shape[0] != n:
        raise ValueError(f"graph {tuple(graph.shape)} vs dataset {tuple(dataset.shape)}")
    if queries.shape != (tile, d) or (parents is not None and (
            parents.ndim != 2 or parents.shape[0] != tile)):
        raise ValueError(
            f"queries {tuple(queries.shape)} / parents "
            f"{None if parents is None else tuple(parents.shape)} vs "
            f"buffer [{tile}, {itopk}] and d={d}")
    if buf_i.shape != (tile, itopk) or explored.shape != (tile, itopk):
        raise ValueError("buf_d, buf_i and explored must share one [tile, itopk] shape")


def gather_rows(dataset, ids: torch.Tensor) -> torch.Tensor:
    """f32 rows of ``ids`` (clipped to [0, n)), from a dense dataset, or by
    the ``decode(ids)`` of a ``PagedRows`` page table or a compressed
    dataset (``neighbors.vpq_dataset.VpqDataset``: the plain versions only)."""
    if not isinstance(dataset, torch.Tensor):
        return dataset.decode(ids)
    return dataset[ids.long().clamp(0, dataset.shape[0] - 1)].to(torch.float32)


def _sqnorm(rows: torch.Tensor) -> torch.Tensor:
    """|v|^2 of rows [..., d], one f32 sum in dimension order."""
    return sequential_dot(rows[..., None, :], rows[..., None, :])[..., 0, 0]


def _hop_torch(dataset, graph, queries, parents, buf_d, buf_i, explored, metric):
    """The plain hop; returns ``(buf_d, buf_i, explored, live, fetched)``,
    live and fetched [tile] int32 the live parents a query had and the
    candidate rows they needed (those not dropped as -1, a repeat or an id
    already in the buffer).  Rows a kernel leg reads (a tensor or a
    ``PagedRows``) are scored in the kernel's summation order; rows decoded
    on gather (a VPQ dataset, which no kernel leg reads) by one batched
    product, as raft_tpu's XLA body scores them."""
    tile, itopk = buf_d.shape
    n, deg = graph.shape
    q = queries.to(torch.float32)
    exact = isinstance(dataset, (torch.Tensor, PagedRows))
    q2 = (_sqnorm(q) if exact else (q * q).sum(dim=1))[:, None]
    inf = torch.full((), float("inf"), dtype=torch.float32, device=q.device)
    earlier = torch.triu(torch.ones((deg, deg), dtype=torch.bool, device=q.device), 1)
    md, mi = buf_d.to(torch.float32), buf_i.to(torch.int32)
    live = (parents >= 0).sum(dim=1, dtype=torch.int32)
    fetched = torch.zeros_like(live)
    for w in range(parents.shape[1]):
        pid = parents[:, w:w + 1].to(torch.int64)
        cand = graph[pid[:, 0].clamp(0, n - 1)].to(torch.int32)               # [t, deg]
        cand = torch.where(pid < 0, torch.full_like(cand, -1), cand)
        rows = gather_rows(dataset, cand)                                      # [t, deg, d]
        ip = (sequential_dot(q[:, None, :], rows)[:, 0, :] if exact
              else torch.bmm(rows, q[:, :, None])[:, :, 0])
        if metric == "inner_product":
            cd = -ip
        else:
            v2 = _sqnorm(rows) if exact else (rows * rows).sum(dim=2)
            cd = torch.clamp((q2 + v2) - 2.0 * ip, min=0.0)
        in_buf = (cand[:, :, None] == mi[:, None, :]).any(dim=2)
        dup = ((cand[:, :, None] == cand[:, None, :]) & earlier).any(dim=1)
        bad = (cand < 0) | (pid < 0) | in_buf | dup
        fetched += (~bad).sum(dim=1, dtype=torch.int32)
        cd = torch.where(bad, inf, cd)
        md, mi = fold_topk(md, mi, cd, torch.where(bad, torch.full_like(cand, -1), cand), itopk)
        mi = torch.where(torch.isfinite(md), mi, torch.full_like(mi, -1))
    hit = ((mi[:, :, None] == buf_i[:, None, :]) & explored[:, None, :]).any(dim=2)
    return md, mi, hit | ~torch.isfinite(md), live, fetched


def cagra_fused_hop_torch(
    dataset,                  # [n, d] f32 / bf16 / uint8 / int8, or PagedRows
    graph: torch.Tensor,      # [n, deg] int32
    queries: torch.Tensor,    # [tile, d] f32
    parents: torch.Tensor,    # [tile, width] int32, -1 = no parent
    buf_d: torch.Tensor,      # [tile, itopk] f32, ascending, +inf empty slots
    buf_i: torch.Tensor,      # [tile, itopk] int32, -1 at +inf slots
    explored: torch.Tensor,   # [tile, itopk] bool, parents already marked
    *,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the kernel's per-parent fold in tensor operations
    (any itopk)."""
    _check(dataset, graph, queries, parents, buf_d, buf_i, explored, metric)
    return _hop_torch(dataset, graph, queries, parents, buf_d, buf_i, explored, metric)[:3]


def cagra_hop_reads(dataset, graph, queries, parents, buf_d, buf_i, explored, *,
                    metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """What one hop (arguments as :func:`cagra_fused_hop_torch`) really
    reads: ``(live, fetched)`` [tile] int32, each query's live parents and
    the candidate rows they need (a candidate that is -1, repeats an
    earlier slot of its list or already sits in the buffer is dropped
    unread), from the plain version; for ``ops.cost.cagra_hop_work``."""
    _check(dataset, graph, queries, parents, buf_d, buf_i, explored, metric)
    return _hop_torch(dataset, graph, queries, parents, buf_d, buf_i, explored, metric)[3:]


def cagra_fused_hop(
    dataset,
    graph: torch.Tensor,
    queries: torch.Tensor,
    parents: torch.Tensor,
    buf_d: torch.Tensor,
    buf_i: torch.Tensor,
    explored: torch.Tensor,
    *,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One hop (arguments as :func:`cagra_fused_hop_torch`); returns the
    merged ``(buf_d, buf_i, explored)``.  CUDA tensors go through
    ``csrc/cagra_hop.cu`` (a ``PagedRows`` dataset through its paged leg),
    CPU tensors take the plain version; the call stamps ``kernel_path``
    "cuda" or "torch".  Raises outside :func:`traverse_supported` on the
    card."""
    _check(dataset, graph, queries, parents, buf_d, buf_i, explored, metric)
    if dataset.device.type == "cpu":
        _k.stamp_kernel_path("torch")
        return cagra_fused_hop_torch(dataset, graph, queries, parents, buf_d, buf_i,
                                     explored, metric=metric)
    tile, itopk = buf_d.shape
    if not traverse_supported(dataset, itopk):
        raise ValueError(f"cagra hop kernel serves itopk<={MAX_ITOPK}, got {itopk}")
    n, d = dataset.shape
    paged = isinstance(dataset, PagedRows)
    name = "cagra_fused_hop_paged" if paged else "cagra_fused_hop"
    x = dataset.pool if paged else dataset.contiguous()
    tensors = [x] + [t.contiguous() for t in (
        graph.to(torch.int32), queries.to(torch.float32), parents.to(torch.int32),
        buf_d.to(torch.float32), buf_i.to(torch.int32), explored.to(torch.bool))]
    if paged:
        if dataset.page_slot.dtype != torch.int32:
            raise ValueError(f"page table must be int32, got {dataset.page_slot.dtype}")
        tensors.append(dataset.page_slot)
    _k.require_cuda(name, *tensors)
    g, qf, par, bd, bi, be = tensors[1:7]
    out_d = torch.empty_like(bd)
    out_i = torch.empty_like(bi)
    out_e = torch.empty_like(be)
    lib = _k.library()
    _k.stamp_kernel_path("cuda")
    _cost.note(name, lambda: _cost.cagra_hop_work(
        *cagra_hop_reads(dataset, graph, queries, parents, buf_d, buf_i, explored,
                         metric=metric),
        g.shape[1], d, itopk, itemsize=x.element_size(), paged=paged, width=par.shape[1]))
    _k.count_launch(name)
    code = lib.rt_cagra_hop(
        x.data_ptr(), _DATASET_DTYPES[x.dtype], g.data_ptr(), qf.data_ptr(),
        par.data_ptr(), bd.data_ptr(), bi.data_ptr(), be.data_ptr(), tile, d, g.shape[1],
        par.shape[1], itopk, int(metric == "inner_product"),
        dataset.page_slot.data_ptr() if paged else None, dataset.page_rows if paged else 0,
        out_d.data_ptr(), out_i.data_ptr(), out_e.data_ptr(), _k.stream_of(x),
    )
    _k.check(name, code)
    return out_d, out_i, out_e


def pick_parents(buf_d: torch.Tensor, buf_i: torch.Tensor, explored: torch.Tensor,
                 width: int, *, select=select_k_torch) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``width`` best unexplored finite slots of each buffer (``select``,
    the lowest slot winning a tie; default the plain select_k), marked
    explored: (parents [tile, width] int32, -1 where the frontier ran out;
    explored)."""
    inf = torch.full((), float("inf"), device=buf_d.device)
    front_d = torch.where(explored | ~torch.isfinite(buf_d), inf, buf_d)
    _, ppos = select(front_d, width, select_min=True)
    ppos = ppos.long()
    parents = torch.gather(buf_i, 1, ppos)
    parents = torch.where(torch.gather(front_d, 1, ppos) < inf, parents,
                          torch.full_like(parents, -1))
    return parents.to(torch.int32), explored.scatter(1, ppos, True)


def cagra_traverse_steps_torch(dataset, graph, queries, buf_d, buf_i, explored, *, steps: int,
                               width: int, metric: str):
    """Plain version: ``steps`` times :func:`pick_parents` then
    :func:`cagra_fused_hop_torch`.  Returns ``(buf_d, buf_i, explored,
    live, fetched)``, live and fetched [tile] int32 the parents each query's
    walk had (a hop past the frontier's end has none and changes nothing)
    and the candidate rows they needed (:func:`cagra_hop_reads`)."""
    _check(dataset, graph, queries, None, buf_d, buf_i, explored, metric)
    live = torch.zeros(buf_d.shape[0], dtype=torch.int32, device=buf_d.device)
    fetched = torch.zeros_like(live)
    for _ in range(steps):
        parents, explored = pick_parents(buf_d, buf_i, explored, width)
        buf_d, buf_i, explored, hop_live, hop_fetched = _hop_torch(
            dataset, graph, queries, parents, buf_d, buf_i, explored, metric)
        live += hop_live
        fetched += hop_fetched
    return buf_d, buf_i, explored, live, fetched


def cagra_traverse_steps(
    dataset,                  # [n, d] f32 / bf16 / uint8 / int8, or PagedRows
    graph: torch.Tensor,      # [n, deg] int32
    queries: torch.Tensor,    # [tile, d] f32
    buf_d: torch.Tensor,      # [tile, itopk] f32, ascending, +inf empty slots
    buf_i: torch.Tensor,      # [tile, itopk] int32, -1 at +inf slots, finite ids distinct
    explored: torch.Tensor,   # [tile, itopk] bool
    *,
    steps: int,
    width: int,
    metric: str,
):
    """``steps`` hops of a tile's walk (arguments as
    :func:`cagra_traverse_steps_torch`); returns ``(buf_d, buf_i, explored,
    live, fetched)``.  CUDA tensors go through ``csrc/cagra_hop.cu``
    ``rt_cagra_traverse``, one launch for the whole walk (a ``PagedRows``
    dataset through its paged rows), CPU tensors take the plain version; the
    call stamps ``kernel_path`` "cuda" or "torch".  Raises outside
    :func:`traverse_supported` on the card."""
    _check(dataset, graph, queries, None, buf_d, buf_i, explored, metric)
    if dataset.device.type == "cpu":
        _k.stamp_kernel_path("torch")
        return cagra_traverse_steps_torch(dataset, graph, queries, buf_d, buf_i, explored,
                                          steps=steps, width=width, metric=metric)
    tile, itopk = buf_d.shape
    if not traverse_supported(dataset, itopk):
        raise ValueError(f"cagra walk kernel serves itopk<={MAX_ITOPK}, got {itopk}")
    if not 0 < width <= itopk or steps < 0:
        raise ValueError(f"cagra walk kernel serves 0 < width <= itopk and steps >= 0, "
                         f"got width={width}, steps={steps}")
    n, d = dataset.shape
    paged = isinstance(dataset, PagedRows)
    name = "cagra_traverse_paged" if paged else "cagra_traverse"
    x = dataset.pool if paged else dataset.contiguous()
    tensors = [x] + [t.contiguous() for t in (
        graph.to(torch.int32), queries.to(torch.float32), buf_d.to(torch.float32),
        buf_i.to(torch.int32), explored.to(torch.bool))]
    if paged:
        if dataset.page_slot.dtype != torch.int32:
            raise ValueError(f"page table must be int32, got {dataset.page_slot.dtype}")
        tensors.append(dataset.page_slot)
    _k.require_cuda(name, *tensors)
    g, qf, bd, bi, be = tensors[1:6]
    out_d = torch.empty_like(bd)
    out_i = torch.empty_like(bi)
    out_e = torch.empty_like(be)
    live = torch.empty(tile, dtype=torch.int32, device=bd.device)
    fetched = torch.empty_like(live)
    lib = _k.library()
    _k.stamp_kernel_path("cuda")
    _k.count_launch(name)
    code = lib.rt_cagra_traverse(
        x.data_ptr(), _DATASET_DTYPES[x.dtype], g.data_ptr(), qf.data_ptr(),
        bd.data_ptr(), bi.data_ptr(), be.data_ptr(), tile, d, g.shape[1], width, itopk,
        int(metric == "inner_product"), steps,
        dataset.page_slot.data_ptr() if paged else None, dataset.page_rows if paged else 0,
        out_d.data_ptr(), out_i.data_ptr(), out_e.data_ptr(), live.data_ptr(), fetched.data_ptr(),
        _k.stream_of(x),
    )
    _k.check(name, code)
    _cost.note(name, lambda: _cost.cagra_hop_work(live, fetched, g.shape[1], d, itopk,
                                                  itemsize=x.element_size(), paged=paged))
    return out_d, out_i, out_e, live, fetched
