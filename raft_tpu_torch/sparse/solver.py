"""Graph solvers: Boruvka MST, connected components, cross-component 1-NN
(counterpart of ``raft_tpu.sparse.solver``).

Each Boruvka round is raft_tpu's: a segment-min per component over its
outgoing edges with the undirected tie order (weight, lo, hi, edge id),
symmetry-broken hookup, pointer jumping until the labels settle.  raft_tpu
runs the rounds in a ``lax.while_loop``; here each round's termination
test (any edge still between components) and each pointer-jumping step's
(any parent not a root) read one bool on the host.  Segment mins are
``scatter_reduce(amin)``: exact in any order, so the card gives one
result run after run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, as_f32, ensure, to_device
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.sparse.formats import COO

_INT_MAX = 2**31 - 1


def _seg_min(values: torch.Tensor, seg: torch.Tensor, n: int, fill) -> torch.Tensor:
    """[n] minimum of ``values`` per segment (segment n: dropped); empty
    segments read ``fill``."""
    out = torch.full((n + 1,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, seg.long(), values, "amin", include_self=True)[:n]


def _pointer_jump(parent: torch.Tensor) -> torch.Tensor:
    """A parent forest collapsed to root labels (log-depth jumping)."""
    while True:
        pp = parent[parent.long()]
        if not bool((pp != parent).any()):
            return parent
        parent = pp


def _mst_rounds(rows, cols, weights, valid, n: int):
    m = rows.shape[0]
    dev = rows.device
    edge_ids = torch.arange(m, dtype=torch.int32, device=dev)
    a = torch.arange(n, dtype=torch.int32, device=dev)
    r = torch.clamp(rows, 0, n - 1).long()
    c = torch.clamp(cols, 0, n - 1).long()
    lo = torch.minimum(rows, cols)
    hi = torch.maximum(rows, cols)
    comp = a.clone()
    chosen = torch.zeros(m, dtype=torch.bool, device=dev)
    imax = torch.full_like(edge_ids, _INT_MAX)
    while bool((valid & (comp[r] != comp[c])).any()):
        cs, cd = comp[r], comp[c]
        cross = valid & (cs != cd)
        # lightest outgoing edge per component, ties broken on the
        # undirected (weight, lo, hi, id) order: with a total order on
        # undirected edges every hookup cycle is a mutual pair
        seg = torch.where(cross, cs, torch.full_like(cs, n))
        csafe = torch.clamp(cs, 0, n - 1).long()
        w = torch.where(cross, weights, torch.full_like(weights, float("inf")))
        wmin = _seg_min(w, seg, n, float("inf"))
        tie = cross & (weights == wmin[csafe])
        lmin = _seg_min(torch.where(tie, lo, imax), seg, n, _INT_MAX)
        tie = tie & (lo == lmin[csafe])
        hmin = _seg_min(torch.where(tie, hi, imax), seg, n, _INT_MAX)
        tie = tie & (hi == hmin[csafe])
        emin = _seg_min(torch.where(tie, edge_ids, imax), seg, n, _INT_MAX)
        has = torch.isfinite(wmin) & (emin < _INT_MAX)
        safe_e = torch.clamp(emin, 0, m - 1).long()
        target = torch.where(has, cd[safe_e], a)
        mutual = target[torch.clamp(target, 0, n - 1).long()] == a
        parent = torch.where(mutual & (a < target), a, target)
        parent = _pointer_jump(parent)
        hooked = has & ~(mutual & (a < target))
        chosen[emin[hooked].long()] = True
        comp = parent[comp.long()]
    return comp, chosen


@traced("solver.mst")
def mst(graph: COO, *, res: Optional[Resources] = None) -> Tuple[COO, torch.Tensor, torch.Tensor]:
    """Minimum spanning forest of an undirected weighted graph: (edges COO,
    component labels [n], total weight).  On a disconnected graph the labels
    name the trees."""
    res = ensure(res)
    graph = graph.to(res.device)
    n = graph.shape[0]
    comp, chosen = _mst_rounds(graph.rows, graph.cols, graph.data, graph.valid, n)
    idx = torch.nonzero(chosen).squeeze(1).cpu().numpy()
    rows = graph.rows.cpu().numpy()[idx]
    cols = graph.cols.cpu().numpy()[idx]
    data = graph.data.cpu().numpy()[idx]
    # an undirected edge picked from both ends (a->b and b->a) kept once
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    _, uniq = np.unique(np.stack([lo, hi]), axis=1, return_index=True)
    uniq = np.sort(uniq)
    out = COO(rows[uniq], cols[uniq], data[uniq], graph.shape, device=res.device)
    total = torch.tensor(data[uniq].sum() if uniq.size else 0.0, dtype=graph.data.dtype,
                         device=res.device)
    return out, comp, total


@traced("solver.connected_components")
def connected_components(graph: COO) -> torch.Tensor:
    """Component labels (the least vertex id of each component) by label
    propagation over both directions plus pointer jumping."""
    n = graph.shape[0]
    rows = torch.cat([graph.rows, graph.cols])
    cols = torch.cat([graph.cols, graph.rows])
    valid = torch.cat([graph.valid, graph.valid])
    seg = torch.where(valid, rows, torch.full_like(rows, n))
    cc = torch.clamp(cols, 0, n - 1).long()
    comp = torch.arange(n, dtype=torch.int32, device=graph.device)
    while True:
        upd = _seg_min(torch.where(valid, comp[cc], torch.full_like(cols, _INT_MAX)), seg, n,
                       _INT_MAX)
        new = torch.minimum(comp, torch.where(upd == _INT_MAX, comp, upd))
        new = _pointer_jump(torch.minimum(new, new[new.long()]))
        if not bool((new != comp).any()):
            return new
        comp = new


@traced("solver.cross_component_nn")
def cross_component_nn(
    x,
    labels,
    *,
    res: Optional[Resources] = None,
) -> COO:
    """For each component, its lightest edge to a point of another
    component (the lowest-index member among those at the least finite
    distance); the edges deduped as undirected.  Distances are squared L2
    in row tiles (``max(|x|^2 + |y|^2 - 2 x.y, 0)``, the same label masked
    to +inf, the first minimum of a row)."""
    res = ensure(res)
    x = as_f32(x, res.device)
    labels = to_device(labels, res.device).to(torch.int32)
    n = x.shape[0]
    tile = max(1, min(n, res.workspace_rows(4 * n, cap=8192)))
    x2 = (x * x).sum(dim=1)
    js, ds = [], []
    for s in range(0, n, tile):
        xt = x[s:s + tile]
        d2 = (xt * xt).sum(dim=1)[:, None] + x2[None, :] - 2.0 * torch.matmul(xt, x.T)
        same = labels[s:s + tile, None] == labels[None, :]
        d2 = torch.where(same, torch.full_like(d2, float("inf")), torch.clamp(d2, min=0.0))
        dt, jt = torch.min(d2, dim=1)
        js.append(jt.to(torch.int32))
        ds.append(dt)
    j_np = torch.cat(js).cpu().numpy()
    d_np = torch.cat(ds).cpu().numpy()
    lab_np = labels.cpu().numpy()
    # one sort groups the members by component, least distance first, then
    # lowest index: the first finite member of each group is its edge
    members = np.nonzero(np.isfinite(d_np))[0]
    order = members[np.lexsort((members, d_np[members], lab_np[members]))]
    lab_s = lab_np[order]
    first = np.ones(order.size, bool)
    first[1:] = lab_s[1:] != lab_s[:-1]
    b = order[first]
    if b.size == 0:
        return COO(np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32),
                   (n, n), device=res.device)
    rows = b.astype(np.int32)
    cols = j_np[b].astype(np.int32)
    vals = d_np[b].astype(np.float32)
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    _, uniq = np.unique(np.stack([lo, hi]), axis=1, return_index=True)
    uniq = np.sort(uniq)
    return COO(rows[uniq], cols[uniq], vals[uniq], (n, n), device=res.device)
