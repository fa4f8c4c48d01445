"""Random ball cover (RBC) nearest neighbours (counterpart of
``raft_tpu.neighbors.ball_cover``; the reference's ``ball_cover.cuh``):
sample √n landmarks, put every row in the ball of its closest landmark,
and at query time rank the landmarks and search the closest balls.
Metrics: sqeuclidean, euclidean and haversine.

The index is raft_tpu's: landmarks drawn by ``_common.subsample_trainset``
(numpy's generator, so the same rows for the same seed), and the balls
packed as padded lists by ``_common.compute_list_layout`` with no
``max_cap`` (a ball is never split).  On the card:

- ``build`` assigns rows to landmarks with the fused argmin kernel (#7)
  for the L2 family, so no [n, L] distance matrix exists; haversine takes
  the pairwise layer in row tiles (no kernel has it, in either package).
- ``knn_query`` ranks the landmarks by the pairwise layer and the
  select_k kernel (#1); for the L2 family it then scans the probed balls
  as IVF lists (``_common.scan_search`` with these probes: the probe-major
  or query-major scan, #3 / #5, on raft_tpu's schedule rule), so the
  [q, p, cap, d] gather of raft_tpu's ``_query_jit`` never exists.
  Haversine scores the gathered rows of a query tile elementwise (d = 2).
- ``eps_nn`` keeps raft_tpu's triangle-inequality pruning, widened by the
  rounding bound of the distances it compares, scores the surviving
  (query, ball) pairs in batched tiles of balls and decides each pair
  exactly (``extras.exact_sq_le``), so it equals
  ``extras.epsilon_neighborhood``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import (
    Resources, as_f32, ensure, resolve_device, to_device, to_numpy)
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES, distance_matrix_tile
from raft_tpu_torch.kernels.fused_argmin import fused_l2_argmin
from raft_tpu_torch.neighbors import _common
from raft_tpu_torch.neighbors.extras import exact_sq_le, l2_rounding_bound, sq_norm_max
from raft_tpu_torch.ops.matrix import select_k_untraced as select_k

_SUPPORTED = ("sqeuclidean", "euclidean", "haversine")
#: bytes a query's candidate slot takes in a haversine scan tile (the
#: gathered [lat, lon], the elementwise temporaries, the id)
_HAVERSINE_SLOT_BYTES = 48
#: an f32 haversine distance lies within this of the exact one (radians),
#: away from antipodal pairs; eps_nn widens its pruning by three of it
_HAVERSINE_ERR = 1e-3
#: bytes an element of an L2 eps_nn tile [ball, query, member] takes (the
#: product, turned into the distance in place, and its masks)
_EPS_ELEM_BYTES = 16


class BallCoverIndex:
    """landmarks [L, d] f32, list_vecs [L, cap, d] f32 (each ball's rows,
    zero padded), list_index [L, cap] int32 (-1 padded), list_sizes [L]
    int32, radii [L] f32 (the largest member distance in the internal
    metric: squared L2 for the L2 family).  numpy arrays (raft_tpu's index
    arrays) go to ``res``'s device, or cuda; tensors stay where they are
    (on the landmarks' device)."""

    def __init__(self, metric, landmarks, list_vecs, list_index, list_sizes, radii, *,
                 res: Optional[Resources] = None):
        dev = resolve_device(res, landmarks)
        self.metric = DISTANCE_TYPES.get(metric, metric)
        self.landmarks = to_device(landmarks, dev).to(torch.float32)
        self.list_vecs = to_device(list_vecs, dev).to(torch.float32)
        self.list_index = to_device(list_index, dev).to(torch.int32)
        self.list_sizes = to_device(list_sizes, dev).to(torch.int32)
        self.radii = to_device(radii, dev).to(torch.float32)
        self._scan_norms: Optional[torch.Tensor] = None

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def dim(self) -> int:
        return self.landmarks.shape[1]

    @property
    def list_cap(self) -> int:
        return self.list_vecs.shape[1]

    @property
    def scan_norms(self) -> torch.Tensor:
        """|y|^2 of each ball slot [L, cap] f32, 0 at padding: the scans'
        ``list_y2``."""
        if self._scan_norms is None:
            y2 = (self.list_vecs * self.list_vecs).sum(dim=2)
            self._scan_norms = torch.where(self.list_index >= 0, y2, torch.zeros_like(y2))
        return self._scan_norms


def _base(metric: str) -> str:
    """The internal metric: haversine, or squared L2 for the L2 family."""
    return "haversine" if metric == "haversine" else "sqeuclidean"


def _sq_dist_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a_i - b_i|^2 per row, in the difference form (within
    ``l2_rounding_bound`` of exact)."""
    diff = a - b
    return (diff * diff).sum(dim=1)


def _haversine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Haversine of [lat, lon] points ``a`` and ``b`` [..., 2], broadcast:
    the operations of ``pairwise._haversine_tile`` in its order, so a pair
    scores the same bits in both."""
    lat1, lon1 = a[..., 0], a[..., 1]
    lat2, lon2 = b[..., 0], b[..., 1]
    sdlat = torch.sin(0.5 * (lat2 - lat1))
    sdlon = torch.sin(0.5 * (lon2 - lon1))
    a = sdlat * sdlat + torch.cos(lat1) * torch.cos(lat2) * sdlon * sdlon
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def _assign(x: torch.Tensor, landmarks: torch.Tensor, base: str, res: Resources):
    """(label [n] int64, member distance [n] f32) of each row's closest
    landmark (the first of equals)."""
    if base == "sqeuclidean":
        _, labels = fused_l2_argmin(x, landmarks, (landmarks * landmarks).sum(dim=1))
        labels = labels.long()
        member_d = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        step = res.workspace_rows(8 * x.shape[1])
        for s in range(0, x.shape[0], step):
            member_d[s:s + step] = _sq_dist_rows(x[s:s + step], landmarks[labels[s:s + step]])
        return labels, member_d
    step = res.workspace_rows(4 * landmarks.shape[0])
    labels = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    member_d = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], step):
        d = distance_matrix_tile(x[s:s + step], landmarks, "haversine")
        member_d[s:s + step], labels[s:s + step] = torch.min(d, dim=1)
    return labels, member_d


@traced("ball_cover.build")
def build(dataset, *, metric: str = "sqeuclidean", n_landmarks: int = 0, seed: int = 0,
          res: Optional[Resources] = None) -> BallCoverIndex:
    """Sample ``n_landmarks`` (default √n) rows as landmarks, assign every
    row to its closest one, and pack the balls (the reference's
    ``build_index``)."""
    res = ensure(res)
    dev = res.device
    canonical = DISTANCE_TYPES.get(metric, metric)
    if canonical not in _SUPPORTED:
        raise ValueError(f"ball_cover supports {_SUPPORTED}, got {metric}")
    x = as_f32(dataset, dev)
    n, d = x.shape
    L = n_landmarks or max(1, int(np.sqrt(n)))
    landmarks = _common.subsample_trainset(x, L, seed)
    labels, member_d = _assign(x, landmarks, _base(canonical), res)
    lst, slot, sizes, _, cap = _common.compute_list_layout(to_numpy(labels), L)
    lst_t = torch.from_numpy(lst).to(dev)
    slot_t = torch.from_numpy(slot).to(dev)
    list_vecs = torch.zeros((L, cap, d), dtype=torch.float32, device=dev)
    list_index = torch.full((L, cap), -1, dtype=torch.int32, device=dev)
    list_vecs[lst_t, slot_t] = x
    list_index[lst_t, slot_t] = torch.arange(n, dtype=torch.int32, device=dev)
    radii = torch.zeros(L, dtype=torch.float32, device=dev).scatter_reduce(
        0, labels, member_d, "amax")
    return BallCoverIndex(canonical, landmarks, list_vecs, list_index,
                          torch.from_numpy(sizes).to(dev), radii)


def _landmark_distances(index: BallCoverIndex, queries: torch.Tensor, res: Resources):
    """[q, L] internal-metric distances of the queries to the landmarks,
    in row tiles of the pairwise layer."""
    base = _base(index.metric)
    L = index.n_landmarks
    out = torch.empty((queries.shape[0], L), dtype=torch.float32, device=queries.device)
    step = res.workspace_rows(4 * L)
    for s in range(0, queries.shape[0], step):
        out[s:s + step] = distance_matrix_tile(queries[s:s + step], index.landmarks, base)
    return out


def _haversine_search(index: BallCoverIndex, queries: torch.Tensor, k: int, n_probes: int,
                      probes_fn, res: Resources):
    """Haversine kNN over the probed balls: each query tile gathers its
    balls' rows, scores them elementwise and selects (select_k, #1); tiles
    are sized so a tile's candidates fit the workspace."""
    cap = index.list_cap
    step = max(1, res.workspace_rows(_HAVERSINE_SLOT_BYTES * n_probes * cap))
    vs, is_ = [], []
    for s in range(0, queries.shape[0], step):
        qt = queries[s:s + step]
        pr = probes_fn(qt).long()
        rows = index.list_vecs[pr].reshape(qt.shape[0], n_probes * cap, 2)
        ids = index.list_index[pr].reshape(qt.shape[0], n_probes * cap)
        dist = _haversine(qt[:, None, :], rows)
        dist = torch.where(ids < 0, torch.full_like(dist, float("inf")), dist)
        v, i = select_k(dist, k, select_min=True, input_indices=ids)
        vs.append(v)
        is_.append(i)
    return torch.cat(vs), torch.cat(is_)


@traced("ball_cover.knn_query")
def knn_query(index: BallCoverIndex, queries, k: int, *, n_probes: int = 0,
              res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN by ball probing (the reference's ``knn_query``): the
    ``n_probes`` closest balls (default ``min(4 ⌊√L⌋, L)``) are searched;
    ``n_probes = L`` is exact.  Returns (distances [q, k] f32 in the index
    metric, ids [q, k] int32); runs on the index's device."""
    res = ensure(res)
    res.device  # raises without a card unless the caller asked for the CPU
    dev = index.landmarks.device
    queries = as_f32(queries, dev)
    L = index.n_landmarks
    p = min(n_probes or max(1, int(np.sqrt(L)) * 4), L)
    if k > p * index.list_cap:
        raise ValueError(f"k={k} exceeds the candidate pool n_probes*cap={p}*{index.list_cap}; "
                         "raise n_probes")
    base = _base(index.metric)

    def probes_fn(qt):
        ranked = distance_matrix_tile(qt, index.landmarks, base)
        return select_k(ranked, p, select_min=True)[1]

    if base == "haversine":
        return _haversine_search(index, queries, int(k), p, probes_fn, res)
    lists = (index.list_vecs, index.scan_norms, index.list_index)
    v, i = _common.scan_search(queries, int(k), p, "auto", index.landmarks, lists, "sqeuclidean",
                               lambda qt: qt, {"scan_scale": None}, res.workspace_limit_bytes,
                               probes_fn=probes_fn)
    v = torch.clamp(v, min=0.0)
    return (torch.sqrt(v) if index.metric == "euclidean" else v), i


def _dataset_rows(index: BallCoverIndex) -> torch.Tensor:
    """The indexed rows in dataset (id) order, rebuilt from the balls."""
    live = index.list_index >= 0
    order = torch.argsort(index.list_index[live])
    return index.list_vecs[live][order]


@traced("ball_cover.all_knn_query")
def all_knn_query(index: BallCoverIndex, k: int, *, n_probes: int = 0,
                  res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN of every indexed row, in dataset order (the reference's
    ``all_knn_query``)."""
    return knn_query(index, _dataset_rows(index), k, n_probes=n_probes, res=res)


def _ball_tiles(counts: np.ndarray, sizes: np.ndarray, d: int, elem_bytes: int, budget: int):
    """Slices of the surviving balls (ordered by their query counts,
    descending) whose padded tile [balls, most queries, largest ball] and
    gathered rows fit ``budget`` bytes (at least one ball a tile)."""
    start, n = 0, len(counts)
    while start < n:
        cq, smax, end = int(counts[start]), 0, start
        while end < n:
            s2 = max(smax, int(sizes[end]))
            ball_bytes = cq * s2 * elem_bytes + 4 * d * (cq + s2)
            if end > start and (end - start + 1) * ball_bytes > budget:
                break
            smax, end = s2, end + 1
        yield slice(start, end)
        start = end


@traced("ball_cover.eps_nn")
def eps_nn(index: BallCoverIndex, queries, eps: float, *,
           res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Epsilon-ball adjacency [q, n] bool and degrees [q] int32 by landmark
    pruning (the reference's ``eps_nn``).  ``eps`` is in the index metric:
    squared L2 for sqeuclidean, L2 for euclidean, radians for haversine.

    A ball is skipped when the triangle inequality rules it out, as
    raft_tpu's ``dist(q, landmark) - radius > eps`` (in L2, not squared
    L2), with every distance it compares widened by its rounding bound, so
    that no hit is lost to rounding.  The [q, L] skip mask comes to the
    host once.  The surviving (query, ball) pairs are grouped by ball and
    scored in tiles of balls sized by the workspace budget (one batched
    product, or the elementwise haversine, over [balls, queries, members]);
    each tile reads its candidates once, and the L2 pairs within the
    rounding bound of ``eps`` are decided again in float64."""
    res = ensure(res)
    res.device  # raises without a card unless the caller asked for the CPU
    dev = index.landmarks.device
    queries = as_f32(queries, dev)
    base = _base(index.metric)
    eps_int = float(eps) ** 2 if index.metric == "euclidean" else float(eps)
    ql = _landmark_distances(index, queries, res)
    if base == "sqeuclidean":
        bound = l2_rounding_bound(index.dim, sq_norm_max(queries), float(index.scan_norms.max()))
        reach = (torch.sqrt(torch.clamp(ql - bound, min=0.0))
                 - torch.sqrt(index.radii + bound)[None, :])
        cant = reach > np.sqrt(max(eps_int, 0.0))
    else:
        cant = ql - index.radii[None, :] > eps_int + 3 * _HAVERSINE_ERR
    lm_of, q_of = np.nonzero(~to_numpy(cant).T)     # surviving pairs, grouped by ball
    balls, first, counts = np.unique(lm_of, return_index=True, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    sizes = to_numpy(index.list_sizes)
    adj = torch.zeros((queries.shape[0], int(sizes.sum())), dtype=torch.bool, device=dev)
    elem = _HAVERSINE_SLOT_BYTES if base == "haversine" else _EPS_ELEM_BYTES
    tiles = list(_ball_tiles(counts[order], sizes[balls[order]], index.dim, elem,
                             res.workspace_limit_bytes))
    # every tile's [balls, queries] query ids (-1 padded) and ball ids, in
    # one host-to-device copy
    host = []
    for t in tiles:
        sel = order[t]
        slot = np.arange(int(counts[sel].max()))
        pair = np.minimum(first[sel][:, None] + slot[None, :], len(q_of) - 1)
        host += [np.where(slot[None, :] < counts[sel][:, None], q_of[pair], -1).ravel(),
                 balls[sel]]
    flat = torch.from_numpy(np.concatenate(host).astype(np.int64)).to(dev) if host else None
    q2 = (queries * queries).sum(dim=1)
    at = 0
    for t in tiles:
        sel = order[t]
        nb, cq, smax = len(sel), int(counts[sel].max()), int(sizes[balls[sel]].max())
        qidx = flat[at:at + nb * cq].view(nb, cq)
        bt = flat[at + nb * cq:at + nb * cq + nb]
        at += nb * cq + nb
        qv = queries[qidx.clamp(min=0)]                     # [B, cq, d]
        rows = index.list_vecs[bt, :smax]                   # [B, smax, d]
        ids = index.list_index[bt, :smax]                   # [B, smax]
        live = (qidx >= 0)[:, :, None] & (ids >= 0)[:, None, :]
        if base == "haversine":
            dist = _haversine(qv[:, :, None, :], rows[:, None, :, :])
            bi, qs, ms = torch.nonzero(live & (dist <= eps_int)).unbind(1)
            adj[qidx[bi, qs].long(), ids[bi, ms].long()] = True
            continue
        dist = torch.bmm(qv, rows.transpose(1, 2)).mul_(-2.0)
        dist.add_(q2[qidx.clamp(min=0)][:, :, None]).add_(index.scan_norms[bt, :smax][:, None, :])
        dist.clamp_(min=0.0)
        bi, qs, ms = torch.nonzero(live & (dist <= eps_int + bound)).unbind(1)
        dv = dist[bi, qs, ms]
        hit = dv <= eps_int
        near = torch.nonzero((dv - eps_int).abs() <= bound)[:, 0]
        qrow = qidx[bi, qs].long()
        hit[near] = exact_sq_le(queries, qrow[near], index.list_vecs, (bt[bi[near]], ms[near]),
                                eps_int)
        adj.index_put_((qrow, ids[bi, ms].long()), hit)
    return adj, adj.sum(dim=1, dtype=torch.int32)
