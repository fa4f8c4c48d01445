"""Refine: re-rank ANN candidates by exact distances (counterpart of
``raft_tpu.neighbors.refine``).

The device path works on query tiles: a gather of each query's candidate
rows (converted to f32 a tile at a time: an 8-bit or bf16 dataset is never
copied whole), a batched f32 dot (``torch`` ops, as raft_tpu leaves it to XLA),
then the ported select_k with the candidate ids as its payload (the
select_k kernel for CUDA tensors).  ``host=True`` is raft_tpu's numpy
path.  Negative candidate ids score +inf.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, as_f32, ensure, to_device
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import DISTANCE_TYPES
from raft_tpu_torch.neighbors._common import postprocess
from raft_tpu_torch.ops.matrix import select_k_untraced as select_k

#: bytes of the [tile, k', d] f32 candidate gather
_REFINE_TILE_BYTES = 512 * 1024 * 1024


def _refine_query_tile(q: int, kprime: int, d: int) -> int:
    tile = max(8, _REFINE_TILE_BYTES // max(1, kprime * d * 4))
    return min(q, 1 << (tile.bit_length() - 1))


def _distances(qf: torch.Tensor, cand: torch.Tensor, metric: str) -> torch.Tensor:
    """qf [q, d], cand [q, k', d] → [q, k'] distances under ``metric``
    (squared L2 for both L2 metrics)."""
    ip = torch.einsum("qd,qcd->qc", qf, cand)
    if metric == "inner_product":
        return -ip
    if metric == "cosine":
        qn = torch.clamp(torch.linalg.vector_norm(qf, dim=1), min=1e-12)
        cn = torch.clamp(torch.linalg.vector_norm(cand, dim=2), min=1e-12)
        return 1.0 - ip / (qn[:, None] * cn)
    c2 = (cand * cand).sum(dim=2)
    q2 = (qf * qf).sum(dim=1)
    return torch.clamp(q2[:, None] + c2 - 2.0 * ip, min=0.0)


@traced("refine.refine")
def refine(dataset, queries, candidates, k: int, *, metric: str = "sqeuclidean",
           host: bool = False, res: Optional[Resources] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of ``candidates`` [q, k'] → top-k (distances f32,
    indices int32)."""
    canonical = DISTANCE_TYPES[metric]
    if k > candidates.shape[1]:
        raise ValueError(f"k={k} > candidate count {candidates.shape[1]}")
    if host:
        as_np = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return _refine_host(as_np(dataset), as_np(queries),
                            as_np(candidates).astype(np.int32), k, canonical)
    dev = ensure(res).device
    x = to_device(dataset, dev)   # its own dtype: a tile of rows is converted at a time
    q = as_f32(queries, dev)
    cand = torch.as_tensor(candidates).to(device=dev, dtype=torch.int32)
    tile = _refine_query_tile(cand.shape[0], cand.shape[1], x.shape[1])
    vs, is_ = [], []
    for s in range(0, cand.shape[0], tile):
        c = cand[s:s + tile]
        rows = x[c.long().clamp(0, x.shape[0] - 1)].to(torch.float32)     # [t, k', d]
        dist = _distances(q[s:s + tile], rows, canonical)
        dist = torch.where(c < 0, torch.full_like(dist, float("inf")), dist)
        v, i = select_k(dist, k, select_min=True, input_indices=c)
        vs.append(v)
        is_.append(i)
    v = torch.cat(vs) if vs else torch.zeros((0, k), dtype=torch.float32, device=dev)
    i = torch.cat(is_) if is_ else torch.zeros((0, k), dtype=torch.int32, device=dev)
    return postprocess(v, canonical), i


def _refine_host(dataset, queries, candidates, k, metric):
    """CPU refine in numpy (raft_tpu's fallback host path): returns CPU
    tensors."""
    safe = np.clip(candidates, 0, dataset.shape[0] - 1)
    cand = dataset[safe].astype(np.float32)
    qf = queries.astype(np.float32)
    ip = np.einsum("qd,qcd->qc", qf, cand)
    if metric == "inner_product":
        dist = -ip
    elif metric == "cosine":
        qn = np.maximum(np.linalg.norm(qf, axis=1), 1e-12)
        cn = np.maximum(np.linalg.norm(cand, axis=2), 1e-12)
        dist = 1.0 - ip / (qn[:, None] * cn)
    else:
        dist = np.maximum((qf * qf).sum(1)[:, None] + (cand * cand).sum(2) - 2.0 * ip, 0.0)
    dist = np.where(candidates < 0, np.inf, dist).astype(np.float32)
    order = np.argsort(dist, axis=1, kind="stable")[:, :k]
    v = torch.from_numpy(np.take_along_axis(dist, order, axis=1))
    i = torch.from_numpy(np.take_along_axis(candidates, order, axis=1).astype(np.int32))
    return postprocess(v, metric), i
