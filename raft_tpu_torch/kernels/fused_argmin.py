"""Fused L2 1-NN assignment: ``csrc/fused_argmin.cu`` and its plain
version (counterpart of ``raft_tpu.kernels.fused_argmin``).

For each row of ``x``, the smallest partial score ``|c|^2 - 2 x.c`` over
the centers and its argmin (add |x|^2 for the true squared distance; the
ranking is the same).  x and the centers are cast to f32 first; the first
center wins a tie (overall: the lowest index among the minima, as the TPU
kernel's running argmin over its center tiles gives).  A center whose
norm is +inf never wins, as raft_tpu's padding centers.

raft_tpu routes nothing through this kernel: its k-means and
``distance.fused_nn`` assign with ``tiled_argmin`` / the distance tile,
whose score carries |x|^2 and a clamp at 0 (``max(|x|^2 + |c|^2 - 2 x.c,
0)``).  Routing this kernel there would move labels that clamp to 0 (and
ties that the |x|^2 rounding merges or splits), and with them every index
built on the labels, away from raft_tpu's.  So the port keeps the same
split: ``cluster.kmeans`` and ``distance.fused_nn`` do not call it, and it
serves callers of the public name.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch import kernels as _k
from raft_tpu_torch.kernels.toolkit import cdiv, sequential_dot
from raft_tpu_torch.ops import cost as _cost

#: score elements the plain version materializes per row block
_PLAIN_CHUNK_ELEMS = 1 << 26
#: rows and centers of a block tile of the kernel (csrc/fused_argmin.cu kTile)
_TILE = 128
#: blocks an SM holds at once (the kernel's launch bounds)
_BLOCKS_PER_SM = 2


def center_parts(n: int, n_centers: int, slots: int) -> Tuple[int, int]:
    """(parts, centers a part) of the kernel for ``n`` rows on a card that
    runs ``slots`` blocks at once: the centers cut into contiguous parts of
    whole 128-center tiles (the last part may hold fewer centers), as many
    as make the ceil(n / 128) row tiles fill whole waves
    (``kernels.wave_splits``, as fused_knn cuts its dataset)."""
    tiles = cdiv(n_centers, _TILE)
    parts = _k.wave_splits(cdiv(n, _TILE), tiles, slots, tiles)
    chunk = cdiv(tiles, parts) * _TILE
    return cdiv(n_centers, chunk), chunk


def _check(x, centers, center_sqnorms):
    if x.ndim != 2 or centers.ndim != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and centers {tuple(centers.shape)} "
                         "must be [*, d] with one d")
    if centers.shape[0] < 1:
        raise ValueError("fused_l2_argmin needs at least one center")
    if tuple(center_sqnorms.shape) != (centers.shape[0],):
        raise ValueError(f"center_sqnorms must be [{centers.shape[0]}], "
                         f"got {tuple(center_sqnorms.shape)}")


def fused_l2_argmin_torch(x: torch.Tensor, centers: torch.Tensor,
                          center_sqnorms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: score blocks of rows by ``toolkit.sequential_dot``
    (the kernel's summation order), then the first minimum of each row."""
    _check(x, centers, center_sqnorms)
    x = x.to(torch.float32)
    c = centers.to(torch.float32)
    cc = center_sqnorms.to(torch.float32)[None, :]
    step = max(1, _PLAIN_CHUNK_ELEMS // c.shape[0])
    vals = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    ids = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for s in range(0, x.shape[0], step):
        scores = cc - 2.0 * sequential_dot(x[s:s + step], c)
        # the first minimum (a row of +inf scores: id 0, the kernels'
        # initial pair)
        vals[s:s + step], ids[s:s + step] = torch.min(scores, dim=1)
    return vals, ids


def fused_l2_argmin(x: torch.Tensor, centers: torch.Tensor,
                    center_sqnorms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (partial scores [n] f32, argmin ids [n] int32) through
    ``csrc/fused_argmin.cu`` (centers cut into :func:`center_parts`); CPU
    tensors take :func:`fused_l2_argmin_torch`."""
    _check(x, centers, center_sqnorms)
    if x.device.type == "cpu":
        return fused_l2_argmin_torch(x, centers, center_sqnorms)
    xf = x.to(torch.float32).contiguous()
    c = centers.to(torch.float32).contiguous()
    cc = center_sqnorms.to(torch.float32).contiguous()
    _k.require_cuda("fused_argmin", xf, c, cc)
    n, d = xf.shape
    parts, chunk = center_parts(n, c.shape[0],
                                _BLOCKS_PER_SM * _k.sm_count(xf.device.index or 0))
    out_v = torch.empty(n, dtype=torch.float32, device=xf.device)
    out_i = torch.empty(n, dtype=torch.int32, device=xf.device)
    # each part's (min, argmin) per row, folded by the kernel's second pass
    part_v = torch.empty((n, parts) if parts > 1 else 0, dtype=torch.float32, device=xf.device)
    part_i = torch.empty((n, parts) if parts > 1 else 0, dtype=torch.int32, device=xf.device)
    _cost.note("fused_argmin", _cost.fused_argmin_cost(n, c.shape[0], d))
    lib = _k.library()
    _k.count_launch("fused_argmin")
    code = lib.rt_fused_argmin(xf.data_ptr(), c.data_ptr(), cc.data_ptr(), n, c.shape[0], d,
                               chunk, part_v.data_ptr() if parts > 1 else None,
                               part_i.data_ptr() if parts > 1 else None,
                               out_v.data_ptr(), out_i.data_ptr(), _k.stream_of(xf))
    _k.check("fused_argmin", code)
    return out_v, out_i
