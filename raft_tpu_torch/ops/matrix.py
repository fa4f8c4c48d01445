"""Batched k-selection (counterpart of ``raft_tpu.ops.matrix`` select_k /
select_k_stable).

``select_k``'s ``auto`` routing follows raft_tpu's: rows of ``n >= 8192``
with ``4 k <= n`` take the chunked tournament; float rows inside the
kernel envelope (``kernels.select_k.select_k_supported``) take the
select_k kernel (its plain version for CPU tensors); everything else takes
a stable sort.  Every path returns the k smallest (or largest) by (value,
position): the lowest position wins a tie, as ``lax.top_k`` gives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import validation
from raft_tpu_torch.kernels import select_k as _sk
from raft_tpu_torch.kernels.toolkit import topk_by_position

_CHUNKED_MIN_N = 8192
_CHUNK = 2048
_INT32_MAX = 2**31 - 1


def _is_int(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def _topk_max(cur: torch.Tensor, k: int):
    """Largest k by (value desc, position asc) — lax.top_k's rule."""
    v, pos = torch.sort(cur, dim=-1, descending=True, stable=True)
    return v[..., :k], pos[..., :k]


def _select_k_chunked(scores: torch.Tensor, k: int, select_min: bool):
    """Multi-level tournament for long rows: per-chunk top-k on
    [B, n/c, c], repeated while the pool is still wide, then a final top-k
    (raft_tpu's ``_select_k_chunked``; same winners as one stable sort)."""
    b, n = scores.shape
    c = max(_CHUNK, 4 * (1 << max(k - 1, 1).bit_length()))
    cur_v = -scores if select_min else scores
    cur_i = None
    while cur_v.shape[-1] > max(2 * c, 2 * k):
        n_cur = cur_v.shape[-1]
        n_chunks = -(-n_cur // c)
        if n_chunks * k >= n_cur:
            break
        pad = n_chunks * c - n_cur
        if pad:
            cur_v = torch.cat(
                [cur_v, torch.full((b, pad), float("-inf"), dtype=cur_v.dtype,
                                   device=cur_v.device)], dim=-1)
        v1, i1 = _topk_max(cur_v.reshape(b, n_chunks, c), k)
        base = (torch.arange(n_chunks, device=cur_v.device) * c)[None, :, None]
        flat_i = (i1 + base).reshape(b, n_chunks * k)
        if cur_i is not None:
            flat_i = torch.gather(cur_i, -1, flat_i)
        cur_v = v1.reshape(b, n_chunks * k)
        cur_i = flat_i
    v2, i2 = _topk_max(cur_v, k)
    idx = torch.gather(cur_i, -1, i2) if cur_i is not None else i2
    vals = -v2 if select_min else v2
    return vals.to(scores.dtype), idx.to(torch.int32)


def _take_ids(input_indices, idx):
    if input_indices is None:
        return idx
    ii = input_indices
    if ii.ndim == 1:
        ii = ii[None, :]
    ii = ii.expand(idx.shape[0], ii.shape[-1])
    return torch.gather(ii.to(torch.int32), -1, idx.long())


def select_k(
    scores: torch.Tensor,
    k: int,
    *,
    select_min: bool = True,
    input_indices: Optional[torch.Tensor] = None,
    sorted: bool = True,
    algo: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched top-k: (values [batch, k], int32 indices [batch, k]) —
    positions into the row, or gathered from ``input_indices``.  ``algo``:
    "auto", "topk" (one stable sort) or "chunked"; rows always come out
    sorted (``sorted`` is kept for interface parity)."""
    if algo not in ("auto", "topk", "chunked"):
        raise ValueError(f"unknown select_k algo {algo!r}")
    squeeze = scores.ndim == 1
    if squeeze:
        scores = scores[None, :]
    n = scores.shape[-1]
    if k > n:
        raise ValueError(f"k={k} larger than row length {n}")
    is_int = _is_int(scores)
    if is_int and algo == "chunked":
        raise validation.LogicError(
            "select_k algo='chunked' unsupported for integer dtypes"
        )
    if not is_int and (
        algo == "chunked"
        or (algo == "auto" and n >= _CHUNKED_MIN_N and 4 * k <= n)
    ):
        vals, idx = _select_k_chunked(scores, k, select_min)
        idx = _take_ids(input_indices, idx)
    elif not is_int and algo == "auto" and _sk.select_k_supported(n, k, scores.dtype):
        vals, idx = _sk.select_k_kernel(
            scores, k, select_min=select_min, input_indices=input_indices
        )
    else:
        if is_int:
            order = torch.argsort(scores, dim=-1, stable=True)
            if not select_min:
                order = order.flip(-1)
            idx = order[..., :k]
            vals = torch.gather(scores, -1, idx)
        elif select_min:
            vals, idx = topk_by_position(scores, k)
        else:
            vals, idx = _topk_max(scores, k)
        idx = _take_ids(input_indices, idx.to(torch.int32))
    if squeeze:
        return vals[0], idx[0]
    return vals, idx


def segment_sum(values: torch.Tensor, labels: torch.Tensor, n_segments: int, *,
                block_bytes: int = 1 << 28) -> torch.Tensor:
    """Sums of the rows of ``values`` [..., n, c] by ``labels`` [..., n]
    (int, in [0, n_segments)) → [..., n_segments, c]: raft_tpu's
    ``jax.ops.segment_sum``.  Summed in a fixed order — a one-hot matrix
    product per block of rows, the blocks added in turn — so one input
    gives one result on every run.  (``index_add_`` adds by atomics on
    CUDA, in an order that changes from run to run.)  ``block_bytes``
    bounds the f32 one-hot block."""
    batch = values.shape[:-2]
    n, c = values.shape[-2:]
    per_row = 4 * n_segments * max(1, int(torch.Size(batch).numel()))
    block = max(1, block_bytes // per_row)
    seg = torch.arange(n_segments, device=values.device)[:, None]
    out = torch.zeros(batch + (n_segments, c), dtype=values.dtype, device=values.device)
    for s in range(0, n, block):
        onehot = (labels[..., None, s:s + block] == seg).to(values.dtype)   # [..., K, b]
        out += torch.matmul(onehot, values[..., s:s + block, :])
    return out


def select_k_stable(
    scores: torch.Tensor,
    k: int,
    *,
    select_min: bool = True,
    input_indices: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tie-stable k-selection: equal scores resolve by the smallest id;
    negative ids lose every tie and surface as -1 (raft_tpu's
    ``select_k_stable``)."""
    squeeze = scores.ndim == 1
    if squeeze:
        scores = scores[None, :]
        if input_indices is not None and input_indices.ndim == 1:
            input_indices = input_indices[None, :]
    n = scores.shape[-1]
    if k > n:
        raise ValueError(f"k={k} larger than row length {n}")
    if not _is_int(scores) and _sk.select_k_supported(n, k, scores.dtype):
        vals, ids = _sk.select_k_kernel(
            scores, k, select_min=select_min, stable=True,
            input_indices=input_indices,
        )
    else:
        rows = scores.shape[0]
        if input_indices is None:
            ids = torch.arange(n, dtype=torch.int32, device=scores.device).expand(rows, n)
        else:
            ids = input_indices.to(torch.int32).expand(rows, n)
        ids_key = torch.where(ids < 0, torch.full_like(ids, _INT32_MAX), ids)
        key = scores.to(torch.int64) if _is_int(scores) else scores
        if not select_min:
            key = -key
        # (key, id) lexicographic: stable sort by id, then by key
        o1 = torch.sort(ids_key, dim=-1, stable=True).indices
        o2 = torch.sort(torch.gather(key, -1, o1), dim=-1, stable=True).indices[..., :k]
        order = torch.gather(o1, -1, o2)
        skey = torch.gather(key, -1, order)
        sids = torch.gather(ids_key, -1, order)
        ids = torch.where(sids == _INT32_MAX, torch.full_like(sids, -1), sids)
        vals = (skey if select_min else -skey).to(scores.dtype)
    if squeeze:
        return vals[0], ids[0]
    return vals, ids
