"""Batched k-selection (counterpart of ``raft_tpu.ops.matrix`` select_k /
select_k_stable).

``select_k``'s ``auto`` routing follows raft_tpu's: rows of ``n >= 8192``
with ``4 k <= n`` take the chunked tournament; float rows inside the
kernel envelope (``kernels.select_k.select_k_supported``) take the
select_k kernel (its plain version for CPU tensors); everything else takes
a stable sort.  Every path returns the k smallest (or largest) by (value,
position): the lowest position wins a tie, as ``lax.top_k`` gives.

Signed zeros follow raft_tpu's routing too.  Where raft_tpu runs its Pallas
select_k (float rows, ``k <= 128``, ``k <= n <= 8192``, not chunked) -0.0
and +0.0 tie; everywhere else raft_tpu takes ``lax.top_k``, which ranks
-0.0 below +0.0, and so does the port (the chunked tournament, the sort
path, ``algo="topk"``, and the kernel past k = 128).  ``select_k_stable``
holds them equal at every k, as raft_tpu's two-key ``lax.sort`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import validation
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.kernels import select_k as _sk
from raft_tpu_torch.kernels.toolkit import topk_by_position

_CHUNKED_MIN_N = 8192
_CHUNK = 2048
_INT32_MAX = 2**31 - 1


def _is_int(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def _topk_max(cur: torch.Tensor, k: int):
    """Largest k by (value desc, position asc), +0.0 above -0.0 —
    lax.top_k's rule."""
    return topk_by_position(cur, k, descending=True, signed_zeros=True)


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


def mask_row_k(
    vals: torch.Tensor,
    idx: torch.Tensor,
    row_k: torch.Tensor,
    *,
    select_min: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Demote result columns past each row's own k: positions >= row_k[r]
    become (worst value, id -1) — raft_tpu's ``mask_row_k``.  The ragged
    serving path computes every row at the bucket's ``k_max`` and restores
    per-row k with this mask."""
    kk = vals.shape[-1]
    pos = torch.arange(kk, dtype=torch.int32, device=vals.device)
    row_k = torch.as_tensor(row_k).to(device=vals.device, dtype=torch.int32)
    keep = pos[None, :] < row_k.reshape(-1, 1)
    if vals.is_floating_point():
        worst = float("inf") if select_min else float("-inf")
    else:
        info = torch.iinfo(vals.dtype)
        worst = info.max if select_min else info.min
    return (torch.where(keep, vals, torch.full_like(vals, worst)),
            torch.where(keep, idx, torch.full_like(idx, -1)))


def _take_ids(input_indices, idx):
    if input_indices is None:
        return idx
    ii = input_indices
    if ii.ndim == 1:
        ii = ii[None, :]
    ii = ii.expand(idx.shape[0], ii.shape[-1])
    return torch.gather(ii.to(torch.int32), -1, idx.long())


@traced("matrix.select_k")
def select_k(
    scores: torch.Tensor,
    k: int,
    *,
    select_min: bool = True,
    input_indices: Optional[torch.Tensor] = None,
    sorted: bool = True,
    algo: str = "auto",
    row_k: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched top-k: (values [batch, k], int32 indices [batch, k]) —
    positions into the row, or gathered from ``input_indices``.  ``algo``:
    "auto", "topk" (one stable sort) or "chunked"; rows always come out
    sorted (``sorted`` is kept for interface parity).  ``row_k`` ([batch]
    int, each <= k) demotes the columns past each row's own k after the
    selection (:func:`mask_row_k`), on every route."""
    return select_k_untraced(scores, k, select_min=select_min, input_indices=input_indices,
                             algo=algo, row_k=row_k)


def select_k_untraced(
    scores: torch.Tensor,
    k: int,
    *,
    select_min: bool = True,
    input_indices: Optional[torch.Tensor] = None,
    algo: str = "auto",
    row_k: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`select_k` without its span: what the port's own modules call.
    raft_tpu calls its select_k inside jitted bodies, where the span fires
    once when the body is traced; a span on every call of a search's inner
    loops would cost host time raft_tpu does not spend."""
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
        else:
            vals, idx = topk_by_position(scores, k, descending=not select_min,
                                         signed_zeros=True)
        idx = _take_ids(input_indices, idx.to(torch.int32))
    if row_k is not None:
        vals, idx = mask_row_k(vals, idx, row_k, select_min=select_min)
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


def merge_topk(
    vals_a: torch.Tensor,
    idx_a: torch.Tensor,
    vals_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
    *,
    select_min: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-row top-k result sets into one (raft_tpu's
    ``merge_topk``): rows sorted by value, ties resolved by the smallest id
    whichever part held the candidate, so the result is a function of the
    candidate set alone; sentinel ids (-1) lose every tie."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a.to(torch.int32), idx_b.to(torch.int32)], dim=-1)
    return select_k_stable(vals, k, select_min=select_min, input_indices=idx)


def argmax(m: torch.Tensor) -> torch.Tensor:
    """Per-row argmax, int32 (the first maximum)."""
    return torch.argmax(torch.as_tensor(m), dim=-1).to(torch.int32)


def argmin(m: torch.Tensor) -> torch.Tensor:
    """Per-row argmin, int32 (the first minimum)."""
    return torch.argmin(torch.as_tensor(m), dim=-1).to(torch.int32)


def gather(m: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Row gather."""
    m = torch.as_tensor(m)
    return m[torch.as_tensor(rows, device=m.device).long()]


def gather_if(m: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, fill=0) -> torch.Tensor:
    """Conditional row gather: rows whose ``mask`` is false are ``fill``."""
    out = gather(m, rows)
    mask = torch.as_tensor(mask, device=out.device).to(torch.bool)
    return torch.where(mask[:, None], out, torch.full_like(out, fill))


def scatter(m: torch.Tensor, rows: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """A copy of ``m`` with ``updates`` written to ``rows``."""
    out = torch.as_tensor(m).clone()
    out[torch.as_tensor(rows, device=out.device).long()] = torch.as_tensor(
        updates, device=out.device).to(out.dtype)
    return out


def sample_rows(gen: torch.Generator, m: torch.Tensor, n_samples: int) -> torch.Tensor:
    """``n_samples`` rows drawn uniformly without replacement; the draw
    runs on ``gen``'s device (raft_tpu takes a threefry key here)."""
    m = torch.as_tensor(m)
    idx = torch.randperm(m.shape[0], generator=gen, device=gen.device)[:n_samples]
    return m[idx.to(m.device)]


def slice_matrix(m: torch.Tensor, row0: int, col0: int, row1: int, col1: int) -> torch.Tensor:
    """Submatrix copy."""
    return torch.as_tensor(m)[row0:row1, col0:col1].clone()


def col_wise_sort(m: torch.Tensor, *, ascending: bool = True) -> torch.Tensor:
    """Each column sorted on its own (descending: the ascending sort's rows
    reversed, as raft_tpu does)."""
    s = torch.sort(torch.as_tensor(m), dim=0).values
    return s if ascending else s.flip(0)


def linewise_op(m: torch.Tensor, vec: torch.Tensor, op, *, along_rows: bool) -> torch.Tensor:
    """``op(m, vec)`` with ``vec`` broadcast along rows ([n_cols]) or
    columns ([n_rows])."""
    m = torch.as_tensor(m)
    vec = torch.as_tensor(vec, device=m.device)
    return op(m, vec[None, :]) if along_rows else op(m, vec[:, None])


def threshold(m: torch.Tensor, value, *, below: bool = True, fill=0.0) -> torch.Tensor:
    """Entries below (or above) ``value`` replaced by ``fill``."""
    m = torch.as_tensor(m)
    mask = m < value if below else m > value
    return torch.where(mask, torch.full_like(m, fill), m)


def ratio(m: torch.Tensor) -> torch.Tensor:
    """Each element over the total (a zero total divides by 1)."""
    m = torch.as_tensor(m)
    total = m.sum()
    return m / torch.where(total == 0, torch.ones_like(total), total)


def reciprocal(m: torch.Tensor, *, scalar=1.0, setzero: bool = False,
               thres: float = 1e-15) -> torch.Tensor:
    """``scalar / m``; with ``setzero``, 0 where ``|m| <= thres``."""
    m = torch.as_tensor(m)
    out = torch.full_like(m, scalar) / m
    if setzero:
        out = torch.where(m.abs() <= thres, torch.zeros_like(out), out)
    return out


def sign_flip(m: torch.Tensor) -> torch.Tensor:
    """Each column's sign flipped so that its largest-|value| entry is
    positive (a column of zeros keeps its sign)."""
    m = torch.as_tensor(m)
    idx = torch.argmax(m.abs(), dim=0)
    signs = torch.sign(m[idx, torch.arange(m.shape[1], device=m.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return m * signs[None, :]


def triangular(m: torch.Tensor, *, upper: bool = True, k: int = 0) -> torch.Tensor:
    """Upper (or lower) triangular copy from diagonal ``k``."""
    m = torch.as_tensor(m)
    return torch.triu(m, k) if upper else torch.tril(m, k)


def eye(n: int, m: Optional[int] = None, dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Identity, or a rectangular eye of ``n`` x ``m``."""
    from raft_tpu_torch.core.resources import resolve_device

    return torch.eye(n, n if m is None else m, dtype=dtype, device=resolve_device(device))


def diagonal(m: torch.Tensor) -> torch.Tensor:
    """The main diagonal (a copy)."""
    return torch.diagonal(torch.as_tensor(m)).clone()


def set_diagonal(m: torch.Tensor, value) -> torch.Tensor:
    """A copy with the main diagonal set to ``value`` (a scalar or a
    vector)."""
    out = torch.as_tensor(m).clone()
    n = min(out.shape[0], out.shape[1])
    idx = torch.arange(n, device=out.device)
    out[idx, idx] = torch.as_tensor(value, device=out.device).to(out.dtype)
    return out


def reverse(m: torch.Tensor, *, along_rows: bool = False) -> torch.Tensor:
    """Row order reversed, or (``along_rows``) each row reversed."""
    m = torch.as_tensor(m)
    return m.flip(1) if along_rows else m.flip(0)
