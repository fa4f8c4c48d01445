"""Per-row k-selection: ``csrc/select_k.cu`` and its plain version
(counterpart of ``raft_tpu.kernels.select_k``).

Both tie disciplines of raft_tpu:

- **positional** (``stable=False``): the lowest position wins a tie;
  payload = ``input_indices`` (or the position);
- **stable** (``stable=True``): the smallest id wins a tie, negative ids
  lose every tie and surface as -1.

Rows come out sorted (ascending for ``select_min``).  Signed zeros follow
raft_tpu: positional selection holds -0.0 and +0.0 equal up to k = 128
(raft_tpu's Pallas kernel) and ranks -0.0 below +0.0 past it (raft_tpu's
``lax.top_k``); stable selection holds them equal at every k (its two-key
``lax.sort``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch import kernels as _k
from raft_tpu_torch.kernels.toolkit import topk_by_position
from raft_tpu_torch.ops import cost as _cost

#: widest row the shared-memory kernel serves (matrix.select_k's chunked
#: tournament takes wider rows)
MAX_N = 8192
#: deepest k (csrc/topk.cuh kMaxK: the port's list envelope)
MAX_K = 2048
#: deepest k of raft_tpu's Pallas select_k; past it raft_tpu's positional
#: selection is lax.top_k, which ranks -0.0 below +0.0
PALLAS_MAX_K = 128

_INT32_MAX = 2**31 - 1


def select_k_supported(n: int, k: int, dtype) -> bool:
    """Routing gate: float rows, ``0 < k <= 2048``, ``k <= n <= 8192``."""
    return (
        dtype in (torch.float32, torch.bfloat16)
        and 0 < k <= MAX_K
        and k <= n <= MAX_N
    )


def _ids_2d(input_indices: Optional[torch.Tensor], rows: int, n: int):
    if input_indices is None:
        return None
    ids = input_indices.to(torch.int32)
    if ids.ndim == 1:
        ids = ids[None, :]
    return ids.expand(rows, n)


def select_k_torch(
    scores: torch.Tensor,
    k: int,
    *,
    select_min: bool = True,
    stable: bool = False,
    input_indices: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: stable sorts on (value[, tie key], position); past
    ``PALLAS_MAX_K`` positional selection ranks -0.0 below the +0.0 of the
    (possibly negated) values."""
    rows, n = scores.shape
    v = scores.to(torch.float32)
    if not select_min:
        v = -v
    ids = _ids_2d(input_indices, rows, n)
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=scores.device).expand(rows, n)
    if stable:
        tie = torch.where(ids < 0, torch.full_like(ids, _INT32_MAX), ids)
        order = torch.sort(tie, dim=-1, stable=True).indices
        v_t = torch.gather(v, -1, order)
        vals, pos = topk_by_position(v_t, k)
        pos = torch.gather(order, -1, pos)
        out_i = torch.gather(ids, -1, pos)
        out_i = torch.where(out_i < 0, torch.full_like(out_i, -1), out_i)
    else:
        vals, pos = topk_by_position(v, k, signed_zeros=k > PALLAS_MAX_K)
        out_i = torch.gather(ids, -1, pos)
    if not select_min:
        vals = -vals
    return vals.to(scores.dtype), out_i.to(torch.int32)


def select_k_kernel(
    scores: torch.Tensor,
    k: int,
    *,
    select_min: bool = True,
    stable: bool = False,
    input_indices: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k through ``csrc/select_k.cu``; a CPU tensor takes
    :func:`select_k_torch`.  Raises outside :func:`select_k_supported`."""
    rows, n = scores.shape
    if not select_k_supported(n, k, scores.dtype):
        raise ValueError(
            f"select_k kernel unsupported shape/dtype: n={n} k={k} {scores.dtype}"
        )
    if scores.device.type == "cpu":
        return select_k_torch(
            scores, k, select_min=select_min, stable=stable,
            input_indices=input_indices,
        )
    v = scores.to(torch.float32).contiguous()
    ids, stride = None, 0
    if input_indices is not None:
        ids = input_indices.to(torch.int32)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        ids = ids.contiguous()
        if ids.ndim == 2:
            if ids.shape != (rows, n):
                raise ValueError(f"input_indices {tuple(ids.shape)} vs scores {(rows, n)}")
            stride = n
        elif ids.shape != (n,):
            raise ValueError(f"input_indices {tuple(ids.shape)} vs row length {n}")
        _k.require_cuda("select_k", v, ids)
    else:
        _k.require_cuda("select_k", v)
    out_v = torch.empty((rows, k), dtype=torch.float32, device=v.device)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=v.device)
    lib = _k.library()
    _cost.note("select_k", lambda: _cost.select_k_work(rows, n, k, with_ids=ids is not None))
    _k.count_launch("select_k")
    code = lib.rt_select_k(
        v.data_ptr(), ids.data_ptr() if ids is not None else None, stride,
        rows, n, k, int(select_min), int(stable), int(not stable and k > PALLAS_MAX_K),
        out_v.data_ptr(), out_i.data_ptr(), _k.stream_of(v),
    )
    _k.check("select_k", code)
    return out_v.to(scores.dtype), out_i
