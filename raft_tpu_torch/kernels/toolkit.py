"""Small shared pieces of the kernels and their plain versions (counterpart
of ``raft_tpu.kernels.toolkit``).

The device-side running top-k every kernel shares is ``csrc/topk.cuh``;
:func:`fold_topk` is its plain PyTorch statement.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    return cdiv(x, multiple) * multiple


def topk_by_position(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row by (value, position): a stable
    sort on value, so the lowest position wins a tie (``torch.topk`` leaves
    its tie order unspecified).  Returns (values, positions int64)."""
    v, pos = torch.sort(values, dim=-1, stable=True)
    return v[..., :k], pos[..., :k]


def fold_topk(run_v: torch.Tensor, run_i: torch.Tensor, cand_v: torch.Tensor,
              cand_i: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a candidate tile into a resident top-k: the k smallest of
    [residents | candidates] by (value, pool position), residents first —
    the rule of raft_tpu's ``fold_topk``.  Ids of +inf slots are left
    unspecified (every caller masks them to -1)."""
    pool_v = torch.cat([run_v, cand_v], dim=-1)
    pool_i = torch.cat([run_i, cand_i], dim=-1)
    v, pos = topk_by_position(pool_v, k)
    return v, torch.gather(pool_i, -1, pos)


def sequential_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.mT`` for a [..., M, d] and b [..., N, d], summed in dimension
    order 0..d-1 into one f32 accumulator per entry — the order of the CUDA
    kernels' fma loop.  A library matmul sums in another order, and the
    distances built from these products (|y|^2 - 2 q.y + |q|^2, terms near
    |y|^2) would then differ from the kernels' by more than their stated
    tolerance."""
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-2])
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    for j in range(a.shape[-1]):
        acc.addcmul_(a[..., :, j, None], b[..., None, :, j])
    return acc
