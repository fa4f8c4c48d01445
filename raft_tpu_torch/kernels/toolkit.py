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


def topk_by_position(values: torch.Tensor, k: int, *, descending: bool = False,
                     signed_zeros: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (``descending``: largest) entries of each row by
    (value, position): a stable sort on value, so the lowest position wins a
    tie (``torch.topk`` leaves its tie order unspecified).  -0.0 and +0.0
    tie, as raft_tpu's Pallas select_k holds them; with ``signed_zeros``
    -0.0 ranks below +0.0, as ``lax.top_k`` orders floats (it comes first
    among the smallest, last among the largest).  Returns (values,
    positions int64)."""
    if not signed_zeros:
        v, pos = torch.sort(values, dim=-1, descending=descending, stable=True)
        return v[..., :k], pos[..., :k]
    # one stable sort of the values' bits as integers that order as the
    # floats do, -0.0 just below +0.0 (every NaN above +inf, as torch.sort
    # puts NaN last)
    v = values if values.dtype in (torch.float32, torch.float64) else values.float()
    itype = torch.int32 if v.dtype == torch.float32 else torch.int64
    bits = v.contiguous().view(itype)
    top = torch.iinfo(itype).max
    key = torch.where(bits < 0, bits ^ top, bits)
    key = torch.where(torch.isnan(v), torch.full_like(key, top), key)
    pos = torch.sort(key, dim=-1, descending=descending, stable=True).indices[..., :k]
    return torch.gather(values, -1, pos), pos


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


#: widest int8 row whose int8 x int8 dot products sum exactly in f32
#: (127^2 * d < 2^24), as the plain int8 scan sums them
MAX_I8_DIM = 1040


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as an IEEE f32 division on any device.  The divisor goes
    in as a tensor on ``a``'s device: PyTorch's CUDA kernel turns a
    division by a CPU scalar into a multiplication by its reciprocal, which
    rounds otherwise than the CUDA kernels' (and raft_tpu's) division."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_queries_i8(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of query rows [..., d] → (q_i8
    int8, scale [..., 1] f32 with a 1e-12 floor): raft_tpu's
    ``quantize_queries_i8``, rounding half to even.  The int8 scan kernels
    quantize each query the same way in shared memory."""
    sq = torch.clamp(true_div(q.abs().amax(dim=-1, keepdim=True), 127.0), min=1e-12)
    q_i8 = torch.clamp(torch.round(q / sq), -127, 127).to(torch.int8)
    return q_i8, sq


def int8_scored_ip(q: torch.Tensor, rows_i8: torch.Tensor, scan_scale: float) -> torch.Tensor:
    """q·y of f32 queries [..., M, d] against an int8 scan cache [..., N, d]
    whose values are int8 x ``scan_scale``: quantize the queries
    (:func:`quantize_queries_i8`), sum the int8 x int8 products (exact in
    f32 up to :data:`MAX_I8_DIM`), rescale by (query scale x scan_scale),
    in that order.  The one copy of raft_tpu's ``int8_scored_ip`` recipe."""
    d = q.shape[-1]
    if d > MAX_I8_DIM:
        raise ValueError(f"int8 scan of {d} dimensions: the exact f32 sum holds to {MAX_I8_DIM}")
    q_i8, sq = quantize_queries_i8(q)
    ip = sequential_dot(q_i8.to(torch.float32), rows_i8.to(torch.float32))
    return ip * (sq * torch.full((), scan_scale, dtype=torch.float32, device=q.device))


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
