"""Cost of the slice's kernels, and the least time an H100 could take for
them.

Two families:

- ``*_work``: the work a call needs at its inputs — each input byte read
  once, each output byte written once, and the operations of the function
  itself (2·d flops per scored (query, row) pair, one comparison per
  selected-from score), counting only real rows where the data decides.
  This is what a kernel's bound is taken from.
- ``*_cost``: raft_tpu's own formulas (``raft_tpu.ops.cost``), which count
  the TPU kernels' schedule (padded list capacity, k-round selection, all
  buckets) and so over-count the work; kept for comparison.

:func:`bound_ms` turns either into the larger of bytes over the memory rate
and operations over the card's peak rate for the arithmetic the work needs
(``KernelCost.compute``): f32 FMA for f32 compute on any storage, the
dense bf16 tensor-core rate for bf16 products, the int8 rate for int8
products — whatever instructions a kernel happens to use.  Rates from
NVIDIA's H100 SXM data sheet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: H100 SXM: HBM3 rate, and dense peak operations per second by arithmetic
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_PEAK_OPS = {"float32": H100_F32_FLOPS, "bfloat16": 989e12, "int8": 1979e12}


@dataclass(frozen=True)
class KernelCost:
    flops: int
    bytes_accessed: int
    #: the arithmetic the operations need: "float32", "bfloat16" or "int8"
    compute: str = "float32"


def select_k_cost(rows: int, n: int, k: int, *, itemsize: int = 4) -> KernelCost:
    """k rounds of masked min-extraction over [rows, n]."""
    flops = 6 * rows * n * k
    bytes_accessed = rows * n * (itemsize + 8) + rows * k * (itemsize + 4)
    return KernelCost(int(flops), int(bytes_accessed))


def ivf_scan_cost(n_blocks: int, g: int, cap: int, rot: int, kk: int, *,
                  itemsize: int = 4) -> KernelCost:
    """Both scan schedules: per (block, list) a [g, cap] score tile against
    [cap, rot] rows plus the fold; ``n_blocks`` counts buckets or
    (query, probe) steps."""
    per_block = 2 * g * cap * rot + 6 * kk * (kk + cap) * g
    flops = n_blocks * per_block
    bytes_accessed = n_blocks * (
        cap * rot * itemsize + cap * 8 + g * rot * 4
    ) + n_blocks * g * kk * 8
    return KernelCost(int(flops), int(bytes_accessed))


def fused_knn_cost(n_q: int, n: int, d: int, k: int, *, itemsize: int = 4) -> KernelCost:
    """Tiled brute-force distance + running top-k."""
    flops = n_q * n * (2 * d + 6 * k)
    bytes_accessed = (
        (n_q + n) * d * itemsize
        + n * itemsize
        + n_q * k * (itemsize + 4)
    )
    return KernelCost(int(flops), int(bytes_accessed))


def select_k_work(rows: int, n: int, k: int, *, with_ids: bool = False,
                  itemsize: int = 4) -> KernelCost:
    """Row-wise top-k of [rows, n]: each score (and its id, when ids are
    passed) read once, [rows, k] values and ids written, one comparison
    per score."""
    bytes_accessed = rows * n * (itemsize + (4 if with_ids else 0)) + rows * k * 8
    return KernelCost(int(rows * n), int(bytes_accessed))


def fused_knn_work(n_q: int, n: int, d: int, k: int) -> KernelCost:
    """Brute-force kNN: 2·d flops per (query, row) pair; queries, rows and
    row norms read once, [n_q, k] values and ids written."""
    bytes_accessed = (n_q + n) * d * 4 + n * 4 + n_q * k * 8
    return KernelCost(int(n_q * n * 2 * d), int(bytes_accessed))


def scan_work(probes: torch.Tensor, list_rows: torch.Tensor, d: int,
              out_rows: int, kk: int, *, itemsize: int = 4,
              compute: str = "float32") -> KernelCost:
    """IVF list scan over the (query, probe) pairs of ``probes`` [q, p]:
    2·d operations per (pair, real row of the probed list) in ``compute``
    arithmetic; the real rows (d values of ``itemsize`` bytes, an f32 norm
    and an int32 id) of each distinct probed list read once, each query (d
    f32 and its norm) and probe id read once, ``out_rows`` x ``kk`` values
    and ids written.  ``list_rows`` [n_lists] counts each list's real
    rows."""
    probes = probes.long()
    rows = list_rows.long().to(probes.device)
    pair_rows = int(rows[probes].sum())
    list_bytes = int(rows[torch.unique(probes)].sum()) * (d * itemsize + 8)
    q, p = probes.shape
    bytes_accessed = list_bytes + q * (d + 1) * 4 + q * p * 4 + out_rows * kk * 8
    return KernelCost(int(pair_rows * 2 * d), int(bytes_accessed), compute)


def bound_ms(cost: KernelCost) -> tuple:
    """(least milliseconds on an H100, "bytes" or "operations")."""
    t_bytes = cost.bytes_accessed / H100_BYTES_PER_S * 1e3
    t_ops = cost.flops / H100_PEAK_OPS[cost.compute] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
