"""Quantized cross-shard reductions for the sharded k-means fits
(counterpart of ``raft_tpu.comms.quantized``).

The sharded Lloyd iterations reduce one packed statistics buffer per
iteration (centroid sums | counts | inertia).  Across devices that
allreduce is the only traffic of the loop, so its byte volume sets the
collective's cost; EQuARX-style quantization (bf16, or int8 with a shared
per-column scale) shrinks it 2–4x at a bounded accuracy cost.
``RAFT_TPU_BUILD_REDUCE_DTYPE`` selects the wire dtype; the sum the caller
sees is always float32.

The rounding is raft_tpu's: bf16 partials are summed in f32, in rank
order, and rounded once to bf16 (what XLA's CPU all-reduce of a bf16
buffer gives); int8 partials take a shared per-trailing-column scale from
the max magnitude over every shard, are rounded half to even, clipped to
±127, summed exactly in int32 and scaled back.  Zero columns get scale 1.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from raft_tpu_torch.core import env as _env

REDUCE_DTYPE_ENV = "RAFT_TPU_BUILD_REDUCE_DTYPE"

#: accepted spellings → canonical wire-dtype name
_REDUCE_DTYPES = {
    "float32": "float32",
    "f32": "float32",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "int8": "int8",
}


def reduce_dtype_from_env() -> str:
    """Resolve ``RAFT_TPU_BUILD_REDUCE_DTYPE`` to a canonical name."""
    name = _env.env_str(REDUCE_DTYPE_ENV, "float32").strip().lower()
    if name not in _REDUCE_DTYPES:
        raise ValueError(
            f"{REDUCE_DTYPE_ENV}={name!r} not understood; expected one of "
            f"{sorted(set(_REDUCE_DTYPES.values()))}"
        )
    return _REDUCE_DTYPES[name]


def quantized_psum(comms, values: Sequence[torch.Tensor],
                   reduce_dtype: str = "float32") -> List[torch.Tensor]:
    """The float32 sum over ``comms``' axis of the per-shard partials
    ``values`` (a rank-ordered list, as every verb of ``Comms``), with an
    optionally quantized wire; one result a shard.

    - ``float32``: the plain allreduce (rank order).
    - ``bfloat16``: partials rounded to bf16, summed in f32, the sum
      rounded to bf16 and widened.
    - ``int8``: shared per-trailing-column scale from the max over shards
      of the local max magnitudes; quantized partials summed in int32 and
      dequantized against the shared scale.
    """
    values = [v.to(torch.float32) for v in values]
    if reduce_dtype == "float32":
        return comms.allreduce(values)
    if reduce_dtype == "bfloat16":
        wire = [v.to(torch.bfloat16).to(torch.float32) for v in values]
        return [s.to(torch.bfloat16).to(torch.float32) for s in comms.allreduce(wire)]
    if reduce_dtype == "int8":
        peaks = comms.allreduce(
            [v.abs().reshape(-1, v.shape[-1]).amax(dim=0) for v in values], op="max")
        scales = [torch.where(p > 0, p / 127.0, torch.ones_like(p)) for p in peaks]
        q = [torch.clamp(torch.round(v / s), -127, 127).to(torch.int8).to(torch.int32)
             for v, s in zip(values, scales)]
        return [t.to(torch.float32) * s for t, s in zip(comms.allreduce(q), scales)]
    raise ValueError(f"unknown reduce dtype {reduce_dtype!r}")
