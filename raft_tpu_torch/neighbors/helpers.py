"""Public IVF list helpers: raw-list access and code pack / unpack
(counterpart of ``raft_tpu.neighbors.helpers``; the reference's
``ivf_flat_helpers.cuh``, ``ivf_pq_helpers.cuh`` and
``ivf_flat_codepacker.hpp``).

Unpacked lists come back as numpy on the host, as raft_tpu returns them;
a reconstruction stays a tensor on the index's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import to_numpy
from raft_tpu_torch.neighbors import ivf_flat as _ivf_flat
from raft_tpu_torch.neighbors import ivf_pq as _ivf_pq


def _list_rows(index, list_id: int, payload: torch.Tensor):
    size = int(index.list_sizes[list_id])
    return to_numpy(payload[list_id, :size]), to_numpy(index.list_index[list_id, :size])


def ivf_flat_unpack_list(index: "_ivf_flat.Index", list_id: int):
    """(vectors [size, dim], source ids [size]) of one list."""
    return _list_rows(index, list_id, index.list_data)


def ivf_pq_unpack_list(index: "_ivf_pq.Index", list_id: int):
    """(codes [size, pq_dim] uint8, source ids [size]) of one list: the
    codepacker's 'unpack' direction."""
    return _list_rows(index, list_id, index.list_codes)


def ivf_pq_pack_codes(codes: np.ndarray, pq_bits: int) -> np.ndarray:
    """Dense bitstream from per-byte codes: the codepacker's 'pack'
    direction (the serialization layout)."""
    return _ivf_pq._pack_bits(np.asarray(codes, np.uint8), pq_bits)


def ivf_pq_unpack_codes(packed: np.ndarray, pq_dim: int, pq_bits: int) -> np.ndarray:
    return _ivf_pq._unpack_bits(np.asarray(packed, np.uint8), pq_dim, pq_bits)


def ivf_pq_reconstruct_list(index: "_ivf_pq.Index", list_id: int) -> Tuple[torch.Tensor, np.ndarray]:
    """Approximate original-space vectors of one list (the reference's
    ``reconstruct_list_data``): the decoded rotated rows, dequantized by
    ``scan_scale`` for an int8 cache, mapped back through the orthonormal
    rotation."""
    size = int(index.list_sizes[list_id])
    y_rot = index.list_data[list_id, :size].to(torch.float32)   # [size, rot_dim]
    if index.list_data.dtype == torch.int8:
        y_rot = y_rot * index.scan_scale
    vecs = torch.matmul(y_rot, index.rotation)   # R^T maps rotated → original
    return vecs, to_numpy(index.list_index[list_id, :size])


def index_memory_footprint(index) -> dict:
    """Bytes of every tensor and ndarray attribute of an index (any kind):
    ``{attr: bytes, ..., "total": bytes}``."""
    out = {}
    for name, val in vars(index).items():
        if isinstance(val, np.ndarray):
            out[name] = int(val.nbytes)
        elif isinstance(val, torch.Tensor):
            out[name] = int(val.numel() * val.element_size())
    out["total"] = sum(out.values())
    return out
