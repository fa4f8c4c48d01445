"""Recall (counterpart of ``raft_tpu.stats.metrics`` ``recall_at_k`` and
``neighborhood_recall``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def recall_at_k(indices, ref_indices, k: Optional[int] = None) -> float:
    """Order-insensitive set-intersection recall: the fraction of reference
    neighbors found anywhere in the served top-k.  Negative reference ids
    (padding) are left out of the denominator.  ``k`` truncates both sides
    (default: the smaller width)."""
    ids = indices.cpu().numpy() if isinstance(indices, torch.Tensor) else np.asarray(indices)
    ref = (ref_indices.cpu().numpy() if isinstance(ref_indices, torch.Tensor)
           else np.asarray(ref_indices))
    if ids.ndim != 2 or ref.ndim != 2 or ids.shape[0] != ref.shape[0]:
        raise ValueError(f"expected [rows, k] id matrices, got {ids.shape} vs {ref.shape}")
    if k is None:
        k = min(ids.shape[1], ref.shape[1])
    ids = ids[:, :k]
    ref = ref[:, :k]
    valid = ref >= 0
    if not valid.any():
        return 0.0
    match = (ids[:, :, None] == ref[:, None, :]).any(axis=1)
    return float((match & valid).sum() / valid.sum())


def neighborhood_recall(indices, ref_indices) -> float:
    """Share of the reference slots whose id appears anywhere in the same row
    of ``indices`` (raft_tpu's ``neighborhood_recall``: the mean over every
    slot of ``ref_indices``, padding included)."""
    ids = torch.as_tensor(indices)
    ref = torch.as_tensor(ref_indices).to(ids.device)
    match = (ids[:, :, None] == ref[:, None, :]).any(dim=1)
    return float(match.to(torch.float32).mean())
