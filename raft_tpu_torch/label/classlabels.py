"""Class-label utilities (counterpart of ``raft_tpu.label.classlabels``).
A tensor stays on its device; numpy input goes to ``res``'s device
(default: cuda)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import resolve_device, to_device


def get_classlabels(labels, *, res=None) -> torch.Tensor:
    """Sorted unique labels."""
    dev = resolve_device(res, labels)
    return torch.unique(to_device(labels, dev), sorted=True)


def make_monotonic(labels, *, classes=None, res=None) -> torch.Tensor:
    """Labels mapped onto 0..k-1 in sorted order of ``classes`` (default:
    the labels' own classes), int32."""
    dev = resolve_device(res, labels)
    labels = to_device(labels, dev)
    classes = get_classlabels(labels) if classes is None else to_device(classes, dev)
    return torch.searchsorted(classes.to(labels.dtype).contiguous(), labels.contiguous()).to(
        torch.int32)


def relabel(labels, old, new, *, res=None) -> torch.Tensor:
    """Each occurrence of old[i] replaced by new[i] (matched against the
    input labels, so a chain a->b, b->c does not compose)."""
    dev = resolve_device(res, labels)
    labels = to_device(labels, dev)
    out = labels.clone()
    for o, v in zip(torch.as_tensor(old).tolist(), torch.as_tensor(new).tolist()):
        out = torch.where(labels == o, torch.full_like(labels, v), out)
    return out
