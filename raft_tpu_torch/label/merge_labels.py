"""Merge two label arrays over a shared mask (counterpart of
``raft_tpu.label.merge_labels``): groups of ``labels_a`` are unioned with
groups of ``labels_b`` wherever both occur on masked rows, and every row
takes the least row id of its merged group.  Label propagation by segment
mins plus pointer jumping, as raft_tpu; each fixpoint test reads one bool
on the host."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import resolve_device, to_device

_INT_MAX = 2**31 - 1


def _seg_min(values, seg, n):
    out = torch.full((n + 1,), _INT_MAX, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, seg.long(), values, "amin", include_self=True)[:n]


def merge_labels(labels_a, labels_b, mask, *, res=None) -> torch.Tensor:
    """[n] int32: the least row id of each row's merged group."""
    dev = resolve_device(res, labels_a, labels_b, mask)
    a = to_device(labels_a, dev).to(torch.int32)
    b = to_device(labels_b, dev).to(torch.int32)
    mask = to_device(mask, dev).to(torch.bool)
    n = a.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=dev)

    def dense_groups(labels, live):
        """Arbitrary int labels -> dense ids in [0, n) (dead rows -> n)."""
        order = torch.argsort(torch.where(live, labels, torch.full_like(labels, _INT_MAX)),
                              stable=True)
        s = labels[order]
        first = torch.ones_like(s, dtype=torch.bool)
        first[1:] = s[1:] != s[:-1]
        gid = (torch.cumsum(first.to(torch.int32), 0) - 1).to(torch.int32)
        out = torch.zeros(n, dtype=torch.int32, device=dev)
        out[order] = gid
        return torch.where(live, out, torch.full_like(out, n))

    ga = dense_groups(a, torch.ones(n, dtype=torch.bool, device=dev))
    gb = dense_groups(b, mask)
    cur = _seg_min(rows, ga, n)[ga.long()]
    imax = torch.full_like(cur, _INT_MAX)
    while True:
        mina = _seg_min(cur, ga, n)
        minb = _seg_min(torch.where(mask, cur, imax), gb, n)
        upd = torch.minimum(mina[ga.long()],
                            torch.where(mask, minb[(gb % n).long()], cur))
        new = torch.minimum(cur, upd)
        new = torch.minimum(new, new[new.long()])
        while True:
            nn_ = new[new.long()]
            if not bool((nn_ != new).any()):
                break
            new = nn_
        if not bool((new != cur).any()):
            return new
        cur = new
