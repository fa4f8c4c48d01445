"""Linear assignment problem (counterpart of
``raft_tpu.solver.linear_assignment``): Bertsekas' auction with
epsilon-scaling, raft_tpu's rounds op for op (each unassigned row bids for
its best column at its price plus the gap to the second best plus eps;
each column takes its best bid, the lowest row on a tie; prices rise; the
assignment restarts at each eps / 4 phase).

raft_tpu loops the rounds in ``lax.while_loop``; here the test for an
unassigned row reads the host only every ``_CHECK_EVERY`` rounds.  A round
on a finished assignment changes nothing (no row bids), so the result is
the same, and the cap of 8 n^2 + 64 rounds a phase still counts single
rounds."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import Resources, as_f32, ensure

_CHECK_EVERY = 32
_INT_MAX = 2**31 - 1


def _round(a, prices, owner, person_of, eps, ar, imax):
    n = a.shape[0]
    unassigned = person_of < 0
    vals = a - prices[None, :]
    v1, j1 = torch.max(vals, dim=1)
    masked = vals.clone()
    masked[ar, j1] = float("-inf")
    v2 = masked.amax(dim=1)
    v2 = torch.where(torch.isfinite(v2), v2, v1 - 1.0)
    bid = prices[j1] + (v1 - v2) + eps
    obj = torch.where(unassigned, j1, torch.full_like(j1, n))
    best_bid = torch.full((n + 1,), float("-inf"), dtype=a.dtype, device=a.device).scatter_reduce(
        0, obj, torch.where(unassigned, bid, torch.full_like(bid, float("-inf"))), "amax",
        include_self=True)[:n]
    is_best = unassigned & (best_bid[j1] == bid)
    winner = torch.full((n + 1,), _INT_MAX, dtype=torch.int32, device=a.device).scatter_reduce(
        0, obj, torch.where(is_best, ar.to(torch.int32), imax), "amin", include_self=True)[:n]
    took = winner < _INT_MAX
    prices = torch.where(took, best_bid, prices)
    # displaced owners lose their object, then winners take theirs (slot n
    # absorbs the objects nobody took: no host sync for a masked index)
    displaced = torch.where(took, owner, torch.full_like(owner, -1))
    po = torch.cat([person_of, person_of.new_full((1,), -1)])
    po.scatter_(0, torch.where(displaced >= 0, displaced, n).long(), -1)
    po.scatter_(0, torch.where(took, winner, n).long(),
                torch.where(took, ar.to(torch.int32), torch.full_like(winner, -1)))
    owner = torch.where(took, winner, owner)
    return prices, owner, po[:n]


def _auction(cost: torch.Tensor, maximize: bool, eps_final: float) -> torch.Tensor:
    n = cost.shape[0]
    a = cost if maximize else -cost
    scale = torch.clamp(a.abs().max(), min=1e-12)
    cap = 8 * n * n + 64
    ar = torch.arange(n, device=a.device)
    imax = torch.full((n,), _INT_MAX, dtype=torch.int32, device=a.device)
    eps_t = torch.tensor(eps_final, dtype=torch.float32)
    eps = torch.maximum(scale.cpu() / 4.0, eps_t)
    prices = torch.zeros(n, dtype=a.dtype, device=a.device)
    person_of = torch.full((n,), -1, dtype=torch.int32, device=a.device)
    while bool(eps >= eps_t):
        owner = torch.full((n,), -1, dtype=torch.int32, device=a.device)
        person_of = torch.full((n,), -1, dtype=torch.int32, device=a.device)
        eps_dev = eps.to(a.device)
        it = 0
        while it < cap and bool((person_of < 0).any()):
            for _ in range(min(_CHECK_EVERY, cap - it)):
                prices, owner, person_of = _round(a, prices, owner, person_of, eps_dev, ar, imax)
                it += 1
        eps = eps / 4.0
    return person_of


def linear_assignment(
    cost, *, maximize: bool = False, eps: float = 0.0, res: Optional[Resources] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the n x n assignment problem: (col_of_row [n] int32, total
    cost).  Optimal within n eps of the optimum (default eps: 1e-4 of the
    largest |cost| over n, at least 1e-7)."""
    res = ensure(res)
    cost = as_f32(cost, res.device)
    n, m = cost.shape
    if n != m:
        raise ValueError(f"cost matrix must be square, got {tuple(cost.shape)}")
    scale = float(cost.abs().max()) or 1.0
    eps_final = float(torch.tensor(eps or max(1e-7, 1e-4 * scale / max(n, 1)),
                                   dtype=torch.float32))
    person_of = _auction(cost, maximize, eps_final)
    if bool((person_of < 0).any()):
        raise RuntimeError(
            "auction did not converge - retry with a larger eps "
            "(accuracy/speed trade-off, Bertsekas eps-scaling)")
    total = torch.gather(cost, 1, person_of[:, None].long()).sum()
    return person_of, total
