"""Lanczos eigensolver for large symmetric operators (counterpart of
``raft_tpu.ops.lanczos``).

Sweeps of m Lanczos steps with full reorthogonalization (two passes of
``w - V^T (V w)``, f32 products with TF32 off), each followed by the small
tridiagonal problem by ``torch.linalg.eigh`` on the host in f32 (m <= a
few dozen).  raft_tpu scans the steps in ``lax.scan``; here they are a
Python loop of device ops with no host sync, and the breakdown restart (an
invariant subspace found) is a ``torch.where`` on the device, as
raft_tpu's.  The caller's matvec is the only sparse work: for graphs,
``spmv_coo`` through the csr_spmm kernel, so one seed gives one result on
the card.

raft_tpu stops after one sweep and returns its Ritz pairs whether or not
they converged.  A wanted eigenvalue of multiplicity above one (the null
space of a graph with many components: a kNN graph of separated blobs) has
a single direction in any one Krylov space, so that sweep returns one null
vector and unconverged pairs for the rest (ROADMAP Q3.9).  The port keeps
the first sweep as raft_tpu's and then restarts: the wanted pairs whose
residual |A y - theta y| is within ``_TOL`` of the spectrum's scale are
locked, in order from the wanted end up to the first that has not
converged, and a new sweep from fresh random vectors runs on A deflated by
the locked vectors, until k are locked or ``_MAX_SWEEPS`` sweeps ran
(then the unconverged pairs of the last sweep fill up to k).  Where the
first sweep converges (m = n: the whole space) the result is raft_tpu's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core.resources import Resources, ensure

#: a wanted Ritz pair is locked when |A y - theta y| <= _TOL x max |theta|
_TOL = 1e-3
#: sweeps at most (each of m steps from fresh random vectors)
_MAX_SWEEPS = 32


def _lanczos_basis(matvec, v0: torch.Tensor, restarts: torch.Tensor, m: int):
    """m Lanczos steps with full reorthogonalization.

    ``restarts`` [m, n]: vectors taken when the recurrence breaks down
    (beta <= 1e-6: an invariant subspace, e.g. a disconnected graph); the
    sweep goes on in a fresh orthogonal direction with beta recorded as 0.

    Returns (V [m, n] orthonormal basis, alphas [m], betas [m-1])."""
    n = v0.shape[0]
    v0 = v0 / torch.clamp(torch.linalg.vector_norm(v0), min=1e-30)
    V = torch.zeros((m, n), dtype=v0.dtype, device=v0.device)
    v_prev = torch.zeros_like(v0)
    v_cur = v0
    beta_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
    alphas, betas = [], []
    for i in range(m):
        V[i] = v_cur
        w = matvec(v_cur)
        alpha = torch.dot(v_cur, w)
        w = w - alpha * v_cur - beta_prev * v_prev
        w = w - V.T @ (V @ w)
        w = w - V.T @ (V @ w)
        beta = torch.linalg.vector_norm(w)
        ok = beta > 1e-6
        r = restarts[i]
        r = r - V.T @ (V @ r)
        r = r / torch.clamp(torch.linalg.vector_norm(r), min=1e-30)
        v_next = torch.where(ok, w / torch.clamp(beta, min=1e-30), r)
        beta_out = torch.where(ok, beta, torch.zeros_like(beta))
        alphas.append(alpha)
        betas.append(beta_out)
        v_prev, v_cur, beta_prev = v_cur, v_next, beta_out
    return V, torch.stack(alphas), torch.stack(betas)[:-1]


def eigsh_lanczos(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    k: int,
    *,
    which: str = "smallest",
    m: int = 0,
    seed: int = 0,
    dtype=torch.float32,
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (or largest) eigenpairs of a symmetric operator:
    (eigenvalues [k] ascending, eigenvectors [n, k]).  The start vector and
    the restart vectors are normal draws of a ``torch.Generator`` seeded by
    ``seed`` on ``res``'s device (not raft_tpu's threefry draws)."""
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    m = m or min(n, max(2 * k + 8, 32))
    m = min(m, n)
    if m < k:
        raise ValueError(f"subspace size m={m} < k={k}")
    if which not in ("smallest", "largest"):
        raise ValueError(f"which must be smallest|largest, got {which}")
    dev = ensure(res).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    locked_vals, locked_vecs = [], []
    scale = 0.0
    for _ in range(_MAX_SWEEPS):
        p = len(locked_vecs)
        m_s = min(m, n - p)
        v0 = torch.randn(n, generator=gen, dtype=dtype, device=dev)
        restarts = torch.randn((m, n), generator=gen, dtype=dtype, device=dev)[:m_s]
        if p:
            q = torch.stack(locked_vecs)
            deflate = lambda v, q=q: v - q.T @ (q @ v)  # noqa: E731
            op = lambda v, deflate=deflate: deflate(matvec(v))  # noqa: E731
            v0 = deflate(v0)
            restarts = restarts - (restarts @ q.T) @ q
        else:
            op = matvec
        V, alphas, betas = _lanczos_basis(op, v0, restarts, m_s)
        T = torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)
        evals, evecs = torch.linalg.eigh(T.cpu())
        scale = max(scale, float(evals.abs().max()))
        order = range(m_s) if which == "smallest" else range(m_s - 1, -1, -1)
        cand = []
        for j in list(order)[:k - p]:
            y = V.T @ evecs[:, j].to(dev)
            y = y / torch.clamp(torch.linalg.vector_norm(y), min=1e-30)
            cand.append((evals[j], y))
        resid = [float(torch.linalg.vector_norm(op(y) - float(t) * y)) for t, y in cand]
        for (t, y), r in zip(cand, resid):
            if r > _TOL * max(scale, 1e-30):
                break
            locked_vals.append(t)
            locked_vecs.append(y)
        if len(locked_vecs) >= k or m_s >= n - p:
            break
    for t, y in cand[len(locked_vecs) - p:] if len(locked_vecs) < k else ():
        locked_vals.append(t)
        locked_vecs.append(y)
    vals = torch.stack(locked_vals)
    vecs = torch.stack(locked_vecs, dim=1)
    order = torch.argsort(vals, stable=True)
    return vals[order].to(dev), vecs[:, order.to(dev)]
