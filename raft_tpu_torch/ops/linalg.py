"""Dense linear algebra primitives (counterpart of ``raft_tpu.ops.linalg``).

Matrix products are ``torch.matmul`` (f32, TF32 off) and the solvers
``torch.linalg``.  The keyed row sums (``reduce_rows_by_key``, the k-means
centroid update) go through ``kernels.csr_spmm``: rows stably sorted by
key, each key's rows summed in row order, as raft_tpu's ``segment_sum``,
with one result on the card run after run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.kernels import csr_spmm as _csr

# ---- BLAS ------------------------------------------------------------------


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    trans_a: bool = False,
    trans_b: bool = False,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[torch.Tensor] = None,
    precision=None,
) -> torch.Tensor:
    """alpha op(A) @ op(B) + beta C (``precision`` is kept for interface
    parity: f32 products run at full precision)."""
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    out = torch.matmul(a, b)
    if alpha != 1.0:
        out = alpha * out
    if beta != 0.0 and c is not None:
        out = out + beta * c
    return out


def gemv(a: torch.Tensor, x: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    return (a.T if trans else a) @ x


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def axpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return alpha * x + y


def transpose(m: torch.Tensor) -> torch.Tensor:
    return m.T


# ---- norms / normalization -------------------------------------------------

L1Norm, L2Norm, LinfNorm = "l1", "l2", "linf"


def norm(m: torch.Tensor, *, norm_type: str = L2Norm, axis: int = 1,
         squared: bool = False) -> torch.Tensor:
    if norm_type == L1Norm:
        return m.abs().sum(dim=axis)
    if norm_type == L2Norm:
        sq = (m * m).sum(dim=axis)
        return sq if squared else torch.sqrt(sq)
    if norm_type == LinfNorm:
        return m.abs().amax(dim=axis)
    raise ValueError(f"unknown norm {norm_type}")


def row_normalize(m: torch.Tensor, *, norm_type: str = L2Norm, eps: float = 1e-12) -> torch.Tensor:
    n = norm(m, norm_type=norm_type, axis=1)
    return m / torch.clamp(n, min=eps)[:, None]


# ---- reductions --------------------------------------------------------------


def reduce(m: torch.Tensor, *, axis: int = 1, op=torch.sum) -> torch.Tensor:
    return op(m, dim=axis)


def map_then_reduce(map_op, m: torch.Tensor, *, axis: Optional[int] = None,
                    reduce_op=torch.sum) -> torch.Tensor:
    mapped = map_op(m)
    return reduce_op(mapped) if axis is None else reduce_op(mapped, dim=axis)


def mean_squared_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.mean(d * d)


def reduce_rows_by_key(
    m: torch.Tensor,
    keys: torch.Tensor,
    n_keys: int,
    *,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rows of ``m`` [n, c] summed by ``keys`` -> [n_keys, c] f32, each
    key's rows in row order (``csr_spmm`` over the stably sorted keys; a
    row's weight multiplies it first, as raft_tpu's ``m * weights``)."""
    m = m.to(torch.float32).contiguous()
    keys = torch.as_tensor(keys, device=m.device).long()
    order = torch.argsort(keys, stable=True)
    counts = torch.bincount(keys, minlength=n_keys)[:n_keys]
    indptr = torch.zeros(n_keys + 1, dtype=torch.int32, device=m.device)
    indptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    w = (torch.ones(m.shape[0], dtype=torch.float32, device=m.device) if weights is None
         else weights.to(device=m.device, dtype=torch.float32))
    return _csr.csr_spmm(indptr, order.to(torch.int32), w[order].contiguous(), m)


def reduce_cols_by_key(m: torch.Tensor, keys: torch.Tensor, n_keys: int) -> torch.Tensor:
    return reduce_rows_by_key(m.T, keys, n_keys).T


def binary_op(a: torch.Tensor, b: torch.Tensor, op) -> torch.Tensor:
    return op(a, b)


def unary_op(a: torch.Tensor, op) -> torch.Tensor:
    return op(a)


# ---- solvers ---------------------------------------------------------------


def eig_dc(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition: (eigenvalues ascending, eigenvectors as
    columns)."""
    return torch.linalg.eigh(m)


def qr_q(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(m).Q


def qr(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    q, r = torch.linalg.qr(m)
    return q, r


def svd(m: torch.Tensor, *, full_matrices: bool = False):
    u, s, vt = torch.linalg.svd(m, full_matrices=full_matrices)
    return u, s, vt


def rsvd(
    gen: torch.Generator,
    m: torch.Tensor,
    rank: int,
    *,
    n_oversamples: int = 10,
    n_iter: int = 4,
):
    """Randomized SVD: a range finder with power iterations, then a small
    exact SVD.  The test matrix is a normal draw of ``gen`` (raft_tpu takes
    a threefry key)."""
    n = m.shape[1]
    p = min(rank + n_oversamples, n)
    omega = torch.randn((n, p), generator=gen, dtype=m.dtype, device=gen.device).to(m.device)
    q = qr_q(m @ omega)
    for _ in range(n_iter):
        q = qr_q(m.T @ q)
        q = qr_q(m @ q)
    b = q.T @ m
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :rank], s[:rank], vt[:rank, :]


def lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares (minimum norm)."""
    if a.device.type == "cuda":   # torch's CUDA lstsq takes full-rank tall matrices only
        return torch.linalg.pinv(a) @ b
    return torch.linalg.lstsq(a, b).solution


def cholesky_r1_update(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """chol(L L^T + x x^T), one column at a time."""
    n = l.shape[0]
    l = l.clone()
    x = x.clone()
    idx = torch.arange(n, device=l.device)
    for j in range(n):
        ljj = l[j, j]
        xj = x[j]
        r = torch.sqrt(ljj * ljj + xj * xj)
        c = r / ljj
        s = xj / ljj
        col = l[:, j]
        mask = idx > j
        new_col = torch.where(mask, (col + s * x) / c, col)
        new_col[j] = r
        x = torch.where(mask, c * x - s * new_col, x)
        l[:, j] = new_col
    return l
