"""Gram-matrix (SVM-style) kernels over dense and CSR inputs: linear,
polynomial, tanh and RBF (counterpart of ``raft_tpu.distance.kernels``).
Dense inputs are one ``torch.matmul`` (or the sqeuclidean distance tile for
RBF) and an elementwise epilogue; CSR inputs take the inner products from
the feature-tiled sparse Gram matrix of ``sparse.distance``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from raft_tpu_torch.core.resources import Resources, as_f32, ensure
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distance.pairwise import distance_matrix_tile


@dataclass
class KernelParams:
    kernel: str = "linear"  # linear | polynomial | tanh | rbf
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0


def _is_csr(x) -> bool:
    return hasattr(x, "indptr") and hasattr(x, "indices")


def _epilogue(ip, params: KernelParams, d2=None):
    k = params.kernel
    if k == "linear":
        return ip
    if k == "polynomial":
        return (params.gamma * ip + params.coef0) ** params.degree
    if k == "tanh":
        return torch.tanh(params.gamma * ip + params.coef0)
    if k == "rbf":
        return torch.exp(-params.gamma * d2)
    raise ValueError(f"unknown kernel {k!r}")


@traced("kernels.gram_matrix")
def gram_matrix(x, y=None, params: Optional[KernelParams] = None, *,
                res: Optional[Resources] = None) -> torch.Tensor:
    """Kernel Gram matrix [n_x, n_y] of dense arrays or CSR matrices."""
    params = params or KernelParams()
    res = ensure(res)
    if _is_csr(x):
        from raft_tpu_torch.sparse.distance import _sparse_gram, row_norms_sq

        y = x if y is None else y
        if not _is_csr(y):
            raise ValueError("CSR gram requires both operands CSR")
        x, y = x.to(res.device), y.to(res.device)
        ip = _sparse_gram(x, y, res)
        if params.kernel == "rbf":
            n2x, n2y = row_norms_sq(x), row_norms_sq(y)
            d2 = torch.clamp(n2x[:, None] + n2y[None, :] - 2.0 * ip, min=0.0)
            return _epilogue(ip, params, d2)
        return _epilogue(ip, params)
    x = as_f32(x, res.device)
    y = x if y is None else as_f32(y, res.device)
    if params.kernel == "rbf":
        return _epilogue(None, params, distance_matrix_tile(x, y, "sqeuclidean"))
    return _epilogue(x @ y.T, params)
