"""VPQ-compressed datasets (counterpart of ``raft_tpu.neighbors.vpq_dataset``;
raft's ``vpq_dataset``): coarse vector quantisation (``vq_n_centers``
balanced-k-means centres) plus product quantisation of the residuals.

Codes are stored unpacked, as raft_tpu stores them: an int32 VQ id a row
and one byte a sub-quantiser, so a decode is two gathers and an add, row =
``vq_centers[vq_code] + concat_j pq_codebook[j, pq_code_j]`` (the first
``dim`` values): bitwise raft_tpu's decode of the same codes.  Training
uses the port's balanced k-means (the fused L2 argmin kernel on the card)
and IVF-PQ's batched Lloyd trainer; their seeds come from
``torch.Generator``, so a build does not give raft_tpu's codes (compare
through a save made by either package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.resources import Resources, as_f32, ensure
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.neighbors.ivf_pq import _train_codebooks_lloyd


@dataclass
class VpqParams:
    """raft_tpu's (raft's ``vpq_params``)."""

    vq_n_centers: int = 0      # 0 → auto (~√n, clipped)
    pq_dim: int = 0            # 0 → auto (dim / 2)
    pq_bits: int = 8
    kmeans_n_iters: int = 25
    vq_kmeans_trainset_fraction: float = 1.0
    pq_kmeans_trainset_fraction: float = 1.0
    seed: int = 0


class VpqDataset:
    """Compressed dataset: ``decode(ids)`` gives the rows back, approximately."""

    def __init__(self, vq_centers: torch.Tensor, pq_codebook: torch.Tensor,
                 vq_codes: torch.Tensor, pq_codes: torch.Tensor, dim: int):
        self.vq_centers = vq_centers    # [V, dim] f32
        self.pq_codebook = pq_codebook  # [pq_dim, 2**bits, pq_len] f32
        self.vq_codes = vq_codes        # [n] int32
        self.pq_codes = pq_codes        # [n, pq_dim] uint8
        self.dim = int(dim)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.vq_codes.shape[0], self.dim)

    @property
    def device(self) -> torch.device:
        return self.vq_codes.device

    @property
    def pq_dim(self) -> int:
        return self.pq_codes.shape[1]

    @property
    def pq_len(self) -> int:
        return self.pq_codebook.shape[2]

    def to(self, device) -> "VpqDataset":
        return VpqDataset(self.vq_centers.to(device), self.pq_codebook.to(device),
                          self.vq_codes.to(device), self.pq_codes.to(device), self.dim)

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """Decoded f32 rows [..., dim] of any id tensor (ids clipped to
        [0, n), as the dense gather clips them)."""
        n = self.vq_codes.shape[0]
        safe = ids.long().clamp(0, n - 1)
        base = self.vq_centers[self.vq_codes[safe].long()]                  # [..., dim]
        codes = self.pq_codes[safe].long()                                  # [..., pq_dim]
        j = torch.arange(self.pq_dim, device=codes.device)
        resid = self.pq_codebook[j, codes]                                  # [..., pq_dim, pq_len]
        resid = resid.reshape(resid.shape[:-2] + (self.pq_dim * self.pq_len,))
        return base + resid[..., :self.dim]


def _auto_vq_centers(n: int) -> int:
    return int(np.clip(int(np.sqrt(n)), 16, 1 << 16))


def _encode(resid: torch.Tensor, codebook: torch.Tensor, res: Resources) -> torch.Tensor:
    """The nearest codebook entry of each residual slice [n, pq_dim, pq_len]
    (first index on a tie), by row tiles: uint8 codes [n, pq_dim]."""
    n, pq_dim, _ = resid.shape
    n_codes = codebook.shape[1]
    cb2 = (codebook * codebook).sum(dim=2)                                   # [pq_dim, K]
    tile = max(1, res.workspace_rows(4 * pq_dim * n_codes * 2, cap=1 << 16))
    out = torch.empty((n, pq_dim), dtype=torch.uint8, device=resid.device)
    for s in range(0, n, tile):
        r = resid[s:s + tile].transpose(0, 1)                               # [pq_dim, t, L]
        ip = torch.bmm(r, codebook.transpose(1, 2))                         # [pq_dim, t, K]
        out[s:s + tile] = (cb2[:, None, :] - 2.0 * ip).argmin(dim=2).T.to(torch.uint8)
    return out


@traced("vpq_dataset.build")
def build(params: VpqParams, dataset, *, res: Optional[Resources] = None) -> VpqDataset:
    """Train VQ + PQ and encode the dataset (raft_tpu's ``build``: train_vq
    → train_pq → encode)."""
    res = ensure(res)
    if not (4 <= params.pq_bits <= 8):
        # codes are one byte a sub-quantiser
        raise ValueError(f"pq_bits must be in [4, 8], got {params.pq_bits}")
    x = as_f32(dataset, res.device)
    n, dim = x.shape
    V = params.vq_n_centers or _auto_vq_centers(n)
    pq_dim = params.pq_dim or max(1, dim // 2)
    pq_len = max(1, (dim + pq_dim - 1) // pq_dim)
    pad = pq_dim * pq_len - dim
    gen = torch.Generator().manual_seed(int(params.seed))

    # coarse VQ (balanced k-means, as the IVF coarse quantisers)
    n_train = min(n, max(V * 4, int(n * params.vq_kmeans_trainset_fraction)))
    train = x if n_train >= n else x[torch.randperm(n, generator=gen)[:n_train].to(x.device)]
    kb = kmeans_balanced.KMeansBalancedParams(n_iters=params.kmeans_n_iters, seed=params.seed)
    vq_centers = kmeans_balanced.fit(kb, train, V, res=res)
    vq_codes = kmeans_balanced.predict(vq_centers, x, res=res)

    # PQ of the residuals (zero-padded to pq_dim * pq_len)
    resid = x - vq_centers[vq_codes.long()]
    if pad:
        resid = torch.nn.functional.pad(resid, (0, pad))
    n_pq = min(n, max(1 << params.pq_bits, int(n * params.pq_kmeans_trainset_fraction)))
    pq_train = resid if n_pq >= n else resid[
        torch.randperm(n, generator=gen)[:n_pq].to(x.device)]
    sub = pq_train.reshape(-1, pq_dim, pq_len).transpose(0, 1).contiguous()
    codebook = _train_codebooks_lloyd(gen, sub, 1 << params.pq_bits, params.kmeans_n_iters)

    pq_codes = _encode(resid.reshape(n, pq_dim, pq_len), codebook, res)
    return VpqDataset(vq_centers, codebook, vq_codes.to(torch.int32), pq_codes, dim)


def compression_ratio(ds: VpqDataset) -> float:
    """Bytes of f32 rows over bytes of codes (codebooks excluded, as raft
    accounts its storage)."""
    n, dim = ds.shape
    return (n * dim * 4) / (n * (4 + ds.pq_dim))
