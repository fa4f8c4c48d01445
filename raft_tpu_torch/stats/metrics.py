"""Model metrics (counterpart of ``raft_tpu.stats.metrics``; the reference's
cpp/include/raft/stats/ — accuracy.cuh, r2_score.cuh,
regression_metrics.cuh, neighborhood_recall.cuh, silhouette_score.cuh,
adjusted_rand_index.cuh, rand_index.cuh, entropy.cuh, mutual_info_score.cuh,
completeness_score.cuh, homogeneity_score.cuh, v_measure.cuh,
contingency_matrix.cuh, kl_divergence.cuh, trustworthiness_score.cuh,
information_criterion.cuh).

The recall family (:func:`recall_at_k`, :func:`tie_aware_recall_at_k`,
:func:`rank_displacement`) runs on numpy on purpose: the quality auditor
scores with it from a background thread while traffic is served, and must
neither contend for the card nor launch on the dispatch stream.  The
scores take tensors (or arrays), move them to ``res``'s device (``cuda``
unless the caller passes ``Resources(device="cpu")``) and return a 0-d
tensor there.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, ensure, to_device
from raft_tpu_torch.distance.pairwise import distance_matrix_tile


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a, res: Optional[Resources], dtype=None) -> torch.Tensor:
    t = to_device(a if isinstance(a, torch.Tensor) else np.asarray(a), ensure(res).device)
    return t if dtype is None else t.to(dtype)


def accuracy(pred, ref, *, res: Optional[Resources] = None) -> torch.Tensor:
    return (_t(pred, res) == _t(ref, res)).to(torch.float32).mean()


def r2_score(y, y_hat, *, res: Optional[Resources] = None) -> torch.Tensor:
    y = _t(y, res, torch.float32)
    y_hat = _t(y_hat, res, torch.float32)
    ss_res = ((y - y_hat) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    return 1.0 - ss_res / ss_tot


def regression_metrics(pred, ref, *, res: Optional[Resources] = None) -> Dict[str, torch.Tensor]:
    """Mean absolute, mean squared and median absolute error
    (stats/regression_metrics.cuh)."""
    err = _t(pred, res, torch.float32) - _t(ref, res, torch.float32)
    # raft_tpu takes jnp.median: the mean of the two middle values
    return {
        "mean_abs_error": err.abs().mean(),
        "mean_squared_error": (err * err).mean(),
        "median_abs_error": err.abs().quantile(0.5),
    }


def recall_at_k(indices, ref_indices, k: Optional[int] = None) -> float:
    """Order-insensitive set-intersection recall: the fraction of reference
    neighbors found anywhere in the served top-k.  Negative reference ids
    (padding) are left out of the denominator.  ``k`` truncates both sides
    (default: the smaller width)."""
    ids = _host(indices)
    ref = _host(ref_indices)
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


def tie_aware_recall_at_k(distances, ref_distances, k: Optional[int] = None, *,
                          eps: float = 1e-4, select_min: bool = True) -> float:
    """Distance recall that forgives ties at the k-th boundary: a served
    neighbor counts when its distance is within a relative ``eps`` of the
    row's k-th reference distance (ann-benchmarks' epsilon-recall).
    ``select_min=False`` flips the comparison for similarities."""
    d = _host(distances).astype(np.float64)
    rd = _host(ref_distances).astype(np.float64)
    if d.ndim != 2 or rd.ndim != 2 or d.shape[0] != rd.shape[0]:
        raise ValueError(f"expected [rows, k] distance matrices, got {d.shape} vs {rd.shape}")
    if k is None:
        k = min(d.shape[1], rd.shape[1])
    d = d[:, :k]
    thresh = rd[:, k - 1:k]
    tol = eps * np.maximum(np.abs(thresh), 1.0)
    ok = d <= thresh + tol if select_min else d >= thresh - tol
    return float(ok.mean())


def rank_displacement(indices, ref_indices, k: Optional[int] = None) -> float:
    """Mean |served rank - true rank| of the reference neighbors: recall
    sees whether a true neighbor appears, this sees where.  A reference
    neighbor missing from the served list costs ``k``; negative reference
    ids are left out.  0.0 is perfect."""
    ids = _host(indices)
    ref = _host(ref_indices)
    if ids.ndim != 2 or ref.ndim != 2 or ids.shape[0] != ref.shape[0]:
        raise ValueError(f"expected [rows, k] id matrices, got {ids.shape} vs {ref.shape}")
    if k is None:
        k = min(ids.shape[1], ref.shape[1])
    ids = ids[:, :k]
    ref = ref[:, :k]
    eq = ids[:, :, None] == ref[:, None, :]        # [rows, k_served, k_ref]
    pos = np.argmax(eq, axis=1)                    # first match (0 if none)
    found = eq.any(axis=1)
    disp = np.where(found, np.abs(pos - np.arange(k)[None, :]), k)
    valid = ref >= 0
    if not valid.any():
        return 0.0
    return float(disp[valid].mean())


def neighborhood_recall(indices, ref_indices) -> float:
    """Share of the reference slots whose id appears anywhere in the same row
    of ``indices`` (raft_tpu's ``neighborhood_recall``: the mean over every
    slot of ``ref_indices``, padding included)."""
    ids = torch.as_tensor(indices)
    ref = torch.as_tensor(ref_indices).to(ids.device)
    match = (ids[:, :, None] == ref[:, None, :]).any(dim=1)
    return float(match.to(torch.float32).mean())


def contingency_matrix(a, b, n_classes: Optional[int] = None, *,
                       res: Optional[Resources] = None) -> torch.Tensor:
    """[n_classes, n_classes] int32 pair counts (stats/contingency_matrix.cuh)."""
    a = _t(a, res, torch.int64)
    b = _t(b, res, torch.int64)
    if n_classes is None:
        n_classes = int(max(int(a.max()), int(b.max())) + 1)
    counts = torch.bincount(a * n_classes + b, minlength=n_classes * n_classes)
    return counts.to(torch.int32).reshape(n_classes, n_classes)


def _xlogx_ratio(p: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """sum of p log(ratio) over p > 0, logs floored at 1e-30 (raft_tpu's)."""
    terms = p * torch.log(torch.clamp(ratio, min=1e-30))
    return torch.where(p > 0, terms, torch.zeros_like(terms)).sum()


def entropy(labels, n_classes: Optional[int] = None, *, res: Optional[Resources] = None) -> torch.Tensor:
    labels = _t(labels, res, torch.int64)
    if n_classes is None:
        n_classes = int(labels.max()) + 1
    counts = torch.bincount(labels, minlength=n_classes).to(torch.float32)
    p = counts / labels.shape[0]
    return -_xlogx_ratio(p, p)


def mutual_info_score(a, b, n_classes: Optional[int] = None, *,
                      res: Optional[Resources] = None) -> torch.Tensor:
    cm = contingency_matrix(a, b, n_classes, res=res).to(torch.float32)
    pij = cm / cm.sum()
    pi = pij.sum(dim=1, keepdim=True)
    pj = pij.sum(dim=0, keepdim=True)
    return _xlogx_ratio(pij, pij / torch.clamp(pi * pj, min=1e-30))


def homogeneity_score(truth, pred, n_classes: Optional[int] = None, *,
                      res: Optional[Resources] = None) -> torch.Tensor:
    mi = mutual_info_score(truth, pred, n_classes, res=res)
    h = entropy(truth, n_classes, res=res)
    return torch.where(h > 0, mi / torch.clamp(h, min=1e-30), torch.ones_like(h))


def completeness_score(truth, pred, n_classes: Optional[int] = None, *,
                       res: Optional[Resources] = None) -> torch.Tensor:
    return homogeneity_score(pred, truth, n_classes, res=res)


def v_measure(truth, pred, n_classes: Optional[int] = None, beta: float = 1.0, *,
              res: Optional[Resources] = None) -> torch.Tensor:
    h = homogeneity_score(truth, pred, n_classes, res=res)
    c = completeness_score(truth, pred, n_classes, res=res)
    denom = beta * h + c
    return torch.where(denom > 0, (1 + beta) * h * c / torch.clamp(denom, min=1e-30),
                       torch.zeros_like(denom))


def _pair_sums(a, b, n_classes, res):
    """(sum_ij, sum_i, sum_j, comb(n)) of the contingency matrix's pairs."""
    cm = contingency_matrix(a, b, n_classes, res=res).to(torch.float32)

    def comb(x):
        return x * (x - 1) / 2

    return (comb(cm).sum(), comb(cm.sum(dim=1)).sum(), comb(cm.sum(dim=0)).sum(),
            comb(cm.sum()))


def rand_index(a, b, n_classes: Optional[int] = None, *, res: Optional[Resources] = None) -> torch.Tensor:
    sum_ij, sum_i, sum_j, total = _pair_sums(a, b, n_classes, res)
    return (total + 2 * sum_ij - sum_i - sum_j) / total


def adjusted_rand_index(a, b, n_classes: Optional[int] = None, *,
                        res: Optional[Resources] = None) -> torch.Tensor:
    sum_ij, sum_i, sum_j, total = _pair_sums(a, b, n_classes, res)
    expected = sum_i * sum_j / torch.clamp(total, min=1e-30)
    max_idx = 0.5 * (sum_i + sum_j)
    return (sum_ij - expected) / torch.clamp(max_idx - expected, min=1e-30)


def kl_divergence(p, q, *, res: Optional[Resources] = None) -> torch.Tensor:
    p = _t(p, res, torch.float32)
    q = _t(q, res, torch.float32)
    return _xlogx_ratio(p, torch.clamp(p, min=1e-30) / torch.clamp(q, min=1e-30))


def silhouette_score(x, labels, n_clusters: Optional[int] = None, *,
                     metric: str = "euclidean", res: Optional[Resources] = None) -> torch.Tensor:
    """Mean silhouette coefficient (stats/silhouette_score.cuh) over the
    port's distance tile."""
    x = _t(x, res, torch.float32)
    labels = _t(labels, res, torch.int64)
    if n_clusters is None:
        n_clusters = int(labels.max()) + 1
    d = distance_matrix_tile(x, x, metric)
    onehot = torch.nn.functional.one_hot(labels, n_clusters).to(torch.float32)   # [n, k]
    counts = onehot.sum(dim=0)
    sums = d @ onehot                              # per-point distance to each cluster
    same = sums.gather(1, labels[:, None])[:, 0]
    own_count = counts[labels]
    zero = torch.zeros_like(same)
    a = torch.where(own_count > 1, same / torch.clamp(own_count - 1, min=1), zero)
    mean_other = sums / torch.clamp(counts[None, :], min=1)
    # mask the own cluster and empty clusters (whose mean would read as 0)
    mean_other = mean_other.masked_fill(onehot.bool() | (counts[None, :] == 0), float("inf"))
    b = mean_other.min(dim=1).values
    s = torch.where(own_count > 1, (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30), zero)
    return s.mean()


def trustworthiness(x, x_embedded, n_neighbors: int, *,
                    metric: str = "euclidean", res: Optional[Resources] = None) -> torch.Tensor:
    """Trustworthiness of an embedding (stats/trustworthiness_score.cuh)."""
    x = _t(x, res, torch.float32)
    e = _t(x_embedded, res, torch.float32)
    n = x.shape[0]
    diag = torch.arange(n, device=x.device)
    d_orig = distance_matrix_tile(x, x, metric)
    d_orig[diag, diag] = float("inf")
    d_emb = distance_matrix_tile(e, e, metric)
    d_emb[diag, diag] = float("inf")
    rank_orig = torch.argsort(torch.argsort(d_orig, dim=1, stable=True), dim=1, stable=True)
    nn_emb = torch.argsort(d_emb, dim=1, stable=True)[:, :n_neighbors]
    r = rank_orig.gather(1, nn_emb)                # ranks in the original space
    penalty = torch.clamp(r - n_neighbors + 1, min=0).sum().to(torch.float32)
    norm = 2.0 / (n * n_neighbors * (2 * n - 3 * n_neighbors - 1))
    return 1.0 - norm * penalty


def information_criterion(log_likelihood, n_params: int, n_samples: int, *,
                          criterion: str = "aic", res: Optional[Resources] = None) -> torch.Tensor:
    """AIC / AICc / BIC (stats/information_criterion.cuh)."""
    ll = _t(log_likelihood, res, torch.float32)
    if criterion == "aic":
        return -2.0 * ll + 2.0 * n_params
    if criterion == "aicc":
        return -2.0 * ll + 2.0 * n_params + (2.0 * n_params * (n_params + 1)) / max(
            n_samples - n_params - 1, 1)
    if criterion == "bic":
        return -2.0 * ll + n_params * float(np.log(float(n_samples)))
    raise ValueError(criterion)
