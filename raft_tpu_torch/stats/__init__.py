"""Statistics: summary stats and model metrics (counterpart of
``raft_tpu.stats``; the reference's cpp/include/raft/stats/)."""

from raft_tpu_torch.stats.metrics import (
    accuracy,
    adjusted_rand_index,
    completeness_score,
    contingency_matrix,
    entropy,
    homogeneity_score,
    information_criterion,
    kl_divergence,
    mutual_info_score,
    neighborhood_recall,
    r2_score,
    rand_index,
    rank_displacement,
    recall_at_k,
    regression_metrics,
    silhouette_score,
    tie_aware_recall_at_k,
    trustworthiness,
    v_measure,
)
from raft_tpu_torch.stats.summary import (
    cov,
    dispersion,
    histogram,
    mean,
    mean_center,
    meanvar,
    minmax,
    stddev,
    weighted_mean,
)

__all__ = [
    "mean", "mean_center", "meanvar", "stddev", "minmax", "cov", "histogram",
    "weighted_mean", "dispersion", "accuracy", "r2_score", "regression_metrics",
    "recall_at_k", "tie_aware_recall_at_k", "rank_displacement", "neighborhood_recall",
    "silhouette_score", "adjusted_rand_index", "rand_index", "entropy", "mutual_info_score",
    "completeness_score", "homogeneity_score", "v_measure", "contingency_matrix",
    "kl_divergence", "trustworthiness", "information_criterion",
]
