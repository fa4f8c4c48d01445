"""Seeded synthetic datasets with a standard benchmark's geometry (copy of
``raft_tpu.bench.datasets.synthetic_geometry``: same numpy draws, so a
seed gives the same rows in both packages)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    name: str
    base: np.ndarray        # [n, d]
    queries: np.ndarray     # [q, d]
    metric: str = "sqeuclidean"


#: (rows, dim, queries, metric) of the million-scale suite
SYNTH_SHAPES = {
    "sift-128-euclidean": (1_000_000, 128, 10_000, "sqeuclidean"),
    "glove-100-inner": (1_183_514, 100, 10_000, "inner_product"),
    "deep-image-96-inner": (9_990_000, 96, 10_000, "inner_product"),
}


def synthetic_geometry(
    name: str,
    n: int,
    d: int,
    metric: str,
    *,
    scale: float = 1.0,
    n_queries: int = 0,
    default_queries: int = 10_000,
    seed: int = 0,
    clustered: bool = True,
) -> Dataset:
    """Mixture-of-gaussians (``clustered``) or uniform rows and queries.
    An explicit ``n_queries`` wins; 0 scales ``default_queries`` down with
    small n."""
    n = max(1000, int(n * scale))
    q = n_queries or min(default_queries, max(100, n // 100))
    rng = np.random.default_rng(seed)
    if clustered:
        n_clusters = max(16, int(np.sqrt(n) / 4))
        centers = rng.random((n_clusters, d), dtype=np.float32) * 10
        lab = rng.integers(0, n_clusters, n)
        base = centers[lab] + rng.normal(0, 1.0, (n, d)).astype(np.float32)
        qlab = rng.integers(0, n_clusters, q)
        queries = centers[qlab] + rng.normal(0, 1.0, (q, d)).astype(np.float32)
    else:
        base = rng.random((n, d), dtype=np.float32)
        queries = rng.random((q, d), dtype=np.float32)
    return Dataset(name=name, base=base, queries=queries, metric=metric)


def synthetic(name: str = "sift-128-euclidean", *, scale: float = 1.0,
              n_queries: int = 0, seed: int = 0, clustered: bool = True) -> Dataset:
    """A seeded stand-in with a standard dataset's geometry."""
    if name not in SYNTH_SHAPES:
        raise ValueError(f"unknown dataset {name}; have {sorted(SYNTH_SHAPES)}")
    n, d, q, metric = SYNTH_SHAPES[name]
    return synthetic_geometry(name, n, d, metric, scale=scale, n_queries=n_queries,
                              default_queries=q, seed=seed, clustered=clustered)
