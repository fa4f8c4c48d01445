"""Port parity of ``stats`` on the CPU: the recall family
(``recall_at_k``, ``tie_aware_recall_at_k``, ``rank_displacement``) equal to
raft_tpu's exactly on random, tied and padded (-1) id matrices, and every
score and summary statistic within rtol 1e-5 of raft_tpu's on the same
seeded inputs (the distance-based scores at 1e-4 absolute: both sides sum
the pairwise matrix in their own order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import stats as jstats
from raft_tpu_torch import stats as tstats
from raft_tpu_torch.core.resources import Resources

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL = 1e-5
CPU = Resources(device="cpu")


def _ids(rng, rows=40, k=10, n=30, pad=0.0):
    ids = rng.integers(0, n, (rows, k))
    if pad:
        ids[rng.random((rows, k)) < pad] = -1
    return ids.astype(np.int64)


ID_CASES = {
    "random": lambda rng: (_ids(rng), _ids(rng)),
    # few distinct ids: many repeats and ties between served and reference
    "tied": lambda rng: (_ids(rng, n=4), _ids(rng, n=4)),
    "padded": lambda rng: (_ids(rng, pad=0.2), _ids(rng, pad=0.3)),
    "all_padding": lambda rng: (_ids(rng), -np.ones((40, 10), np.int64)),
    "exact": lambda rng: (lambda a: (a, a.copy()))(np.argsort(rng.random((40, 12)), 1)),
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
@pytest.mark.parametrize("k", [None, 1, 7])
def test_recall_family_equals_raft_tpu_exactly(case, k):
    rng = np.random.default_rng(5)
    ids, ref = ID_CASES[case](rng)
    for fn in ("recall_at_k", "rank_displacement"):
        want = getattr(jstats, fn)(ids, ref, k)
        got = getattr(tstats, fn)(torch.from_numpy(ids), torch.from_numpy(ref), k)
        assert got == want, (fn, case, k, got, want)
    d = np.sort(rng.random(ids.shape).astype(np.float32), 1)
    rd = np.sort(rng.random(ids.shape).astype(np.float32), 1)
    if case == "tied":
        d = np.round(d, 1)
        rd = np.round(rd, 1)
    for eps, select_min in ((1e-4, True), (0.1, True), (1e-4, False)):
        want = jstats.tie_aware_recall_at_k(d, rd, k, eps=eps, select_min=select_min)
        got = tstats.tie_aware_recall_at_k(torch.from_numpy(d), rd, k, eps=eps,
                                           select_min=select_min)
        assert got == want, (case, k, eps, select_min)


def test_recall_family_rejects_bad_shapes():
    for fn in (tstats.recall_at_k, tstats.rank_displacement, tstats.tie_aware_recall_at_k):
        with pytest.raises(ValueError):
            fn(np.zeros((3, 4)), np.zeros((2, 4)))


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def labels():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 5, 300)
    b = np.where(rng.random(300) < 0.7, a, rng.integers(0, 5, 300))
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("fn", ["mutual_info_score", "homogeneity_score", "completeness_score",
                                "v_measure", "rand_index", "adjusted_rand_index",
                                "contingency_matrix"])
def test_clustering_scores_match(fn, labels):
    a, b = labels
    _close(getattr(tstats, fn)(torch.from_numpy(a), torch.from_numpy(b), res=CPU),
           getattr(jstats, fn)(jnp.asarray(a), jnp.asarray(b)))


def test_entropy_accuracy_kl_and_regression(labels):
    a, b = labels
    _close(tstats.entropy(torch.from_numpy(a), res=CPU), jstats.entropy(jnp.asarray(a)))
    _close(tstats.accuracy(a, b, res=CPU), jstats.accuracy(a, b))
    rng = np.random.default_rng(2)
    p = rng.random(12).astype(np.float32)
    p /= p.sum()
    q = rng.random(12).astype(np.float32)
    q /= q.sum()
    _close(tstats.kl_divergence(p, q, res=CPU), jstats.kl_divergence(p, q))
    y = rng.standard_normal(101).astype(np.float32)
    y_hat = y + 0.1 * rng.standard_normal(101).astype(np.float32)
    _close(tstats.r2_score(y, y_hat, res=CPU), jstats.r2_score(y, y_hat))
    for even in (y, y[:100]):     # odd and even lengths: the median's two forms
        got = tstats.regression_metrics(even, y_hat[:even.shape[0]], res=CPU)
        want = jstats.regression_metrics(even, y_hat[:even.shape[0]])
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key])
    for crit in ("aic", "aicc", "bic"):
        _close(tstats.information_criterion(-123.4, 7, 50, criterion=crit, res=CPU),
               jstats.information_criterion(-123.4, 7, 50, criterion=crit))
    with pytest.raises(ValueError):
        tstats.information_criterion(0.0, 1, 2, criterion="nope", res=CPU)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
def test_silhouette_and_trustworthiness_match(metric):
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((4, 6)).astype(np.float32) * 4
    lab = rng.integers(0, 4, 120)
    x = centers[lab] + rng.standard_normal((120, 6)).astype(np.float32)
    # one empty cluster id (5) and one singleton: both masked as raft_tpu does
    lab = lab.copy()
    lab[0] = 6
    _close(tstats.silhouette_score(torch.from_numpy(x), lab, 7, metric=metric, res=CPU),
           jstats.silhouette_score(x, lab, 7, metric=metric), rtol=1e-4, atol=1e-5)
    emb = x[:, :2] + 0.05 * rng.standard_normal((120, 2)).astype(np.float32)
    _close(tstats.trustworthiness(x, emb, 5, metric=metric, res=CPU),
           jstats.trustworthiness(x, emb, 5, metric=metric), rtol=1e-4, atol=1e-5)


def test_summary_statistics_match():
    rng = np.random.default_rng(6)
    m = rng.standard_normal((64, 5)).astype(np.float32) * 3 + 1
    t = torch.from_numpy(m)
    for fn, kw in (("mean", {}), ("mean", {"axis": 1}), ("mean_center", {}), ("stddev", {}),
                   ("stddev", {"sample": False}), ("cov", {}), ("cov", {"sample": False})):
        _close(getattr(tstats, fn)(t, res=CPU, **kw), getattr(jstats, fn)(jnp.asarray(m), **kw),
               rtol=1e-4, atol=1e-5)
    for got, want in zip(tstats.meanvar(t, res=CPU), jstats.meanvar(jnp.asarray(m))):
        _close(got, want, rtol=1e-4)
    for got, want in zip(tstats.minmax(t, res=CPU), jstats.minmax(jnp.asarray(m))):
        _close(got, want)
    _close(tstats.histogram(t, 8, lo=-8.0, hi=10.0, res=CPU),
           jstats.histogram(jnp.asarray(m), 8, lo=-8.0, hi=10.0))
    _close(tstats.histogram(t[:, 0], 4, lo=-5.0, hi=5.0, res=CPU),
           jstats.histogram(jnp.asarray(m[:, 0]), 4, lo=-5.0, hi=5.0))
    w = rng.random(64).astype(np.float32)
    _close(tstats.weighted_mean(t, torch.from_numpy(w), res=CPU),
           jstats.weighted_mean(jnp.asarray(m), jnp.asarray(w)), rtol=1e-4)
    _close(tstats.weighted_mean(t.T, torch.from_numpy(w), axis=1, res=CPU),
           jstats.weighted_mean(jnp.asarray(m.T), jnp.asarray(w), axis=1), rtol=1e-4)
    sizes = rng.integers(1, 50, 5).astype(np.float32)
    _close(tstats.dispersion(t[:5], torch.from_numpy(sizes), res=CPU),
           jstats.dispersion(jnp.asarray(m[:5]), jnp.asarray(sizes)), rtol=1e-4)


_X = np.random.default_rng(8).standard_normal((12, 3)).astype(np.float32)
_LAB = np.arange(12) % 3
DEFAULT_DEVICE_CALLS = {
    "accuracy": lambda: tstats.accuracy(_LAB, _LAB),
    "r2_score": lambda: tstats.r2_score(_X[:, 0], _X[:, 1]),
    "v_measure": lambda: tstats.v_measure(_LAB, _LAB[::-1].copy()),
    "adjusted_rand_index": lambda: tstats.adjusted_rand_index(_LAB, _LAB),
    "kl_divergence": lambda: tstats.kl_divergence(_X[:, 0] ** 2, _X[:, 1] ** 2),
    "silhouette_score": lambda: tstats.silhouette_score(_X, _LAB),
    "trustworthiness": lambda: tstats.trustworthiness(_X, _X[:, :2], 3),
    "information_criterion": lambda: tstats.information_criterion(-1.0, 2, 12),
    "mean": lambda: tstats.mean(_X),
    "cov": lambda: tstats.cov(_X),
    "minmax": lambda: tstats.minmax(_X)[0],
    "weighted_mean": lambda: tstats.weighted_mean(_X, np.ones(12, np.float32)),
}


@pytest.mark.parametrize("fn", sorted(DEFAULT_DEVICE_CALLS))
def test_scores_and_summaries_run_on_the_card_unless_told(fn):
    """Given numpy input and no ``res``, a score runs on ``cuda`` (the
    port's default), never quietly on the host: without a card it raises."""
    call = DEFAULT_DEVICE_CALLS[fn]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
