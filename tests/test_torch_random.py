"""Port parity: ``raft_tpu_torch.random`` against ``raft_tpu.random``.

A torch.Generator cannot give raft_tpu's threefry numbers, so (as raft_tpu's
own docstring sets the target) the samplers are held to distribution
parity: the same moments and ranges as raft_tpu's samplers and as the
distribution itself, within a few standard errors of 200,000 draws;
``make_blobs`` / ``make_regression`` to their construction; ``rmat`` to
theta by the quadrant frequencies of every level.  Each sampler is
reproducible from its seed."""

import os

import jax
import numpy as np
import pytest
import torch

from raft_tpu import random as jrandom
from raft_tpu_torch import random as trandom
from raft_tpu_torch.core.resources import Resources

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
N = 200_000


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# (name, kwargs, mean, variance) of the distribution itself
CASES = [
    ("uniform", dict(low=-2.0, high=3.0), 0.5, 25 / 12),
    ("normal", dict(mu=1.0, sigma=2.0), 1.0, 4.0),
    ("gumbel", dict(mu=0.5, beta=2.0), 0.5 + 2.0 * 0.5772156649, (np.pi * 2.0) ** 2 / 6),
    ("laplace", dict(mu=-1.0, scale=0.5), -1.0, 2 * 0.25),
    ("lognormal", dict(mu=0.0, sigma=0.5), np.exp(0.125), (np.exp(0.25) - 1) * np.exp(0.25)),
    ("exponential", dict(lam=2.0), 0.5, 0.25),
    ("rayleigh", dict(sigma=2.0), 2.0 * np.sqrt(np.pi / 2), (4 - np.pi) / 2 * 4.0),
]


@pytest.mark.parametrize("name,kw,mean,var", CASES)
def test_distribution_moments_match_raft_tpu_and_the_distribution(name, kw, mean, var):
    t = getattr(trandom, name)(_gen(), (N,), res=CPU, **kw).numpy().astype(np.float64)
    j = np.asarray(getattr(jrandom, name)(jax.random.PRNGKey(0), (N,), **kw), np.float64)
    se = np.sqrt(var / N)
    for x in (t, j):
        assert abs(x.mean() - mean) < 6 * se, (name, x.mean(), mean)
        assert abs(x.var() - var) < 0.05 * var, (name, x.var(), var)
    if name == "uniform":
        assert t.min() >= -2.0 and t.max() < 3.0
    if name in ("exponential", "rayleigh", "lognormal"):
        assert t.min() > 0
    again = getattr(trandom, name)(_gen(), (N,), res=CPU, **kw).numpy()
    np.testing.assert_array_equal(again, t.astype(np.float32))


def test_integer_bernoulli_permutation_and_sampling():
    u = trandom.uniform_int(_gen(), (N,), low=3, high=9, res=CPU).numpy()
    assert u.dtype == np.int32 and u.min() == 3 and u.max() == 8
    np.testing.assert_allclose(np.bincount(u - 3) / N, np.full(6, 1 / 6), atol=0.01)
    b = trandom.bernoulli(_gen(), (N,), prob=0.3, res=CPU).numpy()
    jb = np.asarray(jrandom.bernoulli(jax.random.PRNGKey(0), (N,), prob=0.3))
    assert b.dtype == np.bool_ and abs(b.mean() - 0.3) < 0.01 and abs(jb.mean() - 0.3) < 0.01
    p = trandom.permute(_gen(), 1000, res=CPU).numpy()
    np.testing.assert_array_equal(np.sort(p), np.arange(1000))
    s = trandom.sample_without_replacement(_gen(), 500, 100, res=CPU).numpy()
    assert len(np.unique(s)) == 100 and s.max() < 500
    w = np.zeros(500, np.float32)
    w[:50] = 1.0
    sw = trandom.sample_without_replacement(_gen(), 500, 50, weights=w, res=CPU).numpy()
    np.testing.assert_array_equal(np.sort(sw), np.arange(50))   # zero weight is never drawn
    jw = np.asarray(jrandom.sample_without_replacement(jax.random.PRNGKey(0), 500, 50,
                                                        weights=w))
    np.testing.assert_array_equal(np.sort(jw), np.arange(50))


def test_multi_variable_gaussian_covariance():
    mean = np.array([1.0, -2.0, 0.5], np.float32)
    a = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.4], [0.0, 0.4, 0.5]], np.float32)
    z = trandom.multi_variable_gaussian(_gen(), torch.from_numpy(mean), torch.from_numpy(a), N,
                                        res=CPU).numpy()
    j = np.asarray(jrandom.multi_variable_gaussian(jax.random.PRNGKey(0), jax.numpy.asarray(mean),
                                                   jax.numpy.asarray(a), N))
    for x in (z, j):
        np.testing.assert_allclose(x.mean(0), mean, atol=0.02)
        np.testing.assert_allclose(np.cov(x.T), a, atol=0.03)


def test_rng_state_and_resources_streams_are_reproducible():
    s1, s2 = trandom.RngState(5), trandom.RngState(5)
    a = [trandom.normal(s1.next_key(), (4,), res=CPU) for _ in range(3)]
    b = [trandom.normal(s2.next_key(), (4,), res=CPU) for _ in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    r1, r2 = Resources(device="cpu", seed=3), Resources(device="cpu", seed=3)
    assert torch.equal(trandom.normal(r1.prng_key(), (4,), res=CPU),
                       trandom.normal(r2.prng_key(), (4,), res=CPU))
    r1.reseed(3)
    assert torch.equal(trandom.normal(r1.prng_key(), (4,), res=CPU),
                       trandom.normal(Resources(device="cpu", seed=3).prng_key(), (4,), res=CPU))


def test_make_blobs_structure_matches_raft_tpu():
    x, labels, centers = trandom.make_blobs(_gen(), 20_000, 6, n_clusters=4, cluster_std=0.5,
                                            center_box=(0.0, 10.0), res=CPU)
    jx, jl, jc = jrandom.make_blobs(jax.random.PRNGKey(0), 20_000, 6, n_clusters=4,
                                    cluster_std=0.5, center_box=(0.0, 10.0))
    assert x.shape == jx.shape and labels.dtype == torch.int32 and centers.shape == jc.shape
    x, labels, centers = x.numpy(), labels.numpy(), centers.numpy()
    assert centers.min() >= 0.0 and centers.max() < 10.0
    resid = x - centers[labels]
    jres = np.asarray(jx) - np.asarray(jc)[np.asarray(jl)]
    np.testing.assert_allclose(resid.std(0), 0.5, atol=0.02)
    np.testing.assert_allclose(jres.std(0), 0.5, atol=0.02)
    np.testing.assert_allclose(np.bincount(labels) / 20_000, 0.25, atol=0.02)
    given = np.eye(3, 6, dtype=np.float32) * 5
    x2, l2, c2 = trandom.make_blobs(_gen(1), 100, 6, centers=given, shuffle=False, res=CPU)
    np.testing.assert_array_equal(c2.numpy(), given)
    assert l2.max() <= 2


def test_make_regression_is_a_linear_model():
    x, y, coef = trandom.make_regression(_gen(), 500, 12, n_informative=4, n_targets=2, bias=1.5,
                                         res=CPU)
    jx, jy, jcoef = jrandom.make_regression(jax.random.PRNGKey(0), 500, 12, n_informative=4,
                                            n_targets=2, bias=1.5)
    assert x.shape == jx.shape and y.shape == jy.shape and coef.shape == jcoef.shape
    np.testing.assert_allclose(y.numpy(), x.numpy() @ coef.numpy() + 1.5, rtol=1e-4, atol=1e-3)
    assert (coef.numpy()[4:] == 0).all() and (coef.numpy()[:4] > 0).all()
    assert coef.numpy().max() < 100


@pytest.mark.parametrize("r_scale,c_scale", [(8, 8), (6, 9)])
def test_rmat_quadrant_frequencies_follow_theta(r_scale, c_scale):
    n_edges = 100_000
    rng = np.random.default_rng(0)
    max_scale = max(r_scale, c_scale)
    theta = rng.random((max_scale, 4)).astype(np.float32) + 0.2
    e = trandom.rmat(_gen(), r_scale, c_scale, n_edges, theta=theta, res=CPU).numpy()
    je = np.asarray(jrandom.rmat(jax.random.PRNGKey(0), r_scale, c_scale, n_edges,
                                 theta=theta))
    assert e.shape == je.shape == (n_edges, 2) and e.dtype == np.int32
    assert e[:, 0].max() < 2 ** r_scale and e[:, 1].max() < 2 ** c_scale
    p = theta / theta.sum(1, keepdims=True)
    for edges in (e, je):
        for lvl in range(max_scale):
            # the bit each level set: the most significant first
            rb = (edges[:, 0] >> (r_scale - 1 - lvl)) & 1 if lvl < r_scale else None
            cb = (edges[:, 1] >> (c_scale - 1 - lvl)) & 1 if lvl < c_scale else None
            p_row = p[lvl, 2] + p[lvl, 3]
            p_col = p[lvl, 1] + p[lvl, 3]
            if rb is not None:
                assert abs(rb.mean() - p_row) < 0.01, (lvl, rb.mean(), p_row)
            if cb is not None:
                assert abs(cb.mean() - p_col) < 0.01, (lvl, cb.mean(), p_col)
            if rb is not None and cb is not None:
                q = 2 * rb + cb
                np.testing.assert_allclose(np.bincount(q, minlength=4) / n_edges, p[lvl],
                                           atol=0.01)


def test_rmat_default_theta():
    e = trandom.rmat(_gen(), 10, 10, 50_000, res=CPU).numpy()
    top = (e[:, 0] >> 9) * 2 + (e[:, 1] >> 9)
    np.testing.assert_allclose(np.bincount(top, minlength=4) / 50_000, [0.57, 0.19, 0.19, 0.05],
                               atol=0.01)
