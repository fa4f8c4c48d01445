"""Port parity: ``raft_tpu_torch.distance`` (``pairwise_distance`` over
every canonical metric, the four fused 1-NN functions) against raft_tpu's
on the same numpy inputs.  raft_tpu computes these in XLA and the port in
torch (TF32 off), so values differ by summation order only: each metric's
tolerance is stated beside it, and argmins are equal on data without
near-ties."""

import os
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import distance as jdist
from raft_tpu_torch import distance as tdist
from raft_tpu_torch.core.resources import Resources

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
# a small workspace, so that pairwise_distance and the fused 1-NN run over
# several row tiles
TILED = Resources(device="cpu", workspace_limit_bytes=4 * 40 * 37 * 8)

# metric → (data kind, rtol, atol).  Gram-term metrics cancel terms of size
# |x|^2 (~d), so their absolute tolerance is 1e-4; elementwise metrics sum
# d terms in another order (rtol 1e-5); the divergences need non-negative
# rows.
CASES = {
    "euclidean": ("normal", 1e-5, 1e-4),
    "sqeuclidean": ("normal", 1e-5, 1e-4),
    "cosine": ("normal", 1e-5, 1e-5),
    "inner_product": ("normal", 1e-5, 1e-4),
    "l1": ("normal", 1e-5, 1e-5),
    "chebyshev": ("normal", 0, 0),
    "canberra": ("normal", 1e-5, 1e-5),
    "minkowski": ("normal", 1e-5, 1e-5),
    "correlation": ("normal", 1e-5, 1e-5),
    "jaccard": ("binary", 1e-6, 1e-6),
    "hellinger": ("simplex", 1e-5, 1e-5),
    "braycurtis": ("positive", 1e-5, 1e-6),
    "jensenshannon": ("simplex", 1e-4, 1e-5),
    "hamming": ("small_int", 1e-6, 0),   # XLA takes the mean as a product by 1/d
    "kl_divergence": ("simplex", 1e-4, 1e-5),
    "russellrao": ("binary", 1e-6, 1e-6),
    "dice": ("binary", 1e-6, 1e-6),
    "haversine": ("latlon", 1e-5, 1e-6),
}


def _data(kind, m, n, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "latlon":
        a = np.stack([rng.uniform(-1.5, 1.5, m + n), rng.uniform(-3.1, 3.1, m + n)], 1)
    elif kind == "binary":
        a = (rng.random((m + n, d)) < 0.3).astype(np.float64)
    elif kind == "small_int":
        a = rng.integers(0, 3, (m + n, d)).astype(np.float64)
    elif kind == "positive":
        a = rng.random((m + n, d)) + 0.05
    elif kind == "simplex":
        a = rng.random((m + n, d))
        a[rng.random((m + n, d)) < 0.1] = 0.0      # zeros take the 0 · log branch
        a /= a.sum(1, keepdims=True)
    else:
        a = rng.standard_normal((m + n, d))
    a = a.astype(np.float32)
    return a[:m], a[m:]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_pairwise_distance_matches_raft_tpu(metric):
    kind, rtol, atol = CASES[metric]
    x, y = _data(kind, 37, 29, 24, seed=len(metric))
    kw = {"p": 3.0} if metric == "minkowski" else {}
    want = np.asarray(jdist.pairwise_distance(x, y, metric=metric, **kw))
    got = tdist.pairwise_distance(x, y, metric=metric, res=TILED, **kw)
    assert got.shape == (37, 29) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "l1"])
def test_self_distance_has_a_zero_diagonal(metric):
    x, _ = _data("normal", 40, 1, 16, seed=3)
    want = np.asarray(jdist.pairwise_distance(x, metric=metric))
    got = tdist.pairwise_distance(x, metric=metric, res=TILED)
    assert (np.diag(got.numpy()) == 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "bfloat16"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine",
                                    "correlation"])
def test_expanded_metrics_on_8bit_and_bf16_rows(dtype, metric):
    """Two 8-bit inputs take the exact integer Gram (raft_tpu: int32
    accumulation; here f32 blocks exact below 2^24, added in int64): the
    inner product is exactly equal.  bf16 rows are upcast to f32."""
    rng = np.random.default_rng(4)
    lo, hi = (0, 256) if dtype == "uint8" else (-128, 128)
    xi = rng.integers(lo, hi, (30, 300))            # d 300 > 258: two f32 blocks for uint8
    yi = rng.integers(lo, hi, (20, 300))
    if dtype == "bfloat16":
        jx, jy = jnp.asarray(xi, jnp.bfloat16), jnp.asarray(yi, jnp.bfloat16)
        tx = torch.from_numpy(xi.astype(np.float32)).to(torch.bfloat16)
        ty = torch.from_numpy(yi.astype(np.float32)).to(torch.bfloat16)
    else:
        jx, jy = xi.astype(dtype), yi.astype(dtype)
        tx, ty = torch.from_numpy(jx), torch.from_numpy(jy)
    want = np.asarray(jdist.pairwise_distance(jx, jy, metric=metric))
    got = tdist.pairwise_distance(tx, ty, metric=metric, res=CPU).numpy()
    if metric == "inner_product":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_int_gram_is_exact_past_f32():
    """uint8 rows at d 600: the Gram entries pass 2^24, where one f32 sum
    would round; the blocks keep every entry the exact integer, rounded to
    f32 once."""
    from raft_tpu_torch.distance.pairwise import distance_matrix_tile

    rng = np.random.default_rng(5)
    x = rng.integers(200, 256, (6, 600)).astype(np.uint8)
    y = rng.integers(200, 256, (5, 600)).astype(np.uint8)
    exact = (x.astype(np.int64) @ y.astype(np.int64).T).astype(np.float32)
    assert (x.astype(np.int64) @ y.astype(np.int64).T).max() > 2 ** 24
    got = distance_matrix_tile(torch.from_numpy(x), torch.from_numpy(y), "inner_product")
    np.testing.assert_array_equal(got.numpy(), exact)


def _nn_data(seed=6):
    x, y = _data("normal", 150, 40, 16, seed)
    return x, y


@pytest.mark.parametrize("sqrt", [False, True])
def test_fused_l2_nn_matches_raft_tpu(sqrt):
    x, y = _nn_data()
    wv, wi = jdist.fused_l2_nn(x, y, sqrt=sqrt)
    gv, gi = tdist.fused_l2_nn(x, y, sqrt=sqrt, res=TILED)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-4)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(tdist.fused_l2_nn_argmin(x, y, res=CPU).numpy(),
                                  np.asarray(jdist.fused_l2_nn_argmin(x, y)))


@pytest.mark.parametrize("metric", ["sqeuclidean", "l2", "cosine"])
def test_fused_distance_nn_argmin_matches_raft_tpu(metric):
    x, y = _nn_data(7)
    want = np.asarray(jdist.fused_distance_nn_argmin(x, y, metric=metric))
    got = tdist.fused_distance_nn_argmin(x, y, metric=metric, res=TILED)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="l2/sqeuclidean/cosine"):
        tdist.fused_distance_nn_argmin(x, y, metric="l1", res=CPU)


def test_masked_l2_nn_argmin_dense_and_grouped():
    """A dense [m, n] mask, and the [m, n_groups] group adjacency with
    end offsets over y's rows (a row allowed no column: +inf, id 0)."""
    x, y = _nn_data(8)
    rng = np.random.default_rng(9)
    adj = rng.random((150, 40)) < 0.4
    adj[0] = False
    wv, wi = jdist.masked_l2_nn_argmin(x, y, adj)
    gv, gi = tdist.masked_l2_nn_argmin(x, y, adj, res=TILED)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-4)
    assert np.isinf(gv[0].item()) and gi[0].item() == 0
    ends = np.array([10, 25, 40], np.int32)
    gadj = rng.random((150, 3)) < 0.5
    wv, wi = jdist.masked_l2_nn_argmin(x, y, gadj, ends)
    gv, gi = tdist.masked_l2_nn_argmin(x, y, gadj, ends, res=TILED)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-4)


def test_exports_match_raft_tpu():
    assert set(tdist.__all__) == set(jdist.__all__)
    assert tdist.DISTANCE_TYPES == jdist.DISTANCE_TYPES
