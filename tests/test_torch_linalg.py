"""Port parity: ``raft_tpu_torch.ops.linalg``, the ``ops.matrix`` functions
ported in this slice (``merge_topk`` and the matrix utilities) and
``kmeans_balanced.fit_predict`` against raft_tpu's on the same seeded numpy
inputs.

Tolerances: elementwise ops, gathers, sorts and the keyed row sums (rows
added in row order, as raft_tpu's ``segment_sum``) are bitwise; matrix
products and factorizations at rtol 1e-5 / atol 1e-5 (another summation
order); factors compared up to sign through what they reconstruct."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.ops import linalg as jl
from raft_tpu.ops import matrix as jm
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.ops import linalg as tl
from raft_tpu_torch.ops import matrix as tm

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
RNG = np.random.default_rng(0)
A = RNG.standard_normal((12, 7)).astype(np.float32)
B = RNG.standard_normal((7, 5)).astype(np.float32)
T = torch.from_numpy


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy() if torch.is_tensor(t) else t, np.asarray(j))


def _close(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_blas_and_norms():
    c = RNG.standard_normal((12, 5)).astype(np.float32)
    _close(tl.gemm(T(A), T(B), alpha=2.0, beta=0.5, c=T(c)), jl.gemm(A, B, alpha=2.0, beta=0.5, c=c))
    _close(tl.gemm(T(B), T(A), trans_a=True, trans_b=True), jl.gemm(B, A, trans_a=True, trans_b=True))
    x = RNG.standard_normal(7).astype(np.float32)
    _close(tl.gemv(T(A), T(x)), jl.gemv(A, x))
    _close(tl.dot(T(x), T(x)), jl.dot(x, x))
    _eq(tl.axpy(2.0, T(x), T(x)), jl.axpy(2.0, x, x))
    _eq(tl.transpose(T(A)), jl.transpose(A))
    for nt in (tl.L1Norm, tl.L2Norm, tl.LinfNorm):
        for axis in (0, 1):
            _close(tl.norm(T(A), norm_type=nt, axis=axis), jl.norm(A, norm_type=nt, axis=axis))
    _close(tl.norm(T(A), squared=True), jl.norm(A, squared=True))
    _close(tl.row_normalize(T(A)), jl.row_normalize(A))
    _close(tl.reduce(T(A), axis=0), jl.reduce(A, axis=0))
    _close(tl.map_then_reduce(torch.abs, T(A)), jl.map_then_reduce(jnp.abs, A))
    _close(tl.map_then_reduce(torch.abs, T(A), axis=1), jl.map_then_reduce(jnp.abs, A, axis=1))
    _close(tl.mean_squared_error(T(A), T(A) * 0.5), jl.mean_squared_error(A, A * 0.5))
    _eq(tl.binary_op(T(A), T(A), torch.mul), jl.binary_op(A, A, jnp.multiply))
    _eq(tl.unary_op(T(A), torch.neg), jl.unary_op(A, jnp.negative))


@pytest.mark.parametrize("weighted", [False, True])
def test_reduce_rows_by_key_bitwise(weighted):
    m = RNG.standard_normal((300, 6)).astype(np.float32)
    keys = RNG.integers(0, 17, 300).astype(np.int32)
    w = RNG.random(300).astype(np.float32) if weighted else None
    got = tl.reduce_rows_by_key(T(m), T(keys), 20, weights=None if w is None else T(w))
    _eq(got, jl.reduce_rows_by_key(m, keys, 20, weights=w))
    keys_c = RNG.integers(0, 4, 6).astype(np.int32)
    _eq(tl.reduce_cols_by_key(T(m), T(keys_c), 4), jl.reduce_cols_by_key(m, keys_c, 4))


@pytest.mark.parametrize("weighted", [False, True])
def test_reduce_rows_by_key_few_keys_many_rows_bitwise(weighted):
    """k-means' centroid-sum shape: many rows into few keys, so each key's
    sum runs over thousands of rows (past the csr_spmm kernel's 1,024-slot
    round), one key empty, 40 columns (a warp's 32 and a partial second)."""
    rng = np.random.default_rng(11)
    m = (rng.standard_normal((12000, 40)) * 10.0 ** rng.integers(-2, 3, (12000, 1))).astype(
        np.float32)
    keys = rng.choice([0, 1, 2, 4], 12000, p=[0.5, 0.3, 0.15, 0.05]).astype(np.int32)
    w = rng.random(12000).astype(np.float32) if weighted else None
    got = tl.reduce_rows_by_key(T(m), T(keys), 5, weights=None if w is None else T(w))
    _eq(got, jl.reduce_rows_by_key(m, keys, 5, weights=w))
    assert not got[3].any()


def test_solvers():
    s = A.T @ A
    w, v = tl.eig_dc(T(s))
    jw, jv = jl.eig_dc(s)
    _close(w, jw, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((v * w) @ v.T, s, rtol=1e-4, atol=1e-4)
    q, r = tl.qr(T(A))
    np.testing.assert_allclose((q @ r).numpy(), A, atol=1e-5)
    jq = np.asarray(jl.qr_q(A))
    np.testing.assert_allclose(np.abs(tl.qr_q(T(A)).numpy()), np.abs(jq), atol=1e-5)
    u, sv, vt = tl.svd(T(A))
    _close(sv, jl.svd(A)[1])
    np.testing.assert_allclose(((u * sv) @ vt).numpy(), A, atol=1e-5)
    y = RNG.standard_normal(12).astype(np.float32)
    _close(tl.lstsq(T(A), T(y)), jl.lstsq(A, y), rtol=1e-4, atol=1e-4)
    low = (RNG.standard_normal((40, 6)) @ RNG.standard_normal((6, 30))).astype(np.float32)
    ur, sr, vr = tl.rsvd(torch.Generator().manual_seed(0), T(low), 6)
    _, jsr, _ = jl.rsvd(jax.random.PRNGKey(0), low, 6)
    _close(sr, jsr, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(((ur * sr) @ vr).numpy(), low, atol=1e-3)
    lc = np.linalg.cholesky(s + 7 * np.eye(7)).astype(np.float32)
    xc = RNG.standard_normal(7).astype(np.float32)
    _close(tl.cholesky_r1_update(T(lc), T(xc)), jl.cholesky_r1_update(lc, xc))


def test_merge_topk_keeps_the_smallest_id_on_ties():
    va = np.array([[1.0, 2.0, 2.0, np.inf]], np.float32)
    ia = np.array([[7, 9, 3, -1]], np.int32)
    vb = np.array([[2.0, 0.5, 2.0, 5.0]], np.float32)
    ib = np.array([[1, 4, 8, 2]], np.int32)
    for select_min in (True, False):
        for k in (3, 6):
            got = tm.merge_topk(T(va), T(ia), T(vb), T(ib), k, select_min=select_min)
            want = jm.merge_topk(va, ia, vb, ib, k, select_min=select_min)
            _eq(got[0], want[0])
            _eq(got[1], want[1])
    v = RNG.standard_normal((9, 40)).astype(np.float32).round(1)
    i = RNG.permutation(360).reshape(9, 40).astype(np.int32)
    got = tm.merge_topk(T(v[:, :20]), T(i[:, :20]), T(v[:, 20:]), T(i[:, 20:]), 10)
    want = jm.merge_topk(v[:, :20], i[:, :20], v[:, 20:], i[:, 20:], 10)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_matrix_utilities_match_raft_tpu():
    m = RNG.standard_normal((8, 6)).astype(np.float32)
    rows = np.array([3, 0, 7, 3], np.int32)
    mask = np.array([True, False, True, True])
    vec = RNG.standard_normal(6).astype(np.float32)
    _eq(tm.argmax(T(m)), jm.argmax(m))
    _eq(tm.argmin(T(m)), jm.argmin(m))
    _eq(tm.gather(T(m), T(rows)), jm.gather(m, rows))
    _eq(tm.gather_if(T(m), T(rows), T(mask), fill=-1.0), jm.gather_if(m, rows, mask, fill=-1.0))
    _eq(tm.scatter(T(m), T(rows[:3]), T(m[:3])), jm.scatter(jnp.asarray(m), rows[:3], m[:3]))
    _eq(tm.slice_matrix(T(m), 1, 2, 5, 6), jm.slice_matrix(m, 1, 2, 5, 6))
    for asc in (True, False):
        _eq(tm.col_wise_sort(T(m), ascending=asc), jm.col_wise_sort(m, ascending=asc))
    _eq(tm.linewise_op(T(m), T(vec), torch.add, along_rows=True),
        jm.linewise_op(m, vec, jnp.add, along_rows=True))
    _eq(tm.linewise_op(T(m), T(m[:, 0]), torch.mul, along_rows=False),
        jm.linewise_op(m, m[:, 0], jnp.multiply, along_rows=False))
    for below in (True, False):
        _eq(tm.threshold(T(m), 0.1, below=below, fill=9.0), jm.threshold(m, 0.1, below=below, fill=9.0))
    _close(tm.ratio(T(np.abs(m))), jm.ratio(np.abs(m)))
    _eq(tm.ratio(T(np.zeros((2, 2), np.float32))), jm.ratio(np.zeros((2, 2), np.float32)))
    _eq(tm.reciprocal(T(m), scalar=2.0, setzero=True, thres=0.5),
        jm.reciprocal(m, scalar=2.0, setzero=True, thres=0.5))
    _eq(tm.sign_flip(T(m)), jm.sign_flip(m))
    for upper in (True, False):
        _eq(tm.triangular(T(m), upper=upper, k=1), jm.triangular(m, upper=upper, k=1))
    _eq(tm.eye(4, 6, device="cpu"), jm.eye(4, 6))
    _eq(tm.diagonal(T(m)), jm.diagonal(m))
    _eq(tm.set_diagonal(T(m), 2.5), jm.set_diagonal(jnp.asarray(m), 2.5))
    for along in (True, False):
        _eq(tm.reverse(T(m), along_rows=along), jm.reverse(m, along_rows=along))
    s = tm.sample_rows(torch.Generator().manual_seed(0), T(m), 5).numpy()
    assert s.shape == (5, 6) and len({r.tobytes() for r in s}) == 5
    assert all(any((r == row).all() for row in m) for r in s)


def test_kmeans_balanced_fit_predict():
    x = RNG.standard_normal((600, 8)).astype(np.float32)
    params = tkb.KMeansBalancedParams(n_iters=5)
    centers, labels = tkb.fit_predict(params, x, 6, res=CPU)
    assert centers.shape == (6, 8) and labels.shape == (600,)
    assert torch.equal(labels, tkb.predict(centers, x, res=CPU))
    jc, jlab = jkb.fit_predict(jkb.KMeansBalancedParams(n_iters=5), x, 6)
    assert np.asarray(jc).shape == (6, 8) and np.asarray(jlab).shape == (600,)
