"""Port parity: ``raft_tpu_torch.sparse`` against ``raft_tpu.sparse`` on the
same seeded numpy inputs, case by case after raft_tpu's
``tests/test_sparse.py``.

Tolerances: the sum lanes (SpMV / SpMM, weighted degree, row norms,
duplicate sums, densify) add each row's terms in slot order with one
product rounding each, as raft_tpu's ``segment_sum`` does on the CPU, and
are held bitwise; reductions whose order XLA picks (sddmm's dot products,
the Gram matrix's matmul) at rtol 1e-6 / atol 1e-6; structure (indptr,
indices, nnz, orders) exactly."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from raft_tpu import sparse as js
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.distance.kernels import KernelParams as JKP
from raft_tpu.distance.kernels import gram_matrix as jgram
from raft_tpu_torch import kernels
from raft_tpu_torch import sparse as ts
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.distance.kernels import KernelParams as TKP
from raft_tpu_torch.distance.kernels import gram_matrix as tgram
from raft_tpu_torch.kernels import csr_spmm as csr_k

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
RTOL = ATOL = 1e-6


def _rand_sp(n, m, density=0.2, seed=0):
    mat = sp.random(n, m, density=density, random_state=seed, dtype=np.float64)
    return np.asarray(mat.todense(), np.float32)


def _np(t):
    return np.asarray(t)


def _pair_csr(d):
    return js.CSR.from_dense(d), ts.CSR.from_dense(d, device="cpu")


def _pair_coo(rows, cols, data, shape, nnz=None):
    return (js.COO(rows, cols, data, shape, nnz),
            ts.COO(rows, cols, data, shape, nnz, device="cpu"))


def _same_coo(a, b):
    assert a.nnz == b.nnz and a.shape == b.shape
    for x, y in ((a.rows, b.rows), (a.cols, b.cols), (a.data, b.data)):
        np.testing.assert_array_equal(_np(x), y.numpy())


def _dup_coo(n=30, slots=400, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, slots).astype(np.int32), rng.integers(0, n, slots).astype(np.int32),
            rng.standard_normal(slots).astype(np.float32), (n, n))


def test_formats_roundtrip_and_conversions():
    d = _rand_sp(17, 23)
    jc, tc = _pair_csr(d)
    for x, y in ((jc.indptr, tc.indptr), (jc.indices, tc.indices), (jc.data, tc.data)):
        np.testing.assert_array_equal(_np(x), y.numpy())
    np.testing.assert_array_equal(_np(jc.to_dense()), tc.to_dense().numpy())
    jo, to = js.COO.from_dense(d), ts.COO.from_dense(d, device="cpu")
    _same_coo(jo, to)
    jr, tr = js.convert.coo_to_csr(jo), ts.convert.coo_to_csr(to)
    np.testing.assert_array_equal(_np(jr.indptr), tr.indptr.numpy())
    np.testing.assert_array_equal(_np(jr.data), tr.data.numpy())
    _same_coo(js.convert.csr_to_coo(jc), ts.convert.csr_to_coo(tc))
    np.testing.assert_array_equal(_np(js.convert.csr_to_dense(jc)), ts.convert.csr_to_dense(tc).numpy())


def test_raft_arrays_construct_the_port_containers_unchanged():
    """raft_tpu's arrays, as numpy, make the port's containers (padding,
    nnz and all)."""
    d = _rand_sp(9, 7)
    jc = js.CSR.from_dense(d)
    pad = 5
    jc2 = js.CSR(jc.indptr, np.concatenate([_np(jc.indices), np.zeros(pad, np.int32)]),
                 np.concatenate([_np(jc.data), np.zeros(pad, np.float32)]), jc.shape, jc.nnz)
    tc2 = ts.CSR(_np(jc2.indptr), _np(jc2.indices), _np(jc2.data), jc2.shape, jc2.nnz,
                 device="cpu")
    np.testing.assert_array_equal(_np(jc2.row_ids()), tc2.row_ids().numpy())
    np.testing.assert_array_equal(_np(jc2.valid), tc2.valid.numpy())
    np.testing.assert_array_equal(_np(jc2.to_dense()), tc2.to_dense().numpy())
    rows, cols, data, shape = _dup_coo()
    jo = js.COO(rows, cols, data, shape, 300)
    to = ts.COO(_np(jo.rows), _np(jo.cols), _np(jo.data), jo.shape, jo.nnz, device="cpu")
    np.testing.assert_array_equal(_np(jo.to_dense()), to.to_dense().numpy())
    _same_coo(jo.sorted_by_row(), to.sorted_by_row())


def test_coo_order_is_two_stable_sorts():
    rows, cols, data, shape = _dup_coo(seed=4)
    valid = np.arange(rows.size) < 350
    a = js.formats.coo_order(rows, cols, valid, shape[0])
    b = ts.formats.coo_order(torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(valid), shape[0])
    np.testing.assert_array_equal(_np(a), b.numpy())


def test_spmm_spmv_bitwise():
    rng = np.random.default_rng(0)
    d = _rand_sp(20, 30, density=0.4)
    b = rng.random((30, 8), dtype=np.float32)
    x = rng.random(30, dtype=np.float32)
    jc, tc = _pair_csr(d)
    np.testing.assert_array_equal(_np(js.linalg.spmm(jc, b)), ts.linalg.spmm(tc, b).numpy())
    np.testing.assert_array_equal(_np(js.linalg.spmv(jc, x)),
                                  ts.linalg.spmv(tc, torch.from_numpy(x)).numpy())


def test_sddmm_and_masked_matmul():
    rng = np.random.default_rng(1)
    d = _rand_sp(12, 18, density=0.3)
    a = rng.random((12, 6), dtype=np.float32)
    b = rng.random((18, 6), dtype=np.float32)
    jc, tc = _pair_csr(d)
    jo = js.linalg.sddmm(jc, a, b, alpha=2.0, beta=0.5)
    to = ts.linalg.sddmm(tc, torch.from_numpy(a), torch.from_numpy(b), alpha=2.0, beta=0.5)
    np.testing.assert_allclose(to.data.numpy(), _np(jo.data), rtol=RTOL, atol=ATOL)
    mask = (d != 0).astype(np.float32)
    jm = js.linalg.masked_matmul(js.COO.from_dense(mask), a, b)
    tm = ts.linalg.masked_matmul(ts.COO.from_dense(mask, device="cpu"), torch.from_numpy(a),
                                 torch.from_numpy(b))
    np.testing.assert_allclose(tm.data.numpy(), _np(jm.data), rtol=RTOL, atol=ATOL)


def test_transpose():
    jc, tc = _pair_csr(_rand_sp(15, 9))
    jt, tt = js.linalg.transpose(jc), ts.linalg.transpose(tc)
    assert tt.shape == jt.shape
    for x, y in ((jt.indptr, tt.indptr), (jt.indices, tt.indices), (jt.data, tt.data)):
        np.testing.assert_array_equal(_np(x), y.numpy())


@pytest.mark.parametrize("sym_op", ["max", "min", "add", "mean"])
def test_symmetrize_and_duplicate_reduction_bitwise(sym_op):
    rows, cols, data, shape = _dup_coo()
    jo, to = _pair_coo(rows, cols, data, shape, 350)
    _same_coo(js.linalg.symmetrize(jo, op=sym_op), ts.linalg.symmetrize(to, op=sym_op))
    _same_coo(js.op._reduce_duplicates(jo, sym_op), ts.op._reduce_duplicates(to, sym_op))


def test_dedupe_filters_and_sort():
    rows = np.array([0, 0, 1, 2, 0], np.int32)
    cols = np.array([1, 1, 2, 0, 1], np.int32)
    data = np.array([1.0, 3.0, 2.0, 4.0, 2.0], np.float32)
    jo, to = _pair_coo(rows, cols, data, (3, 3))
    _same_coo(js.op.sum_duplicates(jo), ts.op.sum_duplicates(to))
    _same_coo(js.op.max_duplicates(jo), ts.op.max_duplicates(to))
    _same_coo(js.op.filter_values(js.op.sum_duplicates(jo), threshold=2.5),
              ts.op.filter_values(ts.op.sum_duplicates(to), threshold=2.5))
    _same_coo(js.op.sort_coo(jo), ts.op.sort_coo(to))
    d = _rand_sp(10, 10, density=0.3)
    _same_coo(js.op.filter_degree(js.COO.from_dense(d), min_degree=3),
              ts.op.filter_degree(ts.COO.from_dense(d, device="cpu"), min_degree=3))


def test_slice_rows_row_op_and_select_k():
    d = _rand_sp(12, 8, density=0.5)
    jc, tc = _pair_csr(d)
    js_, ts_ = js.op.slice_rows(jc, 3, 9), ts.op.slice_rows(tc, 3, 9)
    np.testing.assert_array_equal(_np(js_.to_dense()), ts_.to_dense().numpy())
    jr = js.op.row_op(jc, lambda r, v: v * (r + 1))
    tr = ts.op.row_op(tc, lambda r, v: v * (r + 1))
    np.testing.assert_array_equal(_np(jr.data), tr.data.numpy())
    for select_min in (False, True):
        jv, ji = js.op.select_k(jc, 3, select_min=select_min)
        tv, ti = ts.op.select_k(tc, 3, select_min=select_min)
        np.testing.assert_array_equal(_np(jv), tv.numpy())
        np.testing.assert_array_equal(_np(ji), ti.numpy())


def test_degree_weighted_degree_norms_laplacian_spmv_coo_bitwise():
    rows, cols, data, shape = _dup_coo(seed=5)
    data = np.abs(data)
    jo, to = _pair_coo(rows, cols, data, shape, 380)
    np.testing.assert_array_equal(_np(js.linalg.degree(jo)), ts.linalg.degree(to).numpy())
    np.testing.assert_array_equal(_np(js.linalg.weighted_degree(jo)),
                                  ts.linalg.weighted_degree(to).numpy())
    x = np.random.default_rng(6).standard_normal(shape[0]).astype(np.float32)
    for normalized in (False, True):
        jl, tl = (js.linalg.laplacian(jo, normalized=normalized),
                  ts.linalg.laplacian(to, normalized=normalized))
        assert jl.nnz == tl.nnz
        np.testing.assert_array_equal(_np(jl.rows), tl.rows.numpy())
        # 1 / sqrt(d): XLA may rewrite it as rsqrt (one rounding fewer)
        np.testing.assert_allclose(tl.data.numpy(), _np(jl.data), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ts.linalg.spmv_coo(tl, torch.from_numpy(x)).numpy(),
                                   _np(js.linalg.spmv_coo(jl, x)), rtol=RTOL, atol=ATOL)
    jl, tl = js.linalg.laplacian(jo), ts.linalg.laplacian(to)
    np.testing.assert_array_equal(ts.linalg.spmv_coo(tl, torch.from_numpy(x)).numpy(),
                                  _np(js.linalg.spmv_coo(jl, x)))
    jc, tc = _pair_csr(_rand_sp(13, 11, density=0.4))
    for nt in ("l1", "l2", "linf"):
        np.testing.assert_array_equal(_np(js.linalg.row_norm_csr(jc, norm_type=nt)),
                                      ts.linalg.row_norm_csr(tc, norm_type=nt).numpy())


def test_csr_spmm_plain_version_sums_in_slot_order():
    """The plain version of the kernel adds each row's products in slot
    order: bitwise a sequential numpy loop, on rows of very different
    degrees (one hub row) and with empty rows."""
    rng = np.random.default_rng(7)
    deg = np.array([0, 1, 40, 3, 0, 700, 2], np.int64)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = int(indptr[-1])
    idx = rng.integers(0, 50, nnz).astype(np.int32)
    data = (rng.standard_normal(nnz) * 10.0 ** rng.integers(-3, 4, nnz)).astype(np.float32)
    x = rng.standard_normal((50, 3)).astype(np.float32)
    got = csr_k.csr_spmm_torch(torch.from_numpy(indptr), torch.from_numpy(idx),
                               torch.from_numpy(data), torch.from_numpy(x)).numpy()
    want = np.zeros((deg.size, 3), np.float32)
    for r in range(deg.size):
        for s in range(indptr[r], indptr[r + 1]):
            want[r] = want[r] + data[s] * x[idx[s]]
    np.testing.assert_array_equal(got, want)
    assert got.tobytes() == csr_k.csr_spmm(torch.from_numpy(indptr), torch.from_numpy(idx),
                                           torch.from_numpy(data),
                                           torch.from_numpy(x)).numpy().tobytes()
    assert kernels.consume_kernel_path() == "torch"


def _schedule_csr(case, seed):
    """(indptr, indices, data) of a CSR shaped after a branch of
    ``csrc/csr_spmm.cu``'s plan: "empty" (most rows empty, whole windows of
    them), "degrees" (rows of 1, 31, 32 and 33 slots: a warp's round of 32
    and its edges), "long" (one row of 5,000 slots, past a 1,024-slot
    window, so in a block of its own, among short rows).  Signed values over
    several magnitudes, so that the order of each sum shows in its bits."""
    rng = np.random.default_rng(seed)
    if case == "empty":
        deg = np.where(rng.random(700) < 0.1, rng.integers(1, 9, 700), 0)
        deg[256:512] = 0
    elif case == "degrees":
        deg = np.tile([1, 31, 32, 33, 0], 60)
    else:
        deg = rng.integers(0, 40, 300)
        deg[137] = 5000
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = int(indptr[-1])
    idx = rng.integers(0, 90, nnz).astype(np.int32)
    data = (rng.standard_normal(nnz) * 10.0 ** rng.integers(-3, 4, nnz)).astype(np.float32)
    return indptr, idx, data


@pytest.mark.parametrize("cols", [1, 3, 32, 33, 128])
@pytest.mark.parametrize("case", ["empty", "degrees", "long"])
def test_csr_spmm_schedule_cases_bitwise_raft_tpu(case, cols):
    """The plain csr_spmm (and ``sparse.linalg.spmm`` over it) bitwise
    raft_tpu's ``segment_sum`` SpMM at every branch of the kernel's
    schedule and column layout (one column; a warp's 32 columns and its
    edges; 128)."""
    indptr, idx, data = _schedule_csr(case, cols)
    x = np.random.default_rng(cols + 1).standard_normal((90, cols)).astype(np.float32)
    shape = (indptr.size - 1, 90)
    want = _np(js.linalg.spmm(js.CSR(indptr, idx, data, shape), x))
    got = csr_k.csr_spmm_torch(*(torch.from_numpy(a) for a in (indptr, idx, data, x)))
    assert got.numpy().tobytes() == want.tobytes()
    tc = ts.CSR(indptr, idx, data, shape, device="cpu")
    assert ts.linalg.spmm(tc, torch.from_numpy(x)).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine",
                                    "correlation", "hellinger", "l1", "chebyshev", "canberra",
                                    "braycurtis", "minkowski", "jensenshannon", "kl_divergence"])
def test_sparse_pairwise_distance(metric):
    a = _rand_sp(25, 40, density=0.3, seed=1)
    b = _rand_sp(19, 40, density=0.3, seed=2)
    kw = {"p": 3.0} if metric == "minkowski" else {}
    got = ts.distance.pairwise_distance_sparse(ts.CSR.from_dense(a, device="cpu"),
                                               ts.CSR.from_dense(b, device="cpu"),
                                               metric=metric, res=CPU, **kw).numpy()
    want = _np(js.distance.pairwise_distance_sparse(js.CSR.from_dense(a), js.CSR.from_dense(b),
                                                    metric=metric, **kw))
    # expanded terms (|a|^2 + |b|^2 - 2 ab) cancel: an absolute tolerance
    # scaled to the norms
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=metric)


@pytest.mark.parametrize("metric", ["jaccard", "dice", "russellrao", "hamming"])
def test_sparse_pairwise_distance_binary(metric):
    rng = np.random.default_rng(7)
    a = (rng.random((20, 50)) < 0.25).astype(np.float32)
    b = (rng.random((15, 50)) < 0.25).astype(np.float32)
    got = ts.distance.pairwise_distance_sparse(ts.CSR.from_dense(a, device="cpu"),
                                               ts.CSR.from_dense(b, device="cpu"),
                                               metric=metric, res=CPU).numpy()
    want = _np(js.distance.pairwise_distance_sparse(js.CSR.from_dense(a), js.CSR.from_dense(b),
                                                    metric=metric))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sparse_gram_over_many_feature_tiles_and_repeated_slots():
    """A wide matrix through a 1 MB workspace (many feature tiles), with
    repeated (row, col) slots that densify must sum."""
    rng = np.random.default_rng(0)
    n_a, n_b, d, per = 60, 20, 50_000, 12
    def make(n):
        indptr = np.arange(n + 1, dtype=np.int32) * per
        cols = rng.integers(0, d, n * per).astype(np.int32)
        cols[::5] = cols[1::5][:cols[::5].size]       # repeats within rows
        return indptr, cols, rng.random(n * per).astype(np.float32)
    a, b = make(n_a), make(n_b)
    jr, tr = JResources(workspace_limit_bytes=1 << 20), Resources(device="cpu",
                                                                 workspace_limit_bytes=1 << 20)
    want = _np(js.distance.pairwise_distance_sparse(js.CSR(*a, (n_a, d)), js.CSR(*b, (n_b, d)),
                                                    res=jr))
    got = ts.distance.pairwise_distance_sparse(ts.CSR(*a, (n_a, d), device="cpu"),
                                               ts.CSR(*b, (n_b, d), device="cpu"), res=tr).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(
        _np(js.distance.row_norms_sq(js.CSR(*a, (n_a, d)))),
        ts.distance.row_norms_sq(ts.CSR(*a, (n_a, d), device="cpu")).numpy())


@pytest.mark.parametrize("kp", [("linear", {}), ("polynomial", dict(degree=2, gamma=0.5, coef0=1.0)),
                                ("tanh", dict(gamma=0.1, coef0=0.2)), ("rbf", dict(gamma=0.3))])
def test_gram_matrix_dense_and_csr(kp):
    a = _rand_sp(18, 30, density=0.3, seed=5)
    b = _rand_sp(11, 30, density=0.3, seed=6)
    name, kw = kp
    for x, y, tx, ty in ((a, b, torch.from_numpy(a), torch.from_numpy(b)),
                         (js.CSR.from_dense(a), js.CSR.from_dense(b),
                          ts.CSR.from_dense(a, device="cpu"), ts.CSR.from_dense(b, device="cpu"))):
        want = _np(jgram(x, y, JKP(name, **kw)))
        got = tgram(tx, ty, TKP(name, **kw), res=CPU).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)


def test_sparse_brute_force_knn():
    data = _rand_sp(200, 32, density=0.4, seed=3)
    q = _rand_sp(23, 32, density=0.4, seed=4)
    jv, ji = js.neighbors.brute_force_knn(js.CSR.from_dense(data), js.CSR.from_dense(q), 5)
    tv, ti = ts.neighbors.brute_force_knn(ts.CSR.from_dense(data, device="cpu"),
                                          ts.CSR.from_dense(q, device="cpu"), 5, res=CPU)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-5, atol=1e-5)


def test_knn_graph_matches_raft_tpu():
    x = np.random.default_rng(0).random((60, 8), dtype=np.float32)
    jg = js.neighbors.knn_graph(x, 4)
    tg = ts.neighbors.knn_graph(x, 4, res=CPU)
    assert jg.nnz == tg.nnz
    np.testing.assert_array_equal(_np(jg.rows)[:jg.nnz], tg.rows[:tg.nnz].numpy())
    np.testing.assert_array_equal(_np(jg.cols)[:jg.nnz], tg.cols[:tg.nnz].numpy())
    np.testing.assert_allclose(tg.data[:tg.nnz].numpy(), _np(jg.data)[:jg.nnz], rtol=1e-4,
                               atol=1e-5)
    dense = tg.to_dense().numpy()
    np.testing.assert_array_equal(dense, dense.T)
