"""Port parity: the select_k plain versions of ``raft_tpu_torch`` against
raft_tpu's Pallas kernel (interpret mode) and its XLA paths, bitwise."""

import os
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.kernels.select_k import select_k_pallas
from raft_tpu.ops import matrix as jmatrix
from raft_tpu_torch.kernels import select_k as tsk
from raft_tpu_torch.ops import matrix as tmatrix

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same(a, b):
    np.testing.assert_array_equal(_np(a[0]), _np(b[0]))
    np.testing.assert_array_equal(_np(a[1]), _np(b[1]))


# k 129 over 258-wide rows is CAGRA's refine; raft_tpu's Pallas select_k
# stops at k 128, so past it the reference is raft_tpu's routed select_k
@pytest.mark.parametrize("rows,n,k", [(5, 37, 7), (8, 128, 16), (3, 1000, 32), (1, 8, 8),
                                      (4, 258, 129), (2, 600, 258), (2, 1300, 600),
                                      (1, 2100, 2048)])
@pytest.mark.parametrize("select_min", [True, False])
def test_positional_heavy_ties_vs_pallas(rows, n, k, select_min):
    rng = np.random.default_rng(rows * n + k)
    s = np.round(rng.standard_normal((rows, n)) * 3).astype(np.float32)
    if k <= 128:
        ref = select_k_pallas(jnp.asarray(s), k, select_min=select_min, interpret=True)
    else:
        ref = jmatrix.select_k(jnp.asarray(s), k, select_min=select_min)
    got = tsk.select_k_torch(torch.from_numpy(s), k, select_min=select_min)
    _assert_same(got, ref)
    # the routed entry point (CPU tensors take the plain version)
    _assert_same(tmatrix.select_k(torch.from_numpy(s), k, select_min=select_min), ref)


def _zero_heavy(rng, rows, n, select_min):
    """Rows whose k-th smallest (largest) lands among many zeros of both
    signs: |round(z / 2)|, about two thirds of them zeros (negated when
    selecting the largest), every zero's sign drawn at random."""
    s = np.abs(np.round(rng.standard_normal((rows, n)) * 0.5)).astype(np.float32)
    zero = s == 0
    s[zero] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(-0.0), np.float32(0.0))
    return s if select_min else -s


# (300, 100): raft_tpu's Pallas select_k, zeros tie; past k 128 its
# lax.top_k; n 9000: its chunked tournament (lax.top_k at every level)
@pytest.mark.parametrize("n,k", [(300, 100), (300, 200), (9000, 20), (9000, 600)])
@pytest.mark.parametrize("select_min", [True, False])
def test_signed_zero_ties_match_raft_tpu(n, k, select_min):
    """raft_tpu ranks -0.0 below +0.0 wherever it takes lax.top_k (past k
    128, and on the chunked path at any k: -0.0 first among the smallest,
    last among the largest) and holds them equal where its Pallas kernel
    runs; the port follows it on every path, ids bitwise."""
    rng = np.random.default_rng(7 + k)
    s = _zero_heavy(rng, 2, n, select_min)
    key = s if select_min else -s
    kth = np.sort(key, axis=1)[:, k - 1]
    assert (kth == 0).all()     # the cut lies among the zeros
    neg = np.signbit(s[s == 0])
    assert neg.any() and not neg.all()
    got = tmatrix.select_k(torch.from_numpy(s), k, select_min=select_min)
    ref = jmatrix.select_k(jnp.asarray(s), k, select_min=select_min)
    if n < 8192 and k <= 128:
        ref = select_k_pallas(jnp.asarray(s), k, select_min=select_min, interpret=True)
        signed = False
    else:
        signed = True
    sign = np.signbit(s).astype(np.int8)
    zero_key = -sign if select_min else sign
    want = np.stack([np.lexsort((np.arange(n), zero_key[r] if signed else 0 * sign[r],
                                 key[r]))[:k] for r in range(2)])
    np.testing.assert_array_equal(_np(ref[1]), want)
    _assert_same(got, ref)
    if signed:   # (raft_tpu's Pallas kernel writes a row's min, of either sign)
        np.testing.assert_array_equal(np.signbit(_np(got[0])), np.signbit(_np(ref[0])))
    # the plain version of the kernel (k <= 2048, n <= 8192), and the chunked
    # tournament asked for by name
    if n <= 8192:
        _assert_same(tsk.select_k_torch(torch.from_numpy(s), k, select_min=select_min), ref)
    else:
        _assert_same(tmatrix.select_k(torch.from_numpy(s), k, select_min=select_min,
                                      algo="chunked"), ref)


@pytest.mark.parametrize("k", [100, 200])
@pytest.mark.parametrize("select_min", [True, False])
def test_stable_signed_zeros_tie_as_raft_tpu_two_key_sort(k, select_min):
    """raft_tpu's select_k_stable (Pallas up to k 128, a two-key lax.sort
    past it) holds -0.0 and +0.0 equal at every k: the smallest id wins."""
    rng = np.random.default_rng(17 + k)
    s = _zero_heavy(rng, 3, 400, select_min)
    ids = rng.permutation(400 * 3).reshape(3, 400).astype(np.int32)
    ids[:, ::7] = -1
    got = tmatrix.select_k_stable(torch.from_numpy(s), k, select_min=select_min,
                                  input_indices=torch.from_numpy(ids))
    ref = jmatrix.select_k_stable(jnp.asarray(s), k, select_min=select_min,
                                  input_indices=jnp.asarray(ids))
    _assert_same(got, ref)
    if k <= 128:
        _assert_same(got, select_k_pallas(jnp.asarray(s), k, select_min=select_min, stable=True,
                                          input_indices=jnp.asarray(ids), interpret=True))


@pytest.mark.parametrize("metric", ["inner_product", "sqeuclidean"])
def test_brute_force_past_128_matches_raft_tpu_tiled_on_zero_scores(metric):
    """Sparse {-1, 0, 1} rows: hundreds of zero products per query, whose
    fused partial score is -0.0 (-q.x) in the port's ip mode.  Past k 128
    raft_tpu's brute force is its tiled path (lax.top_k merges); the port's
    fused path gives its ids and values."""
    from raft_tpu.neighbors import brute_force as jbf
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import brute_force as tbf

    rng = np.random.default_rng(19)
    x = (rng.integers(-1, 2, (600, 16)) * (rng.random((600, 16)) < 0.15)).astype(np.float32)
    q = (rng.integers(-1, 2, (5, 16)) * (rng.random((5, 16)) < 0.3)).astype(np.float32)
    jv, ji = jbf.knn(x, q, 200, metric=metric)
    tv, ti = tbf.knn(x, q, 200, metric=metric, res=Resources(device="cpu"))
    if metric == "inner_product":
        assert int((np.asarray(jv) == 0).sum()) > 200
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(np.signbit(tv.numpy()), np.signbit(np.asarray(jv)))


@pytest.mark.parametrize("select_min", [True, False])
def test_input_indices_and_inf_pads_vs_pallas(select_min):
    rng = np.random.default_rng(1)
    rows, n, k = 4, 96, 24
    s = np.round(rng.standard_normal((rows, n)) * 2).astype(np.float32)
    s[:, 70:] = np.inf if select_min else -np.inf
    ids = rng.integers(0, 10_000, size=(rows, n)).astype(np.int32)
    ids[:, 70:] = -1
    ref = select_k_pallas(jnp.asarray(s), k, select_min=select_min,
                          input_indices=jnp.asarray(ids), interpret=True)
    got = tsk.select_k_torch(torch.from_numpy(s), k, select_min=select_min,
                             input_indices=torch.from_numpy(ids))
    _assert_same(got, ref)


@pytest.mark.parametrize("select_min", [True, False])
def test_stable_negative_ids_vs_pallas_and_xla(select_min):
    rng = np.random.default_rng(2)
    rows, n, k = 7, 256, 32
    s = np.asarray(rng.integers(0, 4, size=(rows, n)), np.float32)
    s[:, 200:] = np.inf
    ids = rng.integers(-1, 50, size=(rows, n)).astype(np.int32)
    ref = select_k_pallas(jnp.asarray(s), k, select_min=select_min, stable=True,
                          input_indices=jnp.asarray(ids), interpret=True)
    got = tmatrix.select_k_stable(torch.from_numpy(s), k, select_min=select_min,
                                  input_indices=torch.from_numpy(ids))
    _assert_same(got, ref)
    xla = jmatrix.select_k_stable(jnp.asarray(s), k, select_min=select_min,
                                  input_indices=jnp.asarray(ids))
    _assert_same(got, xla)


@pytest.mark.parametrize("k,n", [(150, 700), (600, 700), (2048, 2100)])
def test_stable_past_the_kernel_envelope_matches_xla(k, n):
    # past raft_tpu's envelope (k 128) all: each takes the port kernel's
    # plain version (its envelope runs to k 2048); raft_tpu's reference is
    # its XLA two-key sort
    rng = np.random.default_rng(3)
    s = np.asarray(rng.integers(0, 6, size=(3, n)), np.float32)
    ids = rng.integers(-1, 300, size=(3, n)).astype(np.int32)
    got = tmatrix.select_k_stable(torch.from_numpy(s), k, input_indices=torch.from_numpy(ids))
    ref = jmatrix.select_k_stable(jnp.asarray(s), k, input_indices=jnp.asarray(ids))
    _assert_same(got, ref)


@pytest.mark.parametrize("n,k", [(10_000, 4), (20_000, 100), (9000, 2000)])
@pytest.mark.parametrize("select_min", [True, False])
def test_chunked_path_vs_xla(n, k, select_min):
    rng = np.random.default_rng(n + k)
    s = np.round(rng.standard_normal((2, n)) * 50).astype(np.float32)
    ref = jmatrix.select_k(jnp.asarray(s), k, select_min=select_min)
    got = tmatrix.select_k(torch.from_numpy(s), k, select_min=select_min)
    _assert_same(got, ref)
    ids = rng.permutation(n).astype(np.int32)
    ref = jmatrix.select_k(jnp.asarray(s), k, select_min=select_min,
                           algo="chunked", input_indices=jnp.asarray(ids))
    got = tmatrix.select_k(torch.from_numpy(s), k, select_min=select_min,
                           algo="chunked", input_indices=torch.from_numpy(ids))
    _assert_same(got, ref)


def test_topk_and_integer_paths_vs_xla():
    rng = np.random.default_rng(4)
    s = np.round(rng.standard_normal((3, 300)) * 2).astype(np.float32)
    for select_min in (True, False):
        _assert_same(
            tmatrix.select_k(torch.from_numpy(s), 12, select_min=select_min, algo="topk"),
            jmatrix.select_k(jnp.asarray(s), 12, select_min=select_min, algo="topk"),
        )
    si = rng.integers(0, 5, size=(3, 300)).astype(np.int32)
    for select_min in (True, False):
        _assert_same(
            tmatrix.select_k(torch.from_numpy(si), 9, select_min=select_min),
            jmatrix.select_k(jnp.asarray(si), 9, select_min=select_min),
        )
    v, i = tmatrix.select_k(torch.from_numpy(s[0]), 5)
    assert v.shape == (5,) and i.shape == (5,) and i.dtype == torch.int32


def test_supported_envelope_matches_raft():
    """raft_tpu's gate, but k runs to 2048 (raft_tpu's Pallas kernel: 128)."""
    from raft_tpu.kernels.select_k import select_k_supported as jsup

    for n, k, dt, jdt in [(512, 32, torch.float32, jnp.float32),
                          (8192, 128, torch.bfloat16, jnp.bfloat16),
                          (8193, 32, torch.float32, jnp.float32),
                          (512, 129, torch.float32, jnp.float32),
                          (8192, 512, torch.float32, jnp.float32),
                          (600, 513, torch.float32, jnp.float32),
                          (4000, 2048, torch.float32, jnp.float32),
                          (4000, 2049, torch.float32, jnp.float32),
                          (16, 32, torch.float32, jnp.float32),
                          (512, 32, torch.int32, jnp.int32)]:
        widened = 128 < k <= tsk.MAX_K and jsup(n, 128, jdt)
        assert tsk.select_k_supported(n, k, dt) == (jsup(n, k, jdt) or widened)
    assert tsk.select_k_supported(258, 129, torch.float32)
    assert tsk.select_k_supported(600, 513, torch.float32)
    assert not tsk.select_k_supported(4000, 2049, torch.float32)
    with pytest.raises(ValueError):
        tsk.select_k_kernel(torch.zeros((2, 16), dtype=torch.int32), 4)


def test_fold_topk_matches_raft():
    from raft_tpu.kernels.toolkit import fold_topk as j_fold
    from raft_tpu_torch.kernels.toolkit import fold_topk as t_fold

    rng = np.random.default_rng(9)
    run_v = np.sort(np.round(rng.standard_normal((6, 8)) * 2), axis=1).astype(np.float32)
    run_i = rng.integers(0, 100, size=(6, 8)).astype(np.int32)
    cand_v = np.round(rng.standard_normal((6, 40)) * 2).astype(np.float32)
    cand_i = rng.integers(100, 200, size=(6, 40)).astype(np.int32)
    ref = j_fold(jnp.asarray(run_v), jnp.asarray(run_i), jnp.asarray(cand_v),
                 jnp.asarray(cand_i), 8)
    got = t_fold(*(torch.from_numpy(a) for a in (run_v, run_i, cand_v, cand_i)), 8)
    _assert_same(got, ref)
