"""Port parity: Lanczos (``raft_tpu_torch.ops.lanczos``), spectral
partitioning / modularity (``raft_tpu_torch.cluster.spectral``) and
``find_k`` against raft_tpu's, case by case after raft_tpu's
``tests/test_spectral.py``, on the same seeded numpy inputs.

raft_tpu draws Lanczos' start and restart vectors from threefry, which a
torch.Generator cannot give: ``_lanczos_basis`` is held to raft_tpu's with
the same injected vectors (alphas / betas within rtol 1e-4), and
``eigsh_lanczos`` to raft_tpu's where m = n, where the Krylov space is the
whole space and the Ritz values are exact (rtol 1e-4).  Labels come from
k-means over the embedding, so they are compared by adjusted Rand index,
at raft_tpu's own thresholds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import find_k as jfind_k
from raft_tpu.cluster import spectral as jspectral
from raft_tpu.ops import lanczos as jlanczos
from raft_tpu.random import make_blobs as jmake_blobs
from raft_tpu.sparse import COO as JCOO
from raft_tpu.sparse import linalg as jlinalg
from raft_tpu.sparse.neighbors import knn_graph as jknn_graph
from raft_tpu_torch.cluster import find_k as tfind_k
from raft_tpu_torch.cluster import spectral as tspectral
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.ops import lanczos as tlanczos
from raft_tpu_torch.sparse import COO as TCOO
from raft_tpu_torch.sparse import linalg as tlinalg
from raft_tpu_torch.stats import adjusted_rand_index

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _ari(a, b):
    return float(adjusted_rand_index(np.asarray(a), np.asarray(b), res=CPU))


def _random_graph(n=200, m=2000, seed=0):
    """A connected weighted graph, both directions of each edge."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    ring = np.arange(n)
    r, c = np.concatenate([r, ring]), np.concatenate([c, (ring + 1) % n])
    w = rng.random(r.size).astype(np.float32) + 0.1
    rows = np.concatenate([r, c]).astype(np.int32)
    cols = np.concatenate([c, r]).astype(np.int32)
    data = np.concatenate([w, w])
    return (jlinalg.symmetrize(JCOO(rows, cols, data, (n, n)), op="max"),
            tlinalg.symmetrize(TCOO(rows, cols, data, (n, n), device="cpu"), op="max"))


def test_lanczos_basis_with_injected_vectors_matches_raft_tpu():
    jg, tg = _random_graph()
    n = jg.shape[0]
    jl, tl = jlinalg.laplacian(jg, normalized=True), tlinalg.laplacian(tg, normalized=True)
    rng = np.random.default_rng(1)
    v0 = rng.standard_normal(n).astype(np.float32)
    restarts = rng.standard_normal((32, n)).astype(np.float32)
    _, ja, jb = jlanczos._lanczos_basis(lambda v: jlinalg.spmv_coo(jl, v), jnp.asarray(v0),
                                        jnp.asarray(restarts), 32)
    tv, ta, tb = tlanczos._lanczos_basis(lambda v: tlinalg.spmv_coo(tl, v), torch.from_numpy(v0),
                                         torch.from_numpy(restarts), 32)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tv.numpy() @ tv.numpy().T, np.eye(32), atol=1e-4)


def test_lanczos_breakdown_restarts_like_raft_tpu():
    """A graph of two components: the sweep meets an invariant subspace and
    goes on in the injected restart direction with beta recorded as 0."""
    rows = np.array([0, 1, 1, 2, 3, 4], np.int32)
    cols = np.array([1, 0, 2, 1, 4, 3], np.int32)
    data = np.ones(6, np.float32)
    jl = jlinalg.laplacian(JCOO(rows, cols, data, (5, 5)))
    tl = tlinalg.laplacian(TCOO(rows, cols, data, (5, 5), device="cpu"))
    v0 = np.array([1, 0, 0, 0, 0], np.float32)
    restarts = np.random.default_rng(2).standard_normal((5, 5)).astype(np.float32)
    _, ja, jb = jlanczos._lanczos_basis(lambda v: jlinalg.spmv_coo(jl, v), jnp.asarray(v0),
                                        jnp.asarray(restarts), 5)
    _, ta, tb = tlanczos._lanczos_basis(lambda v: tlinalg.spmv_coo(tl, v), torch.from_numpy(v0),
                                        torch.from_numpy(restarts), 5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-5)
    assert (tb.numpy() == 0).any()


@pytest.mark.parametrize("which,k", [("smallest", 5), ("largest", 3)])
def test_eigsh_lanczos_full_space_matches_raft_tpu_and_numpy(which, k):
    rng = np.random.default_rng(3)
    n = 60
    a = rng.random((n, n)).astype(np.float32)
    a = (a + a.T) / 2
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    jv, _ = jlanczos.eigsh_lanczos(lambda v: aj @ v, n, k, which=which, m=n)
    tv, tvec = tlanczos.eigsh_lanczos(lambda v: at @ v, n, k, which=which, m=n, res=CPU)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    ref = np.linalg.eigvalsh(a)
    np.testing.assert_allclose(tv.numpy(), ref[:k] if which == "smallest" else ref[-k:],
                               rtol=1e-3, atol=1e-3)
    v0 = tvec[:, 0].numpy()
    np.testing.assert_allclose(a @ v0, float(tv[0]) * v0, atol=5e-3)


def test_eigsh_lanczos_reproducible_and_validates():
    a = torch.from_numpy(np.diag(np.arange(1, 41, dtype=np.float32)))
    v1 = tlanczos.eigsh_lanczos(lambda v: a @ v, 40, 4, seed=7, res=CPU)
    v2 = tlanczos.eigsh_lanczos(lambda v: a @ v, 40, 4, seed=7, res=CPU)
    assert torch.equal(v1[0], v2[0]) and torch.equal(v1[1], v2[1])
    with pytest.raises(ValueError):
        tlanczos.eigsh_lanczos(lambda v: a @ v, 40, 41, res=CPU)
    with pytest.raises(ValueError):
        tlanczos.eigsh_lanczos(lambda v: a @ v, 40, 4, which="middle", res=CPU)


def test_laplacian_and_spmv():
    rows = np.array([0, 1, 1, 2, 0, 2], np.int32)
    cols = np.array([1, 0, 2, 1, 2, 0], np.int32)
    adj = TCOO(rows, cols, np.ones(6, np.float32), (4, 4), device="cpu")
    want = np.array([[2, -1, -1, 0], [-1, 2, -1, 0], [-1, -1, 2, 0], [0, 0, 0, 0]], np.float32)
    np.testing.assert_array_equal(tlinalg.laplacian(adj).to_dense().numpy(), want)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    np.testing.assert_array_equal(tlinalg.spmv_coo(tlinalg.laplacian(adj), x).numpy(),
                                  want @ x.numpy())
    lapn = tlinalg.laplacian(adj, normalized=True).to_dense().numpy()
    np.testing.assert_allclose(np.diag(lapn), [1, 1, 1, 0])


def _two_cliques():
    rows, cols = [], []
    for base in (0, 10):
        for i in range(10):
            for j in range(10):
                if i != j:
                    rows.append(base + i)
                    cols.append(base + j)
    rows += [0, 10]
    cols += [10, 0]
    return np.asarray(rows, np.int32), np.asarray(cols, np.int32), np.ones(len(rows), np.float32)


def test_spectral_partition_two_cliques():
    rows, cols, data = _two_cliques()
    adj = TCOO(rows, cols, data, (20, 20), device="cpu")
    labels, vals = tspectral.partition(adj, 2, seed=1, res=CPU)
    truth = np.array([0] * 10 + [1] * 10)
    assert _ari(labels.numpy(), truth) == 1.0
    cut, min_size = tspectral.analyze_partition(adj, labels, 2)
    assert float(cut) == 1.0 and int(min_size) == 10
    jlab, jvals = jspectral.partition(JCOO(rows, cols, data, (20, 20)), 2, seed=1)
    assert _ari(labels.numpy(), np.asarray(jlab)) == 1.0
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-3, atol=1e-4)
    emb = tspectral.fit_embedding(adj, 1, normalized=True, seed=1)
    assert emb.shape == (20, 1)
    assert _ari((emb[:, 0] > 0).numpy(), truth) == 1.0


def _blob_similarity(n, d, k, std, knn_k, seed):
    x, truth, _ = jmake_blobs(jax.random.PRNGKey(seed), n, d, n_clusters=k, cluster_std=std)
    x, truth = np.asarray(x), np.asarray(truth)
    adj = jknn_graph(x, knn_k)
    rows, cols = np.asarray(adj.rows), np.asarray(adj.cols)
    w = np.where(np.asarray(adj.valid), 1.0 / (1.0 + np.asarray(adj.data)), 0.0).astype(np.float32)
    return (JCOO(rows, cols, w, adj.shape, adj.nnz), TCOO(rows, cols, w, adj.shape, adj.nnz,
                                                          device="cpu"), truth)


def test_modularity_maximization_blobs():
    jsim, tsim, truth = _blob_similarity(200, 6, 3, 0.4, 8, 0)
    labels, vals = tspectral.modularity_maximization(tsim, 3, seed=0, res=CPU)
    assert _ari(labels.numpy(), truth) > 0.9
    q = float(tspectral.analyze_modularity(tsim, labels))
    assert q > 0.5
    jlab, _ = jspectral.modularity_maximization(jsim, 3, seed=0)
    np.testing.assert_allclose(q, float(jspectral.analyze_modularity(jsim, jlab)), rtol=1e-5)
    # the same labelling scores the same Q in both packages
    np.testing.assert_allclose(float(jspectral.analyze_modularity(jsim, labels.numpy())), q,
                               rtol=1e-5)


def test_spectral_partition_blobs_and_reproducibility():
    jsim, tsim, truth = _blob_similarity(240, 5, 4, 0.3, 10, 3)
    l1, v1 = tspectral.partition(tsim, 4, seed=0, res=CPU)
    l2, v2 = tspectral.partition(tsim, 4, seed=0, res=CPU)
    assert torch.equal(l1, l2) and torch.equal(v1, v2)
    jl, _ = jspectral.partition(jsim, 4, seed=0)
    assert _ari(l1.numpy(), truth) >= min(0.9, _ari(np.asarray(jl), truth))
    cut_t, _ = tspectral.analyze_partition(tsim, l1, 4)
    cut_j, _ = jspectral.analyze_partition(jsim, l1.numpy(), 4)
    np.testing.assert_allclose(float(cut_t), float(cut_j), rtol=1e-5)


def test_find_k_blobs():
    x, _, _ = jmake_blobs(jax.random.PRNGKey(2), 400, 4, n_clusters=5, cluster_std=0.3)
    x = np.asarray(x)
    k, centers, inertia = tfind_k(x, kmax=10, kmin=1, res=CPU)
    assert 4 <= k <= 6 and centers.shape == (k, 4)
    jk, _, jinertia = jfind_k(x, kmax=10, kmin=1)
    assert abs(k - jk) <= 1
    with pytest.raises(ValueError):
        tfind_k(x, kmax=1000, res=CPU)


def test_eigsh_lanczos_resolves_a_degenerate_null_space():
    """A graph of 12 components has a 12-fold zero eigenvalue.  raft_tpu's
    one sweep finds one null direction per Krylov space and returns
    unconverged Ritz pairs for the rest; the port's locked restarts return
    k converged null vectors (ROADMAP Q3.9), and the first sweep stays
    raft_tpu's where it converges (the full-space cases above)."""
    rng = np.random.default_rng(5)
    n_comp, size = 12, 50
    rows, cols = [], []
    for c in range(n_comp):
        base = c * size
        for i in range(size):   # a ring with chords: connected, no small cut
            for j in (i + 1, i + 7):
                rows += [base + i, base + j % size]
                cols += [base + j % size, base + i]
    rows, cols = np.asarray(rows, np.int32), np.asarray(cols, np.int32)
    data = (rng.random(rows.size) + 0.5).astype(np.float32)
    n = n_comp * size
    jl = jlinalg.laplacian(jlinalg.symmetrize(JCOO(rows, cols, data, (n, n)), op="max"),
                           normalized=True)
    tl = tlinalg.laplacian(tlinalg.symmetrize(TCOO(rows, cols, data, (n, n), device="cpu"),
                                              op="max"), normalized=True)
    jv, _ = jlanczos.eigsh_lanczos(lambda v: jlinalg.spmv_coo(jl, v), n, 6)
    tv, tvec = tlanczos.eigsh_lanczos(lambda v: tlinalg.spmv_coo(tl, v), n, 6, res=CPU)
    assert np.abs(np.asarray(jv)).max() > 1e-2          # raft_tpu: unconverged pairs
    assert np.abs(tv.numpy()).max() < 1e-4
    lv = np.stack([tlinalg.spmv_coo(tl, tvec[:, i]).numpy() for i in range(6)], axis=1)
    assert np.abs(lv).max() < 2e-3                        # L y ~ 0 for each vector
    np.testing.assert_allclose(tvec.T.numpy() @ tvec.numpy(), np.eye(6), atol=1e-4)
    # the partition groups whole components: no edge is cut
    adj = tlinalg.symmetrize(TCOO(rows, cols, data, (n, n), device="cpu"), op="max")
    labels, _ = tspectral.partition(adj, 4, res=CPU)
    cut, _ = tspectral.analyze_partition(adj, labels, 4)
    assert float(cut) == 0.0
