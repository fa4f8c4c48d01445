"""Port parity: the graph solvers of ``raft_tpu_torch.sparse.solver`` (Boruvka
MST, connected components, cross-component 1-NN) and the auction LAP of
``raft_tpu_torch.solver`` against raft_tpu's on the same seeded numpy
inputs (after raft_tpu's ``tests/test_sparse.py`` solver cases).

Tolerances: MST edge sets and component labels equal, total weight within
1e-5 relative (its host sum is the same float32 sum); the assignment equal
and its total within 1e-5 relative."""

import importlib
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from raft_tpu.solver import linear_assignment as jla
from raft_tpu.sparse import COO as JCOO
from raft_tpu.sparse import solver as jsolver
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.solver import linear_assignment as tla
la_mod = importlib.import_module("raft_tpu_torch.solver.linear_assignment")
from raft_tpu_torch.sparse import COO as TCOO
from raft_tpu_torch.sparse import solver as tsolver

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _pair(rows, cols, data, n):
    rows, cols = np.asarray(rows, np.int32), np.asarray(cols, np.int32)
    data = np.asarray(data, np.float32)
    return JCOO(rows, cols, data, (n, n)), TCOO(rows, cols, data, (n, n), device="cpu")


def _edges(coo):
    r = np.asarray(coo.rows)[:coo.nnz]
    c = np.asarray(coo.cols)[:coo.nnz]
    return set(zip(np.minimum(r, c).tolist(), np.maximum(r, c).tolist()))


def _same_mst(jg, tg):
    jt, jc, jw = jsolver.mst(jg)
    tt, tc, tw = tsolver.mst(tg, res=CPU)
    assert _edges(tt) == _edges(jt)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(tw), float(jw), rtol=1e-5)
    return tt, tc


def test_mst_complete_graph_matches_raft_tpu_and_scipy():
    from scipy.sparse.csgraph import minimum_spanning_tree

    rng = np.random.default_rng(0)
    n = 40
    x = rng.random((n, 3), dtype=np.float32)
    d = ((x[:, None] - x[None, :]) ** 2).sum(-1)
    r, c = np.nonzero(~np.eye(n, dtype=bool))
    tt, tc = _same_mst(*_pair(r, c, d[r, c], n))
    assert tt.nnz == n - 1 and len(np.unique(tc.numpy())) == 1
    ref = minimum_spanning_tree(sp.csr_matrix(d)).toarray()
    np.testing.assert_allclose(float(tt.data[:tt.nnz].sum()), ref.sum(), rtol=1e-5)


def test_mst_disconnected_forest():
    rng = np.random.default_rng(1)
    n = 20
    x = rng.random((n, 2), dtype=np.float32)
    rows, cols, data = [], [], []
    for grp in (range(0, 10), range(10, 20)):
        for i in grp:
            for j in grp:
                if i != j:
                    rows.append(i)
                    cols.append(j)
                    data.append(((x[i] - x[j]) ** 2).sum())
    tt, tc = _same_mst(*_pair(rows, cols, data, n))
    assert tt.nnz == n - 2 and len(np.unique(tc.numpy())) == 2


def test_mst_equal_weights_terminates_with_the_same_tree():
    n = 9
    r, c = np.nonzero(~np.eye(n, dtype=bool))
    tt, _ = _same_mst(*_pair(r, c, np.ones(r.size), n))
    assert tt.nnz == n - 1


def test_mst_padded_graph_with_repeated_weights():
    """Rounded weights (many ties), both directions of every edge (Boruvka
    takes an undirected graph) and padding slots past nnz."""
    rng = np.random.default_rng(2)
    n, m = 60, 250
    r0, c0 = rng.integers(0, n, m), rng.integers(0, n, m)
    w0 = np.round(rng.random(m) * 4) / 4
    rows, cols = np.concatenate([r0, c0, [0] * 30]), np.concatenate([c0, r0, [0] * 30])
    w = np.concatenate([w0, w0, [0.0] * 30])
    jg = JCOO(rows.astype(np.int32), cols.astype(np.int32), w.astype(np.float32), (n, n), 2 * m)
    tg = TCOO(np.asarray(jg.rows), np.asarray(jg.cols), np.asarray(jg.data), (n, n), 2 * m,
              device="cpu")
    _same_mst(jg, tg)


def test_connected_components():
    rows = np.array([0, 1, 3, 7, 9], np.int32)
    cols = np.array([1, 2, 4, 8, 7], np.int32)
    jg, tg = _pair(rows, cols, np.ones(5), 10)
    np.testing.assert_array_equal(tsolver.connected_components(tg).numpy(),
                                  np.asarray(jsolver.connected_components(jg)))


def test_cross_component_nn_matches_raft_tpu():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.random((30, 4), dtype=np.float32) + 10.0 * k for k in range(4)])
    labels = np.repeat(np.arange(4), 30).astype(np.int32)
    je = jsolver.cross_component_nn(x, labels)
    te = tsolver.cross_component_nn(x, labels, res=CPU)
    np.testing.assert_array_equal(te.rows.numpy(), np.asarray(je.rows))
    np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))
    np.testing.assert_allclose(te.data.numpy(), np.asarray(je.data), rtol=1e-5, atol=1e-5)


def test_cross_component_nn_grouping_keeps_the_lowest_index_rule():
    """Two members of a component at the same least distance: the lower
    index wins, as raft_tpu's per-component argmin over sorted members."""
    x = np.array([[0, 0], [1, 0], [0, 5], [1, 5], [3, 0]], np.float32)
    labels = np.array([0, 0, 1, 1, 2], np.int32)
    je = jsolver.cross_component_nn(x, labels)
    te = tsolver.cross_component_nn(x, labels, res=CPU)
    np.testing.assert_array_equal(te.rows.numpy(), np.asarray(je.rows))
    np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))


@pytest.mark.parametrize("n,maximize,seed", [(30, False, 0), (30, True, 1), (64, False, 2)])
def test_linear_assignment_matches_raft_tpu_and_scipy(n, maximize, seed):
    from scipy.optimize import linear_sum_assignment

    cost = np.random.default_rng(seed).random((n, n)).astype(np.float32)
    jp, jt = jla(cost, maximize=maximize)
    tp, tt = tla(cost, maximize=maximize, res=CPU)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    r, c = linear_sum_assignment(cost, maximize=maximize)
    eps = max(1e-7, 1e-4 * float(np.abs(cost).max()) / n)
    assert abs(float(tt) - float(cost[r, c].sum())) <= n * eps + 1e-5


def test_linear_assignment_checks_rounds_in_blocks(monkeypatch):
    """The host reads the unassigned test every few rounds: a check every
    round and one every 7 rounds give the same assignment."""
    cost = np.random.default_rng(4).random((20, 20)).astype(np.float32)
    monkeypatch.setattr(la_mod, "_CHECK_EVERY", 1)
    p1, _ = la_mod.linear_assignment(cost, res=CPU)
    monkeypatch.setattr(la_mod, "_CHECK_EVERY", 7)
    p7, _ = la_mod.linear_assignment(cost, res=CPU)
    assert torch.equal(p1, p7)
    with pytest.raises(ValueError, match="square"):
        tla(cost[:3], res=CPU)
