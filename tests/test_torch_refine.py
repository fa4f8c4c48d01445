"""Port parity of refine: exact re-ranking of candidate ids matches
raft_tpu's ``refine`` on the device path and the host path, and lifts an
IVF-PQ search's recall."""

import os
import numpy as np
import pytest
import torch

from raft_tpu.neighbors.refine import refine as j_refine
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import refine as trefine
from raft_tpu_torch.stats.metrics import recall_at_k

from _torch_parity import assert_topk_match

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _problem(seed, n=2000, d=24, n_q=300, kprime=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((n_q, d)).astype(np.float32)
    cand = np.stack([rng.permutation(n)[:kprime] for _ in range(n_q)]).astype(np.int32)
    cand[::7, -5:] = -1          # underfull candidate lists
    cand[3, :] = -1              # a query with no candidate at all
    return x, q, cand


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine"])
@pytest.mark.parametrize("host", [False, True])
def test_refine_matches_raft(metric, host):
    x, q, cand = _problem(0)
    v_ref, i_ref = j_refine(x, q, cand, 10, metric=metric, host=host)
    v, i = trefine.refine(torch.from_numpy(x) if not host else x, q, cand, 10, metric=metric,
                          host=host, res=CPU)
    assert v.dtype == torch.float32 and i.dtype == torch.int32 and v.shape == (300, 10)
    assert_topk_match(v, i, v_ref, i_ref, rtol=1e-5, atol=1e-5)
    assert (i[3] == -1).all() and torch.isinf(v[3]).all()
    assert (i[torch.arange(300) != 3] >= 0).all()   # 35+ real candidates elsewhere


def test_negative_ids_score_inf_and_k_bound():
    x, q, cand = _problem(1, n_q=8)
    cand[:, 2:] = -1
    v, i = trefine.refine(x, q, cand, 4, res=CPU)
    assert (i[:, 2:] == -1).all() and torch.isinf(v[:, 2:]).all()
    assert torch.isfinite(v[torch.arange(8) != 3, :2]).all()   # row 3 has no candidate
    with pytest.raises(ValueError):
        trefine.refine(x, q, cand, 41, res=CPU)


def test_query_tiles_give_the_same_result(monkeypatch):
    x, q, cand = _problem(2)
    whole = trefine.refine(x, q, cand, 10, res=CPU)
    monkeypatch.setattr(trefine, "_REFINE_TILE_BYTES", 40 * 24 * 4 * 16)   # 16-query tiles
    assert trefine._refine_query_tile(300, 40, 24) == 16
    tiled = trefine.refine(x, q, cand, 10, res=CPU)
    assert torch.equal(whole[0], tiled[0]) and torch.equal(whole[1], tiled[1])


def test_refine_lifts_ivf_pq_recall():
    rng = np.random.default_rng(3)
    centers = (rng.random((24, 32)).astype(np.float32) - 0.5) * 6
    x = (centers[rng.integers(0, 24, 3000)] + rng.standard_normal((3000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 200)] + rng.standard_normal((200, 32))).astype(np.float32)
    gt = np.argsort(((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    idx = tpq.build(tpq.IndexParams(n_lists=16, pq_dim=8, kmeans_n_iters=5), x, res=CPU)
    sp = tpq.SearchParams(n_probes=6)
    _, i10 = tpq.search(sp, idx, q, 10, res=CPU)
    _, i40 = tpq.search(sp, idx, q, 40, res=CPU)
    v, i = trefine.refine(x, q, i40, 10, res=CPU)
    r_pq, r_ref = recall_at_k(i10, gt), recall_at_k(i, gt)
    assert r_ref >= r_pq and r_ref >= 0.9, (r_pq, r_ref)
    exact = ((q[:, None, :] - x[i.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(v.numpy(), exact, rtol=1e-4, atol=1e-4)
