"""Port parity: the IVF scan plain versions of ``raft_tpu_torch`` against
raft_tpu's Pallas scans (interpret mode) on the same [L, cap, d] lists."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.kernels.ivf_scan import (
    ivf_scan_probe_major as j_probe_major,
    ivf_scan_query_major as j_query_major,
)
from raft_tpu_torch.kernels import ivf_scan as tscan
from raft_tpu_torch.ops import cost

from _torch_parity import assert_topk_match

L, CAP, D = 6, 40, 16


def _lists(seed):
    """Lists with padding slots: list l holds 40 - 5 l real rows (list 5
    is empty past slot 15); padding rows are zeros with norm 0, id -1."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((L, CAP, D)).astype(np.float32)
    ids = np.arange(L * CAP, dtype=np.int32).reshape(L, CAP)
    for l in range(L):
        ids[l, CAP - 5 * l:] = -1
    data[ids < 0] = 0.0
    y2 = np.where(ids >= 0, (data * data).sum(-1), 0.0).astype(np.float32)
    return rng, data, y2, ids


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
def test_probe_major_matches_pallas(metric):
    rng, data, y2, ids = _lists(1)
    B, G, kk = 7, 16, 8
    bl = rng.integers(0, L, B).astype(np.int32)
    qg = rng.standard_normal((B, G, D)).astype(np.float32)
    q2g = (qg * qg).sum(-1).astype(np.float32)
    q2g[:, 11:] = np.inf          # padding queries of partly filled buckets
    q2g[3] = np.inf               # an empty bucket
    ref = j_probe_major(jnp.asarray(bl), jnp.asarray(qg), jnp.asarray(q2g),
                        jnp.asarray(data), jnp.asarray(y2), jnp.asarray(ids), kk,
                        metric=metric, interpret=True)
    got = tscan.ivf_scan_probe_major(
        torch.from_numpy(bl), torch.from_numpy(qg), torch.from_numpy(q2g),
        torch.from_numpy(data), torch.from_numpy(y2), torch.from_numpy(ids), kk,
        metric=metric)
    assert got[0].shape == (B, G, kk) and got[1].dtype == torch.int32
    assert_topk_match(*got, *ref)
    assert (got[1][3] == -1).all() and torch.isinf(got[0][3]).all()


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
def test_query_major_matches_pallas(metric):
    rng, data, y2, ids = _lists(2)
    Q, P, kk = 13, 3, 10   # Q not a multiple of 8: the TPU kernel gets pad rows
    probes = np.stack([rng.permutation(L)[:P] for _ in range(Q)]).astype(np.int32)
    probes[0] = [5, 5, 4]  # a probe set with few real rows, repeats included
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q2 = (q * q).sum(-1).astype(np.float32)
    pad = (-Q) % 8
    ref = j_query_major(
        jnp.asarray(np.pad(probes, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(q, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(q2, (0, pad), constant_values=np.inf)),
        jnp.asarray(data), jnp.asarray(y2), jnp.asarray(ids), kk,
        metric=metric, interpret=True)
    got = tscan.ivf_scan_query_major(
        torch.from_numpy(probes), torch.from_numpy(q), torch.from_numpy(q2),
        torch.from_numpy(data), torch.from_numpy(y2), torch.from_numpy(ids), kk,
        metric=metric)
    assert got[0].shape == (Q, kk)
    assert_topk_match(*got, np.asarray(ref[0])[:Q], np.asarray(ref[1])[:Q])


def test_scan_envelope():
    data = torch.zeros((2, 8, 4))
    assert tscan.scan_supported("sqeuclidean", data, 10)
    assert not tscan.scan_supported("sqeuclidean", data, 129)
    assert not tscan.scan_supported("sqeuclidean", data.to(torch.bfloat16), 10)
    assert not tscan.scan_supported("l1", data, 10)
    with pytest.raises(ValueError):
        tscan.ivf_scan_query_major(
            torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 4)), torch.zeros(1),
            data, torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32), 200)


def test_scan_work_counts_real_rows_of_probed_lists():
    """The scan bound counts 2·d flops per (pair, real row) and reads each
    distinct probed list's real rows once."""
    _, _, _, ids = _lists(3)
    rows = torch.from_numpy((ids >= 0).sum(1))
    probes = torch.tensor([[5, 5, 4], [0, 4, 1]], dtype=torch.int32)
    w = cost.scan_work(probes, rows, D, out_rows=6, kk=8)
    real = [CAP - 5 * l for l in range(L)]
    pair_rows = sum(real[int(p)] for p in probes.reshape(-1))
    assert w.flops == pair_rows * 2 * D
    distinct = real[0] + real[1] + real[4] + real[5]
    assert w.bytes_accessed == distinct * (D * 4 + 8) + 2 * (D + 1) * 4 + 6 * 4 + 6 * 8 * 8
    # raft_tpu's schedule formula charges every step a full list: more work
    raft = cost.ivf_scan_cost(6, 1, CAP, D, 8)
    assert raft.flops > w.flops and raft.bytes_accessed > w.bytes_accessed
