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


SCALE = 0.0173  # value of one int8 step of the int8 lists below


def _stored_lists(seed, storage):
    """``_lists`` stored as ``storage`` ("bfloat16", or "int8" values
    rint(x / 0.25) clipped to ±127, one step worth SCALE), with y2 the
    squared norms of the stored values, as ivf_pq's decode keeps them."""
    rng, data, _, ids = _lists(seed)
    if storage == "int8":
        stored = np.clip(np.rint(data / 0.25), -127, 127).astype(np.int8)
        vals = stored.astype(np.float32) * np.float32(SCALE)
        j_data, t_data = jnp.asarray(stored), torch.from_numpy(stored)
    else:
        t_data = torch.from_numpy(data).to(torch.bfloat16)
        vals = t_data.to(torch.float32).numpy()
        j_data = jnp.asarray(data).astype(jnp.bfloat16)
    y2 = np.where(ids >= 0, (vals * vals).sum(-1), 0.0).astype(np.float32)
    return rng, j_data, t_data, y2, ids


# the three storage legs of _score_against_list: bf16 rows with f32 or bf16
# products, int8 rows (scan_dtype ignored)
LEGS = [("bfloat16", "float32"), ("bfloat16", "bfloat16"), ("int8", "float32")]


@pytest.mark.parametrize("storage,scan_dtype", LEGS)
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_probe_major_storage_legs_match_pallas(storage, scan_dtype, metric):
    rng, j_data, t_data, y2, ids = _stored_lists(4, storage)
    B, G, kk = 7, 16, 8
    bl = rng.integers(0, L, B).astype(np.int32)
    qg = (rng.standard_normal((B, G, D)) * 0.1).astype(np.float32)
    q2g = (qg * qg).sum(-1).astype(np.float32)
    q2g[:, 11:] = np.inf
    scale = SCALE if storage == "int8" else 1.0
    ref = j_probe_major(jnp.asarray(bl), jnp.asarray(qg), jnp.asarray(q2g), j_data,
                        jnp.asarray(y2), jnp.asarray(ids), kk, metric=metric,
                        scan_dtype=scan_dtype, scan_scale=scale, interpret=True)
    got = tscan.ivf_scan_probe_major(
        torch.from_numpy(bl), torch.from_numpy(qg), torch.from_numpy(q2g), t_data,
        torch.from_numpy(y2), torch.from_numpy(ids), kk, metric=metric,
        scan_dtype=scan_dtype, scan_scale=scale)
    assert_topk_match(*got, *ref, atol=1e-4)


@pytest.mark.parametrize("storage,scan_dtype", LEGS)
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_query_major_storage_legs_match_pallas(storage, scan_dtype, metric):
    rng, j_data, t_data, y2, ids = _stored_lists(5, storage)
    Q, P, kk = 13, 3, 10
    probes = np.stack([rng.permutation(L)[:P] for _ in range(Q)]).astype(np.int32)
    q = (rng.standard_normal((Q, D)) * 0.1).astype(np.float32)
    q2 = (q * q).sum(-1).astype(np.float32)
    pad = (-Q) % 8
    scale = SCALE if storage == "int8" else 1.0
    ref = j_query_major(
        jnp.asarray(np.pad(probes, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(q, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(q2, (0, pad), constant_values=np.inf)),
        j_data, jnp.asarray(y2), jnp.asarray(ids), kk, metric=metric,
        scan_dtype=scan_dtype, scan_scale=scale, interpret=True)
    got = tscan.ivf_scan_query_major(
        torch.from_numpy(probes), torch.from_numpy(q), torch.from_numpy(q2), t_data,
        torch.from_numpy(y2), torch.from_numpy(ids), kk, metric=metric,
        scan_dtype=scan_dtype, scan_scale=scale)
    assert_topk_match(*got, np.asarray(ref[0])[:Q], np.asarray(ref[1])[:Q], atol=1e-4)


def test_quantize_queries_i8_bitwise_with_raft():
    from raft_tpu.kernels.toolkit import quantize_queries_i8 as j_quantize
    from raft_tpu_torch.kernels.toolkit import quantize_queries_i8

    rng = np.random.default_rng(6)
    for spread in (1e-3, 1.0, 300.0):
        q = (rng.standard_normal((500, 37)) * spread).astype(np.float32)
        q[0] = 0.0                                     # the 1e-12 scale floor
        q[1, :4] = [127.5, -127.5, 0.5, 1.5]           # ties round half to even
        j_q, j_s = j_quantize(jnp.asarray(q))
        t_q, t_s = quantize_queries_i8(torch.from_numpy(q))
        assert t_q.dtype == torch.int8
        np.testing.assert_array_equal(t_q.numpy(), np.asarray(j_q))
        np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))


def test_scan_envelope():
    data = torch.zeros((2, 8, 4))
    assert tscan.scan_supported("sqeuclidean", data, 10)
    assert not tscan.scan_supported("sqeuclidean", data, 129)
    assert tscan.scan_supported("sqeuclidean", data.to(torch.bfloat16), 10)
    assert tscan.scan_supported("sqeuclidean", data.to(torch.int8), 10)
    assert not tscan.scan_supported("sqeuclidean", data.to(torch.float16), 10)
    assert not tscan.scan_supported("l1", data, 10)
    assert tscan.kernel_name("probe_major", data.to(torch.int8)) == "ivf_scan_probe_major_int8"
    assert tscan.kernel_name("query_major", data) == "ivf_scan_query_major"
    args = (torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 4)), torch.zeros(1),
            data, torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        tscan.ivf_scan_query_major(*args, 200)
    with pytest.raises(ValueError):
        tscan.ivf_scan_query_major(*args, 4, scan_dtype="float16")
    wide = torch.zeros((2, 8, 1041), dtype=torch.int8)  # past the exact f32 sum
    with pytest.raises(ValueError):
        tscan.ivf_scan_query_major(args[0], torch.zeros((1, 1041)), torch.zeros(1), wide,
                                   args[4], args[5], 4)


def _scan_work(itemsize=4, compute="float32"):
    _, _, _, ids = _lists(3)
    rows = torch.from_numpy((ids >= 0).sum(1))
    probes = torch.tensor([[5, 5, 4], [0, 4, 1]], dtype=torch.int32)
    real = [CAP - 5 * l for l in range(L)]
    pair_rows = sum(real[int(p)] for p in probes.reshape(-1))
    distinct = real[0] + real[1] + real[4] + real[5]
    w = cost.scan_work(probes, rows, D, out_rows=6, kk=8, itemsize=itemsize, compute=compute)
    return w, pair_rows, distinct


def test_scan_work_counts_real_rows_of_probed_lists():
    """The scan bound counts 2·d flops per (pair, real row) and reads each
    distinct probed list's real rows once."""
    w, pair_rows, distinct = _scan_work()
    assert w.flops == pair_rows * 2 * D
    assert w.bytes_accessed == distinct * (D * 4 + 8) + 2 * (D + 1) * 4 + 6 * 4 + 6 * 8 * 8
    # raft_tpu's schedule formula charges every step a full list: more work
    raft = cost.ivf_scan_cost(6, 1, CAP, D, 8)
    assert raft.flops > w.flops and raft.bytes_accessed > w.bytes_accessed


@pytest.mark.parametrize("itemsize,compute", [(4, "float32"), (2, "bfloat16"), (1, "int8")])
def test_scan_work_charges_stored_width_and_the_legs_rate(itemsize, compute):
    """bf16 and int8 rows are read at their stored width; the operations
    bound takes the peak rate of the arithmetic the leg needs."""
    w, pair_rows, distinct = _scan_work(itemsize, compute)
    assert w.flops == pair_rows * 2 * D and w.compute == compute
    assert w.bytes_accessed == (distinct * (D * itemsize + 8) + 2 * (D + 1) * 4 + 6 * 4
                                + 6 * 8 * 8)
    heavy = cost.KernelCost(w.flops * 10**9, w.bytes_accessed, compute)
    ms, by = cost.bound_ms(heavy)
    assert by == "operations"
    assert ms == pytest.approx(heavy.flops / cost.H100_PEAK_OPS[compute] * 1e3)
    assert cost.H100_PEAK_OPS["float32"] < cost.H100_PEAK_OPS["bfloat16"] < cost.H100_PEAK_OPS["int8"]
