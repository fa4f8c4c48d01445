"""Port parity: the IVF scan plain versions of ``raft_tpu_torch`` against
raft_tpu's Pallas scans (interpret mode) on the same [L, cap, d] lists."""

import os
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

from _torch_parity import assert_topk_match, paged_lists

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

L, CAP, D = 6, 40, 16


def _lists(seed, cap=CAP):
    """Lists with padding slots: list l holds cap - 5 l real rows (at the
    default cap, list 5 is empty past slot 15); padding rows are zeros with
    norm 0, id -1."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((L, cap, D)).astype(np.float32)
    ids = np.arange(L * cap, dtype=np.int32).reshape(L, cap)
    for l in range(L):
        ids[l, cap - 5 * l:] = -1
    data[ids < 0] = 0.0
    y2 = np.where(ids >= 0, (data * data).sum(-1), 0.0).astype(np.float32)
    return rng, data, y2, ids


# kk 129 and 258: past the kernels' former 128 (CAGRA's graph build scans at
# kk 258); the lists then hold fewer real rows than kk, so the tails are +inf
@pytest.mark.parametrize("kk", [8, 129, 258])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
def test_probe_major_matches_pallas(metric, kk):
    rng, data, y2, ids = _lists(1, CAP if kk <= CAP else kk + 8)
    B, G = 7, 16
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


@pytest.mark.parametrize("kk", [10, 129, 258])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
def test_query_major_matches_pallas(metric, kk):
    rng, data, y2, ids = _lists(2, CAP if kk <= CAP else 96)
    Q, P = 13, 3   # Q not a multiple of 8: the TPU kernel gets pad rows
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


@pytest.mark.parametrize("schedule", ["probe_major", "query_major"])
def test_kk_past_the_rows_scanned_pads_like_pallas(schedule):
    """kk 60 over lists of 40 slots (probe-major scans cap, query-major one
    probe: P * cap): [.., kk] with +inf / -1 tails, as raft_tpu returns."""
    rng, data, y2, ids = _lists(4)
    kk = 60
    lists = [jnp.asarray(data), jnp.asarray(y2), jnp.asarray(ids)]
    t_lists = [torch.from_numpy(a) for a in (data, y2, ids)]
    if schedule == "probe_major":
        bl = rng.integers(0, L, 5).astype(np.int32)
        qg = rng.standard_normal((5, 8, D)).astype(np.float32)
        q2g = (qg * qg).sum(-1).astype(np.float32)
        ref = j_probe_major(jnp.asarray(bl), jnp.asarray(qg), jnp.asarray(q2g), *lists, kk,
                            interpret=True)
        got = tscan.ivf_scan_probe_major(torch.from_numpy(bl), torch.from_numpy(qg),
                                         torch.from_numpy(q2g), *t_lists, kk)
        assert got[0].shape == (5, 8, kk)
    else:
        probes = rng.integers(0, L, (8, 1)).astype(np.int32)
        q = rng.standard_normal((8, D)).astype(np.float32)
        q2 = (q * q).sum(-1).astype(np.float32)
        ref = j_query_major(jnp.asarray(probes), jnp.asarray(q), jnp.asarray(q2), *lists, kk,
                            interpret=True)
        got = tscan.ivf_scan_query_major(torch.from_numpy(probes), torch.from_numpy(q),
                                         torch.from_numpy(q2), *t_lists, kk)
        assert got[0].shape == (8, kk)
    assert torch.isinf(got[0][..., CAP:]).all() and (got[1][..., CAP:] == -1).all()
    assert_topk_match(*got, *ref)


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


# The float legs' kernel scores 64 queries x 128 slots a tile over chunks of
# 32 dimensions: widths that leave a partial chunk (100) and rows whose
# width in bytes is no multiple of 16 (f32 at 97: 388 bytes; bf16 at 100:
# 200, at 97: 194), G = 70 (a second block of 6 queries), cap = 200 (a
# partial second tile), 8-row pages, a filter, and kk in each fold class
# (lists in registers to 32, in shared memory to 128, candidate arrays past).
TILE_EDGES = [("float32", 100, False, False, 10), ("float32", 97, True, False, 40),
              ("bfloat16", 100, False, True, 10), ("bfloat16", 97, True, False, 129),
              ("float32", 97, True, True, 129)]


@pytest.mark.parametrize("storage,d,paged,filtered,kk", TILE_EDGES)
def test_probe_major_tile_edges_match_pallas(storage, d, paged, filtered, kk):
    rng = np.random.default_rng(d + kk)
    n_lists, cap, B, G = 4, 200, 5, 70
    data = rng.standard_normal((n_lists, cap, d)).astype(np.float32)
    ids = np.arange(n_lists * cap, dtype=np.int32).reshape(n_lists, cap)
    ids[1, 150:] = -1
    ids[3, 60:] = -1
    data[ids < 0] = 0.0
    t_data = torch.from_numpy(data).to(getattr(torch, storage))
    vals = t_data.to(torch.float32).numpy()
    y2 = np.where(ids >= 0, (vals * vals).sum(-1), 0.0).astype(np.float32)
    bl = rng.integers(0, n_lists, B).astype(np.int32)
    qg = (rng.standard_normal((B, G, d)) * 0.5).astype(np.float32)
    q2g = (qg * qg).sum(-1).astype(np.float32)
    q2g[:, 67:] = np.inf
    q2g[2] = np.inf
    words = None
    if filtered:   # bit j of word w: slot 32 w + j passes; padding slots fail
        bits = (rng.random((n_lists, cap)) < 0.6) & (ids >= 0)
        bits = np.pad(bits, ((0, 0), (0, -cap % 32))).reshape(n_lists, -1, 32)
        words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(
            np.uint32)
    kw = dict(metric="sqeuclidean", scan_dtype="float32" if storage == "bfloat16" else "highest")
    ref = j_probe_major(jnp.asarray(bl), jnp.asarray(qg), jnp.asarray(q2g),
                        jnp.asarray(data).astype(getattr(jnp, storage)), jnp.asarray(y2),
                        jnp.asarray(ids), kk, interpret=True,
                        list_filter=None if words is None else jnp.asarray(words), **kw)
    args = (torch.from_numpy(bl), torch.from_numpy(qg), torch.from_numpy(q2g))
    lists = (torch.from_numpy(y2), torch.from_numpy(ids), kk)
    t_kw = dict(kw, list_filter=None if words is None else torch.from_numpy(words.view(np.int32)))
    got = tscan.ivf_scan_probe_major(*args, t_data, *lists, **t_kw)
    assert got[0].shape == (B, G, kk)
    assert_topk_match(*got, *ref, atol=1e-4)
    if paged:   # bitwise the monolithic plain scan on the same rows
        pv, pi = tscan.ivf_scan_probe_major(*args, paged_lists(t_data, 8, d), *lists, **t_kw)
        assert torch.equal(pv, got[0]) and torch.equal(pi, got[1])


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
    assert tscan.scan_supported("sqeuclidean", data, 2048)
    assert not tscan.scan_supported("sqeuclidean", data, 2049)
    assert tscan.scan_supported("sqeuclidean", data.to(torch.uint8), 10)
    assert tscan.scan_supported("sqeuclidean", data.to(torch.bfloat16), 10)
    assert tscan.scan_supported("sqeuclidean", data.to(torch.int8), 10)
    assert not tscan.scan_supported("sqeuclidean", data.to(torch.float16), 10)
    assert not tscan.scan_supported("l1", data, 10)
    assert tscan.kernel_name("probe_major", data.to(torch.int8)) == "ivf_scan_probe_major_int8"
    assert tscan.kernel_name("query_major", data) == "ivf_scan_query_major"
    # raw 8-bit rows (IVF-Flat's 8-bit lists): scan_scale None for int8
    assert tscan.kernel_name("query_major", data.to(torch.uint8)) == "ivf_scan_query_major_u8"
    assert (tscan.kernel_name("probe_major", data.to(torch.int8), scan_scale=None)
            == "ivf_scan_probe_major_s8")
    args = (torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 4)), torch.zeros(1),
            data, torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="kk<=2048"):
        tscan.ivf_scan_query_major(*args, 2049)
    with pytest.raises(ValueError):
        tscan.ivf_scan_query_major(*args, 4, scan_dtype="float16")
    wide = torch.zeros((2, 8, 1041), dtype=torch.int8)  # past the exact f32 sum
    with pytest.raises(ValueError):
        tscan.ivf_scan_query_major(args[0], torch.zeros((1, 1041)), torch.zeros(1), wide,
                                   args[4], args[5], 4)


@pytest.mark.parametrize("B,G,kk", [(1880, 256, 10), (1880, 256, 128), (1880, 256, 129),
                                    (1880, 256, 258), (1, 1, 258), (3, 70, 1000),
                                    (20, 40, 2048)])
def test_probe_major_workspace_is_no_larger_than_the_outputs(B, G, kk):
    """Past kk = 128 each (bucket, query) of a probe-major launch has a
    candidate array of its output row and a workspace row: room for a
    64-slot tile beyond kk, and never more bytes than the outputs [B, G,
    kk]; up to kk = 128 the lists need no workspace."""
    shape = tscan.probe_major_workspace(B, G, kk)
    if kk <= 128:
        assert shape == (0, 0, 0)
        return
    assert shape[:2] == (B, G) and 64 <= shape[2] <= kk
    assert np.prod(shape) <= B * G * kk


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


@pytest.mark.parametrize("k", [600, 2048])
@pytest.mark.parametrize("strategy", ["query_major", "probe_major"])
def test_ivf_flat_search_past_512_matches_raft_tpu(k, strategy, tmp_path):
    """k past the kernels' former 512, to the new 2048: the port's search
    (plain versions on the CPU) of an index raft_tpu built and saved, against
    raft_tpu's own search of it (its XLA leg, which takes any k)."""
    from raft_tpu.neighbors import ivf_flat as jivf
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_flat as tivf

    rng = np.random.default_rng(12)
    x = rng.standard_normal((5000, 8)).astype(np.float32)
    q = rng.standard_normal((9, 8)).astype(np.float32)
    jidx = jivf.build(jivf.IndexParams(n_lists=4, kmeans_n_iters=3), x)
    path = str(tmp_path / "ivf")
    jivf.save(path, jidx)
    idx = tivf.load(path, res=Resources(device="cpu"))
    assert 4 * idx.list_cap > k
    jv, ji = jivf.search(jivf.SearchParams(n_probes=4, strategy=strategy), jidx, q, k)
    tv, ti = tivf.search(tivf.SearchParams(n_probes=4, strategy=strategy), idx, q, k,
                         res=Resources(device="cpu"))
    assert tv.shape == (9, k)
    assert_topk_match(tv, ti, jv, ji)


# kk past 128 with the probes cut into parts, as a small batch runs on the
# card: each part's top-kk, then the merge (merge_parts past k = 128 is a
# radix select + sort on the card); lists shorter than kk give +inf tails
@pytest.mark.parametrize("kk,splits", [(150, 2), (150, 3), (200, 5), (10, 3)])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_query_major_split_parts_equal_unsplit_and_pallas(metric, kk, splits):
    rng, data, y2, ids = _lists(7, 64)
    data[1, 10:20] = data[1, 0]          # repeated rows: ties broken by position
    data[2, :6] = 0.0                    # zero rows: inner product scores -0.0
    y2 = np.where(ids >= 0, (data * data).sum(-1), 0.0).astype(np.float32)
    Q, P = 11, 5
    probes = np.stack([rng.permutation(L)[:P] for _ in range(Q)]).astype(np.int32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q2 = (q * q).sum(-1).astype(np.float32)
    args = [torch.from_numpy(a) for a in (probes, q, q2, data, y2, ids)]
    whole = tscan.ivf_scan_query_major(*args, kk, metric=metric)
    chunk, n_parts = tscan.query_major_parts(P, splits)
    assert n_parts > 1
    outs = [tscan.ivf_scan_query_major(args[0][:, s:s + chunk], *args[1:], kk, metric=metric)
            for s in range(0, P, chunk)]
    parts = tscan.merge_parts_torch(torch.cat([o[0] for o in outs], dim=1),
                                    torch.cat([o[1] for o in outs], dim=1), kk)
    assert torch.equal(parts[0].view(torch.int32), whole[0].view(torch.int32))
    assert torch.equal(parts[1], whole[1])
    assert bool(torch.isinf(whole[0][:, -1]).all()) == (kk > P * 64 - 25)
    pad = (-Q) % 8
    ref = j_query_major(
        jnp.asarray(np.pad(probes, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(q, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(q2, (0, pad), constant_values=np.inf)),
        *(jnp.asarray(a) for a in (data, y2, ids)), kk, metric=metric, interpret=True)
    assert_topk_match(*parts, np.asarray(ref[0])[:Q], np.asarray(ref[1])[:Q])


def test_merge_parts_plain_keeps_value_then_pool_order():
    """Two sorted parts of 4 with ties across them and +inf tails: the
    earlier part wins a tie, +inf never enters."""
    inf = float("inf")
    pv = torch.tensor([[0.0, 1.0, 2.0, inf, -0.0, 1.0, 1.5, inf]])
    pi = torch.tensor([[10, 11, 12, -1, 20, 21, 22, -1]], dtype=torch.int32)
    v, i = tscan.merge_parts_torch(pv, pi, 6)
    assert v[0].tolist() == [0.0, 0.0, 1.0, 1.0, 1.5, 2.0]
    assert i.tolist() == [[10, 20, 11, 21, 22, 12]]
    v, i = tscan.merge_parts_torch(pv, pi, 8)
    assert i[0, 6:].tolist() == [-1, -1] and bool(torch.isinf(v[0, 6:]).all())
