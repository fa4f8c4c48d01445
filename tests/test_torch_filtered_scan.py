"""Port parity of the scans' filter legs: ``pack_list_filter`` /
``pack_list_filter_table`` bitwise against raft_tpu's, and the filtered
plain scans (one plane of words on both schedules; per-query planes with
``query_fid`` on query-major) against raft_tpu's Pallas scans in
interpret mode, on f32, bf16 and int8 rows and three metrics."""

import os
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.kernels import ivf_scan as jscan
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.kernels import ivf_scan as tscan
from raft_tpu_torch.ops import cost

from _torch_parity import assert_topk_match

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

L, CAP, D = 6, 40, 16
DEAD_LIST = 2          # every slot of this list fails every filter below
SCALE = 0.0173         # value of one int8 step


def _lists(seed, storage):
    """Lists with padding (list l holds CAP - 5 l real rows), stored as
    ``storage``; y2 the squared norms of the stored values.  Returns (rng,
    raft_tpu's rows, the port's rows, y2, ids)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((L, CAP, D)).astype(np.float32)
    ids = np.arange(L * CAP, dtype=np.int32).reshape(L, CAP)
    for l in range(L):
        ids[l, CAP - 5 * l:] = -1
    data[ids < 0] = 0.0
    if storage == "int8":
        stored = np.clip(np.rint(data / 0.25), -127, 127).astype(np.int8)
        vals = stored.astype(np.float32) * np.float32(SCALE)
        j_data, t_data = jnp.asarray(stored), torch.from_numpy(stored)
    elif storage == "bfloat16":
        t_data = torch.from_numpy(data).to(torch.bfloat16)
        vals = t_data.to(torch.float32).numpy()
        j_data = jnp.asarray(data).astype(jnp.bfloat16)
    else:
        vals, j_data, t_data = data, jnp.asarray(data), torch.from_numpy(data)
    y2 = np.where(ids >= 0, (vals * vals).sum(-1), 0.0).astype(np.float32)
    return rng, j_data, t_data, y2, ids


def _pass_masks(rng, ids, planes, p=0.5):
    """``planes`` pass masks over the ids [planes, L * CAP]; the ids of
    DEAD_LIST fail in all of them."""
    masks = rng.random((planes, L * CAP)) < p
    masks[:, ids[DEAD_LIST][ids[DEAD_LIST] >= 0]] = False
    return masks


def _pack_both(ids, masks):
    """(raft_tpu's [planes, L, cap_w] uint32 table, the port's int32 one)."""
    j = np.stack([np.asarray(jscan.pack_list_filter(
        jnp.asarray(ids), JBitset.from_mask(jnp.asarray(m)).words)) for m in masks])
    t = tscan.pack_list_filter_table(torch.from_numpy(ids), torch.stack(
        [Bitset.from_mask(m, device="cpu").words for m in masks]))
    return j, t


def test_pack_list_filter_matches_raft_bitwise():
    """cap 40 → two words a list, the second half padding; a filter of fewer
    words than the ids (raft_tpu's clamped gather reads its last word)."""
    _, _, _, _, ids = _lists(0, "float32")
    mask = np.random.default_rng(1).random(L * CAP) < 0.5
    mask[31] = True      # bit 31: the int32 sign bit of word 0
    for n_bits in (L * CAP, 100):
        want = jscan.pack_list_filter(jnp.asarray(ids),
                                      JBitset.from_mask(jnp.asarray(mask[:n_bits])).words)
        got = tscan.pack_list_filter(torch.from_numpy(ids),
                                     Bitset.from_mask(mask[:n_bits], device="cpu").words)
        assert got.dtype == torch.int32 and got.shape == (L, 2)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_pack_list_filter_table_matches_raft_bitwise():
    rng, _, _, _, ids = _lists(2, "float32")
    masks = _pass_masks(rng, ids, 5)
    words = jnp.stack([JBitset.from_mask(jnp.asarray(m)).words for m in masks])
    want = jscan.pack_list_filter_table(jnp.asarray(ids), words)
    got = tscan.pack_list_filter_table(
        torch.from_numpy(ids), torch.from_numpy(np.array(words).view(np.int32)))
    assert got.shape == (5, L, 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    # packed in groups of rows: the same words
    small = tscan._PLAIN_CHUNK_ELEMS
    try:
        tscan._PLAIN_CHUNK_ELEMS = L * CAP * 2
        again = tscan.pack_list_filter_table(torch.from_numpy(ids),
                                             torch.from_numpy(np.array(words).view(np.int32)))
    finally:
        tscan._PLAIN_CHUNK_ELEMS = small
    assert torch.equal(again, got)
    assert bool((got[:, DEAD_LIST] == 0).all())


STORAGE = [("float32", "highest"), ("bfloat16", "bfloat16"), ("int8", "float32")]
METRICS = ["sqeuclidean", "inner_product", "cosine"]


@pytest.mark.parametrize("storage,scan_dtype", STORAGE)
@pytest.mark.parametrize("metric", METRICS)
def test_probe_major_filter_leg_matches_pallas(storage, scan_dtype, metric):
    rng, j_data, t_data, y2, ids = _lists(3, storage)
    B, G, kk = 7, 16, 8
    bl = rng.integers(0, L, B).astype(np.int32)
    bl[0] = DEAD_LIST
    qg = (rng.standard_normal((B, G, D)) * 0.5).astype(np.float32)
    q2g = (qg * qg).sum(-1).astype(np.float32)
    q2g[:, 11:] = np.inf
    j_lf, t_lf = _pack_both(ids, _pass_masks(rng, ids, 1))
    scale = SCALE if storage == "int8" else 1.0
    ref = jscan.ivf_scan_probe_major(
        jnp.asarray(bl), jnp.asarray(qg), jnp.asarray(q2g), j_data, jnp.asarray(y2),
        jnp.asarray(ids), kk, metric=metric, scan_dtype=scan_dtype, list_filter=jnp.asarray(j_lf[0]),
        scan_scale=scale, interpret=True)
    got = tscan.ivf_scan_probe_major(
        torch.from_numpy(bl), torch.from_numpy(qg), torch.from_numpy(q2g), t_data,
        torch.from_numpy(y2), torch.from_numpy(ids), kk, metric=metric, scan_dtype=scan_dtype,
        scan_scale=scale, list_filter=t_lf[0])
    assert_topk_match(*got, *ref)
    # the bucket of the list whose slots all fail: +inf / -1
    assert torch.isinf(got[0][0]).all() and (got[1][0] == -1).all()
    assert bool(torch.isfinite(got[0][torch.from_numpy(bl != DEAD_LIST)][:, :11, 0]).all())


def _qm_inputs(rng, Q=13, P=3):
    probes = np.stack([rng.permutation(L)[:P] for _ in range(Q)]).astype(np.int32)
    probes[0] = DEAD_LIST            # a query whose probes all fail
    q = (rng.standard_normal((Q, D)) * 0.5).astype(np.float32)
    return probes, q, (q * q).sum(-1).astype(np.float32)


def _qm_ref(probes, q, q2, j_data, y2, ids, kk, **kw):
    """raft_tpu's query-major scan (its Q must be a multiple of 8: padding
    rows with q2 = +inf), cut back to Q rows."""
    Q = probes.shape[0]
    pad = (-Q) % 8
    fid = kw.pop("query_fid", None)
    if fid is not None:
        kw["query_fid"] = jnp.asarray(np.pad(fid, (0, pad)))
    v, i = jscan.ivf_scan_query_major(
        jnp.asarray(np.pad(probes, ((0, pad), (0, 0)))), jnp.asarray(np.pad(q, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(q2, (0, pad), constant_values=np.inf)), j_data, jnp.asarray(y2),
        jnp.asarray(ids), kk, interpret=True, **kw)
    return np.asarray(v)[:Q], np.asarray(i)[:Q]


@pytest.mark.parametrize("storage,scan_dtype", STORAGE)
@pytest.mark.parametrize("metric", METRICS)
def test_query_major_filter_leg_matches_pallas(storage, scan_dtype, metric):
    rng, j_data, t_data, y2, ids = _lists(4, storage)
    probes, q, q2 = _qm_inputs(rng)
    j_lf, t_lf = _pack_both(ids, _pass_masks(rng, ids, 1))
    scale = SCALE if storage == "int8" else 1.0
    kk = 10
    ref = _qm_ref(probes, q, q2, j_data, y2, ids, kk, metric=metric, scan_dtype=scan_dtype,
                  scan_scale=scale, list_filter=jnp.asarray(j_lf[0]))
    got = tscan.ivf_scan_query_major(
        torch.from_numpy(probes), torch.from_numpy(q), torch.from_numpy(q2), t_data,
        torch.from_numpy(y2), torch.from_numpy(ids), kk, metric=metric, scan_dtype=scan_dtype,
        scan_scale=scale, list_filter=t_lf[0])
    assert_topk_match(*got, *ref)
    assert torch.isinf(got[0][0]).all() and (got[1][0] == -1).all()


@pytest.mark.parametrize("storage,scan_dtype", STORAGE)
@pytest.mark.parametrize("metric", METRICS)
def test_query_fid_leg_matches_pallas(storage, scan_dtype, metric):
    """Each query scans with its own plane of a 4-plane table; query 0's
    probes all fail in every plane."""
    rng, j_data, t_data, y2, ids = _lists(5, storage)
    probes, q, q2 = _qm_inputs(rng)
    j_lf, t_lf = _pack_both(ids, _pass_masks(rng, ids, 4, p=0.4))
    fid = rng.integers(0, 4, probes.shape[0]).astype(np.int32)
    scale = SCALE if storage == "int8" else 1.0
    kk = 10
    ref = _qm_ref(probes, q, q2, j_data, y2, ids, kk, metric=metric, scan_dtype=scan_dtype,
                  scan_scale=scale, list_filter=jnp.asarray(j_lf), query_fid=fid)
    got = tscan.ivf_scan_query_major(
        torch.from_numpy(probes), torch.from_numpy(q), torch.from_numpy(q2), t_data,
        torch.from_numpy(y2), torch.from_numpy(ids), kk, metric=metric, scan_dtype=scan_dtype,
        scan_scale=scale, list_filter=t_lf, query_fid=torch.from_numpy(fid))
    assert_topk_match(*got, *ref)
    assert torch.isinf(got[0][0]).all() and (got[1][0] == -1).all()
    # the planes differ: one plane for every query gives other results
    one = tscan.ivf_scan_query_major(
        torch.from_numpy(probes), torch.from_numpy(q), torch.from_numpy(q2), t_data,
        torch.from_numpy(y2), torch.from_numpy(ids), kk, metric=metric, scan_dtype=scan_dtype,
        scan_scale=scale, list_filter=t_lf[0])
    assert not torch.equal(one[1], got[1])


def test_filter_leg_names_and_shape_checks():
    data = torch.zeros((L, CAP, D))
    words = torch.zeros((L, 2), dtype=torch.int32)
    table = torch.zeros((3, L, 2), dtype=torch.int32)
    assert tscan.kernel_name("probe_major", data, words) == "ivf_scan_probe_major_filt"
    assert tscan.kernel_name("query_major", data.to(torch.int8), table,
                             torch.zeros(4)) == "ivf_scan_query_major_int8_fid"
    assert tscan.kernel_name("query_major", data.to(torch.bfloat16),
                             words) == "ivf_scan_query_major_bf16_filt"
    ids = torch.zeros((L, CAP), dtype=torch.int32)
    args = (torch.zeros((4, 2), dtype=torch.int32), torch.zeros((4, D)), torch.zeros(4),
            data, torch.zeros((L, CAP)), ids, 5)
    with pytest.raises(ValueError, match="n_lists, cap_w"):
        tscan.ivf_scan_query_major(*args, list_filter=torch.zeros((L, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        tscan.ivf_scan_query_major(*args, list_filter=words.to(torch.int64))
    with pytest.raises(ValueError, match="query_fid needs"):
        tscan.ivf_scan_query_major(*args, list_filter=words,
                                   query_fid=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="query_fid must be"):
        tscan.ivf_scan_query_major(*args, list_filter=table,
                                   query_fid=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs a list_filter"):
        tscan.ivf_scan_query_major(*args, query_fid=torch.zeros(4, dtype=torch.int32))


def test_scan_work_charges_the_filter_words():
    """Filter words: cap_w words of each distinct probed list, or with
    query_fid of each distinct (plane, list) pair, plus the fids."""
    rows = torch.full((L,), 30)
    probes = torch.tensor([[1, 2], [2, 1], [1, 3]])
    base = cost.scan_work(probes, rows, D, 3, 8)
    one = cost.scan_work(probes, rows, D, 3, 8, cap_w=2)
    assert one.bytes_accessed - base.bytes_accessed == 3 * 2 * 4
    fid = cost.scan_work(probes, rows, D, 3, 8, cap_w=2, query_fid=torch.tensor([0, 0, 1]))
    # pairs (0, 1), (0, 2), (1, 1), (1, 3)
    assert fid.bytes_accessed - base.bytes_accessed == 4 * 2 * 4 + 3 * 4
    assert one.flops == base.flops
    raft = cost.ivf_scan_cost(6, 1, CAP, D, 8, cap_w=2)
    assert raft.bytes_accessed - cost.ivf_scan_cost(6, 1, CAP, D, 8).bytes_accessed == 6 * 2 * 4
