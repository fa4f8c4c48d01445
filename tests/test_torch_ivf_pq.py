"""Port parity of IVF-PQ: a raft_tpu-built index saved and loaded into
``raft_tpu_torch`` decodes the same scan cache and searches like raft_tpu's
fused (Pallas, interpret mode) legs on every storage leg; encode agrees on
injected state; the port's own build reaches raft_tpu's recall; extend
appends in place or repacks."""

import numpy as np
import pytest
import torch

from raft_tpu import kernels as jkernels
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import kernels
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.stats.metrics import recall_at_k

from _torch_parity import assert_topk_match

CPU = Resources(device="cpu")
N, D, N_Q = 3000, 32, 512
BUILD = dict(n_lists=16, pq_dim=16, kmeans_n_iters=4)


def _blobs(n, d, n_q, seed, n_centers=24):
    """Gaussian blobs near the origin, so |y|^2 stays of the order of the
    distances and rtol 1e-5 measures summation order."""
    rng = np.random.default_rng(seed)
    centers = (rng.random((n_centers, d)).astype(np.float32) - 0.5) * 6
    x = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, n_centers, n_q)] + rng.standard_normal((n_q, d)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _blobs(N, D, N_Q, 0)


_BUILT = {}


def _raft_index(x, metric="sqeuclidean", codebook_kind="per_subspace", dtype="bfloat16"):
    """raft_tpu's index for (metric, codebook_kind) with its scan cache
    decoded at ``dtype`` as raft_tpu's ``load`` decodes it; built once per
    (metric, codebook_kind)."""
    key = (metric, codebook_kind)
    if key not in _BUILT:
        _BUILT[key] = jpq.build(jpq.IndexParams(
            metric=metric, codebook_kind=codebook_kind, force_random_rotation=True,
            **BUILD), x)
    j = _BUILT[key]
    if dtype == "bfloat16":
        return j
    data, y2, scale = jpq._decode_lists(
        np.asarray(j.codebook), j.codebook_kind, np.asarray(j.centers_rot),
        np.asarray(j.list_codes), np.asarray(j.list_index), jpq._DECODED_DTYPES[dtype])
    return jpq.Index(j.metric, j.codebook_kind, j.pq_bits, j.centers, j.centers_rot,
                     j.rotation, j.codebook, j.list_codes, j.list_index, j.list_sizes,
                     data, y2, scale, headroom=j.headroom)


def _to_port(jidx, tmp_path):
    """Save with raft_tpu, load into the port (the scan cache is rebuilt
    from the codes at the saved storage type)."""
    path = str(tmp_path / "ivf_pq.idx")
    jpq.save(path, jidx)
    return tpq.load(path, res=CPU)


@pytest.mark.parametrize("codebook_kind", ["per_subspace", "per_cluster"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_decode_matches_raft(data, codebook_kind, dtype, tmp_path):
    jidx = _raft_index(data[0], codebook_kind=codebook_kind, dtype=dtype)
    tidx = _to_port(jidx, tmp_path)
    assert tidx.decoded_dtype == dtype and tidx.list_cap == jidx.list_cap
    np.testing.assert_array_equal(tidx.list_codes.numpy(), np.asarray(jidx.list_codes))
    np.testing.assert_array_equal(tidx.list_index.numpy(), np.asarray(jidx.list_index))
    # raft_tpu keeps scan_scale as a float64 Python float; so does the port
    assert tidx.scan_scale == jidx.scan_scale
    got = tidx.list_data.view(torch.int16) if dtype == "bfloat16" else tidx.list_data
    ref = np.asarray(jidx.list_data)
    ref = ref.view(np.int16) if dtype == "bfloat16" else ref
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(tidx.list_y2.numpy(), np.asarray(jidx.list_y2), rtol=1e-6)


@pytest.mark.parametrize("codebook_kind", ["per_subspace", "per_cluster"])
def test_encode_matches_raft_on_injected_state(data, codebook_kind, tmp_path):
    x = data[0]
    jidx = _raft_index(x, codebook_kind=codebook_kind)
    tidx = _to_port(jidx, tmp_path)
    labels = np.array(jpq.kmeans_balanced.predict(jidx.centers, x))
    ref = np.asarray(jpq._encode(jidx.rotation, jidx.centers, jidx.centers_rot, jidx.codebook,
                                 x, labels, codebook_kind))
    got = tpq._encode(tidx.rotation, tidx.centers, tidx.codebook, torch.from_numpy(x),
                      torch.from_numpy(labels), codebook_kind)
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    assert (got.numpy() == ref).mean() >= 0.999


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
@pytest.mark.parametrize("dtype,lut_dtype", [
    ("bfloat16", "float32"), ("bfloat16", "bfloat16"), ("int8", "float32")])
def test_search_parity_on_a_raft_built_index(data, metric, dtype, lut_dtype, tmp_path,
                                             monkeypatch):
    x, q = data
    jidx = _raft_index(x, metric=metric, dtype=dtype)
    tidx = _to_port(jidx, tmp_path)
    sp_j = jpq.SearchParams(n_probes=4, lut_dtype=lut_dtype)
    sp_t = tpq.SearchParams(n_probes=4, lut_dtype=lut_dtype)
    monkeypatch.setenv("RAFT_TPU_PALLAS", "1")
    for n_q in (64, 512):  # query-major, then probe-major
        v_ref, i_ref = jpq.search(sp_j, jidx, q[:n_q], 10)
        assert jkernels.consume_kernel_path() == "pallas"
        v, i = tpq.search(sp_t, tidx, torch.from_numpy(q[:n_q]), 10, res=CPU)
        assert kernels.consume_kernel_path() == "torch"
        assert v.dtype == torch.float32 and i.dtype == torch.int32
        assert_topk_match(v, i, v_ref, i_ref, atol=1e-4)


def test_strategies_agree_and_port_files_load_in_raft(data, tmp_path):
    x, q = data
    tidx = tpq.build(tpq.IndexParams(decoded_dtype="int8", **BUILD), x, res=CPU)
    outs = [tpq.search(tpq.SearchParams(n_probes=5, strategy=s), tidx, q[:300], 7, res=CPU)
            for s in ("query_major", "probe_major")]
    assert torch.equal(outs[0][1], outs[1][1])
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-4)
    path = str(tmp_path / "port.idx")
    tpq.save(path, tidx)
    back = tpq.load(path, res=CPU)
    for name in ("list_codes", "list_index", "list_sizes", "list_data", "list_y2", "codebook"):
        assert torch.equal(getattr(back, name), getattr(tidx, name)), name
    assert back.scan_scale == tidx.scan_scale
    jback = jpq.load(path)
    np.testing.assert_array_equal(np.asarray(jback.list_codes), tidx.list_codes.numpy())
    np.testing.assert_array_equal(np.asarray(jback.list_data), tidx.list_data.numpy())
    assert jback.scan_scale == tidx.scan_scale


def test_own_build_recall_matches_raft(data):
    x, q = data
    q = q[:200]
    d2 = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :10]
    params = dict(BUILD, kmeans_n_iters=10)
    jidx = jpq.build(jpq.IndexParams(**params), x)
    tidx = tpq.build(tpq.IndexParams(**params), x, res=CPU)
    assert tidx.size == N and tidx.decoded_dtype == "bfloat16"   # "auto" off the card
    _, ji = jpq.search(jpq.SearchParams(n_probes=4), jidx, q, 10)
    _, ti = tpq.search(tpq.SearchParams(n_probes=4), tidx, q, 10, res=CPU)
    r_j, r_t = recall_at_k(np.asarray(ji), gt), recall_at_k(ti, gt)
    assert r_t >= r_j - 0.02, (r_t, r_j)


def _fresh_decode_equal(idx):
    """The cache after an extend equals a decode of all its codes."""
    fresh = tpq.with_decoded_dtype(idx, idx.decoded_dtype)
    assert fresh.scan_scale == idx.scan_scale
    assert torch.equal(fresh.list_data, idx.list_data)
    torch.testing.assert_close(fresh.list_y2, idx.list_y2, rtol=1e-6, atol=0)


def test_extend_fast_append_and_int8_repack(data):
    x, _ = data
    base = tpq.build(tpq.IndexParams(decoded_dtype="int8", **BUILD), x[:2500], res=CPU)
    # rows like the index's: spare capacity, no clipping -> appended in place
    fast = tpq.extend(base, x[2500:2540], np.arange(10_000, 10_040), res=CPU)
    assert fast.size == 2540 and fast.list_cap == base.list_cap
    assert fast.scan_scale == base.scan_scale
    kept = base.list_index >= 0
    assert torch.equal(fast.list_index[kept], base.list_index[kept])   # old rows untouched
    _fresh_decode_equal(fast)
    _, i = tpq.search(tpq.SearchParams(n_probes=16), fast, x[2500:2540], 10, res=CPU)
    assert (i.numpy() == np.arange(10_000, 10_040)[:, None]).any(axis=1).mean() >= 0.95
    # rows past the int8 range: the cache is repacked at a larger scale
    far = x[2540:2550] * 4.0
    repacked = tpq.extend(fast, far, res=CPU)
    assert repacked.size == 2550 and repacked.scan_scale > fast.scan_scale
    ids = repacked.list_index[repacked.list_index >= 0].sort().values
    assert torch.equal(ids, torch.cat([torch.arange(2500), torch.arange(10_000, 10_040),
                                       torch.arange(2540, 2550)]).to(torch.int32).sort().values)
    _fresh_decode_equal(repacked)


def test_extend_matches_raft_on_a_loaded_index(data, tmp_path):
    x, _ = data
    jidx = jpq.build(jpq.IndexParams(decoded_dtype="int8", **BUILD), x[:2500])
    tidx = _to_port(jidx, tmp_path)
    new_ids = np.arange(20_000, 20_040, dtype=np.int32)
    jnew = jpq.extend(jidx, x[2500:2540], new_ids)
    tnew = tpq.extend(tidx, x[2500:2540], new_ids, res=CPU)
    np.testing.assert_array_equal(tnew.list_index.numpy(), np.asarray(jnew.list_index))
    np.testing.assert_array_equal(tnew.list_sizes.numpy(), np.asarray(jnew.list_sizes))
    assert tnew.scan_scale == jnew.scan_scale
    assert (tnew.list_codes.numpy() == np.asarray(jnew.list_codes)).mean() >= 0.999


@pytest.mark.parametrize("codebook_kind", ["per_subspace", "per_cluster"])
def test_build_seeds_never_need_multinomial_over_the_rows(data, monkeypatch, codebook_kind):
    """k-means and codebook seeds are drawn by ``draw_rows``, which takes
    any row count, where ``torch.multinomial`` stops at 2**24 categories:
    with multinomial cut to 64 categories here, a 3,000-row build runs."""
    real = torch.multinomial

    def small_multinomial(weights, *args, **kwargs):
        assert weights.shape[-1] <= 64, f"multinomial over {weights.shape[-1]} categories"
        return real(weights, *args, **kwargs)

    monkeypatch.setattr(torch, "multinomial", small_multinomial)
    idx = tpq.build(tpq.IndexParams(codebook_kind=codebook_kind, **BUILD), data[0], res=CPU)
    assert idx.size == N and bool(torch.isfinite(idx.codebook).all())


def test_out_of_slice_options_raise(data):
    x, q = data
    idx = tpq.build(tpq.IndexParams(**BUILD), x[:1000], res=CPU)
    with pytest.raises(NotImplementedError):
        tpq.search(tpq.SearchParams(), idx, q[:4], 3, sample_filter=object(), res=CPU)
    with pytest.raises(NotImplementedError):
        tpq.search(tpq.SearchParams(internal_distance_dtype="bfloat16"), idx, q[:4], 3,
                   res=CPU)
    with pytest.raises(ValueError):
        tpq.build(tpq.IndexParams(metric="cosine", **BUILD), x[:1000], res=CPU)
