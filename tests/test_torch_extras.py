"""Port parity of ``neighbors.extras`` and ``neighbors.helpers`` on the CPU:
``epsilon_neighborhood`` equal to raft_tpu's and to float64 numpy (also on
pairs placed on the eps boundary, which the port decides exactly);
``masked_l2_nn`` equal to raft_tpu's on contiguous and uneven end-offset
groups, with (+inf, -1) where a row admits nothing; ``BatchKQuery`` equal
to raft_tpu's batch by batch; and the IVF helpers on indexes raft_tpu
built and saved (lists bitwise, reconstructions within rtol 1e-5, the int8
cache dequantized, the footprint's bytes), as
``tests/test_parity_extras.py`` holds raft_tpu's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import extras as jextras
from raft_tpu.neighbors import helpers as jhelpers
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import extras, helpers, ivf_flat, ivf_pq

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return rng.random((1200, 16), dtype=np.float32), rng.random((60, 16), dtype=np.float32)


@pytest.mark.parametrize("eps_sq", [0.4, 1.0, 1.6])
def test_epsilon_neighborhood(data, eps_sq):
    x, q = data
    adj, deg = extras.epsilon_neighborhood(q, x, eps_sq, res=CPU)
    d = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(adj.numpy(), d <= eps_sq)
    np.testing.assert_array_equal(deg.numpy(), (d <= eps_sq).sum(1))
    jadj, jdeg = jextras.epsilon_neighborhood(q, x, eps_sq)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    assert deg.dtype == torch.int32


def test_epsilon_neighborhood_decides_the_boundary_exactly(data):
    """eps² set to pairs' own float64 distances: each such pair is a hit,
    and its distance's next float below excludes it, whatever the f32
    product rounds to; small workspaces (other tiles) give the same."""
    x, q = data
    d = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    for eps_sq in d[np.arange(10), np.arange(10)]:
        for res in (CPU, Resources(device="cpu", workspace_limit_bytes=4096)):
            adj, _ = extras.epsilon_neighborhood(q, x, float(eps_sq), res=res)
            np.testing.assert_array_equal(adj.numpy(), d <= float(eps_sq))
            below = float(np.nextafter(eps_sq, 0))
            adj, _ = extras.epsilon_neighborhood(q, x, below, res=res)
            np.testing.assert_array_equal(adj.numpy(), d <= below)


@pytest.mark.parametrize("ends", [[10, 20, 30, 40], [3, 17, 18, 40], [5, 25, 30]],
                         ids=["contiguous", "uneven", "past_last_end"])
@pytest.mark.parametrize("sqrt", [False, True])
def test_masked_l2_nn(ends, sqrt):
    rng = np.random.default_rng(2)
    x = rng.random((30, 8)).astype(np.float32)
    y = rng.random((40, 8)).astype(np.float32)
    adj = rng.random((30, len(ends))) > 0.4
    adj[0] = False          # a row with nothing admissible
    adj[1] = True
    ends = np.asarray(ends, np.int32)
    v, j = extras.masked_l2_nn(x, y, adj, ends, sqrt=sqrt, res=CPU)
    jv, jj = jextras.masked_l2_nn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(adj),
                                  jnp.asarray(ends), sqrt=sqrt)
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert j[0] == -1 and np.isinf(v[0].item())
    # float64 reference: column c belongs to the first group whose end > c
    gid = np.minimum(np.searchsorted(ends, np.arange(40), side="right"), len(ends) - 1)
    d = ((x[:, None].astype(np.float64) - y[None]) ** 2).sum(-1)
    masked = np.where(adj[:, gid], d, np.inf)
    ref_j = np.where(adj[:, gid].any(1), masked.argmin(1), -1)
    np.testing.assert_array_equal(j.numpy(), ref_j)


def test_masked_l2_nn_tiles_rows():
    """A workspace of a few rows: the row tiles give the one-tile answer."""
    rng = np.random.default_rng(3)
    x = rng.random((50, 8)).astype(np.float32)
    y = rng.random((64, 8)).astype(np.float32)
    adj = rng.random((50, 8)) > 0.5
    ends = np.arange(8, 65, 8)
    whole = extras.masked_l2_nn(x, y, adj, ends, res=CPU)
    tiled = extras.masked_l2_nn(x, y, adj, ends,
                                res=Resources(device="cpu", workspace_limit_bytes=2048))
    assert all(torch.equal(a, b) for a, b in zip(whole, tiled))


def test_batch_k_query(data):
    x, q = data
    x = x[:200]
    jbatches = list(zip(range(6), jextras.BatchKQuery(x, q, batch_size=16)))
    batches = list(zip(range(6), extras.BatchKQuery(x, q, batch_size=16, res=CPU)))
    for (_, (jv, ji)), (_, (v, i)) in zip(jbatches, batches):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    # the whole iteration covers every row once per query
    ids = np.concatenate([i.numpy() for _, i in extras.BatchKQuery(x, q[:3], batch_size=48,
                                                                   res=CPU)], axis=1)
    assert ids.shape == (3, 200) and all(sorted(r) == list(range(200)) for r in ids)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """raft_tpu-built IVF-Flat and IVF-PQ (bf16 and int8 caches) indexes,
    saved by raft_tpu and loaded by both packages."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2000, 32)) * 2).astype(np.float32)
    out = {"x": x}
    d = tmp_path_factory.mktemp("helpers")
    fl = jflat.build(jflat.IndexParams(n_lists=16, kmeans_n_iters=4), x)
    jflat.save(str(d / "flat"), fl)
    out["flat"] = (fl, ivf_flat.load(str(d / "flat"), res=CPU))
    for cache in ("bfloat16", "int8"):
        pq = jpq.build(jpq.IndexParams(n_lists=8, pq_dim=16, kmeans_n_iters=3,
                                       decoded_dtype=cache), x)
        jpq.save(str(d / cache), pq)
        out[cache] = (pq, ivf_pq.load(str(d / cache), res=CPU))
    return out


def test_ivf_flat_unpack_list(indexes):
    j, t = indexes["flat"]
    for lst in (0, 5, 15):
        vecs, ids = helpers.ivf_flat_unpack_list(t, lst)
        jvecs, jids = jhelpers.ivf_flat_unpack_list(j, lst)
        np.testing.assert_array_equal(vecs, jvecs)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(vecs, indexes["x"][ids])


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_ivf_pq_lists_codes_and_reconstruction(indexes, cache):
    j, t = indexes[cache]
    for lst in (0, 7):
        codes, ids = helpers.ivf_pq_unpack_list(t, lst)
        jcodes, jids = jhelpers.ivf_pq_unpack_list(j, lst)
        np.testing.assert_array_equal(codes, jcodes)
        np.testing.assert_array_equal(ids, jids)
        for bits in (4, 5, 8):
            c = codes & ((1 << bits) - 1)
            packed = helpers.ivf_pq_pack_codes(c, bits)
            np.testing.assert_array_equal(packed, jhelpers.ivf_pq_pack_codes(c, bits))
            np.testing.assert_array_equal(helpers.ivf_pq_unpack_codes(packed, t.pq_dim, bits), c)
        recon, rids = helpers.ivf_pq_reconstruct_list(t, lst)
        jrecon, jrids = jhelpers.ivf_pq_reconstruct_list(j, lst)
        np.testing.assert_array_equal(rids, jrids)
        np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), rtol=1e-5, atol=1e-4)
        # PQ-level distortion, not a 1 / scan_scale blow-up of raw int8 steps
        orig = indexes["x"][rids]
        err = np.linalg.norm(recon.numpy() - orig, axis=1)
        assert err.mean() < np.linalg.norm(orig, axis=1).mean()


def test_index_memory_footprint(indexes):
    fb = helpers.index_memory_footprint(indexes["bfloat16"][1])
    f8 = helpers.index_memory_footprint(indexes["int8"][1])
    jb = jhelpers.index_memory_footprint(indexes["bfloat16"][0])
    assert fb["total"] == sum(v for k, v in fb.items() if k != "total") > 0
    for name in ("list_data", "list_codes", "centers", "rotation"):
        assert fb[name] == jb[name], name
    assert f8["list_data"] * 2 == fb["list_data"]
    ff = helpers.index_memory_footprint(indexes["flat"][1])
    assert ff["list_data"] == jhelpers.index_memory_footprint(indexes["flat"][0])["list_data"]
