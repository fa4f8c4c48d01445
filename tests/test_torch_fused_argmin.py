"""Port parity: kernel #7's plain version (``raft_tpu_torch.kernels.
fused_argmin``) against raft_tpu's Pallas ``fused_l2_argmin`` in interpret
mode, on the same numpy inputs: ids equal and scores within rtol 1e-5 /
atol 1e-4 (the Pallas product sums in another order) on centred data, with
explicit ties; and ``ops.cost`` against raft_tpu's formula."""

import os
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.kernels.fused_argmin import fused_l2_argmin as j_argmin
from raft_tpu.ops import cost as jcost
from raft_tpu_torch import kernels
from raft_tpu_torch.kernels import fused_argmin as targmin
from raft_tpu_torch.ops import cost as tcost

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D = 40   # not a multiple of anything the kernels tile by


def _both(x, c, cc):
    want = j_argmin(jnp.asarray(x), jnp.asarray(c), jnp.asarray(cc), interpret=True)
    got = kernels.fused_l2_argmin(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(cc))
    return got, (np.asarray(want[0]), np.asarray(want[1]))


def _check(got, want):
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-4)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("n,n_centers", [(1100, 300), (37, 5), (513, 129)])
def test_plain_version_matches_pallas(n, n_centers):
    rng = np.random.default_rng(n + n_centers)
    x = rng.standard_normal((n, D)).astype(np.float32)
    c = rng.standard_normal((n_centers, D)).astype(np.float32)
    _check(*_both(x, c, (c * c).sum(1)))


def test_duplicate_centers_and_the_tile_edge():
    """Duplicates of one center at 3, 127 | 128 (across the Pallas kernel's
    128-center tile edge) and 250: every row nearest that center takes the
    first copy, within a tile and across tiles."""
    rng = np.random.default_rng(1)
    c = rng.standard_normal((300, D)).astype(np.float32)
    for j in (127, 128, 250):
        c[j] = c[3]
    x = np.concatenate([c[3][None] + 0.01 * rng.standard_normal((20, D)),
                        rng.standard_normal((80, D))]).astype(np.float32)
    got, want = _both(x, c, (c * c).sum(1))
    _check(got, want)
    assert (got[1][:20].numpy() == 3).all()
    # a duplicate pair that straddles the edge only
    c2 = c.copy()
    c2[3] = rng.standard_normal(D)
    got, want = _both(x, c2, (c2 * c2).sum(1))
    _check(got, want)
    assert (got[1][:20].numpy() == 127).all()


def test_infinite_norms_never_win():
    """A center with norm +inf (raft_tpu's padding centers) never wins; a
    row whose every score is +inf keeps (+inf, 0), the kernels' initial
    pair."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((200, D)).astype(np.float32)
    c = rng.standard_normal((150, D)).astype(np.float32)
    cc = (c * c).sum(1)
    cc[::3] = np.inf
    got, want = _both(x, c, cc)
    _check(got, want)
    assert (got[1].numpy() % 3 != 0).all()
    got, want = _both(x[:5], c[:4], np.full(4, np.inf, np.float32))
    _check(got, want)
    assert np.isinf(got[0].numpy()).all() and (got[1].numpy() == 0).all()


def test_inputs_are_cast_to_f32():
    rng = np.random.default_rng(3)
    x = rng.integers(-50, 50, (64, D)).astype(np.int8)
    c = rng.integers(-50, 50, (20, D)).astype(np.int8)
    cc = (c.astype(np.float32) ** 2).sum(1)
    got = kernels.fused_l2_argmin(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(cc))
    want = targmin.fused_l2_argmin_torch(torch.from_numpy(x).float(), torch.from_numpy(c).float(),
                                         torch.from_numpy(cc))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_shapes_are_checked():
    with pytest.raises(ValueError, match="center_sqnorms"):
        kernels.fused_l2_argmin(torch.zeros(3, 4), torch.zeros(5, 4), torch.zeros(4))
    with pytest.raises(ValueError, match="one d"):
        kernels.fused_l2_argmin(torch.zeros(3, 4), torch.zeros(5, 3), torch.zeros(5))


@pytest.mark.parametrize("args", [(8192, 1024, 128), (1100, 300, 40)])
def test_cost_formula_matches_raft_tpu(args):
    got, want = tcost.fused_argmin_cost(*args), jcost.fused_argmin_cost(*args)
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes_accessed)


def test_work_counts_what_the_inputs_need():
    w = tcost.fused_argmin_work(8192, 1024, 128)
    assert w.flops == 8192 * 1024 * 2 * 128
    assert w.bytes_accessed == (8192 + 1024) * 128 * 4 + 1024 * 4 + 8192 * 8
    ms, by = tcost.bound_ms(tcost.fused_argmin_work(1_000_000, 1024, 128))
    assert by == "operations" and ms == pytest.approx(3.9126, rel=1e-4)


@pytest.mark.parametrize("n,n_centers,slots", [(8192, 1024, 264), (1_000_000, 1024, 264),
                                               (1100, 300, 264), (5, 1, 264), (70, 129, 264),
                                               (129, 2500, 264), (8191, 1029, 228),
                                               (40_000, 1000, 132)])
def test_center_parts_cover_every_center_once_in_whole_waves(n, n_centers, slots):
    """Kernel #7's part picker: contiguous parts of whole 128-center tiles
    that cover every center once, as many as make the row tiles' blocks
    fill whole waves (within 5 % of the best count); raft_tpu's prims shape
    (8,192 rows) takes four parts on the H100's 264 block slots, one wave,
    and the k-means assignment of 1M rows one part."""
    parts, chunk = targmin.center_parts(n, n_centers, slots)
    assert chunk % 128 == 0 and parts >= 1
    bounds = [(p * chunk, min(n_centers, (p + 1) * chunk)) for p in range(parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n_centers
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    row_tiles = -(-n // 128)
    tiles = -(-n_centers // 128)

    def waves_per_part(s):   # whole waves of blocks, each doing 1 / s of a row tile's work
        return -(-row_tiles * s // slots) / s

    # the counts contiguous whole-tile parts can take, up to four blocks a slot
    limit = min(tiles, 4 * -(-slots // row_tiles))
    best = min(waves_per_part(-(-tiles // -(-tiles // s))) for s in range(1, limit + 1))
    assert waves_per_part(parts) <= 1.05 * best
    if (n, n_centers, slots) == (8192, 1024, 264):
        assert parts == 4 and parts * row_tiles <= slots
    if n == 1_000_000:
        assert parts == 1
