"""Port parity of the pass filters: ``raft_tpu_torch.core.bitset`` against
``raft_tpu.core.bitset`` (words compared as uint32), the folding of
tombstones into a pass filter, and the candidate masks built from them."""

import os
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.core import bitset as jbs
from raft_tpu.neighbors import _common as jcommon
from raft_tpu_torch.core import bitset as tbs
from raft_tpu_torch.neighbors import _common as tcommon

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = "cpu"


def _u32(words) -> np.ndarray:
    """Words of either package as numpy uint32."""
    if isinstance(words, torch.Tensor):
        return words.numpy().view(np.uint32)
    return np.asarray(words).astype(np.uint32)


def _mask(n, seed, p=0.5):
    return np.random.default_rng(seed).random(n) < p


@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 1000])
def test_from_mask_words_match_raft(n_bits):
    mask = _mask(n_bits, n_bits)
    mask[-1] = True          # bit 31 of a full word: the int32 sign bit
    got = tbs.Bitset.from_mask(mask, device=CPU)
    want = jbs.Bitset.from_mask(jnp.asarray(mask))
    assert got.words.dtype == torch.int32 and got.n_bits == n_bits
    np.testing.assert_array_equal(_u32(got.words), _u32(want.words))
    np.testing.assert_array_equal(got.to_mask().numpy(), mask)
    assert got.count() == int(want.count()) == int(mask.sum())


@pytest.mark.parametrize("default", [True, False])
def test_create_and_count_with_a_partial_tail_word(default):
    """70 bits: the last word holds 6 of them; its other 26 bits are set by
    ``create`` (all-ones fill) and must not count."""
    got = tbs.Bitset.create(70, default, device=CPU)
    want = jbs.Bitset.create(70, default)
    np.testing.assert_array_equal(_u32(got.words), _u32(want.words))
    assert got.count() == int(want.count()) == (70 if default else 0)
    assert isinstance(got.count(), int)


@pytest.mark.parametrize("value", [True, False])
def test_set_with_repeated_indices_sets_every_bit(value):
    """Ids repeated in one call, and several ids in one word, all take
    effect (raft_tpu scatters through a mask for this reason)."""
    base = tbs.Bitset.create(100, not value, device=CPU)
    jbase = jbs.Bitset.create(100, not value)
    idx = np.array([3, 3, 4, 31, 32, 32, 99, 5, 4], np.int32)
    got = base.set(idx, value)
    want = jbase.set(jnp.asarray(idx), value)
    np.testing.assert_array_equal(_u32(got.words), _u32(want.words))
    assert bool((got.test(np.unique(idx)) == value).all())
    assert got.count() == int(want.count())
    # the input is not changed
    assert base.count() == (0 if value else 100)


def test_flip_test_and_popcount_match_raft():
    mask = _mask(517, 3, 0.2)
    got = tbs.Bitset.from_mask(mask, device=CPU).flip()
    want = jbs.Bitset.from_mask(jnp.asarray(mask)).flip()
    np.testing.assert_array_equal(_u32(got.words), _u32(want.words))
    assert got.count() == int(want.count()) == int((~mask).sum())
    idx = np.random.default_rng(4).integers(0, 517, (7, 11)).astype(np.int32)
    np.testing.assert_array_equal(got.test(idx).numpy(), np.asarray(want.test(jnp.asarray(idx))))
    words = np.random.default_rng(5).integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    np.testing.assert_array_equal(
        tbs._popcount_words(torch.from_numpy(words.view(np.int32))).numpy(),
        np.asarray(jbs._popcount_words(jnp.asarray(words))))


def test_from_numpy_takes_raft_words():
    mask = _mask(200, 6)
    want = jbs.Bitset.from_mask(jnp.asarray(mask))
    got = tbs.Bitset.from_numpy(np.asarray(want.words), 200, device=CPU)
    np.testing.assert_array_equal(got.to_mask().numpy(), mask)
    np.testing.assert_array_equal(_u32(got.words), _u32(want.words))


def test_row_filter_from_mask_rows_test_rows_and_count():
    masks = np.random.default_rng(7).random((5, 90)) < 0.4
    masks[2] = False
    masks[2, :3] = True            # the least passing row: 3 ids
    got = tbs.RowFilter.from_mask_rows(masks, device=CPU)
    want = jbs.RowFilter.from_mask_rows(jnp.asarray(masks))
    np.testing.assert_array_equal(_u32(got.words), _u32(want.words))
    ids = np.random.default_rng(8).integers(-1, 90, (5, 13)).astype(np.int32)
    np.testing.assert_array_equal(got.test_rows(ids).numpy(),
                                  np.asarray(want.test_rows(jnp.asarray(ids))))
    assert got.count() == int(want.count()) == 3
    assert tbs.RowFilter(got.words, 90, pass_count=2).count() == 2
    again = tbs.RowFilter.from_numpy(np.asarray(want.words), 90, device=CPU)
    assert torch.equal(again.words, got.words) and again.fid is None


@pytest.mark.parametrize("as_numpy", [True, False])
def test_row_filter_from_table(as_numpy):
    """A table of raft_tpu's uint32 words and numpy fids (the host gather),
    or the port's int32 words as tensors: the rows' words, the descriptor
    and the pass count all carry over."""
    rng = np.random.default_rng(9)
    table = jbs.RowFilter.from_mask_rows(jnp.asarray(rng.random((4, 100)) < 0.5)).words
    fid = rng.integers(0, 4, 17)
    want = jbs.RowFilter.from_table(np.asarray(table), fid, 100, pass_count=5)
    if as_numpy:
        got = tbs.RowFilter.from_table(np.asarray(table), fid, 100, pass_count=5, device=CPU)
    else:
        got = tbs.RowFilter.from_table(torch.from_numpy(_u32(table).view(np.int32)),
                                       torch.from_numpy(fid), 100, pass_count=5)
    np.testing.assert_array_equal(_u32(got.words), _u32(want.words))
    np.testing.assert_array_equal(_u32(got.table), _u32(want.table))
    np.testing.assert_array_equal(got.fid.numpy(), np.asarray(want.fid))
    assert got.fid.dtype == torch.int32 and got.count() == 5
    with pytest.raises(ValueError, match="filter ids"):
        tbs.RowFilter.from_table(np.asarray(table), [0, 4], 100, device=CPU)


def _filters(n=160, rows=6, seed=10):
    rng = np.random.default_rng(seed)
    keep, dead = rng.random(n) < 0.6, rng.random(n) < 0.2
    row_masks = rng.random((rows, n + 40)) < 0.5     # covers more ids than the tombstones
    table = rng.random((3, n + 40)) < 0.5
    fid = rng.integers(0, 3, rows)
    return keep, dead, row_masks, table, fid


@pytest.mark.parametrize("with_filter,with_tombstones", [
    (False, False), (True, False), (False, True), (True, True)])
def test_resolve_pass_filter_matches_raft(with_filter, with_tombstones):
    keep, dead, *_ = _filters()
    sf = tbs.Bitset.from_mask(keep, device=CPU) if with_filter else None
    dm = tbs.Bitset.from_mask(dead, device=CPU) if with_tombstones else None
    jsf = jbs.Bitset.from_mask(jnp.asarray(keep)) if with_filter else None
    jdm = jbs.Bitset.from_mask(jnp.asarray(dead)) if with_tombstones else None
    got = tcommon.resolve_pass_filter(sf, dm)
    want = jcommon.resolve_pass_filter(jsf, jdm)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(_u32(got.words), _u32(want.words))
    passing = (keep if with_filter else np.ones_like(keep)) & ~(dead if with_tombstones else 0)
    np.testing.assert_array_equal(got.to_mask().numpy(), passing)


@pytest.mark.parametrize("descriptor", [False, True])
def test_resolve_row_filter_with_tombstones_matches_raft(descriptor):
    """Tombstones clear their bits in every row (and every table row); the
    words past the tombstones' coverage pass through."""
    _, dead, row_masks, table, fid = _filters()
    dm, jdm = tbs.Bitset.from_mask(dead, device=CPU), jbs.Bitset.from_mask(jnp.asarray(dead))
    if descriptor:
        jt = jbs.RowFilter.from_mask_rows(jnp.asarray(table)).words
        sf = tbs.RowFilter.from_table(np.asarray(jt), fid, table.shape[1], device=CPU)
        jsf = jbs.RowFilter.from_table(np.asarray(jt), fid, table.shape[1])
    else:
        sf = tbs.RowFilter.from_mask_rows(row_masks, device=CPU)
        jsf = jbs.RowFilter.from_mask_rows(jnp.asarray(row_masks))
    got = tcommon.resolve_pass_filter(sf, dm)
    want = jcommon.resolve_pass_filter(jsf, jdm)
    assert isinstance(got, tbs.RowFilter)
    np.testing.assert_array_equal(_u32(got.words), _u32(want.words))
    if descriptor:
        np.testing.assert_array_equal(_u32(got.table), _u32(want.table))
        assert torch.equal(got.fid, sf.fid)
    else:
        assert got.table is None and got.fid is None
    # the caller's filter is left as it was
    assert not np.array_equal(_u32(sf.words), _u32(got.words))


def test_resolve_pass_filter_errors():
    keep, dead, row_masks, *_ = _filters()
    with pytest.raises(ValueError, match="sample_filter covers"):
        tcommon.resolve_pass_filter(tbs.Bitset.from_mask(keep[:100], device=CPU),
                                    tbs.Bitset.from_mask(dead, device=CPU))
    with pytest.raises(ValueError, match="row filter covers"):
        tcommon.resolve_pass_filter(tbs.RowFilter.from_mask_rows(row_masks[:, :100], device=CPU),
                                    tbs.Bitset.from_mask(dead, device=CPU))
    # raft_tpu raises the same two
    with pytest.raises(ValueError):
        jcommon.resolve_pass_filter(jbs.Bitset.from_mask(jnp.asarray(keep[:100])),
                                    jbs.Bitset.from_mask(jnp.asarray(dead)))


def test_invalid_masks_match_raft():
    rng = np.random.default_rng(11)
    keep = rng.random(300) < 0.5
    ids = rng.integers(-1, 300, (4, 9, 20)).astype(np.int32)
    words = tbs.Bitset.from_mask(keep, device=CPU).words
    jwords = jbs.Bitset.from_mask(jnp.asarray(keep)).words
    np.testing.assert_array_equal(
        tcommon.invalid_mask(torch.from_numpy(ids), words).numpy(),
        np.asarray(jcommon.invalid_mask(jnp.asarray(ids), jwords)))
    np.testing.assert_array_equal(tcommon.invalid_mask(torch.from_numpy(ids)).numpy(), ids < 0)
    rows = rng.random((4, 300)) < 0.5
    rw = tbs.RowFilter.from_mask_rows(rows, device=CPU).words
    jrw = jbs.RowFilter.from_mask_rows(jnp.asarray(rows)).words
    np.testing.assert_array_equal(
        tcommon.invalid_mask_rows(torch.from_numpy(ids), rw).numpy(),
        np.asarray(jcommon.invalid_mask_rows(jnp.asarray(ids), jrw)))


def test_constructors_take_a_device():
    """Words land on the device asked for; a tensor input keeps its own."""
    assert tbs.Bitset.create(10, device=CPU).device == torch.device("cpu")
    assert tbs.Bitset.from_mask(torch.ones(5, dtype=torch.bool)).device == torch.device("cpu")
    assert tbs.RowFilter.from_mask_rows(np.ones((2, 5), bool), device=CPU).device.type == "cpu"
