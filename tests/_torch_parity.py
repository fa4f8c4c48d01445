"""Shared check of the port's parity tests: a top-k result against raft_tpu's."""

import numpy as np


def assert_topk_match(v, i, v_ref, i_ref, *, rtol=1e-5, atol=1e-5, gap=1e-4):
    """Values close (+inf where the reference is +inf); ids equal wherever
    the value is separated from its neighbors in the reference list by more
    than ``gap`` (near-ties may flip with f32 summation order)."""
    v, i = np.asarray(v), np.asarray(i)
    v_ref, i_ref = np.asarray(v_ref), np.asarray(i_ref)
    np.testing.assert_allclose(v, v_ref, rtol=rtol, atol=atol)
    padded = np.pad(v_ref.astype(np.float64), [(0, 0)] * (v_ref.ndim - 1) + [(1, 1)],
                    constant_values=np.inf)
    with np.errstate(invalid="ignore"):  # inf - inf between padding slots
        sep = (np.abs(padded[..., 1:-1] - padded[..., :-2]) > gap) & (
            np.abs(padded[..., 2:] - padded[..., 1:-1]) > gap)
    sep |= ~np.isfinite(v_ref)
    np.testing.assert_array_equal(i[sep], i_ref[sep])
    assert (i == i_ref).mean() >= 0.999
