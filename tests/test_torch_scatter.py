"""Kernel K5 (sorted window accumulation): the port's plain version
against the JAX package's Pallas kernel in interpret mode, both layouts,
and against a sequential numpy scatter (bit-equal: the CUDA kernel sums
each cell in the same row order, which chip_smoke.py checks on the card).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apnerf_torch.kernels import scatter as ks


def _inputs(seed, M, C, n_rows, sort=True):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, M).astype(np.int32)
    if sort:
        idx = np.sort(idx)
    upd = rng.normal(size=(M, C)).astype(np.float32)
    return idx, upd


def _sequential(idx, upd, n_rows):
    ref = np.zeros((n_rows, upd.shape[1]), np.float32)
    np.add.at(ref, idx, upd)
    return ref


# the shapes and layouts of tests/test_kernels_interpret.py's scatter
# tests; tolerance as there (the Pallas kernel sums a window's rows in
# 128-row one-hot matmul blocks, another order than row by row)
@pytest.mark.parametrize("C,transposed", [(8, False), (96, True)])
def test_plain_matches_pallas_interpret(C, transposed):
    from apnerf.kernels.scatter_pallas import sorted_window_accumulate
    M, n_rows = 4096, 3000
    idx, upd = _inputs(4, M, C, n_rows)
    want = np.asarray(sorted_window_accumulate(
        jnp.asarray(idx), jnp.asarray(upd), n_rows, transposed=transposed))
    got = ks.sorted_window_accumulate(torch.tensor(idx), torch.tensor(upd),
                                      n_rows, transposed=transposed)
    assert tuple(got.shape) == want.shape == (
        (C, n_rows) if transposed else (n_rows, C))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M,C,n_rows", [(4096, 96, 3000), (777, 5, 130),
                                        (0, 12, 64)])
def test_plain_is_sequential_row_order(M, C, n_rows):
    """Bit-equal to np.add.at, which adds the rows one by one in order."""
    idx, upd = _inputs(5, M, C, n_rows)
    want = _sequential(idx, upd, n_rows)
    got = ks.sorted_window_accumulate(torch.tensor(idx), torch.tensor(upd),
                                      n_rows)
    np.testing.assert_array_equal(got.numpy(), want)
    got_t = ks.sorted_window_accumulate(torch.tensor(idx), torch.tensor(upd),
                                        n_rows, transposed=True)
    np.testing.assert_array_equal(got_t.numpy(), want.T)


def test_out_of_range_rows_are_dropped():
    """Rows keyed below 0 or at / above n_rows contribute nothing (the
    grid gradient keys its all-zero rows out of range)."""
    idx, upd = _inputs(7, 2000, 12, 300, sort=False)
    idx = np.concatenate([idx, [-3, -1, 300, 301, 9999]]).astype(np.int32)
    upd = np.concatenate([upd, np.full((5, 12), 7.0, np.float32)])
    order = np.argsort(idx, kind="stable")
    idx, upd = idx[order], upd[order]
    ok = (idx >= 0) & (idx < 300)
    want = _sequential(idx[ok], upd[ok], 300)
    got = ks.sorted_window_accumulate(torch.tensor(idx), torch.tensor(upd),
                                      300, transposed=True)
    np.testing.assert_array_equal(got.numpy(), want.T)


def test_scatter_add_rows_unsorted():
    """A stable argsort keeps each index's rows in their order: still
    bit-equal to the sequential scatter of the unsorted rows."""
    idx, upd = _inputs(6, 5000, 16, 700, sort=False)
    got = ks.scatter_add_rows(torch.tensor(idx).long(), torch.tensor(upd),
                              700)
    np.testing.assert_array_equal(got.numpy(), _sequential(idx, upd, 700))
