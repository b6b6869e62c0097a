"""Kernel K5 (sorted window accumulation): the port's plain version
against the JAX package's Pallas kernel in interpret mode, both layouts,
and against a sequential numpy scatter (bit-equal: the CUDA kernel sums
each cell in the same row order, which chip_smoke.py checks on the card).
A cell with more than ``HOT_ROWS`` rows is summed in chunks, by the kernel
and by the plain version alike: held against a numpy model of that order.
``item_plan``, the model of the kernel's cut of crowded windows into work
items, is held against a row-by-row plan.
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


def _chunked(idx, upd, n_rows):
    """The documented order, row by row: a cell's rows in order from zero;
    a cell with more than HOT_ROWS rows in chunks of HOT_ROWS rows, each
    from zero, the chunks' sums then added in order from zero."""
    ref = np.zeros((n_rows, upd.shape[1]), np.float32)
    for v in np.unique(idx[(idx >= 0) & (idx < n_rows)]):
        rows = upd[idx == v]
        parts = []
        for s in range(0, len(rows), ks.HOT_ROWS):
            acc = np.zeros(upd.shape[1], np.float32)
            for u in rows[s:s + ks.HOT_ROWS]:
                acc = acc + u
            parts.append(acc)
        if len(rows) <= ks.HOT_ROWS:
            ref[v] = parts[0]
        else:
            for part in parts:
                ref[v] = ref[v] + part
    return ref


def _hot_inputs(seed, M, C, n_rows, hot_cell, hot_rows):
    """Positive updates (so that a relative error means something), with
    ``hot_rows`` of the M rows on one cell."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, M).astype(np.int32)
    idx[:hot_rows] = hot_cell
    idx = np.sort(idx)
    upd = np.abs(rng.normal(size=(M, C))).astype(np.float32)
    return idx, upd


@pytest.mark.parametrize("transposed", [False, True])
def test_hot_cell_chunked_order(transposed):
    """One cell with 2.4 HOT_ROWS rows: the plain version is bit-equal to
    the numpy model of the chunked order, and within 1e-5 relative of the
    Pallas kernel in interpret mode and of the sequential np.add.at (other
    sum orders; measured 1.4e-6 and 2.8e-6 of the hot cell's sum)."""
    from apnerf.kernels.scatter_pallas import sorted_window_accumulate
    M, C, n_rows = 12000, 8, 300
    hot = int(2.4 * ks.HOT_ROWS)
    idx, upd = _hot_inputs(11, M, C, n_rows, 131, hot)
    assert (idx == 131).sum() > 2 * ks.HOT_ROWS
    got = ks.sorted_window_accumulate(torch.tensor(idx), torch.tensor(upd),
                                      n_rows, transposed=transposed).numpy()
    got = got.T if transposed else got
    np.testing.assert_array_equal(got, _chunked(idx, upd, n_rows))
    seq = _sequential(idx, upd, n_rows)
    assert (got[131] != seq[131]).any()      # another order than row by row
    cold = np.arange(n_rows) != 131
    np.testing.assert_array_equal(got[cold], seq[cold])
    np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)
    want = np.asarray(sorted_window_accumulate(
        jnp.asarray(idx), jnp.asarray(upd), n_rows, transposed=transposed))
    want = want.T if transposed else want
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _plan_row_by_row(idx, n_rows):
    """The work items of kernels/scatter.py:item_plan, built cell by cell
    from row counts."""
    items, pinfo = [], []
    for base in range(0, n_rows, ks.WIN):
        nc = min(ks.WIN, n_rows - base)
        start = [int(np.sum(idx < base + j)) for j in range(nc + 1)]
        lo, hi = start[0], start[nc]
        if hi - lo <= ks.ITEM_ROWS:
            continue
        run = None                        # (first cell, bucket)
        for j in range(nc + 1):
            n = start[j + 1] - start[j] if j < nc else 0
            bucket = (start[j] - lo) // ks.ITEM_ROWS
            ends = j == nc or n > ks.HOT_ROWS or (
                run is not None and bucket != run[1])
            if run is not None and ends:
                items.append((base + run[0], j - run[0], start[run[0]],
                              start[j]))
                run = None
            if j == nc:
                break
            if n > ks.HOT_ROWS:
                chunks = -(-n // ks.HOT_ROWS)
                for c in range(chunks):
                    s = start[j] + c * ks.HOT_ROWS
                    items.append((base + j, -1 - len(pinfo), s,
                                  min(s + ks.HOT_ROWS, start[j + 1])))
                    pinfo.append((base + j, chunks if c == 0 else 0))
            elif run is None:
                run = (j, bucket)
    return (np.asarray(items, np.int32).reshape(-1, 4),
            np.asarray(pinfo, np.int32).reshape(-1, 2))


def _plan_case(name):
    rng = np.random.default_rng(21)
    n_rows = 700                      # a ragged last window of 60 cells
    if name == "random":
        # crowded in the middle: windows from a few rows to several items
        idx = np.clip(rng.normal(350, 60, 30000), 0, n_rows - 1)
    elif name == "edges":
        # rows below 0 and at or above n_rows around the in-range ones
        idx = rng.integers(-400, n_rows + 400, 40000)
    elif name == "empty":
        idx = np.zeros(0)
    elif name == "out_of_range":
        idx = np.concatenate([np.full(3000, -7), np.full(3000, n_rows)])
    elif name == "hot_cell":
        idx = rng.integers(0, n_rows, 20000)
        idx[:3 * ks.HOT_ROWS + 5] = 321
    elif name == "hot_last_cell":
        idx = rng.integers(0, n_rows, 9000)
        idx[:ks.HOT_ROWS + 1] = n_rows - 1
    return np.sort(idx).astype(np.int32), n_rows


@pytest.mark.parametrize("name", ["random", "edges", "empty", "out_of_range",
                                  "hot_cell", "hot_last_cell"])
def test_item_plan(name):
    """item_plan against the row-by-row plan, and what the kernel needs of
    it: with the windows that have no item, the items cover every in-range
    row once and every cell once; they cut only at cell boundaries, except
    inside a hot cell; a run stays under ITEM_ROWS rows before its last
    cell, a chunk within HOT_ROWS; the static bounds of the scratch hold."""
    idx, n_rows = _plan_case(name)
    items, pinfo = ks.item_plan(torch.tensor(idx), n_rows)
    want_items, want_pinfo = _plan_row_by_row(idx, n_rows)
    np.testing.assert_array_equal(items, want_items)
    np.testing.assert_array_equal(pinfo, want_pinfo)
    _, n_cnt, n_items, n_part = ks.scratch_sizes(len(idx), n_rows)
    assert len(items) <= n_items and len(pinfo) <= n_part
    n_cand = -(-len(idx) // ks.ITEM_ROWS)
    assert n_cnt == n_cand + -(-n_cand // ks.PLAN_WARPS) + 1
    rows_seen = np.zeros(len(idx), np.int64)
    cells_seen = np.zeros(n_rows, np.int64)
    for base in range(0, n_rows, ks.WIN):          # windows without items
        sel = (idx >= base) & (idx < min(base + ks.WIN, n_rows))
        if sel.sum() <= ks.ITEM_ROWS:
            rows_seen[sel] += 1
            cells_seen[base:base + ks.WIN] += 1
    for cell, n, lo, hi in items:
        rows_seen[lo:hi] += 1
        inside = idx[lo:hi]
        if n < 0:                                   # a hot cell's chunk
            assert 0 < hi - lo <= ks.HOT_ROWS and (inside == cell).all()
            assert (idx == cell).sum() > ks.HOT_ROWS
            assert tuple(pinfo[-1 - n])[0] == cell
        else:
            assert n > 0 and cell // ks.WIN == (cell + n - 1) // ks.WIN
            cells_seen[cell:cell + n] += 1
            assert ((inside >= cell) & (inside < cell + n)).all()
            # whole cells: no row of these cells lies outside [lo, hi)
            assert ((idx >= cell) & (idx < cell + n)).sum() == hi - lo
            if hi > lo:
                assert hi - lo - (inside == inside[-1]).sum() < ks.ITEM_ROWS
    for p, (cell, chunks) in enumerate(pinfo):
        if chunks:                                  # a hot cell, once
            cells_seen[cell] += 1
            assert (pinfo[p:p + chunks, 0] == cell).all()
            assert chunks == -(-(idx == cell).sum() // ks.HOT_ROWS)
    in_range = (idx >= 0) & (idx < n_rows)
    np.testing.assert_array_equal(rows_seen, in_range.astype(np.int64))
    np.testing.assert_array_equal(cells_seen, np.ones(n_rows, np.int64))
    if name in ("random", "hot_cell", "hot_last_cell", "edges"):
        assert len(items) > 0
    if name.startswith("hot"):
        assert len(pinfo) > 1
