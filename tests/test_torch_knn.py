"""Plain PyTorch versions of kernels K1-K3 (apnerf_torch.kernels) against
the JAX package's Pallas k-NN kernels, run in interpret mode on the CPU as
tests/test_kernels_interpret.py runs them. The CUDA kernels implement the
same contracts; chip_smoke.py holds them against these plain versions on
the card. ``rt=4`` only shortens the Pallas kernels' unrolled rounds, for
faster interpret-mode compiles."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apnerf_torch.kernels import knn_brute as tkb
from apnerf_torch.kernels import knn_cells as tkc


def _cloud(rng, M, P, spread=0.1, scale=1.0):
    p = (rng.normal(size=(P, 3)) * scale).astype(np.float32)
    q = (p[rng.integers(0, P, M)]
         + rng.normal(size=(M, 3)).astype(np.float32) * spread)
    return q, p


def _d2_f32(q, p):
    """fp32 squared distances formed as the kernels form them."""
    dx = q[:, None, 0] - p[None, :, 0]
    dy = q[:, None, 1] - p[None, :, 1]
    dz = q[:, None, 2] - p[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def test_knn_brute_plain_vs_pallas():
    """K1: sorted d2 rows and neighbour sets as knn_pallas_sorted
    (rtol 1e-4, atol 1e-6, the interpret-mode test's bound)."""
    from apnerf.kernels.knn_pallas import knn_pallas_sorted
    rng = np.random.default_rng(0)
    q, p = _cloud(rng, 512, 1500, spread=1.0)
    jd, ji = knn_pallas_sorted(jnp.asarray(q), jnp.asarray(p), k=8)
    td, ti = tkb.knn_brute(torch.tensor(q), torch.tensor(p), 8)
    assert ti.dtype == torch.int32 and td.shape == (512, 8)
    np.testing.assert_allclose(td.numpy(), np.sort(np.asarray(jd), 1),
                               rtol=1e-4, atol=1e-6)
    full = _d2_f32(q, p)
    np.testing.assert_array_equal(
        td.numpy(), np.take_along_axis(full, ti.numpy().astype(np.int64), 1))
    # the same neighbour sets wherever the kth and (k+1)th differ
    srt = np.sort(full, 1)
    clear = srt[:, 8] > srt[:, 7] * (1 + 1e-5) + 1e-7
    got = np.sort(ti.numpy(), 1)[clear]
    want = np.sort(np.asarray(ji), 1)[clear]
    np.testing.assert_array_equal(got, want)


def test_build_point_tables_equal():
    from apnerf.kernels.knn_cells_pallas import build_point_tables as jbt
    p = np.random.default_rng(1).normal(size=(1500, 3)).astype(np.float32)
    jt = jbt(jnp.asarray(p))
    tt = tkc.build_point_tables(torch.tensor(p))
    for key in ("perm", "pts_t", "pts_sorted", "t_lo", "t_hi", "p_lo",
                "p_hi"):
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]),
                                      err_msg=key)


def test_knn_count_plain_vs_pallas():
    """K2: equal counts, except queries with a point within 2^-20
    relative of the radius (XLA:CPU may contract the Pallas d2 to FMA)."""
    from apnerf.kernels.knn_cells_pallas import knn_count_pallas
    rng = np.random.default_rng(3)
    q, p = _cloud(rng, 700, 1500)
    r2 = 0.05
    want = np.asarray(knn_count_pallas(jnp.asarray(q), jnp.asarray(p),
                                       radius2=r2, rt=4))
    tabs = tkc.build_point_tables(torch.tensor(p))
    got = tkc.knn_count(torch.tensor(q), tabs, r2).numpy()
    d64 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    edge = (np.abs(d64 - r2) <= r2 * 2.0 ** -20).any(1)
    assert (~edge).sum() > 600
    np.testing.assert_array_equal(got[~edge], want[~edge])


@pytest.mark.parametrize("k", [8, 12])
def test_knn_radius_plain_vs_pallas(k):
    """K3 with the same tables, indices in the Morton-sorted space: for
    queries whose kth neighbour is in radius, the same index sets up to
    2^-10-relative ties (the TPU kernel's key truncation). The port's d2
    are exact fp32 and only in-radius points are returned."""
    from apnerf.kernels.knn_cells_pallas import (build_point_tables,
                                                 knn_radius_pallas)
    rng = np.random.default_rng(4 + k)
    q, p = _cloud(rng, 512, 1500, spread=0.03, scale=0.3)
    r2 = 0.01 if k == 8 else 0.015
    jtab = build_point_tables(jnp.asarray(p))
    _, ji = knn_radius_pallas(jnp.asarray(q), jnp.asarray(p), k=k,
                              radius2=r2, tables=jtab, remap_indices=False,
                              rt=4)
    tabs = tkc.build_point_tables(torch.tensor(p))
    td, ti = tkc.knn_radius(torch.tensor(q), tabs, k, r2)
    ps = tabs["pts_sorted"].numpy()
    full = _d2_f32(q, ps)
    srt = np.sort(full, 1)
    ok = srt[:, k - 1] <= r2
    assert ok.sum() > 100 and (~ok).sum() > 0
    ti_np = ti.numpy().astype(np.int64)
    # exact contract: ascending exact d2, in-radius only, (+inf, 0) beyond
    inr = (full <= r2).sum(1)
    slot = np.arange(k)[None]
    filled = slot < inr[:, None]
    np.testing.assert_array_equal(td.numpy()[filled],
                                  np.take_along_axis(full, ti_np, 1)[filled])
    np.testing.assert_array_equal(td.numpy()[filled],
                                  srt[:, :k][filled])
    assert np.isinf(td.numpy()[~filled]).all() and (ti_np[~filled] == 0).all()
    # set equality with the Pallas kernel where no 2^-10 tie decides
    ji_np = np.asarray(ji).astype(np.int64)
    np.testing.assert_allclose(
        np.sort(np.take_along_axis(full, ji_np, 1)[ok], 1), srt[ok, :k],
        rtol=2 ** -10, atol=1e-7)
    clear = ok & (srt[:, k] > srt[:, k - 1] * (1 + 2 ** -9))
    np.testing.assert_array_equal(np.sort(ti_np[clear], 1),
                                  np.sort(ji_np[clear], 1))


@pytest.mark.parametrize("qb", [16, 32, 64, 128, 256])
def test_candidate_tiles_prune_exactly(qb):
    """The tile lists the CUDA kernels walk (one block of qb queries each:
    K2 takes 16 or 64, K1 and K3 32 or 64) hold every in-radius point:
    walking only the listed
    tiles in list order, as csrc/knn_cells.cu does, reproduces the plain
    count and top-k exactly, sentinel queries at 1e9 and a ragged last block
    included."""
    rng = np.random.default_rng(9)
    q, p = _cloud(rng, 600, 4000, spread=0.03, scale=0.3)
    q[::37] = 1e9
    r2, k = 0.01, 8
    tabs = tkc.build_point_tables(torch.tensor(p))
    # Morton-ordered queries, as the render hands them over
    order = torch.argsort(_morton(q, tabs), stable=True)
    qt = torch.tensor(q)[order].contiguous()
    lst, cnt = tkc.candidate_tiles(qt, tabs, r2, qb=qb)
    pts_t = tabs["pts_t"].numpy()
    T, _, pts = pts_t.shape
    assert lst.shape == (-(-600 // qb), T)
    assert (tkc.radius_block(8192), tkc.radius_block(71680),
            tkc.count_block(7392), tkc.count_block(131072)) == (32, 64, 16, 64)
    assert tkc.topk_lanes(8192) * tkc.QB_FEW == tkc.THREADS
    if qb == tkc.QB:                      # the default is K3's block
        dl, dc = tkc.candidate_tiles(qt, tabs, r2)
        assert torch.equal(dl, lst) and torch.equal(dc, cnt)
    assert 0 < cnt.min() < T
    want_c = tkc.knn_count_plain(qt, tabs["pts_sorted"], r2).numpy()
    want_d, want_i = tkc.knn_radius_plain(qt, tabs["pts_sorted"], k, r2)
    qn = qt.numpy()
    for m in range(qn.shape[0]):
        b = m // qb
        tiles = lst[b, :cnt[b]].numpy()
        assert (np.diff(tiles) > 0).all()
        cand = pts_t[tiles].transpose(0, 2, 1).reshape(-1, 3)
        ids = (tiles[:, None] * pts + np.arange(pts)[None]).reshape(-1)
        d = _d2_f32(qn[m:m + 1], cand)[0]
        assert (d <= r2).sum() == want_c[m]
        sel = d <= r2
        o = np.argsort(d[sel], kind="stable")[:k]
        n = len(o)
        np.testing.assert_array_equal(d[sel][o], want_d[m, :n].numpy())
        np.testing.assert_array_equal(ids[sel][o], want_i[m, :n].numpy())


def _count_listed(qt, tabs, r2, qb):
    """K2 as the kernel computes it: per block of qb queries, the count
    over the listed tiles only."""
    lst, cnt = tkc.candidate_tiles(qt, tabs, r2, qb=qb)
    pts = tabs["pts_t"].shape[2]
    out = []
    for b in range(lst.shape[0]):
        tiles = lst[b, :cnt[b]].long()
        cand = tabs["pts_sorted"].reshape(-1, pts, 3)[tiles].reshape(-1, 3)
        out.append(tkc.knn_count_plain(qt[b * qb:(b + 1) * qb], cand, r2)
                   if len(tiles) else
                   torch.zeros(len(qt[b * qb:(b + 1) * qb]),
                               dtype=torch.int32))
    return torch.cat(out), cnt


def test_count_over_listed_tiles_same_for_every_qb():
    """A smaller query block lists fewer tiles and counts the same: the
    counts over the listed tiles at qb 16, 64, 128 and 256 all equal the
    brute-force count (a ragged M, sentinel queries, a sentinel-only
    block)."""
    rng = np.random.default_rng(12)
    q, p = _cloud(rng, 1000, 6000, spread=0.02, scale=0.3)
    q[::41] = 1e9
    r2 = 0.004
    tabs = tkc.build_point_tables(torch.tensor(p))
    order = torch.argsort(_morton(q, tabs), stable=True)
    qt = torch.cat([torch.tensor(q)[order],
                    torch.full((70, 3), 1e9)]).contiguous()
    want = tkc.knn_count_plain(qt, tabs["pts_sorted"], r2)
    assert int(want.max()) > 8
    assert (want[-70:] == (-6000) % tkc.PTS).all()    # the pad rows
    listed = {}
    for qb in (16, 64, 128, 256):
        got, cnt = _count_listed(qt, tabs, r2, qb)
        assert torch.equal(got, want), qb
        listed[qb] = int(cnt.sum()) * qb
    assert listed[16] < listed[64] < listed[128] < listed[256]


@pytest.mark.parametrize("qb", [16, 64, 128, 256])
def test_points_at_exactly_the_radius_count(qb):
    """Points at exactly d2 == r2 count (the <= of the tile test and of
    the distance test): lattice coordinates scaled by a power of two make
    every distance exact in fp32, r2 = 9 steps^2 is met by the offsets
    (3, 0, 0) and (2, 2, 1), and the count over the listed tiles equals the
    integer count."""
    rng = np.random.default_rng(13)
    step = 2.0 ** -4
    pi = np.unique(rng.integers(0, 24, size=(5000, 3)), axis=0)
    qi = rng.integers(0, 24, size=(700, 3))
    p = (pi * step).astype(np.float32)
    q = (qi * step).astype(np.float32)
    r2 = 9 * step * step
    tabs = tkc.build_point_tables(torch.tensor(p))
    order = torch.argsort(_morton(q, tabs), stable=True)
    qt = torch.tensor(q)[order].contiguous()
    qi = qi[order.numpy()]
    d2i = ((qi[:, None, :] - pi[None]) ** 2).sum(-1)
    want = (d2i <= 9).sum(1)
    on_edge = (d2i == 9).sum(1)
    assert on_edge.min() >= 0 and on_edge.sum() > 5000
    plain = tkc.knn_count_plain(qt, tabs["pts_sorted"], r2).numpy()
    np.testing.assert_array_equal(plain, want)
    got, cnt = _count_listed(qt, tabs, r2, qb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(cnt.min()) < tabs["pts_t"].shape[0]     # tiles are pruned
    # a tile whose box sits at exactly gap^2 == r2 from the block's box is
    # listed, and is not at the next smaller radius
    edge = {"t_lo": torch.tensor([[11.0, 0, 0], [10, 10, 9]]) * step,
            "t_hi": torch.tensor([[12.0, 8, 8], [12, 12, 12]]) * step}
    box = torch.tensor([[0.0, 0, 0], [8, 8, 8], [3, 1, 4]]) * step
    lst, cnt = tkc.candidate_tiles(box, edge, r2, qb=qb)
    assert cnt.tolist() == [2] and lst[0].tolist() == [0, 1]
    _, cnt = tkc.candidate_tiles(box, edge, float(np.nextafter(
        np.float32(r2), np.float32(0))), qb=qb)
    assert cnt.tolist() == [0]


def _morton(q, tabs):
    from apnerf_torch.ops.knn import morton_codes
    return morton_codes(torch.tensor(q), tabs["p_lo"], tabs["p_hi"])


def test_wrappers_dispatch_by_device():
    """CPU tensors take the plain versions; a device without a kernel
    raises instead of falling back."""
    rng = np.random.default_rng(10)
    q, p = _cloud(rng, 64, 300)
    tq, tp = torch.tensor(q), torch.tensor(p)
    d, i = tkb.knn_brute(tq, tp, 4)
    pd, pi = tkb.knn_brute_plain(tq, tp, 4)
    assert torch.equal(d, pd) and torch.equal(i, pi)
    with pytest.raises(ValueError):
        tkb.knn_brute(tq.to("meta"), tp.to("meta"), 4)
    tabs = tkc.build_point_tables(tp)
    with pytest.raises(ValueError):
        tkc.knn_count(tq.to("meta"), {k: v.to("meta")
                                      for k, v in tabs.items()}, 0.05)


def _lattice(rng, side, n_p, n_q, step=2.0 ** -4):
    """Points and queries on a lattice scaled by a power of two (every d2
    exact in fp32, so equal distances tie exactly), chip_smoke.lattice_case's
    construction at a smaller size."""
    pi = np.unique(rng.integers(0, side, size=(n_p, 3)), axis=0)
    qi = rng.integers(0, side, size=(n_q, 3))
    return (qi * step).astype(np.float32), (pi * step).astype(np.float32)


def _sorted_queries(q, tabs):
    order = torch.argsort(_morton(q, tabs), stable=True)
    return torch.tensor(q)[order].contiguous()


@pytest.mark.parametrize("k", [1, 8, 12, 16])
@pytest.mark.parametrize("case", ["lattice", "duplicates"])
def test_knn_radius_work_split_model(case, k):
    """K3's work split (topk_scan_model: per-lane top-k over strided
    points, lanes merged by (d2, index), tiles beyond a warp's kth
    distances skipped) equals knn_radius_plain bit for bit, with 8 and 4
    lanes a query: on a lattice where many distances tie exactly (and sit
    at exactly d2 == r2), and on a cloud whose points each appear two or
    three times (ties at equal d2, other indices). Sentinel queries and a
    ragged last block included. The prune skips tiles the listing keeps."""
    rng = np.random.default_rng(20 + k)
    if case == "lattice":
        q, p = _lattice(rng, 12, 1200, 300)
        r2 = 9 * 2.0 ** -8
    else:
        base = (rng.normal(size=(500, 3)) * 0.3).astype(np.float32)
        p = np.concatenate([base, base[::2], base[::3]])
        p = p[rng.permutation(len(p))]
        q = (p[rng.integers(0, len(p), 300)]
             + rng.normal(size=(300, 3)).astype(np.float32) * 0.02)
        r2 = 0.01
    q[::53] = 1e9
    tabs = tkc.build_point_tables(torch.tensor(p))
    qt = _sorted_queries(q, tabs)
    want_d, want_i = tkc.knn_radius_plain(qt, tabs["pts_sorted"], k, r2)
    assert (want_d[:, 0] == 0).any() or case == "duplicates"
    for lanes in (8, 4):
        d, i, tiles = tkc.topk_scan_model(qt, tabs, k, r2, lanes)
        assert torch.equal(d, want_d) and torch.equal(i, want_i), lanes
        _, cnt = tkc.candidate_tiles(qt, tabs, r2, qb=256 // lanes)
        assert 0 < int(tiles.sum()) <= int(cnt.sum()) * 8
    full = _d2_f32(qt.numpy(), tabs["pts_sorted"].numpy())
    assert (full == r2).any() or case == "duplicates"
    srt = np.sort(full, 1)
    assert (srt[:, 1:k + 1] == srt[:, :k]).any()      # ties inside the top-k


@pytest.mark.parametrize("k", [1, 8, 16])
@pytest.mark.parametrize("case", ["lattice_self", "ragged_P", "queries"])
def test_knn_brute_work_split_model(case, k):
    """K1's pruned search (knn_brute_model: Morton-sorted queries seeded
    with the largest d2 over k sorted points near them, the tiles walked
    from the block's own on and pruned by the warps' kth distances, every
    insert by (d2, original index)) equals knn_brute_plain bit for bit: a
    lattice self-query, where many distances tie; a cloud of P = 1,337 (not
    a multiple of the 128-point tile; its pad rows never enter); other
    queries than the points. The seeds bound the true kth distance, and the
    warps scan fewer tiles than a walk of every tile."""
    rng = np.random.default_rng(40 + k)
    if case == "lattice_self":
        _, p = _lattice(rng, 12, 1500, 1)
        q = p
    else:
        q, p = _cloud(rng, 400, 1337, spread=0.05, scale=0.3)
        if case == "ragged_P":
            q = p
    tp = torch.tensor(p)
    tq = tp if q is p else torch.tensor(q)
    want_d, want_i = tkb.knn_brute_plain(tq, tp, k)
    d, i, tiles = tkb.knn_brute_model(tq, tp, k)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    tables, order, pos = tkb.brute_plan(tq, tp)
    assert (pos is None) == (q is p)
    seed = tkb.brute_seeds(tq[order], tables["pts_sorted"], pos, k, len(p))
    assert (seed >= want_d[order, k - 1]).all()
    T = tables["pts_t"].shape[0]
    assert 0 < int(tiles.sum()) < tiles.numel() * T
    if case == "lattice_self":
        srt = np.sort(_d2_f32(p, p), 1)
        assert (srt[:, 2:k + 2] == srt[:, 1:k + 1]).any()   # ties at the kth


def test_c_entry_points_match_signatures():
    """Every extern "C" entry point of csrc/*.cu is declared in
    kernels/build.SIGNATURES with as many arguments as it takes, and every
    declared one exists (ctypes would otherwise fail only on the card, at
    load, or pass arguments in the wrong slots)."""
    import re
    from apnerf_torch.kernels import build
    found = {}
    for src in build.CSRC.glob("*.cu"):
        for name, args in re.findall(r'extern "C" \w+ (\w+)\(([^)]*)\)',
                                     src.read_text()):
            found[name] = len([a for a in args.split(",") if a.strip()])
    assert found == {k: len(v) for k, v in build.SIGNATURES.items()}
