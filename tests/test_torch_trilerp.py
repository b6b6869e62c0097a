"""Kernel G1 (``apnerf_torch/kernels/trilerp.py``, ``csrc/trilerp.cu``):
the stage-1 multi-scale trilinear sample and its gradient.

On the CPU a float32 numpy model of the kernels' index arithmetic and
arithmetic order (``_model_forward``, ``_model_backward``) is held to the
plain path (``ops/grid.mult_dist_interp_plain``): the corner products and
keys exactly, the forward within 2 ulp (the CPU sums the 8 corners in
another order than the CUDA reduce the kernel follows), K5's rows in sorted
order and the grid gradient exactly, d/dpts against a float64 central
difference. The tests marked ``card`` run G1 itself against the plain path
on a CUDA device and skip without one:

    python3 -m pytest --noconftest tests/test_torch_trilerp.py -m card

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which a machine with
the card need not have.)
"""
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from apnerf_torch import kernels  # noqa: E402
from apnerf_torch.kernels import trilerp  # noqa: E402
from apnerf_torch.kernels.scatter import \
    sorted_window_accumulate_plain  # noqa: E402
from apnerf_torch.ops import grid as tg  # noqa: E402

F32, F64 = np.float32, np.float64
LO = np.array([-1.0, -0.5, -2.0], F32)
HI = np.array([1.0, 1.5, 0.25], F32)
# n - 1 a multiple of 4 on every side; on none; a mix with C = 8
SHAPES = [((13, 9, 17), 12), ((10, 7, 15), 12), ((6, 5, 11), 8)]


def _inputs(shape, C, seed, n=1500):
    """Grid, points and cotangent: points inside and outside the bbox, on
    its faces and corners, and a block of rows with an all-zero cotangent
    at one position (the unfilled slots of an active-sample budget), and
    rows whose cotangent is zero at one scale only."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(*shape, C)).astype(F32)
    unit = rng.uniform(-0.15, 1.15, size=(n, 3))
    face = rng.integers(0, 2, size=(n // 5, 3)).astype(F64)
    pick = rng.random((n // 5, 3)) < 0.5
    unit[:n // 5] = np.where(pick, face, unit[:n // 5])
    unit[n // 5:n // 5 + 8] = [[i >> 2 & 1, i >> 1 & 1, i & 1]
                               for i in range(8)]
    xyz = (LO + unit * (HI - LO)).astype(F32)
    xyz[n // 5:n // 5 + 8] = np.where(unit[n // 5:n // 5 + 8] > 0, HI, LO)
    xyz[:n // 5] = np.where(pick, np.where(face > 0, HI, LO), xyz[:n // 5])
    g = rng.normal(size=(n, 3 * C)).astype(F32)
    g[-200:] = 0.0
    xyz[-200:] = xyz[-201]
    g[100:150, C:2 * C] = 0.0
    return grid, xyz, g


def _unit(xyz):
    """The bbox-normalised points as the plain path and G1 form them."""
    x = torch.tensor(xyz)
    return ((x - torch.tensor(LO)) / (torch.tensor(HI) - torch.tensor(LO))
            ).numpy()


def _plain_dims(shape):
    g = tg.pad_to_mult4(torch.zeros(*shape, 1))
    return [tuple(g[::s, ::s, ::s].shape[:3]) for s in trilerp.STRIDES]


# ----------------------------------------------------------------------
# The model: csrc/trilerp.cu's arithmetic in numpy, one sample a row.
# ----------------------------------------------------------------------

def _locate(unit, dims, dt):
    last = np.array([d - 1 for d in dims], dt)
    u = (unit.astype(dt) * last).astype(dt)
    f = np.floor(u)
    frac = (u - f).astype(dt)
    i0 = np.clip(f, -2, np.array(dims, dt)).astype(np.int64)
    return frac, i0


def _corners(frac, i0, dims, s, n, dt):
    """Corner k = dx*4 + dy*2 + dz: weight ((wx*wy)*wz)*ok [M, 8], the
    cell it reads in the unpadded grid (-1: the padding's zero), its
    per-axis weights [M, 8, 3] and ok [M, 8]."""
    M = frac.shape[0]
    w = np.empty((M, 8), dt)
    cell = np.empty((M, 8), np.int64)
    axes = np.empty((M, 8, 3), dt)
    oks = np.empty((M, 8), bool)
    for k in range(8):
        d = (k >> 2 & 1, k >> 1 & 1, k & 1)
        wa = [frac[:, a] if d[a] else (dt(1) - frac[:, a]).astype(dt)
              for a in range(3)]
        i = [i0[:, a] + d[a] for a in range(3)]
        ok = np.ones(M, bool)
        for a in range(3):
            ok &= (i[a] >= 0) & (i[a] < dims[a])
        w[:, k] = ((wa[0] * wa[1]) * wa[2]) * ok.astype(dt)
        p = [np.clip(i[a], 0, dims[a] - 1) * s for a in range(3)]
        inside = (p[0] < n[0]) & (p[1] < n[1]) & (p[2] < n[2])
        cell[:, k] = np.where(inside, (p[0] * n[1] + p[1]) * n[2] + p[2],
                              -1)
        axes[:, k] = np.stack(wa, -1)
        oks[:, k] = ok
    return w, cell, axes, oks


def _scales(grid, unit, dt):
    n, C = grid.shape[:3], grid.shape[3]
    flat = np.concatenate([grid.reshape(-1, C), np.zeros((1, C))]).astype(dt)
    for si, ((dims, n_cells, key_off), s) in enumerate(
            zip(trilerp.geometry(n), trilerp.STRIDES)):
        frac, i0 = _locate(unit, dims, dt)
        yield (si, s, dims, n_cells, key_off, frac, i0,
               *_corners(frac, i0, dims, s, n, dt), flat)


def _model_forward(grid, unit, dt=F32):
    """[M, 3C]: each corner's product, the 8 summed as the CUDA reduce over
    [M, 8, C]'s corner axis sums them: four accumulators from 0, corner q
    then q + 4, combined in order. In float64 (``dt``) the same function
    is the reference of the central differences."""
    outs = []
    for (_, _, _, _, _, _, _, w, cell, _, _, flat) in _scales(grid, unit,
                                                              dt):
        p = flat[cell] * w[:, :, None]
        a = [(dt(0) + p[:, q]) + p[:, q + 4] for q in range(4)]
        outs.append(((a[0] + a[1]) + a[2]) + a[3])
    return np.concatenate(outs, -1)


def _model_backward(grid, unit, g):
    """-> dict: per scale ``keys`` (local) and ``rows`` (K5's rows in the
    joint stable order, keyed-out rows zero), ``idx`` (their local keys),
    ``dgrid`` [X, Y, Z, C] and ``dunit`` [M, 3] (float64 chain, rounded
    once)."""
    X, Y, Z, C = grid.shape
    M = unit.shape[0]
    out = {"keys": [], "rows": [], "idx": [], "acc": []}
    dunit = np.zeros((M, 3), F64)
    joint, per = [], []
    for (si, s, dims, n_cells, key_off, frac, i0, w, cell, axes, oks,
         flat) in _scales(grid, unit, F32):
        gs = g[:, si * C:(si + 1) * C]
        ext = [d + 1 for d in dims]
        b = [np.clip(i0[:, a] + 1, 0, dims[a]) for a in range(3)]
        base = (b[0] * ext[1] + b[1]) * ext[2] + b[2]
        key = np.where((gs != 0).any(-1), base, n_cells)
        out["keys"].append(key)
        joint.append(key + key_off)
        dw = (flat[cell].astype(F64) * gs[:, None, :].astype(F64)).sum(-1)
        ax = np.where(oks[..., None], axes.astype(F64), 0.0)
        for a in range(3):
            sign = np.array([1.0 if k >> (2 - a) & 1 else -1.0
                             for k in range(8)])
            others = np.prod(np.delete(ax, a, axis=-1), -1)
            dunit[:, a] += (sign * dw * others).sum(-1) * (dims[a] - 1)
        per.append((dims, n_cells, key_off, w, gs))
    order = np.argsort(np.concatenate(joint), kind="stable")
    keys_sorted = np.concatenate(joint)[order]
    folds = []
    for si, (dims, n_cells, key_off, w, gs) in enumerate(per):
        seg = slice(si * M, (si + 1) * M)
        m = order[seg] - si * M
        local = keys_sorted[seg] - key_off
        live = local < n_cells
        rows = (gs[m][:, None, :] * w[m][:, :, None]).reshape(M, 8 * C)
        rows = np.where(live[:, None], rows, F32(0))
        out["rows"].append(rows)
        out["idx"].append(local)
        acc = sorted_window_accumulate_plain(
            torch.tensor(local.astype(np.int32)), torch.tensor(rows),
            n_cells, transposed=True).numpy()
        out["acc"].append(acc)
        ext = [d + 1 for d in dims]
        xs, ys, zs = np.meshgrid(*(np.arange(d) for d in dims),
                                 indexing="ij")
        J = ((xs * ext[1] + ys) * ext[2] + zs).reshape(-1)
        red = np.zeros((C, J.size), F32)
        for k in range(8):
            dx, dy, dz = k >> 2 & 1, k >> 1 & 1, k & 1
            off = ((1 - dx) * ext[1] + (1 - dy)) * ext[2] + (1 - dz)
            red = red + acc[k * C:(k + 1) * C, J + off]
        folds.append(red.reshape(C, *dims))
    dg = folds[0][:, :X, :Y, :Z].copy()
    c2 = folds[1][:, :(X + 1) // 2, :(Y + 1) // 2, :(Z + 1) // 2].copy()
    c4 = folds[2][:, :(X + 3) // 4, :(Y + 3) // 4, :(Z + 3) // 4]
    c2[:, ::2, ::2, ::2] = c4 + c2[:, ::2, ::2, ::2]
    dg[:, ::2, ::2, ::2] = c2 + dg[:, ::2, ::2, ::2]
    out["dgrid"] = np.ascontiguousarray(dg.transpose(1, 2, 3, 0))
    out["dunit"] = dunit.astype(F32)
    out["dunit64"] = dunit
    return out


# ----------------------------------------------------------------------
# The plain path's intermediates, read out of ops/grid.py
# ----------------------------------------------------------------------

def _plain_corners(grid, unit):
    """Per scale: (corner products [M, 8, C], lin_ext, weights) of the
    plain path's padded, strided grid and ``_corner_tables``."""
    gp = tg.pad_to_mult4(torch.tensor(grid))
    u_all = torch.tensor(unit)
    out = []
    for s in trilerp.STRIDES:
        gs = gp[::s, ::s, ::s]
        sx, sy, sz, C = gs.shape
        last = torch.tensor([sx - 1.0, sy - 1.0, sz - 1.0])
        u = u_all * last
        i0f = torch.floor(u)
        i0 = i0f.to(torch.int64)
        lins, ws = tg._corner_tables((sx, sy, sz), i0, u - i0f)
        b = [(i0[:, a] + 1).clamp(0, n) for a, n in enumerate((sx, sy, sz))]
        lin_ext = (b[0] * (sy + 1) + b[1]) * (sz + 1) + b[2]
        vals = gs.reshape(-1, C)[lins]
        out.append((vals * ws[:, :, None], lin_ext, ws))
    return out


def _plain_grads(grid, xyz, g):
    gt = torch.tensor(grid, requires_grad=True)
    xt = torch.tensor(xyz, requires_grad=True)
    out = tg.mult_dist_interp_plain(gt, xt, torch.tensor(LO),
                                    torch.tensor(HI))
    dg, dx = torch.autograd.grad(out, (gt, xt), torch.tensor(g))
    return out.detach().numpy(), dg.numpy(), dx.numpy()


@pytest.mark.parametrize("shape", [s for s, _ in SHAPES] + [(1, 4, 2)])
def test_geometry_is_the_plain_paths_padded_strided_grids(shape):
    geo = trilerp.geometry(shape)
    assert [d for d, _, _ in geo] == _plain_dims(shape)
    assert [n for _, n, _ in geo] == [
        (a + 1) * (b + 1) * (c + 1) for a, b, c in _plain_dims(shape)]
    offs = [o for _, _, o in geo]
    assert offs[0] == 0 and offs[1] == geo[0][1] + 1 \
        and offs[2] == offs[1] + geo[1][1] + 1


@pytest.mark.parametrize("C,CG", [(12, 12), (24, 12), (36, 12), (8, 8),
                                  (20, 20), (6, 6)])
def test_channel_chunk_is_the_plain_grid_grads(C, CG):
    assert trilerp.channel_chunk(C) == CG


@pytest.mark.parametrize("shape,C", SHAPES)
def test_model_forward_products_exact_and_sum_within_2_ulp(shape, C):
    grid, xyz, _ = _inputs(shape, C, seed=1)
    unit = _unit(xyz)
    got = _model_forward(grid, unit)
    plain = _plain_corners(grid, unit)
    # the weights and each corner's product, exactly; summed in the CUDA
    # reduce's order, exactly the model
    geo = trilerp.geometry(shape)
    for si, (p, _, ws) in enumerate(plain):
        dims = geo[si][0]
        w = _corners(*_locate(unit, dims, F32), dims, trilerp.STRIDES[si],
                     shape, F32)[0]
        assert np.array_equal(w, ws.numpy())
        q = [p[:, k] for k in range(8)]
        z = torch.zeros_like(q[0])
        want = ((((z + q[0]) + q[4]) + ((z + q[1]) + q[5]))
                + ((z + q[2]) + q[6])) + ((z + q[3]) + q[7])
        assert np.array_equal(got[:, si * C:(si + 1) * C], want.numpy())
    # the plain path on the CPU sums in its own order: within 2 ulp of the
    # sum of the products' magnitudes
    out, _, _ = _plain_grads(grid, xyz, np.zeros((len(xyz), 3 * C), F32))
    mag = np.concatenate([p.abs().sum(1).numpy() for p, _, _ in plain], -1)
    assert np.all(np.abs(got - out) <= 2 * np.spacing(mag.astype(F32)))


@pytest.mark.parametrize("shape,C", SHAPES)
def test_model_keys_and_sorted_rows_are_the_plain_paths(shape, C):
    grid, xyz, g = _inputs(shape, C, seed=2)
    unit = _unit(xyz)
    got = _model_backward(grid, unit, g)
    for si, (p, lin_ext, ws) in enumerate(_plain_corners(grid, unit)):
        gs = torch.tensor(g[:, si * C:(si + 1) * C])
        n_cells = trilerp.geometry(shape)[si][1]
        live = (gs != 0).any(-1)
        key = torch.where(live, lin_ext, torch.full_like(lin_ext, n_cells))
        assert np.array_equal(got["keys"][si], key.numpy())
        # ops/grid.py _grid_grad's sorted rows and keys
        order = torch.argsort(key, stable=True)
        upd = (gs[:, None, :] * ws[:, :, None]).reshape(-1, 8 * C)
        idx = key[order].numpy()
        assert np.array_equal(got["idx"][si], idx)
        rows = upd[order].numpy()
        keep = idx < n_cells
        assert 0 < keep.sum() < len(keep)
        assert np.array_equal(got["rows"][si][keep], rows[keep])


@pytest.mark.parametrize("shape,C", SHAPES)
def test_model_grid_gradient_is_the_plain_paths_bit_for_bit(shape, C):
    grid, xyz, g = _inputs(shape, C, seed=3)
    got = _model_backward(grid, _unit(xyz), g)
    _, dg, _ = _plain_grads(grid, xyz, g)
    assert np.array_equal(got["dgrid"], dg)
    assert np.array_equal(got["dgrid"] == 0, dg == 0)
    # the scales overlap on the lattice cells, where the order counts
    assert (dg != 0).any()


@pytest.mark.parametrize("shape,C", SHAPES)
def test_model_dpts_vs_float64_central_difference(shape, C):
    grid, xyz, g = _inputs(shape, C, seed=4, n=600)
    unit = _unit(xyz)
    got = _model_backward(grid, unit, g)
    span = (HI - LO).astype(F64)
    dx_model = got["dunit64"] / span
    _, _, dx_plain = _plain_grads(grid, xyz, g)
    x64 = xyz.astype(F64)
    h = 1e-7
    cd = np.zeros_like(x64)
    for a in range(3):
        e = np.zeros(3)
        e[a] = h * span[a]
        fp = (_model_forward(grid, (x64 + e - LO) / span, F64) * g).sum(-1)
        fm = (_model_forward(grid, (x64 - e - LO) / span, F64) * g).sum(-1)
        cd[:, a] = (fp - fm) / (2 * e[a])
    # leave out samples within 2h of a cell face at any scale: the
    # function has a kink there
    near = np.zeros(len(x64), bool)
    u64 = (x64 - LO) / span
    for dims, _, _ in trilerp.geometry(shape):
        u = u64 * (np.array(dims) - 1)
        fr = u - np.floor(u)
        near |= ((fr < 4 * h * max(dims)) | (fr > 1 - 4 * h * max(dims))
                 ).any(-1)
    keep = ~near
    assert keep.sum() > len(keep) // 2
    scale = np.abs(cd[keep]).max()
    err_model = np.abs(dx_model - cd)[keep].max()
    err_plain = np.abs(dx_plain - cd)[keep].max()
    assert err_model <= 1e-5 * scale, (err_model, err_plain, scale)
    assert err_model <= 2 * err_plain + 1e-7 * scale, (err_model, err_plain)


@pytest.mark.parametrize("shape,C", SHAPES)
def test_dunit_float64_is_the_models_float64_chain(shape, C):
    """The card tests' yardstick of d/dpts (``chip_smoke.trilerp_dunit64``:
    the float64 derivative at the float32 cell coordinates) against the
    model's float64 chain, which the kernel rounds once. They differ only
    where the kernel's weight 1 - frac is rounded to float32: within a
    float32 ulp of the largest entry."""
    grid, xyz, g = _inputs(shape, C, seed=6, n=600)
    unit = _unit(xyz)
    want = _model_backward(grid, unit, g)["dunit64"]
    got = cs.trilerp_dunit64(torch, torch.tensor(grid), torch.tensor(unit),
                             torch.tensor(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -23 * np.abs(want).max())


def test_cpu_tensors_take_the_plain_path_and_cuda_tensors_g1():
    """The dispatch: a CPU tensor never reaches G1's wrapper; a tensor
    that is not on the CPU goes to it (the wrapper stands in for the
    card)."""
    grid, xyz, _ = _inputs((13, 9, 17), 12, seed=5, n=600)
    args = (torch.tensor(grid), torch.tensor(xyz), torch.tensor(LO),
            torch.tensor(HI))

    def no_g1(*a):
        raise AssertionError("G1 on a CPU tensor")
    with mock.patch.object(trilerp, "mult_dist_interp_cuda", no_g1):
        want = tg.mult_dist_interp(*args)
    calls = []

    def g1(*a):
        calls.append(a)
        return tg.mult_dist_interp_plain(*a)
    with mock.patch.object(tg, "on_cpu", lambda *t: False), \
            mock.patch.object(trilerp, "mult_dist_interp_cuda", g1):
        got = tg.mult_dist_interp(*args)
    assert len(calls) == 1 and torch.equal(got, want)


# ----------------------------------------------------------------------
# On the card: G1 itself against the plain path
# ----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(shape, C, seed, n):
    dev = _cuda()
    grid, xyz, g = _inputs(shape, C, seed, n)
    lo, hi = torch.tensor(LO, device=dev), torch.tensor(HI, device=dev)
    return (torch.tensor(grid, device=dev), torch.tensor(xyz, device=dev),
            lo, hi, torch.tensor(g, device=dev))


def _both(grid, xyz, lo, hi, g, fn):
    gr = grid.clone().requires_grad_(True)
    xr = xyz.clone().requires_grad_(True)
    out = fn(gr, xr, lo, hi)
    dg, dx = torch.autograd.grad(out, (gr, xr), g)
    return out.detach(), dg, dx


CARD_CASES = [((13, 9, 17), 12, 4000), ((10, 7, 15), 12, 4000),
              ((6, 5, 11), 8, 3000), ((9, 13, 6), 6, 3000),
              ((11, 12, 13), 24, 3000), ((41, 41, 41), 12, 1 << 16)]


@pytest.mark.card
@pytest.mark.parametrize("shape,C,n", CARD_CASES)
def test_card_g1_bit_equal_to_the_plain_path(shape, C, n):
    grid, xyz, lo, hi, g = _card_case(shape, C, 11, n)
    out_p, dg_p, dx_p = _both(grid, xyz, lo, hi, g,
                              tg.mult_dist_interp_plain)
    out_k, dg_k, dx_k = _both(grid, xyz, lo, hi, g,
                              trilerp.mult_dist_interp_cuda)
    assert torch.equal(out_k, out_p)
    assert torch.equal(dg_k, dg_p)
    # d/dpts: no further from float64 (at the float32 cell coordinates both
    # take) than the plain path's own
    span = (hi - lo).double()
    dx64 = cs.trilerp_dunit64(torch, grid, (xyz - lo) / (hi - lo), g) / span
    err_k = (dx_k.double() - dx64).abs().max()
    err_p = (dx_p.double() - dx64).abs().max()
    assert err_k <= err_p, (float(err_k), float(err_p))


@pytest.mark.card
def test_card_g1_launches_and_capture():
    grid, xyz, lo, hi, g = _card_case((13, 9, 17), 12, 12, 2000)
    kernels.reset_launches()
    out, dg, _ = _both(grid, xyz, lo, hi, g, trilerp.mult_dist_interp_cuda)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trilerp"] == 1
    assert kernels.LAUNCHES["trilerp_grad"] == 3
    assert kernels.LAUNCHES["scatter"] == 3
    gr = grid.clone().requires_grad_(True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.autograd.grad(trilerp.mult_dist_interp_cuda(gr, xyz, lo, hi),
                            gr, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o2 = trilerp.mult_dist_interp_cuda(gr, xyz, lo, hi)
        d2 = torch.autograd.grad(o2, gr, g)[0]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(o2, out) and torch.equal(d2, dg)
