"""The port's grid ops (apnerf_torch.ops.grid) and raw2alpha's backward
against the JAX package on the CPU: the same numpy inputs through both,
fp32, tolerances stated per test."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.ops import grid as jg
from apnerf_torch.ops import grid as tg

LO, HI = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)


def _grid_pts(seed, shape, C, n=2048, spread=1.1):
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(*shape, C)).astype(np.float32)
    # some points outside the bbox: their out-of-grid corners weigh 0
    pts = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    cot = rng.normal(size=(n, C)).astype(np.float32)
    return grid, pts, cot


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _port_grads(fn, grid, pts, cot):
    g = torch.tensor(grid, requires_grad=True)
    p = torch.tensor(pts, requires_grad=True)
    out = fn(g, p)
    (out * torch.tensor(np.broadcast_to(cot, out.shape).copy())).sum() \
        .backward()
    return out.detach(), g.grad, p.grad


def _jax_grads(fn, grid, pts, cot):
    def loss(g, p):
        out = fn(g, p)
        return (out * jnp.broadcast_to(cot, out.shape)).sum(), out
    (_, out), (dg, dp) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(grid), jnp.asarray(pts))
    return out, dg, dp


# forward at fp32 rounding (1e-6); gradients of a 2048-sample sum at
# 1e-5 (the port bins the grid gradient by a sort and K5, JAX-CPU by an
# XLA scatter: another summation order)
@pytest.mark.parametrize("which", ["grid_interp", "mult_dist_interp"])
def test_interp_forward_and_grads_vs_jax(which):
    C = 4
    grid, pts, cot = _grid_pts(0, (9, 10, 11), C)
    if which == "grid_interp":
        jfn = lambda g, p: jg.grid_interp(g, p, jnp.asarray(LO),  # noqa
                                          jnp.asarray(HI))
        tfn = lambda g, p: tg.grid_interp(g, p, torch.tensor(LO),  # noqa
                                          torch.tensor(HI))
    else:
        jfn = lambda g, p: jg.mult_dist_interp(  # noqa
            g, p, jnp.asarray(LO), jnp.asarray(HI))
        tfn = lambda g, p: tg.mult_dist_interp(  # noqa
            g, p, torch.tensor(LO), torch.tensor(HI))
        cot = np.concatenate([cot] * 3, -1)
    out_j, dg_j, dp_j = _jax_grads(jfn, grid, pts, cot)
    out_t, dg_t, dp_t = _port_grads(tfn, grid, pts, cot)
    _close(out_t, out_j, 1e-6, 1e-6)
    _close(dg_t, dg_j, 1e-5, 1e-5)
    _close(dp_t, dp_j, 1e-5, 1e-5)


@pytest.mark.parametrize("C", [12, 24])
def test_grid_grad_vs_jax_tpu_route(monkeypatch, C):
    """The port's d/dgrid (sort + K5 plain version + shifted reduce)
    against the JAX package's TPU route, forced on the CPU with the Pallas
    scatter in interpret mode (tests/test_kernels_interpret.py's recipe).
    C = 24 takes the 12-channel chunked path."""
    knnmod = importlib.import_module("apnerf.ops.knn")
    monkeypatch.setattr(knnmod, "_tpu_default", lambda: True)
    kp = importlib.import_module("apnerf.kernels.knn_pallas")
    monkeypatch.setattr(kp, "_interpret_mode", lambda: True)
    monkeypatch.setenv("APNERF_SCATTER", "1")
    monkeypatch.setenv("APNERF_PACK8", "0")
    grid, pts, cot = _grid_pts(7, (9, 9, 9), C)
    jfn = lambda g, p: jg.grid_interp(g, p, jnp.asarray(LO),  # noqa
                                      jnp.asarray(HI))
    _, dg_j, _ = _jax_grads(jfn, grid, pts, cot)
    _, dg_t, _ = _port_grads(
        lambda g, p: tg.grid_interp(g, p, torch.tensor(LO),
                                    torch.tensor(HI)), grid, pts, cot)
    _close(dg_t, dg_j, 1e-5, 1e-5)


def test_resize_trilinear_vs_jax():
    grid, _, _ = _grid_pts(1, (5, 6, 7), 3)
    want = jg.resize_trilinear(jnp.asarray(grid), (9, 11, 1))
    got = tg.resize_trilinear(torch.tensor(grid), (9, 11, 1))
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-6, 1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_total_variation_grad_vs_jax(masked):
    grid, _, _ = _grid_pts(2, (6, 5, 4), 3)
    grid *= 2.0                     # differences beyond the +-1 clamp too
    mask = np.random.default_rng(3).random((6, 5, 4)) > 0.5
    want = jg.total_variation_grad(jnp.asarray(grid), 0.3,
                                   jnp.asarray(mask) if masked else None)
    got = tg.total_variation_grad(torch.tensor(grid), 0.3,
                                  torch.tensor(mask) if masked else None)
    _close(got, want, 1e-6, 1e-7)


def test_raw2alpha_backward_vs_jax():
    """The custom backward, including the min(e, 1e10) guard: densities
    up to 40 put exp(density + shift) above 1e10."""
    from apnerf.ops.activation import raw2alpha as jr
    from apnerf_torch.ops.activation import raw2alpha as tr
    d = np.concatenate([np.random.default_rng(4).normal(size=60) * 4,
                        [25.0, 30.0, 35.0, 40.0]]).astype(np.float32)
    shift, interval = -6.9, 0.5
    assert np.exp(d.max() + shift) > 1e10
    want = jax.grad(lambda x: (jr(x, shift, interval) * jnp.arange(64.0))
                    .sum())(jnp.asarray(d))
    x = torch.tensor(d, requires_grad=True)
    (tr(x, shift, interval) * torch.arange(64.0)).sum().backward()
    _close(x.grad, want, 1e-5, 1e-12)
