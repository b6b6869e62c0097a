"""The smaller functions of the JAX package the port had no counterpart
of, against it on the CPU: ``point_warper.get_thetas``, the 3-D chamfer
helpers ``ops/knn.{nn1, chamfer, batch_chamfer}``,
``ops/rays.sample_ndc_pts_on_rays``, ``ops/grid.total_variation``,
``ops/activation.activate_density`` and ``ops/encoding.poc_dim``. The
same numpy inputs through both; fp32 tolerances stated per test."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.models import point_warper as jpw
from apnerf.ops import activation as jact
from apnerf.ops import encoding as jenc
from apnerf.ops import grid as jgrid
from apnerf.ops import rays as jrays
from apnerf_torch.models import point_warper as tpw
from apnerf_torch.ops import activation as tact
from apnerf_torch.ops import encoding as tenc
from apnerf_torch.ops import grid as tgrid
from apnerf_torch.ops import knn as tknn
from apnerf_torch.ops import rays as trays
from apnerf_torch.utils.checkpoint import params_from_jax

# the module (apnerf.ops re-exports its jitted knn under the same name)
jknn = importlib.import_module("apnerf.ops.knn")


def test_get_thetas_vs_jax():
    """Per-time joint angles from the transform net, for a batch of 7
    time embeddings: 1e-5."""
    cfg = jpw.WarpConfig(n_joints=5, t_dim=9, num_layers=3, hidden_dim=32)
    params = jpw.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tpw.WarpConfig(n_joints=5, t_dim=9, num_layers=3, hidden_dim=32)
    warper = tpw.PointWarper(tcfg)
    warper.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    ts = np.random.default_rng(0).normal(size=(7, 9)).astype(np.float32)
    want = np.asarray(jpw.get_thetas(params, cfg, jnp.asarray(ts)))
    with torch.no_grad():
        got = tpw.get_thetas(warper, tcfg, torch.tensor(ts))
    assert got.shape == want.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _clouds(n1=300, n2=200, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n1, 3)).astype(np.float32),
            rng.normal(size=(n2, 3)).astype(np.float32) * 0.8 + 0.1)


def _unique_nearest(q, p):
    """Queries whose nearest and second-nearest points differ by more
    than 1e-5 in d2 (where two fp32 distance formulas may order a tie
    either way)."""
    d = np.sort(((q[:, None] - p[None]) ** 2).sum(-1), 1)
    return d[:, 1] - d[:, 0] > 1e-5


def test_nn1_and_chamfer_vs_jax():
    """nn1 (K1's plain version at k = 1, queries that are not the points)
    and both chamfer directions: d2 to 1e-5 relative / 1e-6 absolute (the
    JAX CPU path's matmul-form distances against the kernel's rounding),
    indices equal wherever the nearest point is unique."""
    a, b = _clouds()
    jd, ji = jknn.nn1(jnp.asarray(a), jnp.asarray(b))
    td, ti = tknn.nn1(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    keep = _unique_nearest(a, b)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(ti.numpy()[keep], np.asarray(ji)[keep])
    for got, want in zip(tknn.chamfer(torch.tensor(a), torch.tensor(b)),
                         jknn.chamfer(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_batch_chamfer_vs_jax(dim):
    """The dense batched chamfer loss and its gradient with respect to
    both clouds: 1e-5."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 50, dim)).astype(np.float32)
    b = rng.normal(size=(3, 40, dim)).astype(np.float32)
    want, (ga, gb) = jax.value_and_grad(jknn.batch_chamfer, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    got = tknn.batch_chamfer(ta, tb)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-5,
                               atol=1e-7)


def test_sample_ndc_pts_on_rays_vs_jax():
    """Points, the bbox mask, step ids, t_min and n_steps: points 1e-6,
    the rest equal (rays that leave the bbox on the way included)."""
    rng = np.random.default_rng(3)
    o = rng.uniform(-1, 1, (20, 3)).astype(np.float32)
    d = rng.normal(size=(20, 3)).astype(np.float32)
    lo, hi = (-0.8, -0.9, -1.0), (0.9, 0.8, 0.7)
    want = jrays.sample_ndc_pts_on_rays(jnp.asarray(o), jnp.asarray(d), lo,
                                        hi, 17)
    got = trays.sample_ndc_pts_on_rays(torch.tensor(o), torch.tensor(d), lo,
                                       hi, 17)
    np.testing.assert_allclose(got.pts.numpy(), np.asarray(want.pts),
                               rtol=1e-6, atol=1e-6)
    valid = got.valid.numpy()
    assert 0 < valid.mean() < 1
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    for key in ("step_id", "t_min", "n_steps"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)))


@pytest.mark.parametrize("masked", [False, True])
def test_total_variation_vs_jax(masked):
    """The TV loss (differences past 1 in magnitude included) and its
    gradient, with and without an edge mask: 1e-5 relative / 1e-8
    absolute. Without a mask its gradient is total_variation_grad's
    clamped differences at weight 6 / voxel count (1e-6)."""
    rng = np.random.default_rng(4)
    g = (rng.normal(size=(6, 5, 7, 3)) * 0.8).astype(np.float32)
    mask = rng.random((6, 5, 7)) < 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want, jg = jax.value_and_grad(jgrid.total_variation)(jnp.asarray(g), jm)
    tg = torch.tensor(g, requires_grad=True)
    got = tgrid.total_variation(tg, None if mask is None
                                else torch.tensor(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-8)
    if not masked:
        analytic = tgrid.total_variation_grad(torch.tensor(g),
                                              6.0 / (6 * 5 * 7))
        np.testing.assert_allclose(tg.grad.numpy(), analytic.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_activate_density_vs_jax():
    """alpha and its guarded backward: 1e-6."""
    d = (np.random.default_rng(5).normal(size=(64,)) * 6).astype(np.float32)
    want, jg = jax.value_and_grad(
        lambda x: jnp.sum(jact.activate_density(x, 0.37, -4.2) ** 2))(
        jnp.asarray(d))
    td = torch.tensor(d, requires_grad=True)
    got = (tact.activate_density(td, 0.37, -4.2) ** 2).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("c,n", [(1, 0), (3, 4), (3, 10), (12, 2)])
def test_poc_dim(c, n):
    """poc_dim is poc_fre's width, as the JAX package counts it."""
    assert tenc.poc_dim(c, n) == jenc.poc_dim(c, n)
    x = torch.zeros(2, c)
    assert tenc.poc_fre(x, tenc.poc_freqs(n)).shape[-1] == tenc.poc_dim(c, n)
