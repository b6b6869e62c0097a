"""The port's op layer (apnerf_torch.ops and the small model helpers)
against the JAX package on the CPU: the same numpy inputs through both,
fp32 at rtol 1e-5 / atol 1e-6 unless stated."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_poc_fre():
    from apnerf.ops import encoding as je
    from apnerf_torch.ops import encoding as te
    x = np.random.default_rng(0).normal(size=(7, 5, 3)).astype(np.float32)
    want = je.poc_fre(jnp.asarray(x), je.poc_freqs(6))
    got = te.poc_fre(torch.tensor(x), te.poc_freqs(6))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("act,final", [("relu", None),
                                       ("leaky_relu", "leaky_relu")])
def test_mlp(act, final):
    from apnerf.ops import nn as jnn
    from apnerf_torch.ops.nn import MLP
    from apnerf_torch.utils.checkpoint import params_from_jax
    dims = [9, 16, 16, 4]
    p = jnn.init_mlp(jax.random.PRNGKey(0), dims)
    x = np.random.default_rng(1).normal(size=(11, 9)).astype(np.float32)
    fn = {"relu": jax.nn.relu, "leaky_relu": jnn.leaky_relu}
    want = jnn.mlp(p, jnp.asarray(x), activation=fn[act],
                   final_activation=None if final is None else fn[final])
    m = MLP(dims, act, final)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, p)))
    with torch.no_grad():
        got = m(torch.tensor(x))
    _close(got, want)


def test_raw2alpha():
    from apnerf.ops.activation import raw2alpha as jr
    from apnerf_torch.ops.activation import raw2alpha as tr
    d = np.random.default_rng(2).normal(size=(64,)).astype(np.float32) * 4
    _close(tr(torch.tensor(d), -2.0, 0.5), jr(jnp.asarray(d), -2.0, 0.5))


def test_alpha2weights_composite():
    """Includes rays that stop early (T < 1e-3) and rays that do not."""
    from apnerf.ops import marching as jm
    from apnerf_torch.ops import marching as tm
    rng = np.random.default_rng(3)
    alpha = rng.random((16, 24)).astype(np.float32)
    alpha[:8] *= 0.05                       # never reaches the stop
    valid = rng.random((16, 24)) > 0.2
    vals = rng.random((16, 24, 3)).astype(np.float32)
    jw, ja = jm.alpha2weights(jnp.asarray(alpha), jnp.asarray(valid))
    tw, ta = tm.alpha2weights(torch.tensor(alpha), torch.tensor(valid))
    assert (np.asarray(ja)[8:] < 1e-3).any() and (np.asarray(ja)[:8] > 0.3).all()
    _close(tw, jw)
    _close(ta, ja)
    _close(tm.composite(tw, torch.tensor(vals), bg=1.0, alphainv_last=ta),
           jm.composite(jw, jnp.asarray(vals), bg=1.0, alphainv_last=ja))
    _close(tm.composite(tw, torch.tensor(vals[..., 0])),
           jm.composite(jw, jnp.asarray(vals[..., 0])))


def test_ray_aabb_and_get_rays():
    from apnerf.ops import rays as jr
    from apnerf_torch.ops import rays as tr
    K = np.array([[50.0, 0, 16], [0, 50.0, 12], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 2.5]
    jo, jd = jr.get_rays(24, 32, K, c2w)
    to, td = tr.get_rays(24, 32, K, c2w)
    _close(to, jo)
    _close(td, jd)
    d = td.reshape(-1, 3).numpy().copy()
    d[::7, 0] = 0.0                          # axis-parallel rays
    o = to.reshape(-1, 3).numpy()
    lo = np.array([-0.5, -0.4, -0.3], np.float32)
    hi = np.array([0.4, 0.5, 0.6], np.float32)
    j0, j1 = jr.ray_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                         jnp.asarray(hi), 0.5, 6.0)
    t0, t1 = tr.ray_aabb(torch.tensor(o), torch.tensor(d), torch.tensor(lo),
                         torch.tensor(hi), 0.5, 6.0)
    _close(t0, j0)
    _close(t1, j1)


@pytest.mark.parametrize("n", [3, 4])
def test_rodrigues(n):
    from apnerf.ops.rotations import rodrigues as jr
    from apnerf_torch.ops.rotations import rodrigues as tr
    v = np.random.default_rng(4).normal(size=(10, n)).astype(np.float32)
    jR, jt = jr(jnp.asarray(v))
    tR, tt = tr(torch.tensor(v))
    _close(tR, jR)
    _close(tt, jt)


def test_special_procrustes():
    from apnerf.ops.rotations import special_procrustes as jp
    from apnerf_torch.ops.rotations import special_procrustes as tp
    m = (np.eye(3) + 0.3 * np.random.default_rng(5).normal(size=(12, 3, 3))
         ).astype(np.float32)
    _close(tp(torch.tensor(m)), jp(jnp.asarray(m)))


def test_inv3x3():
    from apnerf.models.temporal_points import _inv3x3 as ji
    from apnerf_torch.models.temporal_points import _inv3x3 as ti
    m = (np.eye(3) + 0.4 * np.random.default_rng(6).normal(size=(20, 3, 3))
         ).astype(np.float32)
    _close(ti(torch.tensor(m)), ji(jnp.asarray(m)))


def test_compact_per_ray():
    from apnerf.models.temporal_points import _compact_per_ray as jc
    from apnerf_torch.models.temporal_points import _compact_per_ray as tc
    valid = np.random.default_rng(7).random((9, 40)) > 0.6
    np.testing.assert_array_equal(tc(torch.tensor(valid), 12).numpy(),
                                  np.asarray(jc(jnp.asarray(valid), 12)))


def test_morton_codes_bit_identical():
    """Including sentinel rows far outside the normalisation box."""
    from apnerf.ops.knn import morton_codes as jm
    from apnerf_torch.ops.knn import morton_codes as tm
    p = np.random.default_rng(8).normal(size=(500, 3)).astype(np.float32)
    p[::50] = 1e9
    lo = np.array([-2.0, -2.5, -3.0], np.float32)
    hi = np.array([2.0, 2.5, 3.0], np.float32)
    want = np.asarray(jm(jnp.asarray(p), jnp.asarray(lo),
                         jnp.asarray(hi))).astype(np.int64)
    got = tm(torch.tensor(p), torch.tensor(lo), torch.tensor(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    q = p[p[:, 0] < 1e8]
    np.testing.assert_array_equal(
        tm(torch.tensor(q)).numpy(),
        np.asarray(jm(jnp.asarray(q))).astype(np.int64))
