"""The TiNeuVox backbone's camera-id conditioning (``add_cam``) and its
density-only render (``ray_density``) in the port against the JAX package
on the CPU, from the same parameters.

With ``add_cam`` the colour head takes ``camnet(poc_fre(cam_sel))``
beside the view encoding. The JAX package's ``init_params`` sizes that
head for the view encoding alone, so its forward fails on the shape; the
port sizes it as the reference TiNeuVox does (``rgb_views_ch``). Here
both packages run on the port's head: the JAX params get a head of that
width from the JAX initialiser. Tolerances as test_torch_tineuvox.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.models import tineuvox as jt
from apnerf.ops import nn as jnn
from apnerf_torch.models import tineuvox as tt
from apnerf_torch.utils.checkpoint import params_from_jax
from test_torch_tineuvox import (BG, BRANCHES, FAR, NEAR, STEP, _cfg,
                                 _loss_jax, _loss_port, _occ)


def _setup(**kw):
    """(JAX config, JAX params with the port's head, port model, rays,
    times, camera ids, colours)."""
    kw = _cfg(add_cam=True, **kw)
    jcfg = jt.TiNeuVoxConfig(**kw)
    tcfg = tt.TiNeuVoxConfig(**kw)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    W = jcfg.net_width
    params["rgbnet"]["views_linears"] = jnn.init_mlp(
        jax.random.PRNGKey(7), [W + tcfg.rgb_views_ch, W // 2, 3])
    rng = np.random.default_rng(1)
    params["feature"] = jnp.asarray(
        rng.normal(size=params["feature"].shape).astype(np.float32))
    model = tt.TiNeuVox(tcfg)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    N = 48
    ro = np.zeros((N, 3), np.float32) + [0.0, 0.0, 0.9]
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:, :2] *= 0.2
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.random((N, 1)).astype(np.float32)
    cam = rng.integers(0, 4, (N, 1)).astype(np.float32)
    rgb = rng.random((N, 3)).astype(np.float32)
    return jcfg, params, model, (ro, d, t, cam), rgb


def test_head_width():
    """The port's colour head adds camnet's output to the view channels
    under add_cam, and only then; the JAX package's views_ch is the view
    encoding's."""
    for add_cam in (False, True):
        for no_view_dir in (False, True):
            kw = _cfg(add_cam=add_cam, no_view_dir=no_view_dir)
            j, t = jt.TiNeuVoxConfig(**kw), tt.TiNeuVoxConfig(**kw)
            assert t.views_ch == j.views_ch
            extra = t.timenet_output if add_cam and not no_view_dir else 0
            assert t.rgb_views_ch == j.views_ch + extra
            net = tt.TiNeuVox(t).rgbnet.views_linears
            assert net.layers[0].in_features == t.net_width + t.rgb_views_ch


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_add_cam_forward_and_grads_vs_jax(branch):
    """The forward with camera ids in the dense, per-sample and
    coarse-group layouts: outputs at 1e-5, the stage-1 loss's gradient of
    every parameter (camnet's included) at rtol 1e-4 / atol 1e-6."""
    G, use_budget, use_occ = BRANCHES[branch]
    jcfg, params, model, (ro, d, t, cam), rgb = _setup(occ_group=G)
    S = jcfg.max_steps(STEP)
    N = ro.shape[0]
    occ2, occ3 = _occ(jcfg)
    occ = (occ3 if G > 1 else occ2) if use_occ else None
    budget = N * (-(-S // G)) * G if use_budget else None

    def jloss(p):
        res = jt.forward(p, jcfg, jnp.asarray(ro), jnp.asarray(d),
                         jnp.asarray(d), jnp.asarray(t), NEAR, FAR, STEP,
                         BG, S, cam_sel=jnp.asarray(cam), occ_grid=occ,
                         active_budget=budget)
        return _loss_jax(res, jnp.asarray(rgb)), res

    (lj, rj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    rt = tt.forward(model, torch.tensor(ro), torch.tensor(d),
                    torch.tensor(d), torch.tensor(t), NEAR, FAR, STEP, BG, S,
                    occ_grid=None if occ is None else torch.tensor(
                        np.asarray(occ)), active_budget=budget,
                    cam_sel=torch.tensor(cam))
    lt = _loss_port(rt, torch.tensor(rgb))
    lt.backward()
    for k in ("rgb_marched", "weights", "alphainv_last", "raw_rgb"):
        np.testing.assert_allclose(rt[k].detach().numpy(), np.asarray(rj[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, gj))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert float(got["camnet.layers.0.weight"].abs().max()) > 0
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_camera_ids_change_the_colour():
    """Two camera ids, the same rays: another colour, the same density."""
    _, _, model, (ro, d, t, cam), _ = _setup()
    S = model.cfg.max_steps(STEP)
    outs = [tt.forward(model, torch.tensor(ro), torch.tensor(d),
                       torch.tensor(d), torch.tensor(t), NEAR, FAR, STEP, BG,
                       S, cam_sel=torch.full((ro.shape[0], 1), c))
            for c in (0.0, 3.0)]
    assert torch.equal(outs[0]["raw_alpha"], outs[1]["raw_alpha"])
    assert not torch.allclose(outs[0]["raw_rgb"], outs[1]["raw_rgb"])


def test_add_cam_without_camera_ids_raises():
    """With add_cam and no cam_sel the port raises ValueError, where the
    JAX package fails inside poc_fre (a TypeError); the grid export of the
    colour head has no camera ids either."""
    jcfg, params, model, (ro, d, t, _), _ = _setup()
    S = jcfg.max_steps(STEP)
    args = (NEAR, FAR, STEP, BG, S)
    with pytest.raises(TypeError):
        jt.forward(params, jcfg, jnp.asarray(ro), jnp.asarray(d),
                   jnp.asarray(d), jnp.asarray(t), *args)
    with pytest.raises(ValueError, match="cam_sel"):
        tt.forward(model, torch.tensor(ro), torch.tensor(d),
                   torch.tensor(d), torch.tensor(t), *args)
    xyz = tt.grid_xyz_coords(model.cfg, 0.5)
    tt.eval_alpha_volume(model, xyz, 0.4, STEP)         # alpha alone runs
    with pytest.raises(ValueError, match="add_cam"):
        tt.eval_alpha_volume(model, xyz, 0.4, STEP, want_features=True)


@pytest.mark.parametrize("add_cam", [False, True])
def test_ray_density_vs_jax(add_cam):
    """The density-only render (no deformation, no colour head): weights,
    s and valid at 1e-5, n_max equal, and the gradient of the weights'
    sum for every parameter at rtol 1e-4 / atol 1e-6."""
    if add_cam:
        jcfg, params, model, (ro, d, t, _), _ = _setup()
    else:
        kw = _cfg()
        jcfg = jt.TiNeuVoxConfig(**kw)
        params = jt.init_params(jax.random.PRNGKey(0), jcfg)
        params["feature"] = jnp.asarray(np.random.default_rng(1).normal(
            size=params["feature"].shape).astype(np.float32))
        model = tt.TiNeuVox(tt.TiNeuVoxConfig(**kw))
        model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        _, _, _, (ro, d, t, _), _ = _setup()
    S = jcfg.max_steps(STEP)

    def jfn(p):
        res = jt.ray_density(p, jcfg, jnp.asarray(ro), jnp.asarray(d),
                             jnp.asarray(t), NEAR, FAR, STEP, S)
        return jnp.sum(res["weights"] * jnp.arange(S)), res

    (_, rj), gj = jax.value_and_grad(jfn, has_aux=True)(params)
    rt = tt.ray_density(model, torch.tensor(ro), torch.tensor(d),
                        torch.tensor(t), NEAR, FAR, STEP, S)
    (rt["weights"] * torch.arange(S)).sum().backward()
    assert rt["n_max"] == rj["n_max"]
    np.testing.assert_array_equal(rt["valid"].numpy(), np.asarray(rj["valid"]))
    assert float(rt["weights"].detach().sum()) > 0
    for k in ("weights", "s"):
        np.testing.assert_allclose(rt[k].detach().numpy(), np.asarray(rj[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, gj))
    for n, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)
