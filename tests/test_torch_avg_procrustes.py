"""``avg_procrustes`` through the point model, on the CPU: the warp, the
frame (``prepare_frame``) and one stage-2 step's loss and gradients of
the port against the JAX package, with the blended frames replaced by
their nearest rotations (P1's plain version in the port).

The scene is torch_stage2_scene's (2,000 points, six joints, F = 32). Its
initial weights make the joints turn by hundredths of a radian, and a
blended frame near a rotation has two nearly equal singular values, where
``jax.grad`` of the JAX package's ``special_procrustes`` is wrong
(tests/test_torch_procrustes.py). So the joints here turn by 0.8-2.5
radians (explicit rotations, or the transform_net's rotation head scaled
200-fold) at the skinning temperature 1.0: every blended frame then has
singular values at least 0.1 of the largest apart, where both gradients
are sound (asserted).
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.models import temporal_points as jtp
from apnerf.train import stage2 as js2
from apnerf_torch.kernels import procrustes as pk
from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.train import stage2 as ts2
from apnerf_torch.utils.checkpoint import model_from_jax, params_from_jax
from torch_stage2_scene import (FAR, H, J, NEAR, GradsOut,  # noqa
                                artifacts, backbone, batch_arrays, camera,
                                config, force_jax_kernel_path, torch_batch,
                                W)

MIN_GAP = 0.1


def _model(seed=0):
    """(mcfg with avg_procrustes, params as numpy, JAX state, port model,
    port state): the JAX ``build_model``'s, at skinning temperature 1.0
    and with the rotation head of transform_net scaled 200-fold."""
    cfg = config(sample_budget=32)
    canonical, skeleton = artifacts()
    jtcfg, tcfg, heads = backbone()
    mcfg, params, state = js2.build_model(cfg, canonical, skeleton, heads,
                                          jtcfg, seed=seed)
    mcfg = dataclasses.replace(mcfg, avg_procrustes=True, knn_rt=4)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["theta_weight"] = np.array([1.0], np.float32)
    head = params["forward_warp"]["transform_net"]["layers"][-1]
    w = head["w"].reshape(head["w"].shape[0], J + 1, 4).copy()
    w[:, :J] *= 200.0                      # the joints; not global_t
    head["w"] = w.reshape(head["w"].shape)
    _, _, tstate = ts2.build_model(cfg, canonical, skeleton, heads, tcfg,
                                   device="cpu")
    model = model_from_jax(ttp.TemporalPointsConfig(
        **dict(dataclasses.asdict(mcfg), knn_rt=24)), params, device="cpu")
    return cfg, mcfg, params, state, model, tstate


def _rot_params():
    rng = np.random.default_rng(2)
    return np.concatenate([rng.normal(size=(J, 3)),
                           rng.uniform(0.8, 2.5, (J, 1))], -1
                          ).astype(np.float32)


def _gaps(frames):
    s = np.linalg.svd(np.asarray(frames, np.float64)[:, :3, :3],
                      compute_uv=False)
    return np.minimum(s[:, 0] - s[:, 1], s[:, 1] - s[:, 2]) / s[:, 0]


@pytest.fixture(scope="module")
def scene():
    return _model()


@pytest.mark.parametrize("pose", ["rot_params", "time"])
def test_warp_and_frame_vs_jax(pose, scene):
    """The warp with avg_procrustes and prepare_frame's inverse rotations
    (the transposes) against the JAX package, fp32 2e-5: the frames are
    rotations, and differ from the blends."""
    _, mcfg, params, state, model, tstate = scene
    kw = (dict(rot_params=_rot_params()) if pose == "rot_params"
          else dict(t=np.float32(0.3)))
    jf = jtp.prepare_frame(params, mcfg, state,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    blend = jtp.warp(params, dataclasses.replace(mcfg, avg_procrustes=False),
                     state, **{k: jnp.asarray(v) for k, v in kw.items()})
    assert _gaps(blend["frames"]).min() > MIN_GAP
    with torch.no_grad():
        tf = ttp.prepare_frame(model, tstate, **{k: torch.tensor(v)
                                                 for k, v in kw.items()})
    for key in ("xyz", "frames", "inv_rot", "joints_warped"):
        np.testing.assert_allclose(tf[key].numpy(), np.asarray(jf[key]),
                                   rtol=2e-5, atol=2e-5, err_msg=key)
    rot = tf["frames"][:, :3, :3]
    np.testing.assert_allclose((rot @ rot.transpose(1, 2)).numpy(),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
    assert torch.equal(tf["inv_rot"], rot.transpose(1, 2))
    assert np.abs(tf["frames"].numpy()
                  - np.asarray(blend["frames"])).max() > 1e-2


def test_warp_grads_vs_jax(scene):
    """The gradient of a scalar of the warped cloud and its frames with
    respect to the rotations, the skinning weights and the joints, through
    the nearest rotation: against jax.grad, each leaf to 1e-4 of its max
    |.| (fp32 factors divided by gaps of 0.1 or more)."""
    _, mcfg, params, state, model, tstate = scene
    rng = np.random.default_rng(4)
    rot = _rot_params()
    gx = rng.normal(size=(mcfg.n_points, 3)).astype(np.float32)
    gf = rng.normal(size=(mcfg.n_points, 4, 4)).astype(np.float32)

    def jloss(p, r):
        out = jtp.warp(p, mcfg, state, rot_params=r)
        return jnp.sum(out["xyz"] * gx) + jnp.sum(out["frames"] * gf)

    jg_p, jg_r = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(rot))
    r = torch.tensor(rot, requires_grad=True)
    out = ttp.warp(model, tstate, rot_params=r)
    ((out["xyz"] * torch.tensor(gx)).sum()
     + (out["frames"] * torch.tensor(gf)).sum()).backward()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg_p))
    pairs = [("rot_params", r.grad, np.asarray(jg_r))]
    for name in ("weights", "joints", "theta_weight"):
        pairs.append((name, dict(model.named_parameters())[name].grad,
                      want[name].numpy()))
    for name, got, ref in pairs:
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def _port_step(cfg, model, tstate, b, K, pose):
    loss_fn = ts2.make_loss_fn(model, tstate, cfg.pcd_train_config,
                               torch.tensor(K), torch.tensor(pose), H, W,
                               NEAR, FAR, 1.0, 1)
    model.zero_grad(set_to_none=True)
    loss, metrics, _ = loss_fn(torch_batch(b))
    loss.backward()
    metrics["loss"] = loss
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in model.named_parameters()})


def test_step_vs_jax(scene, monkeypatch):
    """One stage-2 step (make_loss_fn; the JAX make_train_step) with
    avg_procrustes, against the JAX kernel path. The loss terms to 1e-5
    relative (ARAP also to 1e-7 of the summed neighbour distances), as in
    torch_stage2_scene's check_step. The gradients: with joints turned by
    radians, a sample's position relative to its neighbours passes
    through the 2^9-frequency encoding, so the fp32 rounding of either
    package's SVD (1e-6 in R, in both) moves a gradient by up to 1e-3 of
    its max on average. The reference is the port's step with the polar
    factor taken in float64: the port must stay within 1e-4 (mean) and
    1e-2 (max) of it, each leaf relative to its max |.|, and within twice
    the JAX package's own departure from it (plus those bounds) of the
    JAX gradient."""
    cfg, mcfg, params, state, model, tstate = scene
    b = batch_arrays()
    blend = jtp.warp(params, dataclasses.replace(mcfg, avg_procrustes=False),
                     state, t=jnp.float32(b["t"]))
    assert _gaps(blend["frames"]).min() > MIN_GAP
    K, pose = camera()
    tm, tg = _port_step(cfg, model, tstate, b, K, pose)
    plain = pk.procrustes_plain
    with mock.patch.object(pk, "procrustes_plain", lambda M: tuple(
            x.float() for x in plain(M.double()))):
        _, ref = _port_step(cfg, model, tstate, b, K, pose)
    force_jax_kernel_path(monkeypatch)
    step = js2.make_train_step(mcfg, state, cfg.pcd_train_config,
                               GradsOut(), jnp.asarray(K), jnp.asarray(pose),
                               H, W, NEAR, FAR, 1.0, 1)
    grads, _, metrics = step(jax.tree_util.tree_map(jnp.asarray, params),
                             None, {k: jnp.asarray(v) for k, v in b.items()})
    jax.clear_caches()
    jm = {k: float(v) for k, v in metrics.items()}
    jg = params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), grads))
    arap_atol = 1e-7 * float(np.asarray(state["nn_distance"]).sum())
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                   atol=arap_atol if key == "arap" else 0,
                                   err_msg=key)
    assert set(tg) == set(jg)
    reached = 0
    for name, want in jg.items():
        got, want, r = tg[name].numpy(), want.numpy(), ref[name].numpy()
        scale = float(np.abs(r).max())
        assert np.isfinite(got).all(), name
        if scale == 0:
            assert not got.any() and not want.any(), name
            continue
        reached += 1
        port_dev = np.abs(got - r) / scale
        jax_dev = np.abs(want - r) / scale
        diff = np.abs(got - want) / scale
        assert port_dev.mean() <= 1e-4 and port_dev.max() <= 1e-2, (
            name, port_dev.mean(), port_dev.max())
        assert diff.mean() <= 2 * jax_dev.mean() + 1e-4, (
            name, diff.mean(), jax_dev.mean())
        assert diff.max() <= 2 * jax_dev.max() + 1e-2, (
            name, diff.max(), jax_dev.max())
    assert reached >= 20, reached
