"""The port's TiNeuVox backbone against the JAX package on the CPU, from
the same parameters (params_from_jax): forward in its three layouts
(dense, per-sample compaction, coarse-group occupancy), the gradients of
the stage-1 loss for every parameter, and eval_alpha_volume. fp32 on
both sides; tolerances stated per test."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.models import tineuvox as jt
from apnerf.ops import compaction as jc
from apnerf.ops import marching as jm
from apnerf_torch.models import tineuvox as tt
from apnerf_torch.ops import marching as tm
from apnerf_torch.utils.checkpoint import params_from_jax

STEP, NEAR, FAR, BG = 0.5, 0.05, 1.53, 1.0


def _cfg(**kw):
    base = dict(xyz_min=(-1.0, -1.0, -1.0), xyz_max=(1.0, 1.0, 1.0),
                num_voxels=10 ** 3, num_voxels_base=10 ** 3, voxel_dim=4,
                defor_depth=3, net_width=16, posbase_pe=3, viewbase_pe=2,
                timebase_pe=3, gridbase_pe=1, alpha_init=1e-2,
                fast_color_thres=1e-4)
    base.update(kw)
    return base


def _setup(**kw):
    jcfg = jt.TiNeuVoxConfig(**_cfg(**kw))
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    params["feature"] = jnp.asarray(
        rng.normal(size=params["feature"].shape).astype(np.float32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = tt.TiNeuVox(tt.TiNeuVoxConfig(**_cfg(**kw)))
    model.load_state_dict(params_from_jax(tree))
    # rays start INSIDE the bbox and the march ends (far) before any
    # sample reaches a face: the in-bbox test at a face is fp-fragile
    # between programs (tests/test_occ_group.py)
    N = 48
    ro = np.zeros((N, 3), np.float32) + [0.0, 0.0, 0.9]
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:, :2] *= 0.2
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.random((N, 1)).astype(np.float32)
    rgb = rng.random((N, 3)).astype(np.float32)
    return jcfg, params, model, (ro, d, d.copy(), t), rgb


def _occ(jcfg):
    flags = np.zeros(jcfg.world_size, bool)
    flags[3:7, 3:7, 2:8] = True
    occ = jc.build_occupancy_grid(jnp.asarray(flags))
    return occ, jc.build_occupancy_grid(occ)


def _loss_jax(res, rgb):
    """The stage-1 loss terms (train/stage1.py loss_fn), entropy, rgbper
    and distortion included."""
    mse = jnp.mean((res["rgb_marched"] - rgb) ** 2)
    pout = jnp.clip(res["alphainv_last"], 1e-6, 1 - 1e-6)
    ent = -(pout * jnp.log(pout) + (1 - pout) * jnp.log(1 - pout)).mean()
    per = ((res["raw_rgb"] - rgb[:, None]) ** 2).sum(-1)
    per = (per * jax.lax.stop_gradient(res["weights"])).sum() / rgb.shape[0]
    dist = jm.distortion_loss(res["weights"], res["s"], 1.0 / res["n_max"])
    return mse + 1e-3 * ent + 1e-2 * per + 5e-2 * dist


def _loss_port(res, rgb):
    mse = torch.mean((res["rgb_marched"] - rgb) ** 2)
    pout = torch.clamp(res["alphainv_last"], 1e-6, 1 - 1e-6)
    ent = -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout)).mean()
    per = ((res["raw_rgb"] - rgb[:, None]) ** 2).sum(-1)
    per = (per * res["weights"].detach()).sum() / rgb.shape[0]
    dist = tm.distortion_loss(res["weights"], res["s"], 1.0 / res["n_max"])
    return mse + 1e-3 * ent + 1e-2 * per + 5e-2 * dist


BRANCHES = {"dense": (4, False, False), "per_sample": (1, True, True),
            "coarse_group": (4, True, True)}


# forward outputs at 1e-5; parameter gradients at rtol 1e-4 / atol 1e-6
# (the loss sums hundreds of samples through five small MLPs; the grid
# gradient's summation order differs, see test_torch_grid.py)
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_forward_and_loss_grads_vs_jax(branch):
    G, use_budget, use_occ = BRANCHES[branch]
    jcfg, params, model, (ro, rd, vd, t), rgb = _setup(occ_group=G)
    S = jcfg.max_steps(STEP)
    N = ro.shape[0]
    occ2, occ3 = _occ(jcfg)
    occ = (occ3 if G > 1 else occ2) if use_occ else None
    budget = N * (-(-S // G)) * G if use_budget else None

    def jloss(p):
        res = jt.forward(p, jcfg, jnp.asarray(ro), jnp.asarray(rd),
                         jnp.asarray(vd), jnp.asarray(t), NEAR, FAR, STEP,
                         BG, S, occ_grid=occ, active_budget=budget)
        return _loss_jax(res, jnp.asarray(rgb)), res

    (lj, rj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    rt = tt.forward(model, torch.tensor(ro), torch.tensor(rd),
                    torch.tensor(vd), torch.tensor(t), NEAR, FAR, STEP, BG,
                    S, occ_grid=None if occ is None else torch.tensor(
                        np.asarray(occ)), active_budget=budget)
    lt = _loss_port(rt, torch.tensor(rgb))
    lt.backward()
    assert bool(rt["valid"].any())
    np.testing.assert_array_equal(rt["valid"].numpy(), np.asarray(rj["valid"]))
    # ray_pts_delta of a budget's unfilled slots is unused and differs by
    # design (the port spreads those slots over the rays)
    keys = ["rgb_marched", "weights", "alphainv_last", "raw_alpha", "depth"]
    for k in keys + ([] if use_budget else ["ray_pts_delta"]):
        np.testing.assert_allclose(rt[k].detach().numpy(), np.asarray(rj[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, gj))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        assert g is not None, n
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_config_geometry_matches():
    kw = _cfg(xyz_min=(-1.3, -0.7, -1.0), xyz_max=(1.1, 0.9, 0.4),
              num_voxels=37 ** 3)
    a, b = jt.TiNeuVoxConfig(**kw), tt.TiNeuVoxConfig(**kw)
    assert a.get_kwargs() == b.get_kwargs()
    for k in ("world_size", "voxel_size", "voxel_size_ratio", "act_shift",
              "featurenet_input", "views_ch"):
        assert getattr(a, k) == getattr(b, k), k
    assert a.max_steps(STEP) == b.max_steps(STEP)
    assert a.n_samples(STEP) == b.n_samples(STEP)


def test_eval_alpha_volume_and_rescale_vs_jax():
    """Alpha on the grid nodes at one time, in batches that split the
    grid unevenly (1e-5), and the same after scale_volume_grid (the
    progressive-grid rebuild) at half the node density."""
    jcfg, params, model, _, _ = _setup()
    xyz = jt.grid_xyz_coords(jcfg, 1.0)
    np.testing.assert_array_equal(tt.grid_xyz_coords(model.cfg, 1.0), xyz)
    want = jt.eval_alpha_volume(params, jcfg, xyz, 0.4, STEP)
    got = tt.eval_alpha_volume(model, xyz, 0.4, STEP, batch=333)
    assert got.shape == want.shape == xyz.shape[:3]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    p2, c2 = jt.scale_volume_grid(params, jcfg, 14 ** 3)
    tt.scale_volume_grid(model, 14 ** 3)
    assert model.cfg == tt.TiNeuVoxConfig(**c2.get_kwargs())
    np.testing.assert_allclose(model.feature.detach().numpy(),
                               np.asarray(p2["feature"]), rtol=1e-6,
                               atol=1e-6)
    xyz2 = jt.grid_xyz_coords(c2, 0.5)
    np.testing.assert_array_equal(tt.grid_xyz_coords(model.cfg, 0.5), xyz2)
    np.testing.assert_allclose(
        tt.eval_alpha_volume(model, xyz2, 1.0, STEP),
        jt.eval_alpha_volume(p2, c2, xyz2, 1.0, STEP), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dense", [True, False])
def test_feature_tv_grad_vs_jax(dense):
    jcfg, params, model, _, _ = _setup()
    photo = np.random.default_rng(2).normal(size=params["feature"].shape)
    photo[photo > 0.3] = 0.0
    photo = photo.astype(np.float32)
    want = jt.feature_tv_grad(params, jcfg, 0.7, jnp.asarray(photo),
                              jnp.float32(1.0 if dense else 0.0))
    got = tt.feature_tv_grad(model, 0.7, torch.tensor(photo), dense)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    if not dense:
        assert (got.numpy()[photo == 0.0] == 0.0).all()
