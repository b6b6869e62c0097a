"""ZeRO-1 training steps of the port on gloo ranks spawned on the CPU (the
counterpart of tests/test_parallel_zero1.py, in its two settings): two
stage-1 and two stage-2 steps on 2 ranks with the moments ZeRO-1 split
(the JAX test's minimum sizes, 1,024 and 64 elements, so that the MLPs'
moments split too) and replicated, against the single-process steps.

* ZeRO-1 against replicated (the same summed gradients): the JAX test's
  tolerances, losses at rtol 1e-5, the parameters at rtol 2e-5 /
  atol 1e-6.
* Against the single-process steps: the losses at rtol 1e-4 and the
  parameters at rtol 2e-4 / atol 1e-6 (test_parallel_train.py's).
  Adam's m / sqrt(v) scales up a near-zero gradient's rounding, and the
  ranks sum a gradient's parts in another order than one process: on the
  larger stage-2 scene of torch_stage2_scene.py (64,000 ``canonical_feat``
  entries) one entry parted by 1.06e-5, a tenth of its lr, after the
  first step.

A ZeRO-1 run's mid-stage checkpoint (``fine_progress.pkl``, the stage-2
progress checkpoint) has the single-device format (the same tree, shapes
and types as a single-process run's) and resumes in one process, and a
single-process checkpoint resumes on 2 ranks: both resumed runs' losses
at rtol 1e-4 and parameters at rtol 2e-4 / atol 1e-6 of the
single-process run resumed in one process (a stage-1 resume draws its
batches anew, in both packages, so it is held to a resumed run).

The single-process reference runs on one thread, as each rank does (the
CPU's matrix products round differently on more threads). The skip-field
mask is on (``skip_zero_grad_fields = ["feature"]``, stage 1), and each
rank holds 1/world of every split moment."""
import copy
import shutil

import numpy as np
import pytest
import torch

import jax

from apnerf.models import tineuvox as jtv
from apnerf.ops import nn as jnn
from apnerf_torch.config import load_config
from apnerf_torch.data.synthetic import make_scene
from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.models import tineuvox as tt
from apnerf_torch.parallel import ranks
from apnerf_torch.utils.checkpoint import load_checkpoint
from torch_stage2_scene import artifacts, backbone, config  # noqa

MIN_SIZE = 1024   # stage 1; the JAX stage-2 test's 64 splits its leaves


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stage1_setup():
    """The JAX test's tiny stage-1 setting (num_voxels 4500: a 16^3 x 4
    grid), the port's seeded init."""
    cfg_model = tt.TiNeuVoxConfig(
        xyz_min=(-1, -1, -1), xyz_max=(1, 1, 1), num_voxels=4500,
        num_voxels_base=4500, voxel_dim=4, defor_depth=2, net_width=32,
        posbase_pe=4, viewbase_pe=2, timebase_pe=2, gridbase_pe=1,
        alpha_init=1e-3)
    model = tt.init_model(cfg_model, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        model.feature.add_(0.05)
    cfg_train = {
        "_stepsize": 0.5, "lrate_decay": 20, "N_rand": 32,
        "lrate_feature": 8e-2, "lrate_featurenet": 8e-4,
        "lrate_deformation_net": 6e-4, "lrate_densitynet": 8e-4,
        "lrate_timenet": 8e-4, "lrate_rgbnet": 8e-4,
        "weight_main": 1.0, "weight_entropy_last": 1e-3,
        "weight_rgbper": 1e-2, "weight_distortion": 5e-2,
        "weight_mask_loss": 0.0, "weight_tv_feature": 1e-4,
        "skip_zero_grad_fields": ["feature"],
    }
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[:, 2, 3] = 3.0
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    B = 32
    batch = {"rgb": torch.as_tensor(rng.uniform(size=(B, 3)),
                                    dtype=torch.float32),
             "mask": torch.ones(B), "time": torch.zeros(B),
             "cam": torch.arange(B) % 2,
             "pix": torch.as_tensor(rng.integers(0, 32 * 32, B))}
    return {"model": model, "cfg_train": cfg_train, "batch": batch,
            "args": (torch.as_tensor(np.stack([K, K])),
                     torch.as_tensor(poses), 32, 32, 0.5, 6.0, 1.0),
            "kw": {}}


def stage2_setup():
    """The JAX test's stage-2 setting: 96 points, 5 joints, F = 8, 4
    neighbours, 64 rays of 32 x 32 views, every loss term, two chamfer
    views; the heads from the JAX initialisers, the rest from the port's
    seeded init."""
    P_pts, J, F = 96, 5, 8
    rng = np.random.default_rng(1)
    pcd = rng.normal(size=(P_pts, 3)).astype(np.float32) * 0.3
    joints = rng.normal(size=(J, 3)).astype(np.float32) * 0.3
    bones = [[0, 1], [1, 2], [0, 3], [3, 4]]
    feat = rng.normal(size=(P_pts, F)).astype(np.float32)
    mcfg = ttp.TemporalPointsConfig(
        n_points=P_pts, n_joints=J, feat_dim=F, neighbours=4,
        timebase_pe=2, posbase_pe=4, viewbase_pe=2, stepsize=0.5,
        voxel_size=0.125, voxel_size_ratio=1.0, act_shift=-6.9,
        sample_budget=16, max_steps=64, featmlp_kernel=False)
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    views_ch = 3 + 3 * 2 * mcfg.viewbase_pe
    heads = jax.tree_util.tree_map(np.asarray, {
        "rgbnet": jtv.init_rgbnet(ks[0], F, views_ch),
        "densitynet": jnn.init_mlp(ks[1], [F, 1]),
        "timenet": jnn.init_mlp(ks[2], [mcfg.t_dim, 16, F])})
    model = ttp.init_params(mcfg, pcd, joints, bones, feat,
                            np.full(P_pts, 0.5, np.float32),
                            np.full((P_pts, 3), 0.5, np.float32), heads,
                            torch.Generator().manual_seed(3), device="cpu")
    state = ttp.init_state(mcfg, pcd, joints, bones, pcd[:16],
                           pcd.min(0) - 0.2, pcd.max(0) + 0.2, device="cpu")
    cfg_train = {
        "lrate_decay": 160, "weight_render": 2e2, "weight_arap": 5e-3,
        "weight_tv": 1e1, "weight_sparsity": 2e-1,
        "weight_transformation_reg": 1e-1, "weight_joint_chamfer": 1.0,
        "weight_chamfer2D": 5e-3, "lrate_rgbnet": 1e-4,
        "lrate_densitynet": 1e-4, "lrate_canonical_feat": 1e-4,
        "lrate_gammas": 1e-3, "lrate_weights": 1e-4,
        "lrate_theta_weight": 1e-4, "lrate_forward_warp": 1e-4,
        "lrate_joints": 1e-5, "lrate_feat_net": 1e-3,
        "skip_zero_grad_fields": [],
    }
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[:, 2, 3] = 3.0
    Kc = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]], np.float32)
    Ks = np.stack([Kc, Kc])
    B = 64
    batch = {
        "rgb": torch.full((B, 3), 0.5), "mask": torch.ones(B),
        "t": 0.25, "cam": torch.arange(B) % 2,
        "pix": torch.as_tensor(rng.integers(0, 32 * 32, B)),
        "sparsity_on": 1.0,
        "chamfer_poses": torch.as_tensor(poses),
        "chamfer_Ks": torch.as_tensor(Ks),
        "chamfer_mask_pts": torch.as_tensor(
            rng.uniform(0, 32, (2, 64, 2)).astype(np.float32)),
        "chamfer_pcd_idx": torch.as_tensor(rng.integers(0, P_pts, 64)),
    }
    return {"model": model, "state": state, "cfg_train": cfg_train,
            "batch": batch,
            "args": (torch.as_tensor(Ks), torch.as_tensor(poses), 32, 32,
                     0.5, 6.0, 1.0, 2), "kw": {}}


def _check(single, runs, world, setup, min_size):
    zero1, replicated = runs
    # the same summed gradients: the JAX zero1-vs-replicated tolerances
    np.testing.assert_allclose(zero1["losses"], replicated["losses"],
                               rtol=1e-5)
    for k, v in replicated["params"][-1].items():
        np.testing.assert_allclose(zero1["params"][-1][k], v, rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    for run in runs:
        np.testing.assert_allclose(run["losses"], single["losses"],
                                   rtol=1e-4)
        for k, v in single["params"][-1].items():
            np.testing.assert_allclose(run["params"][-1][k], v, rtol=2e-4,
                                       atol=1e-6, err_msg=k)
    params = dict(setup["model"].named_parameters())
    assert zero1["split"] and not replicated["split"]
    for n, p in params.items():
        held = zero1["held_mu"][n].size
        if p.numel() >= min_size:
            assert held == -(-p.numel() // world), n
        else:
            assert held == p.numel(), n


@pytest.mark.parametrize("stage", [1, 2])
def test_zero1_step_matches_replicated_and_single(stage, tmp_path,
                                                  one_thread):
    setup = stage1_setup() if stage == 1 else stage2_setup()
    (single,) = ranks.train_steps(stage=stage, setup=copy.deepcopy(setup))
    world, min_size = 2, (MIN_SIZE if stage == 1 else 64)
    got = ranks.spawn(world, ranks.train_steps, store_dir=str(tmp_path),
                      stage=stage, setup=setup,
                      zero1_min_sizes=(min_size, None))
    for runs in got:
        _check(single, runs, world, setup, min_size)
    if stage == 1:
        assert "feature" in got[0][0]["split"]


def _resume_run(stage):
    if stage == 1:
        cfg = load_config("apnerf_torch/config/configs/nerf/default.py")
        cfg.data.update(inverse_y=False, flip_x=False, flip_y=False)
        cfg.model_and_render.update(num_voxels=12 ** 3,
                                    num_voxels_base=12 ** 3, voxel_dim=4,
                                    net_width=24, defor_depth=3)
        cfg.train_config.update(N_rand=64, weight_tv_feature=1e-3,
                                pg_scale=[3], occupancy_start=3)
        return ranks.train_stage1, dict(cfg=cfg,
                                         data=make_scene(3, 24, 24, seed=0),
                                         seed=3, log_every=1)
    cfg = config(active_fraction=0.3, pass_fraction=0.3)
    cfg.pcd_train_config.update(N_rand=64, full_t_iter=6)
    canonical, skeleton = artifacts()
    _, tcfg, heads = backbone()
    return ranks.train_stage2, dict(
        cfg=cfg, data=make_scene(3, 32, 32, seed=0), canonical=canonical,
        skeleton=skeleton, heads=heads, tcfg=tcfg,
        bbox=(np.full(3, -1.5), np.full(3, 1.5)), seed=0, log_every=1,
        sample_budget=32)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    a = np.asarray(tree)
    return (a.shape, a.dtype.str)


@pytest.mark.parametrize("stage", [1, 2])
def test_zero1_checkpoint_resumes_either_way(stage, tmp_path, one_thread):
    program, run = _resume_run(stage)
    half = {}
    for who in ("mesh", "single"):
        path = str(tmp_path / f"{who}.pkl")
        kw = dict(n_iters=2, ckpt_path=path, ckpt_every=2, **run)
        if who == "mesh":
            ranks.spawn(2, program, store_dir=str(tmp_path), **kw)
        else:
            program(**kw)
        half[who] = path
    a, b = load_checkpoint(half["mesh"]), load_checkpoint(half["single"])
    assert a["global_step"] == b["global_step"] == 2
    assert _structure(a["opt_state"]) == _structure(b["opt_state"])
    assert _structure(a["params"]) == _structure(b["params"])

    def resume(src, name, world=1):
        path = str(tmp_path / name)
        shutil.copy(half[src], path)
        kw = dict(n_iters=4, ckpt_path=path, **run)
        if world == 1:
            return [program(**kw)]
        return ranks.spawn(world, program, store_dir=str(tmp_path), **kw)

    # the reference: the single-process run resumed in one process
    (want,) = resume("single", "ref.pkl")
    assert len(want["stats"]["loss"]) == 2
    for res in resume("mesh", "in_one.pkl") + resume("single", "on_two.pkl",
                                                     world=2):
        np.testing.assert_allclose(res["stats"]["loss"],
                                   want["stats"]["loss"], rtol=1e-4)
        for k, v in want["params"].items():
            np.testing.assert_allclose(res["params"][k], v, rtol=2e-4,
                                       atol=1e-6, err_msg=k)
