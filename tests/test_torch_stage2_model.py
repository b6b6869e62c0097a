"""``build_model`` and a four-step ``make_train_step`` trajectory of the
port against the JAX package's CPU path (brute-force k-NN, no Morton
tables), on the scene of torch_stage2_scene.py.

* ``build_model``: equal model configs; equal state (the canonical k-NN
  through K1's plain version against the JAX CPU k-NN: equal neighbour
  sets wherever the kth and (k+1)th distances differ, distances 1e-6);
  the parameters that are not drawn at random (skinning weights, joints,
  the per-point arrays, the backbone heads) equal to 1e-6.
* The trajectory: four steps of masked Adam from the JAX ``build_model``'s
  parameters (carried over with ``model_from_jax``), batches from four
  seeds, fp32, the non-fused sampler pair (budget 40) and the fused one
  (budget 32). Both budgets at 1 (``active_fraction``,
  ``pass_fraction``) so that no sample is cut: the two packages then
  render the same samples, in another order. Adam's normalised step moves
  an entry whose gradient is near 0 by up to lr whatever the gradient's
  rounding, and the stage-2 gradient is discontinuous (see
  test_torch_stage2_step.py), so the packages' parameters part by whole
  steps in single entries: measured after four steps up to 2.4 lr (an
  entry of feat_net's first layer), on average at most 5.3e-2 lr. Held: the
  loss and the render MSE at every step to 1e-5 relative (measured
  2.5e-6), each other term to 1e-5 at step 1 and 2e-3 after (the ARAP and
  transformation terms, which weigh the warp's parameters, drift to
  8.2e-4 by step 4; ARAP also to its absolute bound of
  test_torch_stage2_step.py); every parameter group within 4 lr at most
  and 0.1 lr on average, the frozen ones unchanged.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.train import stage2 as js2
from apnerf.train.masked_adam import create_optimizer
from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.train import stage2 as ts2
from apnerf_torch.train.masked_adam import MaskedAdam
from apnerf_torch.utils.checkpoint import model_from_jax, params_from_jax
from torch_stage2_scene import (FAR, H, NEAR, W, absorb_first_vml_call,  # noqa
                                artifacts, backbone, batch_arrays, camera,
                                config, torch_batch)


@pytest.fixture(autouse=True, scope="module")
def _first_vml_call():
    """MKL's first parallel vector-math call of a process may come back
    at 12 bits in one thread's chunk (``absorb_first_vml_call``); in this
    module it was the canonical k-NN distances' square root, which moved
    step 1's ARAP term by 0.24%."""
    absorb_first_vml_call()


def test_build_model_vs_jax():
    cfg = config(sample_budget=40)
    canonical, skeleton = artifacts()
    jtcfg, tcfg, heads = backbone()
    jm, jp, js = js2.build_model(cfg, canonical, skeleton, heads, jtcfg)
    tm, model, ts = ts2.build_model(cfg, canonical, skeleton, heads, tcfg,
                                    device="cpu")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.sample_budget == 40 and not tm.featmlp_kernel
    pcd = canonical["pcd"]
    d2 = np.sort(((pcd[:, None] - pcd[None]) ** 2).sum(-1), 1)
    clear = d2[:, 8] > d2[:, 7] * (1 + 1e-4)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(np.sort(ts["nn_i"].numpy(), 1)[clear],
                                  np.sort(np.asarray(js["nn_i"]), 1)[clear])
    np.testing.assert_allclose(np.sort(ts["nn_distance"].numpy(), 1),
                               np.sort(np.asarray(js["nn_distance"]), 1),
                               rtol=1e-6, atol=1e-6)
    for key in ("canonical_pcd", "skeleton_pcd", "original_joints",
                "xyz_min", "xyz_max", "og_joint_distance", "rot_mask",
                "sibling_mask", "merge_mat", "bone_arap_idx",
                "mean_min_distance"):
        np.testing.assert_allclose(np.asarray(ts[key], np.float64),
                                   np.asarray(js[key], np.float64),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    for k in ("parent_indices", "parent_ex"):
        np.testing.assert_array_equal(ts["tree"][k].numpy(),
                                      np.asarray(js["tree"][k]))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    got = model.state_dict()
    assert set(got) == set(want)
    for name in got:
        if name.split(".")[0] in ("gammas", "feat_net", "forward_warp"):
            assert got[name].shape == want[name].shape, name
            continue
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("budget", [40, 32])
def test_train_step_trajectory_vs_jax(budget):
    cfg = config(sample_budget=budget, active_fraction=1.0, pass_fraction=1.0)
    canonical, skeleton = artifacts()
    jtcfg, tcfg, heads = backbone()
    mcfg, params, state = js2.build_model(cfg, canonical, skeleton, heads,
                                          jtcfg)
    mcfg = dataclasses.replace(mcfg, agg_bf16=False)
    cfg_train = cfg.pcd_train_config
    K, pose = camera()
    jopt = create_optimizer(params, dict(cfg_train))
    jstate = jopt.init(params)
    jstep = js2.make_train_step(mcfg, state, cfg_train, jopt, jnp.asarray(K),
                                jnp.asarray(pose), H, W, NEAR, FAR, 1.0, 1)

    _, _, tstate = ts2.build_model(cfg, canonical, skeleton, heads, tcfg,
                                   device="cpu")
    model = model_from_jax(ttp.TemporalPointsConfig(
        **dataclasses.asdict(mcfg)), jax.tree_util.tree_map(np.asarray,
                                                            params),
        device="cpu")
    topt = MaskedAdam(model, cfg_train)
    tstep = ts2.make_train_step(model, tstate, cfg_train, topt,
                                torch.tensor(K), torch.tensor(pose), H, W,
                                NEAR, FAR, 1.0, 1)
    arap_atol = 1e-7 * float(np.asarray(state["nn_distance"]).sum())
    for i in range(4):
        b = batch_arrays(seed=10 + i)
        params, jstate, jm = jstep(params, jstate,
                                   {k: jnp.asarray(v) for k, v in b.items()})
        tm = tstep(torch_batch(b))
        assert set(tm) == set(jm)
        for key in jm:
            tight = key in ("loss", "mse") or i == 0
            np.testing.assert_allclose(
                float(tm[key]), float(jm[key]), rtol=1e-5 if tight else 2e-3,
                atol=arap_atol if key == "arap" else 0,
                err_msg=f"step {i + 1} {key}")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    moved = 0
    for name, p in model.named_parameters():
        lr = float(cfg_train.get(f"lrate_{name.split('.')[0]}", 0.0))
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        if lr == 0:
            assert not diff.any(), name
            continue
        moved += 1
        assert diff.max() <= 4 * lr and diff.mean() <= 0.1 * lr, (
            name, diff.max() / lr, diff.mean() / lr)
    assert moved >= 20
