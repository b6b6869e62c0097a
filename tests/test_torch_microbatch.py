"""Stage-1 ray microbatching in the port (``train/stage1.py``) against the
JAX package on the CPU: the step with ``n_micro`` 1, 2 and 4 against the
JAX ``make_train_step`` with the same split, in the dense layout and on
the occupancy path (whose active budget is a microbatch's); the JAX
package's auto rule; and whole runs at 8,192 rays, where that rule splits
every batch in two and the budget audit counts a microbatch's rays."""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.models import tineuvox as jt
from apnerf.ops import compaction as jc
from apnerf.train import masked_adam as jadam
from apnerf.train import stage1 as js1
from apnerf_torch.data.synthetic import make_scene
from apnerf_torch.train import stage1 as ts1
from apnerf_torch.train.masked_adam import MaskedAdam
from apnerf_torch.utils import checkpoint as tck
from test_torch_stage1 import _batches, _port_model, _tiny_cfg, _tree_np


@pytest.fixture(scope="module")
def scene():
    return make_scene(3, 24, 24, seed=0)


def _setup(data, n_rand):
    cfg = _tiny_cfg()
    cfg.train_config.update(N_rand=n_rand)
    lo, hi = js1.compute_bbox_by_cam_frustrm(
        data["HW"], data["Ks"], data["poses"], data["i_train"],
        data["img_to_cam"], data["near"], data["far"])
    m = cfg.model_and_render
    jcfg = jt.TiNeuVoxConfig(
        xyz_min=tuple(lo), xyz_max=tuple(hi), num_voxels=m.num_voxels,
        num_voxels_base=m.num_voxels_base, voxel_dim=m.voxel_dim,
        defor_depth=m.defor_depth, net_width=m.net_width)
    ct = dict(cfg.train_config)
    ct["_stepsize"] = m.stepsize
    return cfg, jcfg, ct


@pytest.mark.parametrize("occupancy", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_microbatched_steps_vs_jax(scene, n_micro, occupancy):
    """Three steps of 64 rays cut into ``n_micro`` microbatches, dense TV
    on the first two, from the JAX init: each step's loss at rtol 1e-5
    against the JAX step with the same split, the parameters after the
    last at rtol 1e-3 / atol 2e-5 (as test_torch_stage1's
    test_train_steps_vs_jax, from the same reason). On the occupancy path
    the active budget is a microbatch's (``active_budget`` of 64 /
    n_micro rays), in both packages."""
    data = scene
    cfg, jcfg, ct = _setup(data, 64)
    params = jt.init_params(jax.random.PRNGKey(1), jcfg)
    model = _port_model(params, jcfg)
    budget, occ = None, None
    if occupancy:
        budget, _ = ts1.active_budget(64 // n_micro, jcfg.max_steps(0.5),
                                      0.25)
        flags = np.zeros(jcfg.world_size, bool)
        flags[2:-2, 2:-2, 2:-2] = True
        occ = np.asarray(jc.build_occupancy_grid(jnp.asarray(flags)))
    Ks, poses = data["Ks"], data["poses"]
    jopt = jadam.create_optimizer(params, ct)
    jstate = jopt.init(params)
    jstep = js1.make_train_step(
        jcfg, ct, jopt, jnp.asarray(Ks), jnp.asarray(poses), 24, 24,
        data["near"], data["far"], 1.0, use_occupancy=occupancy,
        active_budget=budget, n_micro=n_micro)
    topt = MaskedAdam(model, ct)
    tstep = ts1.make_train_step(model, ct, topt, torch.tensor(Ks),
                                torch.tensor(poses), 24, 24, data["near"],
                                data["far"], 1.0, active_budget=budget,
                                n_micro=n_micro)
    for i, b in enumerate(_batches(data, cfg, jcfg, 3)):
        dense = 1.0 if i + 1 < ct["tv_feature_before"] else 0.0
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        args = (jnp.asarray(occ),) if occupancy else ()
        params, jstate, jl, jm = jstep(params, jstate, jb, jnp.float32(1.0),
                                       *args, jnp.float32(dense))
        tb = {k: torch.tensor(v) for k, v in b.items()}
        tb["cam"], tb["pix"] = tb["cam"].long(), tb["pix"].long()
        tl, tm = tstep(tb, True, None if occ is None else torch.tensor(occ),
                       dense > 0.5)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=f"step {i + 1}")
        np.testing.assert_allclose(float(tm), float(jm), rtol=1e-5,
                                   err_msg=f"mse {i + 1}")
    want = tck.params_from_jax(_tree_np(params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-3, atol=2e-5, err_msg=n)


def test_microbatched_step_is_the_full_batch_step(scene):
    """The port's own step: with 2 and 4 microbatches the same update as
    one batch (every loss term is a per-ray mean over equal parts), each
    parameter at rtol 1e-5 / atol 1e-6 after one step (Adam moves every
    touched entry by about one lr step, whatever the gradient's size)."""
    data = scene
    cfg, jcfg, ct = _setup(data, 64)
    params = jt.init_params(jax.random.PRNGKey(2), jcfg)
    b = _batches(data, cfg, jcfg, 1)[0]
    tb = {k: torch.tensor(v) for k, v in b.items()}
    tb["cam"], tb["pix"] = tb["cam"].long(), tb["pix"].long()
    out = {}
    for n_micro in (1, 2, 4):
        model = _port_model(params, jcfg)
        opt = MaskedAdam(model, ct)
        step = ts1.make_train_step(model, ct, opt, torch.tensor(data["Ks"]),
                                   torch.tensor(data["poses"]), 24, 24,
                                   data["near"], data["far"], 1.0,
                                   n_micro=n_micro)
        loss, _ = step(tb, True)
        out[n_micro] = (float(loss), {n: p.detach().clone()
                                      for n, p in model.named_parameters()})
    for n_micro in (2, 4):
        np.testing.assert_allclose(out[n_micro][0], out[1][0], rtol=1e-5)
        for n, p in out[n_micro][1].items():
            np.testing.assert_allclose(p.numpy(), out[1][1][n].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("n_rand,asked,want", [
    (4096, 0, 1), (8192, 0, 2), (12288, 0, 3), (10000, 0, 4), (6000, 0, 2),
    (4097, 0, 17), (8192, 1, 1), (8192, 4, 4), (64, 2, 2)])
def test_auto_rule(n_rand, asked, want):
    """``microbatches``: 0 is the JAX package's auto rule, ceil(N_rand /
    4096) raised until it divides N_rand; a count asked for is kept."""
    assert ts1.microbatches(n_rand, asked) == want


@pytest.mark.parametrize("n_rand,asked", [(64, 3), (8192, 3), (100, -1)])
def test_split_that_does_not_divide_raises(n_rand, asked):
    """Where the JAX package asserts at trace time, the port raises
    ValueError, before a model is built."""
    with pytest.raises(ValueError):
        ts1.microbatches(n_rand, asked)
    cfg = _tiny_cfg()
    cfg.train_config.update(N_rand=n_rand, ray_microbatch=asked)
    with pytest.raises(ValueError):
        ts1.scene_rep_reconstruction(cfg, {}, device="cpu")


def test_runs_at_8192_rays_vs_jax(monkeypatch, capsys):
    """Whole runs of three steps at N_rand 8,192 on a 4-view 56 x 56
    scene, the port's init replaced by the JAX init, occupancy from step
    2: both packages split each batch in two (the auto rule) and print the
    same microbatching and budget-audit lines (the budget of 4,096 rays);
    the logged losses at rtol 1e-4 (as test_torch_stage1's whole runs)."""
    data = make_scene(4, 56, 56, seed=1)
    cfg = _tiny_cfg()
    cfg.train_config.update(N_rand=8192, occupancy_start=2)

    def jax_init(mcfg, generator, device=None):
        jcfg = jt.TiNeuVoxConfig(**mcfg.get_kwargs())
        return _port_model(jt.init_params(jax.random.PRNGKey(3), jcfg),
                           jcfg).to(device)

    monkeypatch.setattr(ts1.tineuvox, "init_model", jax_init)
    run = dict(seed=3, log_every=1, n_iters=3)
    _, _, jstats = js1.scene_rep_reconstruction(cfg, data, **run)
    jout = capsys.readouterr().out
    _, _, tstats = ts1.scene_rep_reconstruction(cfg, data, device="cpu",
                                                **run)
    tout = capsys.readouterr().out

    def lines(text):
        return [ln for ln in text.splitlines()
                if re.match(r"stage1: (ray microbatching|budget audit)", ln)]

    # a line a segment (two: the occupancy switch starts the second), the
    # audit in the occupancy segment
    micro = ("stage1: ray microbatching x2 (4096 rays/microbatch, grads "
             "accumulated)")
    assert lines(jout) == lines(tout)
    assert lines(tout)[:2] == [micro, micro] and len(lines(tout)) == 3
    assert "(4096 rays x" in lines(tout)[2]
    assert "per microbatch x2" in lines(tout)[2]
    np.testing.assert_allclose(tstats["loss"], jstats["loss"], rtol=1e-4)
    np.testing.assert_allclose(tstats["psnr"], jstats["psnr"], rtol=1e-4)
