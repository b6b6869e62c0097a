"""The port's stage-1 trainer against the JAX package on the CPU: one
masked-Adam update, a few train steps from the same init and the same
batches, a whole scene_rep_reconstruction with a grid rebuild and the
occupancy switch inside the run, and fine_last.pkl read across packages.
fp32 on both sides; tolerances stated per test."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.config.config import load_config
from apnerf.data import rays as jrays
from apnerf.models import tineuvox as jt
from apnerf.ops import compaction as jc
from apnerf.ops import nn as jnn
from apnerf.train import masked_adam as jadam
from apnerf.train import stage1 as js1
from apnerf.utils import checkpoint as jck
from apnerf_torch.data import rays as trays
from apnerf_torch.data.synthetic import make_scene
from apnerf_torch.models import tineuvox as tt
from apnerf_torch.parallel.mesh import Mesh
from apnerf_torch.train import stage1 as ts1
from apnerf_torch.train.masked_adam import MaskedAdam
from apnerf_torch.utils import checkpoint as tck

REPO = Path(__file__).resolve().parent.parent


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(params, jcfg):
    model = tt.TiNeuVox(tt.TiNeuVoxConfig(**jcfg.get_kwargs()))
    model.load_state_dict(tck.params_from_jax(_tree_np(params)))
    return model


class _Toy(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        sd = tck.params_from_jax(tree)
        self.feature = torch.nn.Parameter(sd["feature"])
        self.net = torch.nn.Linear(3, 2)
        self.frozen = torch.nn.Parameter(sd["frozen"])
        with torch.no_grad():
            self.net.weight.copy_(sd["net.weight"])
            self.net.bias.copy_(sd["net.bias"])


def test_masked_adam_vs_jax():
    """Three updates; ``feature`` skips zero-gradient entries (about half
    of them), ``frozen`` has no lr. Params and both moments at 1e-6."""
    rng = np.random.default_rng(0)
    tree = {"feature": rng.normal(size=(4, 5, 3)).astype(np.float32),
            "net": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                    "b": rng.normal(size=(2,)).astype(np.float32)},
            "frozen": rng.normal(size=(6,)).astype(np.float32)}
    cfg_train = {"lrate_decay": 0.02, "lrate_feature": 0.08,
                 "lrate_net": 1e-3, "skip_zero_grad_fields": ["feature"]}
    opt = jadam.create_optimizer(tree, cfg_train)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = opt.init(params)
    model = _Toy(tree)
    topt = MaskedAdam(model, cfg_train)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32) * 1e-3,
            tree)
        grads["feature"][rng.random(grads["feature"].shape) < 0.5] = 0.0
        if step == 1:
            grads["feature"][:] = 0.0       # a step with no touched voxel
        params, state = opt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        topt.update(tck.params_from_jax(grads))
    assert topt.count == int(state.count)
    want = tck.params_from_jax(_tree_np(params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    np.testing.assert_array_equal(model.frozen.detach().numpy(),
                                  tree["frozen"])
    for attr in ("mu", "nu"):
        want = tck.params_from_jax(_tree_np(getattr(state, attr)))
        for n, v in getattr(topt, attr).items():
            np.testing.assert_allclose(v.numpy(), want[n].numpy(),
                                       rtol=1e-6, atol=1e-12, err_msg=n)


def _tiny_cfg():
    cfg = load_config(str(REPO / "apnerf/config/configs/nerf/default.py"))
    cfg.data.update(inverse_y=False, flip_x=False, flip_y=False)
    cfg.model_and_render.update(num_voxels=12 ** 3, num_voxels_base=12 ** 3,
                                voxel_dim=4, net_width=24, defor_depth=3)
    cfg.train_config.update(N_rand=64, weight_tv_feature=1e-3,
                            tv_feature_before=3)
    return cfg


@pytest.fixture(scope="module")
def scene():
    return make_scene(3, 24, 24, seed=0)


def _batches(data, cfg, jcfg, n, seed=0):
    H, W = 24, 24
    idx = jrays.build_ray_index(
        list(data["images"]), list(data["masks"]), data["times"],
        data["img_to_cam"], data["poses"], data["Ks"], H, W,
        np.asarray(jcfg.xyz_min), np.asarray(jcfg.xyz_max), data["near"],
        data["far"])
    tidx = trays.build_ray_index(
        list(data["images"]), list(data["masks"]), data["times"],
        data["img_to_cam"], data["poses"], data["Ks"], H, W,
        np.asarray(jcfg.xyz_min), np.asarray(jcfg.xyz_max), data["near"],
        data["far"])
    np.testing.assert_array_equal(tidx.pix_id, idx.pix_id)
    gen = jrays.batch_index_generator(idx.n, cfg.train_config.N_rand, seed)
    out = []
    for _ in range(n):
        rgb, m, t, cam, pix = idx.gather(next(gen))
        out.append({"rgb": rgb.astype(np.float32),
                    "mask": m.astype(np.float32),
                    "time": t.astype(np.float32), "cam": cam.astype(np.int32),
                    "pix": pix.astype(np.int32)})
    return out


@pytest.mark.parametrize("occupancy", [False, True])
def test_train_steps_vs_jax(scene, occupancy):
    """Four make_train_step steps (dense layout, or occupancy grid +
    coarse-group budget), dense TV for the first two: the loss of each
    step at 1e-5, the params after the last at rtol 1e-3 / atol 2e-5
    (Adam's m / sqrt(v) is ~1 for tiny gradients, so an fp32 difference
    in a near-zero gradient moves a parameter by up to one lr step)."""
    cfg = _tiny_cfg()
    data = scene
    lo, hi = js1.compute_bbox_by_cam_frustrm(
        data["HW"], data["Ks"], data["poses"], data["i_train"],
        data["img_to_cam"], data["near"], data["far"])
    tlo, thi = ts1.compute_bbox_by_cam_frustrm(
        data["HW"], data["Ks"], data["poses"], data["i_train"],
        data["img_to_cam"], data["near"], data["far"])
    np.testing.assert_allclose(tlo, lo, rtol=1e-6)
    np.testing.assert_allclose(thi, hi, rtol=1e-6)
    m = cfg.model_and_render
    jcfg = jt.TiNeuVoxConfig(
        xyz_min=tuple(lo), xyz_max=tuple(hi), num_voxels=m.num_voxels,
        num_voxels_base=m.num_voxels_base, voxel_dim=m.voxel_dim,
        defor_depth=m.defor_depth, net_width=m.net_width)
    params = jt.init_params(jax.random.PRNGKey(1), jcfg)
    model = _port_model(params, jcfg)
    ct = dict(cfg.train_config)
    ct["_stepsize"] = m.stepsize
    budget, occ = None, None
    if occupancy:
        budget, _ = ts1.active_budget(ct["N_rand"], jcfg.max_steps(0.5), 0.25)
        flags = np.zeros(jcfg.world_size, bool)
        flags[2:-2, 2:-2, 2:-2] = True
        occ = np.asarray(jc.build_occupancy_grid(jnp.asarray(flags)))
    Ks, poses = data["Ks"], data["poses"]
    jopt = jadam.create_optimizer(params, ct)
    jstate = jopt.init(params)
    jstep = js1.make_train_step(
        jcfg, ct, jopt, jnp.asarray(Ks), jnp.asarray(poses), 24, 24,
        data["near"], data["far"], 1.0, use_occupancy=occupancy,
        active_budget=budget)
    topt = MaskedAdam(model, ct)
    tstep = ts1.make_train_step(model, ct, topt, torch.tensor(Ks),
                                torch.tensor(poses), 24, 24, data["near"],
                                data["far"], 1.0, active_budget=budget)
    for i, b in enumerate(_batches(data, cfg, jcfg, 4)):
        dense = 1.0 if i + 1 < ct["tv_feature_before"] else 0.0
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        args = (jnp.asarray(occ),) if occupancy else ()
        params, jstate, jl, _ = jstep(params, jstate, jb, jnp.float32(1.0),
                                      *args, jnp.float32(dense))
        tb = {k: torch.tensor(v) for k, v in b.items()}
        tb["cam"], tb["pix"] = tb["cam"].long(), tb["pix"].long()
        tl, _ = tstep(tb, True, None if occ is None else torch.tensor(occ),
                      dense > 0.5)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=f"step {i + 1}")
    want = tck.params_from_jax(_tree_np(params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-3, atol=2e-5, err_msg=n)


def test_scene_rep_reconstruction_vs_jax(scene, monkeypatch, tmp_path):
    """Whole runs, the port's init replaced by the JAX init. First four
    steps with pg_scale [2] (one grid rebuild) and occupancy_start 3 (the
    coarse-group occupancy path from then on), each package writing its
    mid-stage checkpoint at step 4. Then both resume from the JAX
    package's checkpoint to step 7, with an occupancy refresh at step 6
    and the feature grid cast to bf16 there (``step_to_half``). The
    logged losses at rtol 1e-4 (the parameter drift of the train-step
    test compounds over the run), the grid shapes equal, and the port's
    checkpoint in the JAX package's layout."""
    import shutil
    cfg = _tiny_cfg()
    cfg.train_config.update(pg_scale=[2], occupancy_start=3,
                            occupancy_update_every=6)

    def jax_init(mcfg, generator, device=None):
        jcfg = jt.TiNeuVoxConfig(**mcfg.get_kwargs())
        return _port_model(jt.init_params(jax.random.PRNGKey(3), jcfg),
                           jcfg).to(device)

    monkeypatch.setattr(ts1.tineuvox, "init_model", jax_init)
    jpath, tpath = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    run = dict(seed=3, log_every=1, ckpt_every=4)
    _, jcfg, jstats = js1.scene_rep_reconstruction(
        cfg, scene, n_iters=4, ckpt_path=jpath, **run)
    model, tcfg, tstats = ts1.scene_rep_reconstruction(
        cfg, scene, n_iters=4, ckpt_path=tpath, device="cpu", **run)
    assert tcfg == tt.TiNeuVoxConfig(**jcfg.get_kwargs())
    assert tuple(model.feature.shape[:3]) == jcfg.world_size
    assert len(tstats["loss"]) == len(jstats["loss"]) == 4
    np.testing.assert_allclose(tstats["loss"], jstats["loss"], rtol=1e-4)
    np.testing.assert_allclose(tstats["psnr"], jstats["psnr"], rtol=1e-4)
    jp, tp = jck.load_checkpoint(jpath), jck.load_checkpoint(tpath)
    assert jp["global_step"] == tp["global_step"] == 4
    assert jp["model_kwargs"] == tp["model_kwargs"]
    for k in ("params", "opt_state"):
        assert (jax.tree_util.tree_structure(tp[k])
                == jax.tree_util.tree_structure(jp[k])), k

    shutil.copy(jpath, tpath)
    _, jcfg, jstats = js1.scene_rep_reconstruction(
        cfg, scene, n_iters=7, ckpt_path=jpath, step_to_half=6, **run)
    model, tcfg, tstats = ts1.scene_rep_reconstruction(
        cfg, scene, n_iters=7, ckpt_path=tpath, step_to_half=6,
        device="cpu", **run)
    assert model.feature.dtype == torch.bfloat16
    assert tcfg == tt.TiNeuVoxConfig(**jcfg.get_kwargs())
    assert len(tstats["loss"]) == len(jstats["loss"]) == 3
    np.testing.assert_allclose(tstats["loss"], jstats["loss"], rtol=1e-4)


def _mesh_of(world):
    """A stand-in mesh: the checks below raise before any collective."""
    return Mesh(None, 0, world, torch.device("cpu"))


@pytest.mark.parametrize("train,mesh", [
    pytest.param({}, _mesh_of(3), id="train0-mesh"),
    pytest.param({"ray_microbatch": 2}, _mesh_of(2), id="microbatch-mesh")])
def test_unported_paths_raise(train, mesh):
    """The mesh refuses what the JAX package refuses, before it reads the
    data: N_rand (64) that does not divide over the ranks, and ray
    microbatching, its alternative (the mesh runs:
    tests/test_torch_parallel_train.py)."""
    cfg = _tiny_cfg()
    cfg.train_config.update(train)
    with pytest.raises(ValueError):
        ts1.scene_rep_reconstruction(cfg, {}, mesh=mesh, device="cpu")


def test_fine_last_across_packages(tmp_path):
    """fine_last.pkl written by the JAX package loads in the port and the
    other way round; fine_progress.pkl's Adam state has the JAX pytree
    structure. The model has camnet (add_cam), so its colour head is
    the reference's width (``rgb_views_ch``, wider than the JAX
    ``init_params`` head, with which no add_cam forward runs)."""
    kw = dict(xyz_min=(-1.0, -1.5, -1.0), xyz_max=(1.0, 1.0, 1.2),
              num_voxels=9 ** 3, num_voxels_base=9 ** 3, voxel_dim=3,
              defor_depth=3, net_width=8, add_cam=True)
    jcfg = jt.TiNeuVoxConfig(**kw)
    params = jt.init_params(jax.random.PRNGKey(5), jcfg)
    params["rgbnet"]["views_linears"] = jnn.init_mlp(
        jax.random.PRNGKey(6), [8 + tt.TiNeuVoxConfig(**kw).rgb_views_ch,
                                4, 3])
    params = _tree_np(params)
    path = str(tmp_path / "fine_last.pkl")
    jck.save_checkpoint(path, jcfg.get_kwargs(), params)
    model = tck.load_tineuvox(path, device="cpu")
    assert model.cfg == tt.TiNeuVoxConfig(**kw)
    want = tck.params_from_jax(params)
    assert set(model.state_dict()) == set(want)
    for n, v in model.state_dict().items():
        assert torch.equal(v, want[n]), n

    with torch.no_grad():
        model.feature.add_(0.25)
    opt = MaskedAdam(model, {"lrate_decay": 20, "lrate_feature": 0.1})
    opt.update({"feature": torch.ones_like(model.feature)})
    path2 = str(tmp_path / "fine_progress.pkl")
    tck.save_tineuvox(path2, model, opt, global_step=7)
    payload = jck.load_checkpoint(path2)
    assert payload["global_step"] == 7
    assert jt.TiNeuVoxConfig(**payload["model_kwargs"]) == jcfg
    back = _tree_np(payload["params"])
    struct = jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_structure(back) == struct
    for n, v in tck.params_from_jax(back).items():
        assert torch.equal(v, model.state_dict()[n]), n
    st = payload["opt_state"]
    assert int(st["count"]) == 1
    assert jax.tree_util.tree_structure(st["mu"]) == struct
    assert jax.tree_util.tree_structure(st["nu"]) == struct
    opt2 = MaskedAdam(model, {"lrate_decay": 20})
    opt2.load_state_from_jax(st)
    assert opt2.count == 1
    for n in opt.mu:
        assert torch.equal(opt2.mu[n], opt.mu[n]), n
        assert torch.equal(opt2.nu[n], opt.nu[n]), n
