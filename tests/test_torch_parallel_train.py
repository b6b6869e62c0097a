"""The port's trainers on a mesh of gloo ranks spawned on the CPU (the
counterpart of tests/test_parallel_train.py): ``scene_rep_reconstruction``
and ``train_pcd`` with ``mesh=`` against the port's single-process run and
against the JAX package's run on a 2-device ``Mesh``.

* Stage 1, six steps of 512 rays with a grid rebuild (``pg_scale`` [2]),
  the occupancy switch at step 3 and an active budget below the demand
  (``active_fraction`` 0.02: the coarse-group compaction keeps 1,024 of
  more groups): on 2 ranks the logged losses at rtol 1e-4 and the
  parameters at rtol 2e-4 / atol 1e-6 of the single-process run's (the
  JAX mesh test's tolerances); on 2 and 4 ranks every compaction's
  survivors (``src``, in order) identical to the single-process run's; the
  losses against the JAX package's 2-device mesh run from the same init
  at rtol 1e-4 (test_torch_stage1.py's tolerance for whole runs).
* Stage 2, four steps: (1) both budgets at 1 (test_torch_stage2_train.py's
  setting, where the two packages render the same samples), 64 rays, on
  2 ranks against the single-process run at the same tolerances, and
  against the JAX 2-device mesh run from the same parameters at rtol 1e-3
  (test_torch_stage2_train.py's); (2) 512 rays at ``active_fraction``
  0.01, where the startup audit says TRUNCATING and the step's active
  compaction keeps 64 of more groups: on 2 and 4 ranks every compaction's
  survivors identical to the single-process run's, the losses at rtol
  1e-3 (measured: equal at the first two steps, 1.1e-4 apart at the
  fourth: the ranks sum the gradients' parts in another order, and
  Adam's m / sqrt(v) scales up that rounding in near-zero gradients).

The single-process references run on one thread, as each rank does (the
CPU's matrix products round differently on more threads).
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from apnerf.config.config import load_config as jload_config
from apnerf.models import tineuvox as jt
from apnerf.parallel import mesh as jmesh
from apnerf.train import stage1 as js1
from apnerf.train import stage2 as js2
from apnerf_torch.config import load_config
from apnerf_torch.data.synthetic import make_scene
from apnerf_torch.parallel import ranks
from apnerf_torch.train import stage1 as ts1
from apnerf_torch.utils.checkpoint import params_from_jax
from torch_stage2_scene import artifacts, backbone, config  # noqa

TRAIN1 = dict(N_rand=512, weight_tv_feature=1e-3, tv_feature_before=3,
              pg_scale=[2], occupancy_start=3, occupancy_update_every=6,
              active_fraction=0.02)
BBOX = (np.full(3, -1.5), np.full(3, 1.5))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh2():
    return Mesh(np.array(jax.devices("cpu")[:2]), (jmesh.RAY_AXIS,))


def _stage1_cfg(load):
    cfg = load("apnerf/config/configs/nerf/default.py"
               if load is jload_config
               else "apnerf_torch/config/configs/nerf/default.py")
    cfg.data.update(inverse_y=False, flip_x=False, flip_y=False)
    cfg.model_and_render.update(num_voxels=12 ** 3, num_voxels_base=12 ** 3,
                                voxel_dim=4, net_width=24, defor_depth=3)
    cfg.train_config.update(TRAIN1)
    return cfg


def _jax_init_state(cfg, data, seed, monkeypatch):
    """The JAX init (``PRNGKey(seed)``, as the JAX trainer's) of the
    model config the port's trainer builds, as a numpy state_dict."""
    seen = {}

    class Built(Exception):
        pass

    def grab(mcfg, generator, device=None):
        seen["cfg"] = mcfg
        raise Built

    with monkeypatch.context() as m:
        m.setattr(ts1.tineuvox, "init_model", grab)
        with pytest.raises(Built):
            ts1.scene_rep_reconstruction(cfg, data, n_iters=1, device="cpu")
    jcfg = jt.TiNeuVoxConfig(**seen["cfg"].get_kwargs())
    params = jax.tree_util.tree_map(
        np.asarray, jt.init_params(jax.random.PRNGKey(seed), jcfg))
    return {k: v.numpy() for k, v in params_from_jax(params).items()}


def _binds(srcs):
    return any(n > len(src) for src, n in srcs)


def _same_survivors(got, want):
    assert len(got) == len(want)
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _same_stage2_survivors(got, single):
    """Rank 0 runs the startup audit's compactions too, the other ranks
    the steps' alone."""
    _same_survivors(got[0]["srcs"], single["srcs"])
    n_audit = len(single["srcs"]) - len(got[1]["srcs"])
    assert n_audit > 0
    for res in got[1:]:
        _same_survivors(res["srcs"], single["srcs"][n_audit:])


def _close(got, want, rtol_loss=1e-4):
    np.testing.assert_allclose(got["stats"]["loss"], want["stats"]["loss"],
                               rtol=rtol_loss)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=2e-4,
                                   atol=1e-6, err_msg=k)


def test_stage1_mesh(tmp_path, monkeypatch, one_thread):
    data = make_scene(3, 24, 24, seed=0)
    cfg = _stage1_cfg(load_config)
    seed = 3
    run = dict(cfg=cfg, data=data, n_iters=6, log_every=1, seed=seed,
               init_state=_jax_init_state(cfg, data, seed, monkeypatch))
    single = ranks.train_stage1(**run)
    assert _binds(single["srcs"])
    meshed = {}
    for world in (2, 4):
        meshed[world] = ranks.spawn(world, ranks.train_stage1,
                                    store_dir=str(tmp_path), **run)
        for res in meshed[world]:
            _same_survivors(res["srcs"], single["srcs"])
            np.testing.assert_allclose(res["stats"]["loss"],
                                       single["stats"]["loss"], rtol=1e-4)
    for res in meshed[2]:
        _close(res, single)
    _, _, jstats = js1.scene_rep_reconstruction(
        _stage1_cfg(jload_config), data, n_iters=6, log_every=1, seed=seed,
        mesh=_jax_mesh2())
    np.testing.assert_allclose(meshed[2][0]["stats"]["loss"], jstats["loss"],
                               rtol=1e-4)


def _stage2_run(active_fraction, pass_fraction, n_rand, init_state=None):
    cfg = config(active_fraction=active_fraction,
                 pass_fraction=pass_fraction)
    cfg.pcd_train_config.update(N_rand=n_rand, full_t_iter=6)
    canonical, skeleton = artifacts()
    _, tcfg, heads = backbone()
    return dict(cfg=cfg, data=make_scene(3, 32, 32, seed=0),
                canonical=canonical, skeleton=skeleton, heads=heads,
                tcfg=tcfg, bbox=BBOX, seed=0, log_every=1, sample_budget=32,
                n_iters=4, init_state=init_state)


def test_stage2_mesh_vs_single_and_jax(tmp_path, one_thread):
    s = _stage2_run(1.0, 1.0, 64)
    jtcfg, _, heads = backbone()
    _, jparams, _ = js2.build_model(s["cfg"], s["canonical"], s["skeleton"],
                                    heads, jtcfg, seed=0)
    s["init_state"] = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}
    single = ranks.train_stage2(**s)
    got = ranks.spawn(2, ranks.train_stage2, store_dir=str(tmp_path), **s)
    _same_stage2_survivors(got, single)
    for res in got:
        _close(res, single)
    _, _, _, jstats = js2.train_pcd(
        s["cfg"], s["data"], s["canonical"], s["skeleton"], heads, jtcfg,
        BBOX, seed=0, log_every=1, sample_budget=32, n_iters=4,
        mesh=_jax_mesh2())
    np.testing.assert_allclose(got[0]["stats"]["loss"], jstats["loss"],
                               rtol=1e-3)


def test_stage2_mesh_budgets_bind(tmp_path, one_thread):
    s = _stage2_run(0.01, 0.3, 512)
    single = ranks.train_stage2(**s)
    assert "TRUNCATING" in single["audit"][0]
    # a step's active compaction (after the audit's) binds
    assert _binds(single["srcs"][-1:])
    for world in (2, 4):
        got = ranks.spawn(world, ranks.train_stage2,
                          store_dir=str(tmp_path), **s)
        # the audit runs and prints on rank 0 alone
        assert got[0]["audit"] == single["audit"]
        assert not any(res["audit"] for res in got[1:])
        _same_stage2_survivors(got, single)
        for res in got:
            np.testing.assert_allclose(res["stats"]["loss"],
                                       single["stats"]["loss"], rtol=1e-3)
