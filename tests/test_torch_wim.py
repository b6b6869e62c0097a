"""The Watch-It-Move robot family on the port's normal path, at small sizes
on the CPU: the benchmark's ``wim`` configuration against the port's own
``configs/wim/spot.py``, the ``spot`` quadruped, a WIM dataset written
from the ``wim`` scene and read back by ``data.load_data``
(``chip_smoke.py`` phase 10 does the same on the card at 512 x 512), and
``train_pcd`` at WIM's settings (``pose_one_each`` off, no pose
embedding, white background, five chamfer silhouettes drawn from six
cameras at one time, the 15-joint tree) against the JAX package's.

The benchmark's own check of its two new cells runs here too, at a tiny
size: the stage-2 step at WIM's settings and the stage-1 step at the
D-NeRF family's (white, no mask loss) against the benchmark's plain
reference (``benchmark/reference``, a frozen copy of the port's plain path
that imports neither JAX nor ``apnerf_torch``), and the cells' limits
failing the program broken underneath. On the CPU the program runs the
plain version of every kernel, so the rows the reference reads from its
own images and the starting parameters agree exactly, and the losses and
the norms of the gradient and of the change agree to float32 rounding
(1e-6; the two may sum in other orders on other threads: they read 0.0
here).

Tolerances against the JAX package (``test_train_pcd_at_wim_settings_vs_jax``):
the drawn rows and chamfer inputs are equal (both packages draw from one
host generator in one order); step 1, from the same parameters, every
loss term within 1e-4 relative (float32 sums in other orders on the two
CPU paths: measured 8.4e-6, the ARAP term); every step's loss within 1e-3
relative, as ``test_torch_stage2_train.py`` holds the monocular scene
(measured 1.8e-4); the terms of steps 2-3 within 5e-2 relative: the first
Adam steps move each entry by about the learning rate whatever the size
of its gradient, so an entry whose gradient is near nought moves by a
whole step one way in one package and the other way in the other (see
``test_torch_stage2_model.py``); measured 2.5e-2 (the translation
regulariser) and 1.7e-2 (the 2D chamfer).
"""
import json
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax


ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from apnerf.data import rays as jrays  # noqa: E402
from apnerf.models import tineuvox as jtv  # noqa: E402
from apnerf.train import stage2 as js2  # noqa: E402
from apnerf_torch.config import config as tconfig  # noqa: E402
from apnerf_torch.data import rays as trays  # noqa: E402
from apnerf_torch.data.load_data import load_data  # noqa: E402
from apnerf_torch.models.tineuvox import TiNeuVoxConfig  # noqa: E402
from apnerf_torch.train import stage2  # noqa: E402
from apnerf_torch.utils.checkpoint import (params_from_jax,  # noqa: E402
                                           params_to_jax)
from benchmark import run as bench  # noqa: E402
from benchmark.generators import stage1_train, stage2_train  # noqa: E402
from benchmark.generators.common import program_config  # noqa: E402
from benchmark.scene import load_figure, make_scene  # noqa: E402
from benchmark.tests.tiny import tiny_config, tiny_context  # noqa: E402
from torch_stage2_scene import absorb_first_vml_call  # noqa: E402

SECTIONS = ("data", "train_config", "model_and_render", "pcd_train_config",
            "pcd_model_and_render")
# keys of the published data section that name files on disk and how to
# read them; the benchmark makes its scene and reads none
DATA_FILE_KEYS = {"datadir", "load2gpu_on_the_fly", "testskip", "white_bkgd",
                  "half_res", "factor", "spherify", "llffhold",
                  "load_depths", "use_bg_points"}
ROUNDING = 1e-6
SEED = 4100000019
TERMS = ("mse", "arap", "weight_tv", "sparsity", "trans_reg",
         "joint_chamfer", "chamfer2d", "loss")
CHAMFER_KEYS = ("chamfer_poses", "chamfer_Ks", "chamfer_mask_pts",
                "chamfer_pcd_idx")


def wim_json():
    return json.loads((ROOT / "benchmark" / "configs" / "wim.json")
                      .read_text())


def test_wim_config_is_the_published_spot():
    """Every program section of ``benchmark/configs/wim.json`` holds the
    merged ``configs/wim/spot.py`` (over ``wim/default.py`` and
    ``nerf/default.py``) key for key, but for the keys it lists under
    ``reduced`` or ``assumed`` and the data section's file keys."""
    cfg = wim_json()
    spot = tconfig.load_config(os.path.join(
        tconfig.builtin_config_dir(), "wim", "spot.py"))
    changed = set(cfg["reduced"]) | set(cfg["assumed"])
    assert cfg["reduced"] == ["n_times"]
    assert cfg["cameras"]["n_times"] == 30
    assert cfg["assumed"]["pre_train_t_num"]
    for sec in SECTIONS:
        want = {k: v for k, v in spot[sec].items() if k not in changed}
        got = {k: v for k, v in cfg[sec].items() if k not in changed}
        if sec == "data":
            want = {k: v for k, v in want.items() if k not in DATA_FILE_KEYS}
        assert got == want, sec
    assert spot.data.inverse_y is False and cfg["data"]["inverse_y"] is True
    assert (cfg["cameras"]["near"], cfg["cameras"]["far"]) == (1.0, 6.0)
    assert cfg["max_steps"] == spot.pcd_model_and_render.sample_budget


def test_spot_figure_is_a_quadruped_tree():
    """15 joints, 14 bones: the root at the body's centre with a front and a
    rear body bone, and under each four legs of three bones each."""
    fig = load_figure("spot")
    parents = fig["parents"]
    assert len(parents) == len(fig["joints"]) == len(fig["radius"]) == 15
    assert parents[0] == -1 and all(p < j for j, p in enumerate(parents)
                                    if j)
    assert [j for j, p in enumerate(parents) if p == 0] == [1, 2]
    for end in (1, 2):
        hips = [j for j, p in enumerate(parents) if p == end]
        assert len(hips) == 2
        for hip in hips:
            knee, = [j for j, p in enumerate(parents) if p == hip]
            foot, = [j for j, p in enumerate(parents) if p == knee]
            assert foot not in parents
            joints = np.asarray(fig["joints"])
            assert abs(np.linalg.norm(joints[knee] - joints[hip])
                       - 0.32) < 1e-5
            assert abs(np.linalg.norm(joints[foot] - joints[knee])
                       - 0.34) < 1e-5


def test_wim_fixture_loads_as_the_scene(tmp_path):
    """A tiny ``wim`` scene (32 px, 18 ring cameras, 2 frames) written as a
    WIM dataset and read back: images within one uint8 level of the
    scene's, or two below it where the loader's truncation adds to the
    file's rounding; masks and the other arrays equal (one render here, so
    not even at alpha 127-128), poses within float32 rounding (``chip_smoke.check_wim_load``, which raises
    otherwise); the test cameras 0 and 10 load too."""
    cfg = tiny_config(wim_json())
    cfg["cameras"].update(n_cams=18, n_times=2, size=32,
                          focal=cfg["cameras"]["focal"] * 32 / 48)
    scene = cs.write_wim_fixture(tmp_path / "spot", cfg, SEED, "cpu")
    data = load_data(cs.wim_data_config(tmp_path / "spot", 2, 32), bg_col=1)
    lo, hi, _, mask_diff, _, _ = cs.check_wim_load(data, scene.data)
    assert -2 <= lo and hi <= 1 and mask_diff == 0
    assert (scene.data["masks"] > 0).any()
    test = load_data(cs.wim_data_config(tmp_path / "spot", 2, 32),
                     load_test_val=True)
    assert len(test["i_test"]) == 4 and test["images"].shape[1:3] == (32, 32)


@pytest.fixture(scope="module")
def wim_setup():
    """A tiny ``wim`` scene (48 px, 6 ring cameras, 2 times: five chamfer
    silhouettes a step), the ``spot`` tree, white background; 64 rays a
    step, both budgets at 1 so that the two packages render the same
    samples (the JAX CPU path in another order)."""
    absorb_first_vml_call()
    cfg = tiny_config(wim_json())
    cfg["cameras"].update(n_cams=6, n_times=2)
    cfg["pcd_model_and_render"].update(active_fraction=1.0,
                                       pass_fraction=1.0)
    cfg["pcd_train_config"]["N_rand"] = 64
    scene = make_scene(cfg, SEED, "cpu")
    heads = params_to_jax({k: torch.from_numpy(v)
                           for k, v in scene.heads.items()})
    return dict(cfg=program_config(cfg), scene=scene, heads=heads)


def test_train_pcd_at_wim_settings_vs_jax(wim_setup, monkeypatch):
    """Three steps of the port's ``train_pcd`` against the JAX package's
    from the same parameters (the port's ``build_model`` made to return the
    JAX ``build_model``'s): the ray rows drawn (the budget audit's, then
    one set a step), the five chamfer silhouettes picked (cameras,
    intrinsics, mask pixels, cloud points), every loss term and the
    losses (tolerances: the module's text)."""
    s = wim_setup
    cfg, scene, heads = s["cfg"], s["scene"], s["heads"]
    pcd = cfg.pcd_train_config
    assert not pcd.pose_one_each and pcd.pose_embedding_dim == 0
    assert pcd.bg_col == 1 and len(scene.skeleton["joints"]) == 15
    jtcfg = jtv.TiNeuVoxConfig(**scene.backbone)
    rows, inputs, terms = ({"jax": [], "port": []} for _ in range(3))
    for key, mod in (("jax", jrays), ("port", trays)):
        real = mod.RayIndex.gather

        def gather(self, sel, _real=real, _key=key):
            rows[_key].append(np.array(sel))
            return _real(self, sel)
        monkeypatch.setattr(mod.RayIndex, "gather", gather)
    real_build = stage2.build_model

    def build_model(*args, **kwargs):
        mcfg, model, state = real_build(*args, **kwargs)
        _, jparams, _ = js2.build_model(cfg, scene.canonical, scene.skeleton,
                                        heads, jtcfg, seed=kwargs["seed"])
        model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams)))
        return mcfg, model, state
    monkeypatch.setattr(stage2, "build_model", build_model)

    def record(key, batch, metrics):
        inputs[key].append({k: np.array(batch[k]) for k in CHAMFER_KEYS})
        terms[key].append({k: float(metrics[k]) for k in TERMS})

    real_jstep = js2.make_train_step

    def jax_step(*args, **kwargs):
        step = real_jstep(*args, **kwargs)

        def call(params, opt_state, batch):
            out = step(params, opt_state, batch)
            record("jax", batch, out[2])
            return out
        return call
    real_tstep = stage2.make_graphed_step

    def port_step(*args, **kwargs):
        step = real_tstep(*args, **kwargs)

        def call(batch, *a, **kw):
            out = step(batch, *a, **kw)
            record("port", batch, out[0])
            return out
        return call
    monkeypatch.setattr(js2, "make_train_step", jax_step)
    monkeypatch.setattr(stage2, "make_graphed_step", port_step)

    run = dict(seed=0, n_iters=3, log_every=1, sample_budget=32)
    *_, jstats = js2.train_pcd(cfg, scene.data, scene.canonical,
                               scene.skeleton, heads, jtcfg, scene.bbox, **run)
    *_, tstats = stage2.train_pcd(cfg, scene.data, scene.canonical,
                                  scene.skeleton, heads,
                                  TiNeuVoxConfig(**scene.backbone),
                                  scene.bbox, device="cpu", **run)

    assert len(rows["jax"]) == len(rows["port"]) == 4
    for a, b in zip(rows["jax"], rows["port"]):
        np.testing.assert_array_equal(a, b)
    assert len(inputs["jax"]) == len(inputs["port"]) == 3
    for a, b in zip(inputs["jax"], inputs["port"]):
        for k in CHAMFER_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert b["chamfer_mask_pts"].shape == (5, stage2.CH_M, 2)
        assert len(np.unique(b["chamfer_poses"].reshape(5, -1), axis=0)) == 5
    for step, (a, b) in enumerate(zip(terms["jax"], terms["port"])):
        rtol = 1e-4 if step == 0 else 5e-2
        for k in TERMS:
            np.testing.assert_allclose(b[k], a[k], rtol=rtol,
                                       err_msg=f"step {step + 1} {k}")
    assert b["chamfer2d"] > 0
    np.testing.assert_allclose(tstats["loss"], jstats["loss"], rtol=1e-3)


def tiny_cell(workload):
    """(spec, ctx) of ``workload`` at a tiny size; the ``wim`` scene with 6
    ring cameras and 2 times, so that a step takes 5 silhouettes."""
    spec, ctx = tiny_context(workload, seed=SEED)
    if ctx.config["name"] == "wim":
        ctx.config["cameras"].update(n_cams=6, n_times=2)
    ctx.traffic = dict(ctx.traffic, warmup_steps=3, check_steps=3)
    return spec, ctx


def small_chamfer():
    """256 mask pixels and warped points a silhouette in place of 3,000
    (the chamfer's sizes; the tiny cloud has 600 points)."""
    return mock.patch.multiple(stage2, CH_M=256, CH_N=256)


def test_wim_stage2_step_matches_the_reference():
    """``train_pcd`` at WIM's settings on a tiny ``wim`` scene against
    ``benchmark.reference.stage2`` over three steps on the rows the
    program drew."""
    spec, ctx = tiny_cell("wim-stage2-train")
    pcd = ctx.config["pcd_train_config"]
    assert not pcd["pose_one_each"] and pcd["pose_embedding_dim"] == 0
    assert pcd["bg_col"] == 1 and ctx.config["figure"]["name"] == "spot"
    views = []
    real = stage2.step_inputs

    def step_inputs(n_rand, n_chamfer_views, device):
        views.append(n_chamfer_views)
        return real(n_rand, n_chamfer_views, device)

    with small_chamfer(), mock.patch.object(stage2, "step_inputs",
                                            step_inputs):
        res = stage2_train.run(ctx)
    assert views == [5]
    checks = {k: v for k, v, _ in res["checks"]}
    assert checks["rows_mismatched"] == 0 and checks["start_gap"] == 0
    assert len(res["loss_gap_by_step"]) == 3
    for k in ("loss_gap", "grad_norm_gap", "change_norm_gap"):
        assert checks[k] <= ROUNDING, (k, checks[k])
    assert res["failed"] == 0


def test_dnerf_stage1_step_matches_the_reference():
    """``scene_rep_reconstruction`` on a tiny ``dnerf`` scene (white, no
    mask loss, monocular) against ``benchmark.reference.stage1`` over three
    steps on the rows the program drew."""
    spec, ctx = tiny_cell("dnerf-stage1-train")
    tc = ctx.config["train_config"]
    assert tc["bg_col"] == 1 and tc["weight_mask_loss"] == 0
    res = stage1_train.run(ctx)
    checks = {k: v for k, v, _ in res["checks"]}
    assert checks["rows_mismatched"] == 0 and checks["start_gap"] == 0
    for k in ("loss_gap", "grad_norm_gap", "change_norm_gap"):
        assert checks[k] <= ROUNDING, (k, checks[k])
    assert res["failed"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", ["wim-stage2-train",
                                      "dnerf-stage1-train"])
def test_a_fault_fails_the_new_cells(workload, fault):
    """The new cells' limits (``benchmark/limits/``) at a tiny size with the
    program broken underneath: a step that leaves its state unchanged, or
    a loss over the first half of the rays only. ``correct`` comes out
    false."""
    from apnerf_torch.train import masked_adam, stage1
    spec, ctx = tiny_cell(workload)
    if fault == "state_unchanged":
        broken = mock.patch.object(masked_adam.MaskedAdam, "apply",
                                   lambda self, grads: None)
    else:
        module = stage1 if "stage1" in workload else stage2
        real = module.make_loss_fn

        def half(*args, **kw):
            loss_fn = real(*args, **kw)

            def on_half(batch, *rest):
                n = batch["cam"].shape[0] // 2
                return loss_fn({k: (v[:n] if k in ("rgb", "mask", "cam",
                                                   "pix") else v)
                                for k, v in batch.items()}, *rest)
            return on_half
        broken = mock.patch.object(module, "make_loss_fn", half)
    with small_chamfer(), broken:
        line = bench.execute(ctx, spec)
    assert not line["correct"], line["checks"]
