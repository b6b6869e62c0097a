"""``train_pcd`` of the port against the JAX package's on the CPU: a
three-view 32 x 32 arm scene (``data.synthetic.make_scene``), the
artifacts and backbone heads of torch_stage2_scene.py, 64 rays a step,
``full_t_iter`` 6 (the curriculum opens over the run), every loss term on
and one chamfer view a step, both budgets at 1 so that the two packages
render the same samples (the JAX CPU path in another order).

* Four steps from the same initial parameters (the port's ``build_model``
  made to return the JAX ``build_model``'s): the startup budget-audit
  numbers within 1% or 1 (the occupancy grid of two fp32 warps differs in
  a few cells: measured 6 of 1,316 valid samples, a per-ray p99 of 32
  against 31); every step's ray selection
  (and with it the sampled time) equal; the logged losses and PSNRs
  within 1e-3 relative (bf16 aggregation; the Adam steps part the two
  packages' parameters by whole steps in single entries, see
  test_torch_stage2_model.py: measured 2.5e-4 at step 3).
* Resuming from the port's own checkpoint at step 3 gives step 4 of the
  uninterrupted run (the checkpoint carries the host random state): the
  same rays, the same loss, the parameters to 1e-6 relative + 1e-7 (the
  CPU's matrix products may round the reloaded copies in another order:
  measured 1.5e-8).
* Resuming from the JAX package's mid-stage checkpoint: in
  test_torch_stage2_resume.py.
* ``max_steps`` reaches ``build_model``: the model config of a one-step
  run equals the JAX ``build_model``'s at the same ``max_steps`` and
  budget (the budget capped at ``max_steps`` below it).
* ``mesh`` raises ``NotImplementedError`` (``tensorboard_path``, once
  unported too, is held against the JAX package in
  test_torch_stage2_previews.py).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax

from apnerf.data import rays as jrays
from apnerf.train import stage2 as js2
from apnerf_torch.data import rays as trays
from apnerf_torch.data.synthetic import make_scene
from apnerf_torch.train import stage2 as ts2
from apnerf_torch.utils.checkpoint import params_from_jax
from torch_stage2_scene import artifacts, backbone, config  # noqa

RUN = dict(seed=0, log_every=1, sample_budget=32)
BBOX = (np.full(3, -1.5), np.full(3, 1.5))


@pytest.fixture(scope="module")
def setup():
    cfg = config(active_fraction=1.0, pass_fraction=1.0)
    cfg.pcd_train_config.update(N_rand=64, full_t_iter=6)
    canonical, skeleton = artifacts()
    jtcfg, tcfg, heads = backbone()
    return dict(cfg=cfg, data=make_scene(3, 32, 32, seed=0),
                canonical=canonical, skeleton=skeleton, jtcfg=jtcfg,
                tcfg=tcfg, heads=heads)


@pytest.fixture
def recorded(monkeypatch, setup):
    """Record each package's ray selections; the port's build_model
    returns the JAX build_model's parameters."""
    sels = {"jax": [], "port": []}
    for key, mod in (("jax", jrays), ("port", trays)):
        real = mod.RayIndex.gather

        def gather(self, sel, _real=real, _key=key):
            sels[_key].append(np.array(sel))
            return _real(self, sel)
        monkeypatch.setattr(mod.RayIndex, "gather", gather)
    real_build = ts2.build_model
    s = setup

    def build_model(*args, **kwargs):
        mcfg, model, state = real_build(*args, **kwargs)
        _, jparams, _ = js2.build_model(s["cfg"], s["canonical"],
                                        s["skeleton"], s["heads"],
                                        s["jtcfg"], seed=kwargs["seed"])
        model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams)))
        return mcfg, model, state
    monkeypatch.setattr(ts2, "build_model", build_model)
    return sels


def run_jax(s, **kw):
    return js2.train_pcd(s["cfg"], s["data"], s["canonical"], s["skeleton"],
                         s["heads"], s["jtcfg"], BBOX, **RUN, **kw)


def run_port(s, **kw):
    return ts2.train_pcd(s["cfg"], s["data"], s["canonical"], s["skeleton"],
                         s["heads"], s["tcfg"], BBOX, device="cpu", **RUN,
                         **kw)


def test_train_pcd_vs_jax(setup, recorded, capsys, tmp_path):
    s = setup
    jpath, tpath = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    _, _, _, jstats = run_jax(s, n_iters=4, ckpt_path=jpath, ckpt_every=3)
    jout = capsys.readouterr().out
    model, mcfg, _, tstats = run_port(s, n_iters=4, ckpt_path=tpath,
                                      ckpt_every=3)
    tout = capsys.readouterr().out
    audit = [[l for l in out.splitlines() if "budget audit" in l]
             for out in (jout, tout)]
    assert len(audit[0]) == len(audit[1]) == 1
    nums = [np.array(re.findall(r"\d+", a[0]), float) for a in audit]
    np.testing.assert_allclose(nums[1], nums[0], rtol=1e-2, atol=1)
    # one audit gather, then one a step
    assert len(recorded["jax"]) == len(recorded["port"]) == 5
    for a, b in zip(recorded["jax"], recorded["port"]):
        np.testing.assert_array_equal(a, b)
    assert len(tstats["loss"]) == len(jstats["loss"]) == 4
    assert all(np.isfinite(tstats["loss"]))
    np.testing.assert_allclose(tstats["loss"], jstats["loss"], rtol=1e-3)
    np.testing.assert_allclose(tstats["psnr"], jstats["psnr"], rtol=1e-3)
    assert set(tstats["terms"][0]) == {"mse", "arap", "weight_tv",
                                       "sparsity", "trans_reg",
                                       "joint_chamfer", "chamfer2d", "loss"}

    # resume from the port's own step-3 checkpoint: step 4 as uninterrupted
    step4 = recorded["port"][-1]
    for v in recorded.values():
        v.clear()
    model2, _, _, rstats = run_port(s, n_iters=4, ckpt_path=tpath,
                                    ckpt_every=3)
    assert len(recorded["port"]) == 2              # the audit, step 4
    np.testing.assert_array_equal(recorded["port"][-1], step4)
    assert len(rstats["loss"]) == 1
    assert rstats["loss"][0] == tstats["loss"][-1]
    for (n, p), q in zip(model.named_parameters(), model2.parameters()):
        torch.testing.assert_close(q, p, rtol=1e-6, atol=1e-7, msg=n)


@pytest.mark.parametrize("max_steps", [24, 48])
def test_train_pcd_max_steps(setup, max_steps):
    s = setup
    _, mcfg, _, stats = run_port(s, n_iters=1, max_steps=max_steps)
    jm, _, _ = js2.build_model(s["cfg"], s["canonical"], s["skeleton"],
                               s["heads"], s["jtcfg"],
                               sample_budget=RUN["sample_budget"],
                               max_steps=max_steps)
    assert dataclasses.asdict(mcfg) == dataclasses.asdict(jm)
    assert mcfg.max_steps == max_steps
    assert mcfg.sample_budget == min(RUN["sample_budget"], max_steps)
    assert np.isfinite(stats["loss"]).all()


@pytest.mark.parametrize("kw", [dict(mesh="mesh")])
def test_train_pcd_unported_options_raise(setup, kw):
    with pytest.raises(NotImplementedError):
        run_port(setup, n_iters=1, **kw)
