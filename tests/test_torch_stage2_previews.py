"""``train_pcd``'s tensorboard previews, the port (``torch.utils.
tensorboard``) against the JAX package (tensorboardX), on
test_torch_stage2_train.py's scene and run (the port's ``build_model``
made to return the JAX parameters), three steps with ``i_save`` 2: the
previews at steps 1 and 2 draw their training views from the batch
generator, so the batches after step 1 depend on where they are drawn.

* The batches are equal step by step.
* The scalars: the loss, the render MSE and the PSNR within 1e-3
  relative (test_torch_stage2_train.py's tolerance for the losses), the
  other terms within 5e-3 (the ARAP term, which weighs the warp's
  parameters, measured 2.0e-3 by step 4; test_torch_stage2_model.py
  shows that drift); ``eps_time`` is a wall clock.
* The ``payload`` and ``video_panels`` images within 2 levels of 255 on
  99% of their pixels and 8 on every one (the renders of two
  trajectories 1e-3 apart; measured over four steps: ``payload`` equal,
  ``video_panels`` 99.87% within 2 levels, 4 at most), the comparison
  videos written.
* Without tensorboard nothing is written and no preview view is drawn:
  the batches are those of a run without ``tensorboard_path``.
"""
import os
import sys

import numpy as np
import pytest

import jax

from apnerf.data import rays as jrays
from apnerf.train import stage2 as js2
from apnerf_torch.data import rays as trays
from apnerf_torch.data.synthetic import make_scene
from apnerf_torch.train import stage2 as ts2
from apnerf_torch.utils.checkpoint import params_from_jax
from apnerf_torch.utils.png import read_png
from torch_cli_scene import one_torch_thread  # noqa
from torch_stage2_scene import artifacts, backbone, config  # noqa

RUN = dict(seed=0, log_every=1, sample_budget=32, n_iters=3, i_save=2)
BBOX = (np.full(3, -1.5), np.full(3, 1.5))
SCALARS = ("PSNR", "mse", "arap", "weight_tv", "sparsity", "trans_reg",
           "joint_chamfer", "chamfer2d", "loss")


def setup():
    cfg = config(active_fraction=1.0, pass_fraction=1.0)
    cfg.pcd_train_config.update(N_rand=64, full_t_iter=6)
    canonical, skeleton = artifacts()
    jtcfg, tcfg, heads = backbone()
    return dict(cfg=cfg, data=make_scene(3, 32, 32, seed=0),
                canonical=canonical, skeleton=skeleton, jtcfg=jtcfg,
                tcfg=tcfg, heads=heads)


def record(mp, sels, s):
    """Record each package's ray selections; the port's build_model
    returns the JAX build_model's parameters."""
    for key, mod in (("jax", jrays), ("port", trays)):
        real = mod.RayIndex.gather

        def gather(self, sel, _real=real, _key=key):
            sels[_key].append(np.array(sel))
            return _real(self, sel)
        mp.setattr(mod.RayIndex, "gather", gather)
    real_build = ts2.build_model

    def build_model(*args, **kwargs):
        mcfg, model, state = real_build(*args, **kwargs)
        _, jparams, _ = js2.build_model(s["cfg"], s["canonical"],
                                        s["skeleton"], s["heads"],
                                        s["jtcfg"], seed=kwargs["seed"])
        model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams)))
        return mcfg, model, state
    mp.setattr(ts2, "build_model", build_model)


def run_port(s, **kw):
    return ts2.train_pcd(s["cfg"], s["data"], s["canonical"], s["skeleton"],
                         s["heads"], s["tcfg"], BBOX, device="cpu", **RUN,
                         **kw)


def events(path):
    """{tag: {step: value or image}} of a tensorboard event directory."""
    from tensorboard.backend.event_processing import event_accumulator
    acc = event_accumulator.EventAccumulator(
        path, size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    out = {}
    for tag in acc.Tags()["scalars"]:
        out[tag] = {e.step: e.value for e in acc.Scalars(tag)}
    for tag in acc.Tags()["images"]:
        imgs = {}
        for e in acc.Images(tag):
            tmp = os.path.join(path, f"_{tag}_{e.step}.png")
            with open(tmp, "wb") as f:
                f.write(e.encoded_image_string)
            imgs[e.step] = read_png(tmp)
        out[tag] = imgs
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    s = setup()
    d = tmp_path_factory.mktemp("tb")
    sels = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    try:
        record(mp, sels, s)
        _, _, _, jstats = js2.train_pcd(
            s["cfg"], s["data"], s["canonical"], s["skeleton"], s["heads"],
            s["jtcfg"], BBOX, tensorboard_path=str(d / "jax"), **RUN)
        _, _, _, tstats = run_port(s, tensorboard_path=str(d / "port"))
        plain = len(sels["port"])
        run_port(s)                                  # no tensorboard_path
        sels["port_no_tb"] = sels["port"][plain:]
        del sels["port"][plain:]
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        run_port(s, tensorboard_path=str(d / "none"))
        sels["port_no_writer"] = sels["port"][plain:]
        del sels["port"][plain:]
    finally:
        mp.undo()
    return dict(sels=sels, jstats=jstats, tstats=tstats, dir=d,
                jev=events(str(d / "jax")), tev=events(str(d / "port")))


def test_batches_equal_step_by_step(runs):
    sels = runs["sels"]
    assert len(sels["jax"]) == len(sels["port"]) == 4     # audit + 3 steps
    for a, b in zip(sels["jax"], sels["port"]):
        np.testing.assert_array_equal(a, b)
    # the step-1 preview's draw moves every later batch
    assert not np.array_equal(sels["port"][2], sels["port_no_tb"][2])
    np.testing.assert_allclose(runs["tstats"]["loss"], runs["jstats"]["loss"],
                               rtol=1e-3)


def test_scalars_vs_jax(runs):
    jev, tev = runs["jev"], runs["tev"]
    for name in SCALARS + ("eps_time",):
        tag = f"metrics/{name}"
        assert sorted(tev[tag]) == sorted(jev[tag]) == [1, 2, 3], tag
    for name in SCALARS:
        tag = f"metrics/{name}"
        steps = sorted(jev[tag])
        rtol = 1e-3 if name in ("PSNR", "mse", "loss") else 5e-3
        np.testing.assert_allclose([tev[tag][k] for k in steps],
                                   [jev[tag][k] for k in steps], rtol=rtol,
                                   atol=1e-7, err_msg=tag)


@pytest.mark.parametrize("tag,shape", [("payload", (24, 16, 3)),
                                       ("video_panels", None)])
def test_preview_images_vs_jax(runs, tag, shape):
    jimg, timg = runs["jev"][tag], runs["tev"][tag]
    assert sorted(timg) == sorted(jimg) == [1, 2]
    for step in jimg:
        a, b = timg[step].astype(int), jimg[step].astype(int)
        assert a.shape == b.shape, (tag, step)
        if shape is not None:
            assert a.shape == shape
        d = np.abs(a - b)
        assert (d <= 2).mean() >= 0.99 and d.max() <= 8, (tag, step, d.max())
        assert a.std() > 0
    for pkg in ("jax", "port"):
        names = os.listdir(runs["dir"] / pkg)
        for step in (1, 2):
            assert any(n.startswith(f"comparison_{step:06d}") for n in names)


def test_without_a_writer_no_preview_is_drawn(runs, capsys):
    sels = runs["sels"]
    assert len(sels["port_no_writer"]) == len(sels["port_no_tb"]) == 4
    for a, b in zip(sels["port_no_writer"], sels["port_no_tb"]):
        np.testing.assert_array_equal(a, b)
    assert not (runs["dir"] / "none").exists()


def test_missing_tensorboard_is_announced(capsys, monkeypatch):
    s = setup()
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    run = dict(RUN, n_iters=1)
    ts2.train_pcd(s["cfg"], s["data"], s["canonical"], s["skeleton"],
                  s["heads"], s["tcfg"], BBOX, device="cpu",
                  tensorboard_path="unused", **{k: v for k, v in run.items()})
    assert "logging to console only" in capsys.readouterr().out
