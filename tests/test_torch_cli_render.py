"""``apnerf_torch.cli.main`` against ``apnerf.cli.main``, part 2: the
render branch, on the checkpoints of one JAX training run (the scene,
config and working directories of torch_cli_scene.py) copied into the
port's run directory.

* ``--render_only --load_test_val --render_test --render_pcd
  --eval_psnr --degree_threshold 30`` (the bones pruned at 30 degrees):
  the ``img_*.png`` within one level on 99.9% of the pixels, the
  ``results.txt`` PSNR within 0.05 dB, the JAX ``threshold.txt``; the
  same images and PSNR for the backbone's ``--render_test``.
* ``--repose_pcd --degree_threshold 30 --visualise_canonical`` (the port
  only; the JAX command line's repose is in tests/test_cli_e2e.py): 60
  frames written, equal to the port's ``cli.repose`` on the same pruned
  state (held against the JAX repose by test_torch_render.py), and
  ``canonical_skeleton.png``; ``--repose_pcd`` without ``--render_pcd``
  takes the point model; ``--render_devices 2`` raises on the CPU (one
  process a CUDA card).
* Without imageio, cv2, matplotlib and tensorboard (made unimportable in
  a fresh interpreter) the render writes its PNGs, ``results.txt`` and
  the animated-PNG video.
"""
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from apnerf_torch import cli as tcli
from apnerf_torch.config import load_config
from apnerf_torch.data.load_data import load_data
from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.render import render as trender
from apnerf_torch.utils import checkpoint as tck
from apnerf_torch.utils.png import read_png, read_png_frames
from torch_cli_scene import (one_torch_thread,  # noqa
                             LOG, RUN_DIR, jax_cli, make_dirs,  # noqa
                             port_cli, read_results)

REPO = Path(__file__).resolve().parent.parent
EVAL = ["--render_only", "--load_test_val", "--render_test", "--eval_psnr"]
POINTS = "render_test_temporalpoints_last"
BACKBONE = "render_test_fine_last"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_render")
    _, dirs = make_dirs(root)
    cache = root / "cache"
    jax_cli(dirs["jax"], LOG, cache)
    jrun, trun = dirs["jax"] / RUN_DIR, dirs["port"] / RUN_DIR
    trun.mkdir(parents=True)
    for name in ("fine_last.pkl", "temporalpoints_last.pkl"):
        shutil.copy(jrun / name, trun / name)
    out = {}
    for key, argv in (("points", EVAL + ["--render_pcd",
                                         "--degree_threshold", "30"]),
                      ("backbone", EVAL)):
        jax_cli(dirs["jax"], argv + LOG, cache)
        port_cli(dirs["port"], argv + LOG)
        sub = POINTS if key != "backbone" else BACKBONE
        for pkg, run in (("jax", jrun), ("port", trun)):
            shutil.copytree(run / sub, root / f"{key}_{pkg}")
        out[key] = (root / f"{key}_jax", root / f"{key}_port")
    return dict(root=root, dirs=dirs, jrun=jrun, trun=trun, out=out)


@pytest.mark.parametrize("key", ["points", "backbone"])
def test_render_test_vs_jax(runs, key):
    jdir, tdir = runs["out"][key]
    pngs = sorted(p.name for p in jdir.glob("img_*.png"))
    assert pngs == sorted(p.name for p in tdir.glob("img_*.png"))
    assert pngs == ["img_000.png"]                 # the one test view
    for name in pngs:
        a = read_png(tdir / name).astype(int)
        b = read_png(jdir / name).astype(int)
        d = np.abs(a - b)
        assert a.shape == b.shape == (32, 32, 3)
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                           (d > 0).mean())
    got, want = read_results(tdir / "results.txt"), \
        read_results(jdir / "results.txt")
    assert set(got) == set(want) == {"psnr"}
    assert abs(got["psnr"] - want["psnr"]) <= 0.05
    assert any(p.name.startswith("test_video.rgb") for p in tdir.iterdir())


def test_threshold_txt_vs_jax(runs):
    jdir, tdir = runs["out"]["points"]
    text = (tdir / "threshold.txt").read_text()
    assert text == (jdir / "threshold.txt").read_text()
    assert text.startswith("30.0\nStatic joints: ")


@pytest.fixture(scope="module")
def repose(runs):
    """The CLI's repose (frames at a quarter size, 64-ray chunks: the same
    render either way), recording what render_viewpoints returns."""
    got = []
    real = trender.render_viewpoints

    def record(*a, **k):
        out = real(*a, **k)
        got.append(out)
        return out
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(trender, "render_viewpoints", record)
        mp.setattr(tcli, "repose", functools.partial(tcli.repose, chunk=64))
        port_cli(runs["dirs"]["port"],
                 ["--render_only", "--render_pcd", "--repose_pcd",
                  "--degree_threshold", "30", "--visualise_canonical",
                  "--render_video_factor", "4"] + LOG)
    finally:
        mp.undo()
    return got


def test_repose_vs_repose_function(runs, repose):
    (out,) = repose
    rep = runs["trun"] / "render_video_repose_0"
    frames = sorted(p.name for p in rep.glob("img_*.png"))
    assert len(frames) == 60 and frames[-1] == "img_059.png"
    assert any(p.name.startswith("train_video.rgb") for p in rep.iterdir())
    assert (runs["trun"] / "canonical_skeleton.png").stat().st_size > 0
    cfg = load_config(str(runs["dirs"]["port"] / "micro.py"))
    data = load_data(cfg.data, cfg)
    model, state = tck.load_temporalpoints(
        str(runs["trun"] / "temporalpoints_last.pkl"), device="cpu")
    model.cfg = tcli.points_render_config(model.cfg, cfg)
    state, info = ttp.simplify_skeleton(
        model, state, np.unique(data["times"]), deg_threshold=30.0,
        five_percent_heuristic=True)
    want = tcli.repose(model, state, data, data["near"], data["far"],
                       float(cfg.train_config.bg_col), seed=0,
                       render_factor=4, chunk=64, device="cpu",
                       verbose=False, inverse_y=False, flip_x=False,
                       flip_y=False)
    assert out["rgbs"].shape == (60, 8, 8, 3)
    for key in ("rgbs", "depths", "weights"):
        np.testing.assert_array_equal(out[key], want[key], err_msg=key)
    from apnerf_torch.render.metrics import to8b
    np.testing.assert_array_equal(read_png(rep / "img_029.png"),
                                  to8b(want["rgbs"][29]))


def test_repose_without_render_pcd_takes_the_point_model(runs, repose,
                                                         monkeypatch):
    rep = runs["trun"] / "render_video_repose_0"
    for f in rep.glob("img_*.png"):
        f.unlink()
    monkeypatch.setattr(tcli, "repose", functools.partial(tcli.repose,
                                                          chunk=64))
    port_cli(runs["dirs"]["port"], ["--render_only", "--repose_pcd",
                                    "--render_video_factor", "4"] + LOG)
    assert len(list(rep.glob("img_*.png"))) == 60


def test_fused_agg_renders_no_weight_images(runs, monkeypatch):
    """With ``fused_agg`` (and the shared k-NN) in the scene config the
    repose runs the fused aggregation (K6's plain version here) and draws
    no LBS-weight images."""
    from apnerf_torch.kernels import agg
    work = runs["dirs"]["port"]
    (work / "fused.py").write_text(
        "_base_ = './micro.py'\n"
        "pcd_model_and_render = dict(knn_share=16, knn_cand=8, "
        "coarse_stride=32, fused_agg=True)\n")
    calls, got = [], []
    real_agg, real_render = agg.fused_subgroup_agg_plain, \
        trender.render_viewpoints
    monkeypatch.setattr(agg, "fused_subgroup_agg_plain",
                        lambda *a, **k: calls.append(1) or real_agg(*a, **k))
    monkeypatch.setattr(trender, "render_viewpoints",
                        lambda *a, **k: got.append(real_render(*a, **k))
                        or got[-1])
    monkeypatch.setattr(tcli, "repose", functools.partial(tcli.repose,
                                                          chunk=64))
    from torch_cli_scene import working_dir
    with working_dir(work):
        tcli.main(["--config", "fused.py", "--render_only", "--render_pcd",
                   "--repose_pcd", "--seed", "3", "--render_video_factor",
                   "4"] + LOG, device="cpu")
    (out,) = got
    assert out["rgbs"].shape == (60, 8, 8, 3) and out["weights"].size == 0
    assert len(calls) == 60                       # one chunk a frame
    rep = runs["trun"] / "render_video_repose_3"
    assert len(list(rep.glob("img_*.png"))) == 60
    assert not list(rep.glob("weights_*")) \
        and not list(rep.glob("video.weights*"))


def test_render_devices_raise(runs):
    # one process a CUDA card: on the CPU there is none
    with pytest.raises(RuntimeError, match="CUDA card"):
        port_cli(runs["dirs"]["port"], EVAL + ["--render_devices", "2"])


def test_render_without_optional_packages(runs, tmp_path):
    """imageio, cv2, matplotlib and tensorboard unimportable: the PNGs,
    ``results.txt`` and the video as an animated PNG."""
    work = tmp_path / "work"
    (work / RUN_DIR).mkdir(parents=True)
    shutil.copy(runs["dirs"]["port"] / "micro.py", work / "micro.py")
    shutil.copy(runs["trun"] / "temporalpoints_last.pkl", work / RUN_DIR)
    code = (
        "import sys\n"
        "for m in ('imageio', 'imageio.v2', 'cv2', 'matplotlib',\n"
        "          'tensorboard', 'tensorboardX', 'torch.utils.tensorboard'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from apnerf_torch import cli\n"
        "cli.main(['--config', 'micro.py', '--render_only',\n"
        "          '--load_test_val', '--render_test', '--render_pcd',\n"
        "          '--eval_psnr'], device='cpu')\n"
        "assert all(sys.modules[m] is None for m in ('imageio', 'cv2',\n"
        "           'matplotlib', 'tensorboard', 'tensorboardX'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=work,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = work / RUN_DIR / POINTS
    assert "neither imageio nor cv2" in res.stdout
    assert read_png(out / "img_000.png").shape == (32, 32, 3)
    assert np.isfinite(read_results(out / "results.txt")["psnr"])
    video = read_png_frames(out / "test_video.rgb.png")
    np.testing.assert_array_equal(video[0], read_png(out / "img_000.png"))
