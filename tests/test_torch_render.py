"""The port's render, evaluation and repose entry points
(apnerf_torch.render, apnerf_torch.cli) against the JAX package on the CPU.

Metrics: PSNR and SSIM run the same scipy / numpy code in float64 (1e-7);
LPIPS-rand runs the same seeded numpy weights through ``F.conv2d`` here
and ``lax.conv`` there in fp32 (1e-4 relative). ``render_viewpoints`` is
compared twice: with an analytic chunk renderer at 64 x 64 (every metric,
``results.txt``, PNGs, a ragged last chunk), and over
``make_points_renderer`` on the small scene of
test_torch_temporal_points.py, 3 views of 16 x 12 in 80-ray chunks, the
JAX side on its CPU path (PSNR >= 40 dB between the two stacks, as the
one-chunk comparisons there). The backbone renderer compares at 1e-5.
"""
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.models import temporal_points as jtp
from apnerf.models import tineuvox as jtv
from apnerf.render import lpips_jax, metrics as jmetrics
from apnerf.render import render as jrender, renderers as jrenderers
from apnerf_torch import cli as tcli
from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.models import tineuvox as ttv
from apnerf_torch.parallel import ranks
from apnerf_torch.render import lpips as tlpips, metrics as tmetrics
from apnerf_torch.render import render as trender, renderers as trenderers
from apnerf_torch.utils import checkpoint as tck
from test_torch_temporal_points import (BASE, MODES, jax_state,  # noqa
                                        port_model, psnr, scene)

H, W = 12, 16
SHARED = MODES["shared8_cand8"]


def _images(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


def test_metrics_vs_jax():
    a, b = _images(0, 40, 30)
    assert abs(tmetrics.psnr(a, b) - jmetrics.psnr(a, b)) < 1e-7
    assert abs(tmetrics.rgb_ssim(a, b, max_val=1)
               - jmetrics.rgb_ssim(a, b, max_val=1)) < 1e-7
    np.testing.assert_allclose(
        tmetrics.rgb_ssim(a, b, return_map=True),
        jmetrics.rgb_ssim(a, b, return_map=True), rtol=0, atol=1e-7)
    assert tmetrics.mse2psnr(0.01) == jmetrics.mse2psnr(0.01) == 20.0
    np.testing.assert_array_equal(tmetrics.to8b(a * 1.5 - 0.2),
                                  jmetrics.to8b(a * 1.5 - 0.2))
    assert tmetrics.to8b(a).dtype == np.uint8


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_rand_vs_jax(net, monkeypatch):
    """The seeded-random fallback: same numpy weights on both sides, 1e-4
    relative; the honest metric name; the warning comes once."""
    monkeypatch.delenv("APNERF_LPIPS_WEIGHTS", raising=False)
    gt, im = _images(1)
    want = lpips_jax.lpips(gt, im, net_name=net)
    tlpips._warned_random.discard(net)
    tlpips._CACHE.clear()
    with pytest.warns(UserWarning, match="seeded-random"):
        got = tlpips.lpips(gt, im, net_name=net, device="cpu")
    tlpips._CACHE.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = tlpips.lpips(gt, im, net_name=net, device="cpu")
    assert got == again and want > 1e-3
    assert abs(got - want) <= 1e-4 * want
    assert abs(tmetrics.rgb_lpips(gt, im, net, device="cpu") - want) \
        <= 1e-4 * want
    assert tlpips.lpips(gt, gt, net_name=net, device="cpu") == 0.0
    assert (tmetrics.lpips_metric_name(net) == jmetrics.lpips_metric_name(net)
            == f"lpips_rand_{net}")
    for a, b in zip(tlpips.random_params(net, 3)["convs"],
                    lpips_jax.random_params(net, 3)["convs"]):
        np.testing.assert_array_equal(a[0], b[0])


def test_lpips_npz_weights_vs_jax(tmp_path, monkeypatch):
    """The ``.npz`` route: weights from a file (negative calibration
    entries clipped), by argument and by ``APNERF_LPIPS_WEIGHTS``, which
    also turns the metric's name into the official one."""
    params = lpips_jax.random_params("alex", seed=7)
    rng = np.random.default_rng(7)
    payload = {}
    for i, (w, b) in enumerate(params["convs"]):
        payload[f"conv{i}_w"] = w
        payload[f"conv{i}_b"] = rng.normal(size=b.shape).astype(np.float32)
    for i, lin in enumerate(params["lins"]):
        payload[f"lin{i}"] = (lin * rng.normal(size=lin.shape)).astype(
            np.float32)
    path = str(tmp_path / "alex.npz")
    np.savez(path, **payload)
    gt, im = _images(2)
    want = lpips_jax.lpips(gt, im, "alex", weights_path=path)
    got = tlpips.lpips(gt, im, "alex", weights_path=path, device="cpu")
    assert abs(got - want) <= 1e-4 * want
    assert all((v >= 0).all()
               for v in tlpips.load_params("alex", path)["lins"])
    monkeypatch.setenv("APNERF_LPIPS_WEIGHTS", path)
    assert tmetrics.lpips_metric_name("alex") == "lpips_alex"
    tlpips._CACHE.clear()
    assert tlpips.lpips(gt, im, "alex", device="cpu") == got


def _results(path):
    with open(path) as f:
        return [line.split(": ") for line in f.read().splitlines()]


def test_render_viewpoints_analytic_vs_jax(tmp_path, monkeypatch):
    """Both packages' loops over the same analytic chunk renderer, 2 views of
    64 x 64 in 1000-ray chunks (the last one ragged): images 1e-6, every
    metric, the lines of results.txt, the PNGs."""
    monkeypatch.delenv("APNERF_LPIPS_WEIGHTS", raising=False)
    n = 2
    rng = np.random.default_rng(3)
    poses = np.repeat(np.eye(4, dtype=np.float32)[None], n, 0)
    poses[:, 2, 3] = 3.0
    poses[1, 0, 3] = 0.3
    Ks = np.repeat(np.array([[80, 0, 32], [0, 80, 32], [0, 0, 1]],
                            np.float32)[None], n, 0)
    HW = np.array([[64, 64]] * n)
    times = np.array([0.0, 1.0], np.float32)
    gts = rng.random((n, 64, 64, 3)).astype(np.float32)

    def port_for(i, t):
        return lambda ro, rd, vd: {
            "rgb_marched": 0.5 + 0.5 * torch.sin(40 * vd + i + t + ro),
            "depth": vd[:, 2] * (1 + t)}

    def jax_for(i, t):
        return lambda ro, rd, vd: {
            "rgb_marched": 0.5 + 0.5 * jnp.sin(40 * vd + i + t + ro),
            "depth": vd[:, 2] * (1 + t)}

    kw = dict(gt_imgs=gts, eval_psnr=True, eval_ssim=True,
              eval_lpips_alex=True, eval_lpips_vgg=True, chunk=1000,
              verbose=False)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    jdir.mkdir()
    got = trender.render_viewpoints(port_for, poses, HW, Ks, times,
                                    savedir=str(tdir), device="cpu", **kw)
    want = jrender.render_viewpoints(jax_for, poses, HW, Ks, times,
                                     savedir=str(jdir), **kw)
    assert got["rgbs"].shape == (n, 64, 64, 3)
    assert got["depths"].shape == (n, 64, 64) and got["weights"].size == 0
    np.testing.assert_allclose(got["rgbs"], want["rgbs"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depths"], want["depths"], rtol=0,
                               atol=1e-6)
    for key, rtol in (("psnrs", 1e-5), ("ssims", 1e-4), ("lpips_alex", 1e-3),
                      ("lpips_vgg", 1e-3)):
        assert len(got[key]) == n
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   err_msg=key)
    tres, jres = _results(tdir / "results.txt"), _results(jdir /
                                                          "results.txt")
    assert [k for k, _ in tres] == [k for k, _ in jres] == [
        "psnr", "ssim", "lpips_rand_vgg", "lpips_rand_alex"]
    np.testing.assert_allclose([float(v) for _, v in tres],
                               [float(v) for _, v in jres], rtol=1e-3)
    assert float(tres[0][1]) == np.mean(got["psnrs"])
    import imageio.v2 as imageio
    for i in range(n):
        png = imageio.imread(tdir / f"img_{i:03d}.png")
        np.testing.assert_array_equal(png, tmetrics.to8b(got["rgbs"][i]))
    assert sorted(os.listdir(tdir)) == ["img_000.png", "img_001.png",
                                        "results.txt"]


def _cameras(n):
    poses = np.repeat(np.eye(4, dtype=np.float32)[None], n, 0)
    poses[:, 2, 3] = 3.0
    poses[:, 0, 3] = np.linspace(-0.03, 0.03, n)
    Ks = np.repeat(np.array([[140, 0, W / 2], [0, 140, H / 2], [0, 0, 1]],
                            np.float32)[None], n, 0)
    return poses, Ks, np.array([[H, W]] * n)


def test_render_viewpoints_points_vs_jax(tmp_path, scene):
    """3 views at times 0, 0.5, 1 through ``make_points_renderer`` in both
    packages (shared k-NN, LBS-weight colours, joints for the overlay):
    rgb, depth / max_steps and weight images at >= 40 dB, the PSNRs
    against random gt images, results.txt and the PNGs."""
    n = 3
    poses, Ks, HW = _cameras(n)
    times = np.linspace(0, 1, n).astype(np.float32)
    gts = np.random.default_rng(4).random((n, H, W, 3)).astype(np.float32)
    kw = dict(gt_imgs=gts, eval_psnr=True, eval_ssim=True, chunk=80,
              verbose=False)
    jcfg = jtp.TemporalPointsConfig(**{**BASE, **SHARED})
    jview = jrenderers.make_points_renderer(
        scene["params"], jcfg, jax_state(jcfg, scene), 0.5, 6.0, 1.0,
        poses=poses, Ks=Ks)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    want = jrender.render_viewpoints(jview, poses, HW, Ks, times,
                                     savedir=str(jdir), **kw)
    model, state = port_model(SHARED, scene)
    tview = trenderers.make_points_renderer(model, state, 0.5, 6.0, 1.0,
                                            poses=poses, Ks=Ks)
    got = trender.render_viewpoints(tview, poses, HW, Ks, times,
                                    savedir=str(tdir), device="cpu", **kw)
    for key, shape in (("rgbs", (n, H, W, 3)), ("depths", (n, H, W)),
                       ("weights", (n, H, W, 3))):
        assert got[key].shape == want[key].shape == shape, key
        assert np.isfinite(got[key]).all(), key
    assert (got["rgbs"] < 0.99).any(-1).mean() > 0.5      # foreground
    assert psnr(got["rgbs"], want["rgbs"]) >= 40.0
    assert psnr(got["depths"] / 128.0, want["depths"] / 128.0) >= 40.0
    assert psnr(got["weights"], want["weights"]) >= 40.0
    # the three views differ (time moves the cloud)
    assert np.abs(got["rgbs"][0] - got["rgbs"][2]).max() > 0.05
    np.testing.assert_allclose(got["psnrs"], want["psnrs"], rtol=1e-3)
    np.testing.assert_allclose(got["ssims"], want["ssims"], atol=1e-3)
    tres, jres = _results(tdir / "results.txt"), _results(jdir /
                                                          "results.txt")
    assert [k for k, _ in tres] == [k for k, _ in jres] == ["psnr", "ssim"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert "weights_002.png" in os.listdir(tdir)


def test_render_factor_joints_and_direct(scene):
    """``render_factor`` halves the view and scales K; ``finish()`` gives
    the joints projected with the renderer's own cameras; the skeleton is
    drawn on the weight image; ``render_pcd_direct`` swaps the image;
    ``render_weights=False`` gives no weight image."""
    poses, Ks, HW = _cameras(1)
    model, state = port_model(SHARED, scene)
    view = trenderers.make_points_renderer(model, state, 0.5, 6.0, 1.0,
                                           poses=poses, Ks=Ks)
    half = trender.render_viewpoints(view, poses, HW, Ks, [0.5],
                                     render_factor=2, chunk=48,
                                     verbose=False, device="cpu")
    assert half["rgbs"].shape == (1, H // 2, W // 2, 3)
    assert half["weights"].shape == (1, H // 2, W // 2, 3)
    res = trender.render_image(view(0, 0.5), Ks[0], poses[0], H, W,
                               chunk=H * W, extra_keys=("weights", "acc"),
                               device="cpu")
    assert res["bones"].shape == (5, 2) and res["joints_2d"].shape == (6, 2)
    with torch.no_grad():       # prepare_frame is differentiable
        j3 = ttp.prepare_frame(model, state, t=0.5)["joints_warped"]
        want = ttp.project_points(j3, torch.tensor(poses[0]),
                                  torch.tensor(Ks[0])).numpy()
    np.testing.assert_allclose(res["joints_2d"], want, rtol=1e-5, atol=1e-4)
    drawn = trender.overlay_skeleton(res["weights"], res["joints_2d"],
                                     res["bones"])
    assert drawn.shape == res["weights"].shape
    assert (drawn != res["weights"]).any() and res["acc"].max() > 0.5

    direct = trenderers.make_points_renderer(
        model, state, 0.5, 6.0, 1.0, render_weights=False,
        render_pcd_direct=True)
    dres = trender.render_image(direct(0, 0.5), Ks[0], poses[0], H, W,
                                chunk=H * W, extra_keys=("weights",),
                                device="cpu")
    assert "weights" not in dres and "joints_2d" not in dres
    assert np.isfinite(dres["rgb_marched"]).all()
    assert np.abs(dres["rgb_marched"] - res["rgb_marched"]).max() > 0.05
    # canonical rgb 0.5 everywhere: the direct image is grey on white
    fg = dres["rgb_marched"][res["acc"] > 0.9]
    assert np.ptp(fg, axis=-1).max() < 1e-5


def test_budget_audit_warns_once(scene, capsys):
    """A pass budget far below the demand: the renderer says so once, on
    its first view."""
    tight = dict(SHARED, pass_fraction=0.05)
    poses, Ks, HW = _cameras(2)
    model, state = port_model(tight, scene)
    view = trenderers.make_points_renderer(model, state, 0.5, 6.0, 1.0)
    trender.render_viewpoints(view, poses, HW, Ks, [0.0, 1.0],
                              chunk=H * W, verbose=False, device="cpu")
    out = capsys.readouterr().out
    assert out.count("render: budget audit") == 1
    assert "radius-pass" in out


def _tiny_backbone():
    kw = dict(xyz_min=(-1.0, -1.0, -1.0), xyz_max=(1.0, 1.0, 1.0),
              num_voxels=10 ** 3, num_voxels_base=10 ** 3, voxel_dim=4,
              defor_depth=3, net_width=16, posbase_pe=3, viewbase_pe=2,
              timebase_pe=3, gridbase_pe=1, alpha_init=1e-2,
              fast_color_thres=1e-4)
    jcfg = jtv.TiNeuVoxConfig(**kw)
    params = jtv.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    params["feature"] = jnp.asarray(
        rng.normal(size=params["feature"].shape).astype(np.float32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, tck.tineuvox_from_jax(kw, tree, device="cpu")


def test_backbone_renderer_vs_jax(tmp_path):
    """``make_backbone_renderer`` over a tiny TiNeuVox, 2 views of 10 x 12
    from inside the bbox (a face would make the in-bbox test fp-fragile
    between programs), in 50-ray chunks: rgb and depth at 1e-5; on a
    one-rank mesh equal to the render without one."""
    jcfg, params, model = _tiny_backbone()
    n, h, w = 2, 10, 12
    poses = np.repeat(np.eye(4, dtype=np.float32)[None], n, 0)
    poses[:, 2, 3] = 0.9
    poses[1, 0, 3] = 0.1
    Ks = np.repeat(np.array([[30, 0, w / 2], [0, 30, h / 2], [0, 0, 1]],
                            np.float32)[None], n, 0)
    HW = np.array([[h, w]] * n)
    times = np.array([0.2, 0.8], np.float32)
    near, far, step, bg = 0.05, 1.53, 0.5, 1.0
    jview = jrenderers.make_backbone_renderer(params, jcfg, step, near, far,
                                              bg)
    tview = trenderers.make_backbone_renderer(model, step, near, far, bg)
    kw = dict(chunk=50, verbose=False)
    want = jrender.render_viewpoints(jview, poses, HW, Ks, times, **kw)
    got = trender.render_viewpoints(tview, poses, HW, Ks, times,
                                    device="cpu", **kw)
    assert got["rgbs"].shape == (n, h, w, 3) and got["weights"].size == 0
    assert np.ptp(got["rgbs"]) > 0.01 and np.ptp(got["depths"]) > 0.01
    np.testing.assert_allclose(got["rgbs"], want["rgbs"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depths"], want["depths"], rtol=0,
                               atol=1e-4)
    # the same views on a one-rank mesh (a gloo group in this process):
    # the chunk split and the view's all-gather leave them equal
    with ranks.local_group(str(tmp_path)) as mesh:
        mview = trenderers.make_backbone_renderer(model, step, near, far, bg,
                                                  mesh=mesh)
        meshed = trender.render_viewpoints(mview, poses, HW, Ks, times,
                                           device="cpu", **kw)
    for key in ("rgbs", "depths"):
        np.testing.assert_array_equal(meshed[key], got[key], err_msg=key)


def test_repose_is_seeded(scene, tmp_path):
    """60 frames (a 30-step ramp there and back) from the first camera,
    the root fixed; the same seed gives the same frames, another seed
    others; frames and videos are written only with ``savedir``."""
    poses, Ks, HW = _cameras(1)
    data = dict(poses=poses, Ks=Ks, HW=HW)
    model, state = port_model(SHARED, scene)
    kw = dict(render_factor=2, chunk=48, verbose=False, device="cpu")
    a = tcli.repose(model, state, data, 0.5, 6.0, 1.0, seed=1, **kw)
    assert a["rgbs"].shape == (60, H // 2, W // 2, 3)
    assert a["weights"].shape == (60, H // 2, W // 2, 3)
    assert np.isfinite(a["rgbs"]).all()
    # the pose moves the silhouette: depth and LBS colours show it (the
    # random rgbnet paints everything the same grey)
    for key in ("rgbs", "depths", "weights"):
        np.testing.assert_array_equal(a[key][0], a[key][59])
        np.testing.assert_array_equal(a[key][29], a[key][30])
    assert np.abs(a["depths"][29] - a["depths"][0]).max() > 1.0
    assert np.abs(a["weights"][29] - a["weights"][0]).max() > 0.1
    b = tcli.repose(model, state, data, 0.5, 6.0, 1.0, seed=1,
                    savedir=str(tmp_path / "repose"), **kw)
    np.testing.assert_array_equal(a["rgbs"], b["rgbs"])
    np.testing.assert_array_equal(a["depths"], b["depths"])
    c = tcli.repose(model, state, data, 0.5, 6.0, 1.0, seed=2, **kw)
    assert np.abs(c["depths"][29] - a["depths"][29]).max() > 1.0
    np.testing.assert_array_equal(c["depths"][0], a["depths"][0])  # rest
    files = os.listdir(tmp_path / "repose")
    assert "img_059.png" in files and "weights_059.png" in files
    assert any(f.startswith("train_video.rgb") for f in files)


def test_points_render_config(capsys):
    mcfg = ttp.TemporalPointsConfig(n_points=10, n_joints=2, feat_dim=8)
    cfg = {"pcd_model_and_render": {"knn_share": 16, "knn_cand": 8,
                                    "coarse_stride": 32, "fused_agg": 1}}
    out = tcli.points_render_config(mcfg, cfg)
    assert (out.knn_share, out.knn_cand, out.coarse_stride,
            out.fused_agg) == (16, 8, 32, True)
    assert "APPROXIMATE subgroup-shared KNN active (knn_share=16" in \
        capsys.readouterr().out
    cfg["pcd_model_and_render"]["render_exact"] = True
    out = tcli.points_render_config(mcfg, cfg)
    assert out.knn_share == 1 and out.knn_cand == 8
    assert "APPROXIMATE" not in capsys.readouterr().out
    assert tcli.points_render_config(mcfg, {"pcd_model_and_render": {}}) \
        == mcfg


NEEDS_CUDA = {
    "load_temporalpoints": lambda s: tck.load_temporalpoints(s["pkl"]),
    "load_tineuvox": lambda s: tck.load_tineuvox(s["fine"]),
    "model_from_jax": lambda s: tck.model_from_jax(s["cfg"], s["tree"]),
    "tineuvox_from_jax": lambda s: tck.tineuvox_from_jax(*s["tnv"]),
    "init_model": lambda s: ttv.init_model(
        s["tnv_model"].cfg, torch.Generator().manual_seed(0)),
    "init_state": lambda s: ttp.init_state(s["cfg"], *s["state_args"]),
    "init_params": lambda s: ttp.init_params(
        s["cfg"], s["pcd"], s["joints"], s["bones"],
        np.zeros((len(s["pcd"]), 32), np.float32), np.zeros(len(s["pcd"])),
        np.zeros((len(s["pcd"]), 3)),
        {k: v for k, v in tck.params_to_jax(s["model"].state_dict()).items()
         if k in ttp.HEADS}, torch.Generator().manual_seed(0)),
    "scene_rep_reconstruction": lambda s: s["stage1"](),
    "render_image": lambda s: trender.render_image(
        lambda *a: {}, np.eye(3), np.eye(4), 2, 2),
    "render_viewpoints": lambda s: trender.render_viewpoints(
        lambda i, t: (lambda *a: {}), np.eye(4)[None], [[2, 2]],
        np.eye(3)[None], [0.0]),
    "repose": lambda s: tcli.repose(s["model"], s["state"], s["data"], 0.5,
                                    6.0, 1.0),
    "rgb_lpips": lambda s: tmetrics.rgb_lpips(*_images(0)),
    "lpips": lambda s: tlpips.lpips(*_images(0)),
}


@pytest.fixture(scope="module")
def entry_args(scene, tmp_path_factory):
    from apnerf_torch.config import nerf_default
    from apnerf_torch.data.synthetic import make_scene
    from apnerf_torch.train.stage1 import scene_rep_reconstruction
    d = tmp_path_factory.mktemp("entry")
    model, state = port_model({}, scene)
    tck.save_temporalpoints(str(d / "tp.pkl"), model, state)
    jcfg, params, tnv_model = _tiny_backbone()
    tck.save_tineuvox(str(d / "fine.pkl"), tnv_model)
    pcd = scene["pcd"]
    poses, Ks, HW = _cameras(1)
    cfg = nerf_default(N_rand=32, pg_scale=[])
    return dict(
        pkl=str(d / "tp.pkl"), fine=str(d / "fine.pkl"), cfg=model.cfg,
        tree=scene["tree"], model=model, state=state, pcd=pcd,
        joints=scene["joints"], bones=scene["bones"], tnv_model=tnv_model,
        tnv=(tnv_model.cfg.get_kwargs(),
             jax.tree_util.tree_map(np.asarray, params)),
        state_args=(pcd, scene["joints"], scene["bones"], pcd[::40],
                    pcd.min(0) - .1, pcd.max(0) + .1),
        data=dict(poses=poses, Ks=Ks, HW=HW),
        stage1=lambda: scene_rep_reconstruction(cfg, make_scene(2, 8, 8),
                                                n_iters=1))


@pytest.mark.parametrize("name", list(NEEDS_CUDA))
def test_entry_points_need_cuda_unless_asked(name, entry_args):
    """``device=None`` means the CUDA device: without one every entry point
    raises and none carries on on the CPU (the CPU is taken only for
    ``device="cpu"``, as every other test here asks)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        NEEDS_CUDA[name](entry_args)


def test_profile_render_reads_launches_from_the_trace(tmp_path):
    """profile_render counts a wrapper range's launches by the CUPTI
    correlation ids of the runtime calls made inside it: the wrapper's own
    launch counts as its kernel, a call outside the range counts nowhere,
    and a launch whose correlation id is also an operation's External id
    is reported as such, with that operation's kernels not counted."""
    import json
    from apnerf_torch.render import profile_render as pr
    x = dict(ph="X", dur=1)
    events = [
        dict(x, cat="user_annotation", name="wrapper of K3", ts=100, dur=50,
             tid=1, args={"External id": 40}),
        dict(x, cat="cpu_op", name="aten::mul", ts=10, tid=1,
             args={"External id": 7}),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", ts=11, tid=1,
             args={"correlation": 3, "External id": 7}),
        dict(x, cat="kernel", name="vectorized_elementwise_kernel", ts=20,
             tid=9, args={"correlation": 3, "External id": 7}),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", ts=120, tid=1,
             args={"correlation": 7}),
        dict(x, cat="kernel", name="void knn_topk_kernel<8, 8, false>",
             ts=130, tid=9, args={"correlation": 7}),
        dict(x, cat="cuda_runtime", name="cudaLaunchKernel", ts=120, tid=2,
             args={"correlation": 8}),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rows = pr.range_launches(str(path))
    k3 = rows["wrapper of K3"]
    assert (k3["ranges"], k3["calls"]) == (1, 1)
    assert dict(k3["kernels"]) == {"K3 knn_radius": 1}
    assert dict(k3["clashes"]) == {"aten::mul": 1}
    assert rows["wrapper of K2"]["calls"] == 0
