"""The one-dispatch frame of the port (``renderers.make_image_scan``, the
frame graph of ``prepare_frame``, ``render_image``'s image path and
``render_viewpoints``' overlapped readback) on the CPU, where the bodies
that a CUDA device captures as graphs run eagerly.

- The image path against the chunk loop of the same renderer (its
  ``image_fn`` removed), exact, shared, fused (kernel K6's plain version)
  and the backbone: bit-equal.
- The image path against the JAX package's ``make_image_scan`` path:
  rgb, depth / max_steps and LBS-weight images at >= 40 dB, as
  test_torch_render.py holds ``render_viewpoints``; the backbone at 1e-5.
- One renderer's image function at three times and two poses against a
  fresh renderer's: bit-equal (a value baked in where it should be read
  from a static input would show).
- ``render_viewpoints`` with its readback overlapped and without: the same
  arrays, PNGs and ``results.txt``.
- A replay counts the launches its capture counted (a fake graph).
- The graphed bodies, once warmed up, make no host tensor and read
  nothing back (what a CUDA graph's capture refuses).
"""
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package below runs on it)

from apnerf.render import render as jrender, renderers as jrenderers
from apnerf.models import temporal_points as jtp
from apnerf_torch import kernels
from apnerf_torch.render import render as trender, renderers as trenderers
from test_torch_render import _tiny_backbone
from test_torch_temporal_points import (BASE, MODES, jax_state,  # noqa
                                        port_model, psnr, rot_params, scene)

H, W = 12, 16
CHUNK = 80          # 192 pixels: two full chunks and a ragged third
POINT_MODES = {
    "exact": (MODES["exact"], True),
    "shared": (MODES["shared8_cand8"], True),
    # K6 (its plain version here) runs only without the LBS-weight images
    "fused": (dict(MODES["shared16_cand12"], fused_agg=True), False),
}


def _camera(dx=0.0):
    K = np.array([[140, 0, W / 2], [0, 140, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.0
    c2w[0, 3] = dx
    return K, c2w


def _loop_only(fn):
    """The chunk loop of ``fn`` (its image function removed, as
    tests/test_renderers.py does in the JAX package)."""
    def plain(ro, rd, vd):
        return fn(ro, rd, vd)
    if hasattr(fn, "finish"):
        plain.finish = fn.finish
    return plain


def _points_renderer(mode, scene, **kw):
    over, weights = POINT_MODES[mode]
    model, state = port_model(over, scene)
    K, c2w = _camera()
    return trenderers.make_points_renderer(
        model, state, 0.5, 6.0, 1.0, render_weights=weights,
        poses=c2w[None], Ks=K[None], **kw)


def _image(fn, keys=("weights", "acc"), dx=0.0):
    K, c2w = _camera(dx)
    return trender.render_image(fn, K, c2w, H, W, chunk=CHUNK,
                                extra_keys=keys, device="cpu")


@pytest.mark.parametrize("mode", list(POINT_MODES))
def test_image_path_matches_chunk_loop(mode, scene):
    """Every output of the image path equal to the chunk loop's, the
    joints of the overlay included, at a time and in a pose."""
    view = _points_renderer(mode, scene)
    for t, rot in ((0.3, None), (None, rot_params())):
        fn = view(0, t, rot_params=rot)
        assert hasattr(fn, "image_fn")
        got, want = _image(fn), _image(_loop_only(fn))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["rgb_marched"].shape == (H, W, 3)
        assert (got["acc"] > 0.5).mean() > 0.3
    assert set(want) >= {"joints_2d", "bones"}
    assert ("weights" in want) == POINT_MODES[mode][1]


def test_backbone_image_path_matches_chunk_loop():
    _, _, model = _tiny_backbone()
    fn = trenderers.make_backbone_renderer(model, 0.5, 0.05, 1.53, 1.0)(0,
                                                                        0.4)
    K = np.array([[30, 0, W / 2], [0, 30, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 0.9
    got = trender.render_image(fn, K, c2w, H, W, chunk=50, device="cpu")
    want = trender.render_image(_loop_only(fn), K, c2w, H, W,
                                chunk=50, device="cpu")
    for k in ("rgb_marched", "depth"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.ptp(got["rgb_marched"]) > 0.01


@pytest.mark.parametrize("mode", ["exact", "shared"])
def test_image_path_vs_jax(mode, scene):
    """One view in a pose through both packages' image functions: rgb,
    depth / max_steps and the LBS-weight image at >= 40 dB."""
    over, _ = POINT_MODES[mode]
    K, c2w = _camera()
    jcfg = jtp.TemporalPointsConfig(**{**BASE, **over})
    jfn = jrenderers.make_points_renderer(
        scene["params"], jcfg, jax_state(jcfg, scene), 0.5, 6.0, 1.0)(
            0, None, rot_params=rot_params())
    tfn = _points_renderer(mode, scene)(0, None, rot_params=rot_params())
    assert hasattr(jfn, "image_fn") and hasattr(tfn, "image_fn")
    want = jrender.render_image(jfn, K, c2w, H, W, chunk=CHUNK,
                                extra_keys=("weights",))
    got = _image(tfn, keys=("weights",))
    assert (got["rgb_marched"] < 0.99).any(-1).mean() > 0.3
    assert psnr(got["rgb_marched"], want["rgb_marched"]) >= 40.0
    steps = BASE["max_steps"]
    assert psnr(got["depth"] / steps, want["depth"] / steps) >= 40.0
    assert psnr(got["weights"], want["weights"]) >= 40.0


def test_backbone_image_path_vs_jax():
    jcfg, params, model = _tiny_backbone()
    K = np.array([[30, 0, W / 2], [0, 30, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 0.9
    jfn = jrenderers.make_backbone_renderer(params, jcfg, 0.5, 0.05, 1.53,
                                            1.0)(0, 0.7)
    tfn = trenderers.make_backbone_renderer(model, 0.5, 0.05, 1.53,
                                            1.0)(0, 0.7)
    want = jrender.render_image(jfn, K, c2w, H, W, chunk=50)
    got = trender.render_image(tfn, K, c2w, H, W, chunk=50, device="cpu")
    np.testing.assert_allclose(got["rgb_marched"], want["rgb_marched"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=0,
                               atol=1e-4)


def test_no_stale_inputs(scene):
    """One renderer's image function at t = 0, 0.5, 1, at two poses and
    from a second camera, each equal to a fresh renderer's image."""
    view = _points_renderer("shared", scene)
    rot2 = rot_params() * -0.5
    cases = [(0.0, None, 0.0), (0.5, None, 0.0), (1.0, None, 0.0),
             (None, rot_params(), 0.0), (None, rot2, 0.0),
             (1.0, None, 0.05)]
    seen = []
    for t, rot, dx in cases:
        got = _image(view(0, t, rot_params=rot), dx=dx)
        fresh = _points_renderer("shared", scene)
        want = _image(fresh(0, t, rot_params=rot), dx=dx)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        seen.append(got["rgb_marched"])
    # the cases differ from each other
    for a, b in zip(seen, seen[1:]):
        assert np.abs(a - b).max() > 1e-3
    _, _, model = _tiny_backbone()
    back = trenderers.make_backbone_renderer(model, 0.5, 0.05, 1.53, 1.0)
    K = np.array([[30, 0, W / 2], [0, 30, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 0.9
    for t in (0.0, 0.5, 1.0):
        got = trender.render_image(back(0, t), K, c2w, H, W, chunk=50,
                                   device="cpu")
        want = trender.render_image(
            trenderers.make_backbone_renderer(model, 0.5, 0.05, 1.53,
                                              1.0)(0, t),
            K, c2w, H, W, chunk=50, device="cpu")
        np.testing.assert_array_equal(got["rgb_marched"],
                                      want["rgb_marched"])


def test_overlapped_readback(scene, tmp_path, monkeypatch):
    """``render_viewpoints`` queues view i + 1 before it reads view i back;
    the same run with every view read back at once gives the same arrays,
    PNGs and results.txt."""
    n = 3
    poses = np.repeat(_camera()[1][None], n, 0)
    poses[:, 0, 3] = np.linspace(-0.03, 0.03, n)
    Ks = np.repeat(_camera()[0][None], n, 0)
    HW = np.array([[H, W]] * n)
    times = np.linspace(0, 1, n).astype(np.float32)
    gts = np.random.default_rng(4).random((n, H, W, 3)).astype(np.float32)
    kw = dict(gt_imgs=gts, eval_psnr=True, eval_ssim=True, chunk=CHUNK,
              verbose=False, device="cpu")

    def run(savedir):
        view = _points_renderer("shared", scene)
        return trender.render_viewpoints(view, poses, HW, Ks, times,
                                         savedir=str(savedir), **kw)

    got = run(tmp_path / "overlapped")
    order = []
    render_image = trender.render_image

    def at_once(*args, async_out=False, **kwargs):
        res = render_image(*args, **kwargs)
        order.append(len(order))
        return lambda: res

    monkeypatch.setattr(trender, "render_image", at_once)
    want = run(tmp_path / "at_once")
    assert order == list(range(n))
    for k in ("rgbs", "depths", "weights", "psnrs", "ssims"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["weights"].shape == (n, H, W, 3)
    files = sorted(os.listdir(tmp_path / "at_once"))
    assert files == sorted(os.listdir(tmp_path / "overlapped"))
    assert "results.txt" in files and "weights_002.png" in files
    for f in files:
        assert (tmp_path / "at_once" / f).read_bytes() == \
            (tmp_path / "overlapped" / f).read_bytes(), f


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_counts_the_captured_launches():
    """What the wrappers count while a graph is captured is taken back
    (nothing ran) and added at every replay."""
    kernels.reset_launches()
    kernels.LAUNCHES["knn_radius"] = 5
    with kernels.counted_capture() as launches:
        kernels.LAUNCHES["knn_count"] += 2
        kernels.LAUNCHES["knn_radius"] += 1
        kernels.LAUNCHES["featmlp"] += 1
    assert launches == dict.fromkeys(kernels.LAUNCHES, 0) | dict(
        knn_count=2, knn_radius=1, featmlp=1)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0) | dict(
        knn_radius=5)
    graph = FakeGraph()
    replay = kernels.GraphReplay(graph, launches)
    for _ in range(3):
        replay.replay()
    assert graph.replays == 3
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0) | dict(
        knn_count=6, knn_radius=8, featmlp=3)
    kernels.reset_launches()


HOST_CALLS = [(torch, "tensor"), (torch, "as_tensor"),
              (torch.Tensor, "item"), (torch.Tensor, "tolist"),
              (torch.Tensor, "cpu"), (torch.Tensor, "numpy"),
              (torch.Tensor, "__bool__"), (torch.Tensor, "__float__"),
              (torch.Tensor, "__int__")]


def _recorded(monkeypatch, calls):
    for owner, name in HOST_CALLS:
        orig = getattr(owner, name)

        def rec(*args, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*args, **kw)
        monkeypatch.setattr(owner, name, rec)


@pytest.mark.parametrize("mode", list(POINT_MODES) + ["backbone"])
def test_graphed_bodies_make_no_host_copy(mode, scene, monkeypatch):
    """After one image (the warm-up: builds and caches fill), the frame
    body and the chunk-loop body run again while calls that make a host
    tensor or read a tensor back are recorded: there is none, so a capture
    on the card meets no host-to-device copy and no sync."""
    if mode == "backbone":
        _, _, model = _tiny_backbone()
        view = trenderers.make_backbone_renderer(model, 0.5, 0.05, 1.53, 1.0)
        view(0, 0.4).image_fn(*_camera(), H, W, 50)
        extra = {"scan": torch.full((1,), 0.4)}
    else:
        view = _points_renderer(mode, scene)
        fn = view(0, None, rot_params=rot_params())
        fn.image_fn(*_camera(), H, W, CHUNK)
        extra = {}
    calls, order = [], []
    bodies = view.graphs.calls
    assert {k[0] for k in bodies} == ({"scan"} if mode == "backbone"
                                      else {"frame", "scan"})
    _recorded(monkeypatch, calls)
    with torch.inference_mode():
        for key, call in sorted(bodies.items(), key=lambda kv: kv[0][0]):
            order.append(key[0])
            if key[0] == "frame":
                extra["scan"] = call.body()
            else:
                out = call.body(extra["scan"])
    monkeypatch.undo()
    assert order[-1] == "scan" and calls == []
    assert out["rgb_marched"].shape == (-(-H * W // (50 if mode == "backbone"
                                                    else CHUNK)),
                                        50 if mode == "backbone" else CHUNK,
                                        3)


def test_frame_graph_reads_its_static_input(scene):
    """The frame body reads the time from its static input: refilled, the
    next call warps the cloud elsewhere; the pose graph is its own."""
    view = _points_renderer("exact", scene)
    K, c2w = _camera()
    view(0, 0.0).image_fn(K, c2w, H, W, CHUNK)
    view(0, None, rot_params=rot_params()).image_fn(K, c2w, H, W, CHUNK)
    frames = {k: c for k, c in view.graphs.calls.items() if k[0] == "frame"}
    assert sorted(frames, key=str) == [("frame", (6, 4)), ("frame", None)]
    call = frames[("frame", None)]
    with torch.inference_mode():
        call.inputs[0].fill_(0.0)
        a = call.body()["xyz"].clone()
        call.inputs[0].fill_(1.0)
        b = call.body()["xyz"]
    assert (a - b).abs().max() > 1e-4
    model, state = port_model(POINT_MODES["exact"][0], scene)
    with torch.no_grad():
        want = trenderers.tp.prepare_frame(model, state, t=1.0)["xyz"]
    assert torch.equal(b, want)


def test_profile_render_counts_host_launch_calls():
    """profile_render's host launch calls: kernel launches
    (``cudaLaunchKernel``, ``cuLaunchKernel``) against graph launches,
    from the profile's rows."""
    from types import SimpleNamespace as Row
    from apnerf_torch.render.profile_render import host_launch_calls

    class Prof:
        def key_averages(self):
            return [Row(key="cudaLaunchKernel", count=7000),
                    Row(key="cuLaunchKernel", count=3),
                    Row(key="cudaGraphLaunch", count=2),
                    Row(key="cudaMemcpyAsync", count=5),
                    Row(key="aten::mul", count=9)]
    assert host_launch_calls(Prof()) == {"kernel": 7003, "graph": 2}
