"""The test-view render, closed loop, one caller: ``render_viewpoints``
over a scene's held-out views, as ``cli.py --render_test --eval_psnr``
calls it.

The traffic file gives ``n_views`` test views, drawn from the seed on the
training cameras' sphere (the configuration's ``cameras`` block: its
radius, elevations and focal length, any azimuth), view k at time k /
(n_views - 1); their ground-truth images are rendered by the scene maker's
volume render of the figure at that time (``scene.render_image``). One
pass is one ``render_viewpoints`` call over the views in ``chunk``-ray
chunks, with the outputs of ``extra_keys`` (the LBS-weight images, the
skeleton overlaid), PSNR and SSIM against the ground truth (``eval_*``),
and no files written: view i + 1 is queued before view i is read back.
Passes run back to back. The renderer is ``make_points_renderer`` over
the stage-2 starting state of the scene (``train/stage2.build_model`` with
the seed), at the render knobs of the configuration's own
``pcd_model_and_render`` applied by ``cli.points_render_config``, with
the test views' cameras for the overlay; it is built once, as the command
line builds it.

Set-up ends with one ``render_viewpoints`` call over the first
``warmup_views`` views (the renderer's first view warms up eagerly and
captures, the next replays, as every view after it does). A unit is a
view; the window holds whole passes, and, traced, ``trace_passes``. A
view is done when ``render_viewpoints`` reads its ground truth, right
after its images are on the host. The scene is made without the
training images, which this cell never reads.

End-to-end: ``render_rays_per_s`` (every ray of every view completed in
the window over the window's wall time), ``frame_ms_p95`` (the 95th
percentile of the views' intervals: each view from the one before it in
its call, the first from the call's start), ``setup_s``.
``sample_views`` views of the window, drawn from the seed, are kept with
their scores and, after the window, rendered again by the reference
(``reference.render.render_views``) and scored by it against the same
ground truth (``reference.scores``). Compared: the colours everywhere,
the LBS-weight images where no skeleton overlay can lie, and the PSNR
and SSIM that the program reported beside the reference's.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..reference import render as ref
from ..reference import scores
from ..scene import make_scene, pose_spherical, render_image, seed_of
from ..trace import events, reduce
from ..work import knn_bound, mean_counts, point_model, samples
from .common import (Window, WindowClosed, free_device, keep, peaks,
                     percentile, program_config)
from .repose import rgb_rmse
from .stage2_train import shape_of


@dataclass
class Views:
    """The test views: cameras, times and ground-truth images (numpy)."""
    poses: np.ndarray     # [N, 4, 4]
    Ks: np.ndarray        # [N, 3, 3]
    HW: np.ndarray        # [N, 2]
    times: np.ndarray     # [N]
    images: List[np.ndarray]


def test_views(cfg: Dict, scene, n: int, seed: int, device) -> Views:
    """``n`` views on the sphere of the configuration's cameras, from their
    own stream of the seed (the scene's draws are left as they are), view k
    at time k / (n - 1), and the figure's images there."""
    cam = cfg["cameras"]
    rng = np.random.default_rng([seed_of(seed), 2])
    H = W = int(cam["size"])
    focal = float(cam["focal"])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    az = rng.uniform(0.0, 360.0, n)
    el = rng.uniform(*cam["elevation"], n)
    poses = np.stack([pose_spherical(a, e, float(cam["radius"]))
                      for a, e in zip(az, el)]).astype(np.float32)
    times = (np.arange(n) / max(n - 1, 1)).astype(np.float32)
    bg = float(cfg["pcd_train_config"]["bg_col"])
    fig = scene.figure
    images = []
    for c2w, t in zip(poses, times):
        rgb, acc = render_image(fig, fig.joints_at(float(t)), K, c2w, H, W,
                                float(cam["near"]), float(cam["far"]),
                                bool(cfg["data"]["inverse_y"]), device)
        img = (rgb + bg * (1.0 - acc[..., None])).clamp(0, 1)
        if cam["image_dtype"] == "uint8":
            images.append((img * 255).round().to(torch.uint8).cpu().numpy())
        else:
            images.append(img.float().cpu().numpy())
    return Views(poses, np.repeat(K[None], n, 0),
                 np.array([[H, W]] * n), times, images)


class Clock:
    """The ground truth handed to ``render_viewpoints``: reading image i
    marks view i done (its images are on the host then)."""

    def __init__(self, images: List[np.ndarray]):
        self.images = images
        self.start = 0.0
        self.done: List[float] = []

    def begin(self) -> None:
        self.start = time.perf_counter()
        self.done = []

    def __getitem__(self, i: int) -> np.ndarray:
        self.done.append(time.perf_counter())
        return self.images[i]

    def intervals(self) -> List[float]:
        """Each view's interval in ms since the one before it in the call
        (the first: since the call's start)."""
        marks = [self.start] + self.done
        return [1e3 * (b - a) for a, b in zip(marks, marks[1:])]


def weights_rmse(images, ref_images, masks) -> float:
    """Root mean square of the LBS-weight images' differences over the
    pixels outside each view's overlay mask."""
    diff = np.concatenate([(a - b)[~m].reshape(-1).astype(np.float64)
                           for a, b, m in zip(images, ref_images, masks)])
    return float(np.sqrt(np.mean(diff ** 2)))


def score_gap(got: List[float], want: List[float]) -> float:
    """The widest gap between two lists of scores."""
    return float(max(abs(a - b) for a, b in zip(got, want)))


def scored(images, gts, dtype=np.float64):
    """The reference's (PSNR, SSIM) lists of ``images`` against ``gts``."""
    return ([scores.psnr(im, gt) for im, gt in zip(images, gts)],
            [scores.ssim(im, gt, dtype) for im, gt in zip(images, gts)])


def run(ctx) -> Dict:
    from apnerf_torch import cli, kernels
    from apnerf_torch.models.tineuvox import TiNeuVoxConfig
    from apnerf_torch.render.render import render_viewpoints
    from apnerf_torch.render.renderers import make_points_renderer
    from apnerf_torch.train import stage2
    from apnerf_torch.utils.checkpoint import params_to_jax

    traffic = ctx.traffic
    scene = make_scene(ctx.config, ctx.seed, ctx.device, images=False)
    n = int(traffic["n_views"])
    views = test_views(ctx.config, scene, n, ctx.seed, ctx.device)
    cfg = program_config(ctx.config)
    heads = params_to_jax({k: torch.from_numpy(v)
                           for k, v in scene.heads.items()})
    _, model, state = stage2.build_model(
        cfg, scene.canonical, scene.skeleton, heads,
        TiNeuVoxConfig(**scene.backbone), seed=seed_of(ctx.seed),
        max_steps=ctx.config.get("max_steps"), device=ctx.device)
    model.cfg = cli.points_render_config(model.cfg, cfg)
    data = scene.data
    bg = float(ctx.config["pcd_train_config"]["bg_col"])
    renderer = make_points_renderer(
        model, state, float(data["near"]), float(data["far"]), bg,
        render_weights=cli.renders_weights(model.cfg), poses=views.poses,
        Ks=views.Ks)
    flips = {k: bool(ctx.config["data"][k])
             for k in ("inverse_y", "flip_x", "flip_y")}
    clock = Clock(views.images)
    chunk = int(traffic["chunk"])
    # the warm-up call is the window's one unit of set-up
    win = Window(ctx, 1, int(traffic["trace_passes"]))
    intervals, kept, psnrs = [], [], []
    n_failed = 0
    pick = np.random.default_rng(seed_of(ctx.seed) + 1)
    n_keep = int(traffic["sample_views"])
    m = int(traffic["warmup_views"])
    try:
        while True:
            clock.begin()
            out = render_viewpoints(
                renderer, views.poses[:m], views.HW[:m], views.Ks[:m],
                views.times[:m], gt_imgs=clock,
                eval_psnr=bool(traffic["eval_psnr"]),
                eval_ssim=bool(traffic["eval_ssim"]), chunk=chunk,
                verbose=False, extra_keys=tuple(traffic["extra_keys"]),
                device=ctx.device, **flips)
            if win.t_open is not None:
                intervals += clock.intervals()
                psnrs += out["psnrs"]
                for k in range(n):
                    n_failed += int(not all(
                        np.isfinite(out[key][k]).all()
                        for key in ("rgbs", "weights") if len(out[key])))
                    # a uniform sample of the window's views drawn from the
                    # seed, with the scores the program gave them
                    keep(kept, (win.count - win.warmup) * n + k, n_keep, pick,
                         lambda: (k, np.array(out["rgbs"][k]),
                                  np.array(out["weights"][k]),
                                  out["psnrs"][k], out["ssims"][k]))
            else:
                kernels.reset_launches()
                m = n
            del out
            win.tick()
    except WindowClosed:
        pass
    n_done = win.units * n
    launches = {k: v / n_done for k, v in kernels.LAUNCHES.items() if v}
    del renderer, model, state
    peak = free_device()

    setting = ref.Setting(ctx.config, scene, seed_of(ctx.seed), ctx.device)
    idx = [k for k, *_ in kept]
    gts = [views.images[k] for k in idx]
    out_ref = ref.render_views(setting, views.poses[idx], views.Ks[idx],
                               views.times[idx], chunk)
    ref_psnr, ref_ssim = scored(out_ref["images"], gts)
    H, W = (int(x) for x in views.HW[0])
    masks = [ref.overlay_mask(H, W, j2, out_ref["bones"])
             for j2 in out_ref["joints_2d"]]
    lim = ctx.limits
    checks = [("rgb_rmse", rgb_rmse([v[1] for v in kept], out_ref["images"]),
               lim["rgb_rmse"]),
              ("weights_rmse", weights_rmse([v[2] for v in kept],
                                            out_ref["weights"], masks),
               lim["weights_rmse"]),
              ("psnr_gap", score_gap([v[3] for v in kept], ref_psnr),
               lim["psnr_gap"]),
              ("ssim_gap", score_gap([v[4] for v in kept], ref_ssim),
               lim["ssim_gap"])]
    first = intervals[:n]
    print(f"render_test: {n_done} views in {win.units} passes, interval ms "
          f"median {percentile(intervals, 50)!r}, p95 "
          f"{percentile(intervals, 95)!r}, the first pass's largest "
          f"{max(first) if first else float('nan')!r}; mean PSNR "
          f"{float(np.mean(psnrs)) if psnrs else float('nan')!r}; kept "
          f"views {idx}, reference PSNR {ref_psnr}, SSIM {ref_ssim}; overlay "
          f"mask {float(np.mean(masks))!r} of the pixels; launches a view "
          f"{launches}", file=sys.stderr)
    result = {"attempted": n_done, "failed": n_failed, "checks": checks,
              "memory_peak_bytes": peak,
              "e2e": {"render_rays_per_s": n_done * H * W / win.seconds,
                      "frame_ms_p95": percentile(intervals, 95),
                      "setup_s": win.setup_s}}
    if ctx.trace:
        counts = mean_counts([samples(a) for a in out_ref["audits"]])
        mcfg = out_ref["mcfg"]
        shape = shape_of(mcfg)
        chunks = -(-H * W // chunk)
        dev, host = events(win.prof)
        result["reading"] = {
            "trace": reduce(dev, host, win.seconds, n_done),
            "unit_s": win.seconds / n_done, "peaks": peaks(),
            "work": {"ops": point_model(shape, counts, train=False,
                                        at_time=True),
                     "knn": knn_bound(mcfg.neighbours, counts, chunks,
                                      mcfg.n_points, peaks()),
                     "counts": counts}}
    if ctx.extra.get("controls"):
        # the control: the reference in TF32 put in the program's place,
        # scored by the reference; beside it, the reference's SSIM in
        # float32, the next lower precision of the score
        ctl = ref.render_views(setting, views.poses[idx], views.Ks[idx],
                               views.times[idx], chunk, tf32=True)
        ctl_psnr, ctl_ssim = scored(ctl["images"], gts)
        result["controls"] = {
            "tf32": {"rgb_rmse": rgb_rmse(ctl["images"], out_ref["images"]),
                     "weights_rmse": weights_rmse(ctl["weights"],
                                                  out_ref["weights"], masks),
                     "psnr_gap": score_gap(ctl_psnr, ref_psnr),
                     "ssim_gap": score_gap(ctl_ssim, ref_ssim)},
            "ssim_f32": {"ssim_gap": score_gap(
                scored(out_ref["images"], gts, np.float32)[1], ref_ssim)}}
    return result
