"""Interactive reposing, closed loop, one client.

Each frame is a new pose (``rot_params`` [J, 4]) on the ramp of
``cli.repose``: from rest toward a random target over ``ramp_frames``
frames and back, then toward the next target; targets are drawn from the
seed, ``target_scale`` times a standard normal, the root's row 0. A frame
is rendered from the scene's first camera through the view function of
``make_points_renderer`` and ``render.render_image`` in ``chunk``-ray
chunks (the frame graph and the chunk graph replays, then the readback),
at the render knobs of the configuration's ``render`` block applied by
``cli.points_render_config``. The image is on the host before the next
pose is sent.

The model is the stage-2 starting state of the scene (``train/stage2.
build_model`` with the seed), as a trained model would be loaded.

End-to-end: ``render_rays_per_s`` (every ray of every frame of the window
over the window's wall time), ``frame_ms_p95`` (the 95th percentile of
the frames' latencies: from the pose handed to the renderer to its image
on the host), ``setup_s``. ``sample_frames`` frames of the window, drawn
from the seed, are kept and, after the window, rendered again by the
reference (``reference.render``) and compared.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Iterator

import numpy as np
import torch

from ..reference import render as ref
from ..scene import make_scene, seed_of
from ..work import k6_bound, mean_counts, point_model, samples
from .common import (Window, WindowClosed, free_device, keep, peaks,
                     percentile, program_config)
from .stage2_train import shape_of


def poses(J: int, ramp: int, scale: float, seed: int) -> Iterator[np.ndarray]:
    """The frames' ``rot_params``: ramps to random targets and back."""
    rng = np.random.default_rng(seed_of(seed))
    up = np.linspace(0, 1, ramp, dtype=np.float32)[:, None, None]
    while True:
        target = rng.normal(size=(J, 4)).astype(np.float32) * scale
        target[0] = 0.0
        seq = target[None] * up
        for rot in np.concatenate([seq, seq[::-1]], 0):
            yield rot


def rgb_rmse(images, ref_images) -> float:
    """Root mean square of the colour differences over the frames."""
    diff = np.concatenate([(a - b).reshape(-1).astype(np.float64)
                           for a, b in zip(images, ref_images)])
    return float(np.sqrt(np.mean(diff ** 2)))


def render_config(cfg: Dict):
    """The program's config with the render knobs in
    ``pcd_model_and_render``."""
    pcfg = program_config(cfg)
    pcfg["pcd_model_and_render"] = type(pcfg)(
        {**pcfg["pcd_model_and_render"], **cfg["render"]})
    return pcfg


def run(ctx) -> Dict:
    from apnerf_torch import cli
    from apnerf_torch.models.tineuvox import TiNeuVoxConfig
    from apnerf_torch.render.render import render_image
    from apnerf_torch.render.renderers import make_points_renderer
    from apnerf_torch.train import stage2
    from apnerf_torch.utils.checkpoint import params_to_jax

    traffic = ctx.traffic
    scene = make_scene(ctx.config, ctx.seed, ctx.device)
    cfg = render_config(ctx.config)
    heads = params_to_jax({k: torch.from_numpy(v)
                           for k, v in scene.heads.items()})
    _, model, state = stage2.build_model(
        cfg, scene.canonical, scene.skeleton, heads,
        TiNeuVoxConfig(**scene.backbone), seed=seed_of(ctx.seed),
        max_steps=ctx.config.get("max_steps"), device=ctx.device)
    model.cfg = cli.points_render_config(model.cfg, cfg)
    data = scene.data
    H, W = (int(x) for x in data["HW"][0])
    K, c2w = data["Ks"][0], data["poses"][0]
    flips = {k: bool(ctx.config["data"][k])
             for k in ("inverse_y", "flip_x", "flip_y")}
    renderer = make_points_renderer(
        model, state, float(data["near"]), float(data["far"]),
        float(ctx.config["pcd_train_config"]["bg_col"]),
        render_weights=cli.renders_weights(model.cfg), poses=c2w[None],
        Ks=K[None])
    chunk = int(traffic["chunk"])
    win = Window(ctx, int(traffic["warmup_frames"]),
                 int(traffic["trace_frames"]))
    latencies, kept = [], []
    pick = np.random.default_rng(seed_of(ctx.seed) + 1)
    n_keep = int(traffic["sample_frames"])
    stream = poses(model.cfg.n_joints, int(traffic["ramp_frames"]),
                   float(traffic["target_scale"]), ctx.seed)
    try:
        while True:
            rot = next(stream)
            t = time.perf_counter()
            view = renderer(0, None, rot_params=rot)
            img = render_image(view, K, c2w, H, W, chunk=chunk,
                               device=ctx.device, **flips)
            latencies.append(time.perf_counter() - t)
            # a uniform sample of the window's frames drawn from the seed
            i = win.count - win.warmup
            if i >= 0:
                keep(kept, i, n_keep, pick,
                     lambda: (rot, img["rgb_marched"]))
            win.tick()
    except WindowClosed:
        pass
    del renderer, model, state
    peak = free_device()

    setting = ref.Setting(ctx.config, scene, seed_of(ctx.seed), ctx.device)
    out_ref = ref.render_frames(setting, [rot for rot, _ in kept], chunk)
    rmse = rgb_rmse([im for _, im in kept], out_ref["images"])
    finite = all(np.isfinite(im).all() for _, im in kept)
    lat = [1e3 * x for x in latencies[win.warmup:]]
    print(f"repose: {len(lat)} frames, frame ms median "
          f"{percentile(lat, 50)!r}, p95 {percentile(lat, 95)!r}",
          file=sys.stderr)
    out = {"attempted": win.units, "failed": 0 if finite else 1,
           "checks": [("rgb_rmse", rmse, ctx.limits["rgb_rmse"])],
           "memory_peak_bytes": peak,
           "e2e": {"render_rays_per_s": win.units * H * W / win.seconds,
                   "frame_ms_p95": percentile(lat, 95),
                   "setup_s": win.setup_s}}
    if ctx.trace:
        mcfg = out_ref["mcfg"]
        counts = mean_counts([samples(a) for a in out_ref["audits"]])
        shape = shape_of(mcfg)
        out["reading"] = {
            "trace": win.reading(), "unit_s": win.seconds / win.units,
            "peaks": peaks(),
            "work": {"ops": point_model(shape, counts, train=False,
                                        at_time=False),
                     "k6": k6_bound(shape, counts, -(-H * W // chunk),
                                    peaks()),
                     "counts": counts}}
    if ctx.extra.get("controls"):
        # the control: the reference in TF32 put in the program's place
        ctl = ref.render_frames(setting, [rot for rot, _ in kept], chunk,
                                tf32=True)
        out["controls"] = {"tf32": {"rgb_rmse": rgb_rmse(
            ctl["images"], out_ref["images"])}}
    return out

