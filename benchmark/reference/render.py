"""The reference of a reposed frame and of a test view: the frozen plain
path.

The model is built from the scene and the seed as the program's
``train/stage2.build_model`` builds it (``reference.stage2``), the render
knobs of the configuration's ``render`` block applied as
``cli.points_render_config`` applies them. A frame is ``prepare_frame`` in
the pose, then the image in ``chunk``-ray chunks, the last one padded by
repeating the last pixel, each chunk through ``forward`` as the view
function of ``make_points_renderer`` calls it (depth on, no LBS-weight
images), every kernel its plain version. A test view (``render_views``)
is ``prepare_frame`` at the view's time, at the configuration's own render
knobs, then the same chunks with the LBS-weight images.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .frozen.data.rays import pixels_to_rays
from .frozen.models import temporal_points as tp
from .frozen.ops.marching import composite
from .stage2 import Setting  # noqa: F401  (the renders' setting too)


def render_knobs(mcfg, render: Dict):
    """``cli.points_render_config``: the render block's knobs on ``mcfg``."""
    ov = {k: int(render[k]) for k in ("knn_share", "knn_cand",
                                      "coarse_stride") if k in render}
    if "fused_agg" in render:
        ov["fused_agg"] = bool(render["fused_agg"])
    return dataclasses.replace(mcfg, **ov)


def render_frames(setting: Setting, rots: List[np.ndarray], chunk: int,
                  tf32: bool = False) -> Dict:
    """The reference's images [H, W, 3] of the poses ``rots`` from the
    scene's first camera -> ``images``, ``audits`` (each frame's chunks'
    budget audit rows), ``mcfg``. ``tf32``: the control."""
    mcfg, model, state = setting.build()
    model.cfg = render_knobs(model.cfg, setting.cfg["render"])
    data = setting.scene.data
    H, W = setting.H, setting.W
    dev = setting.device
    K = torch.as_tensor(np.asarray(data["Ks"][0], np.float32), device=dev)
    c2w = torch.as_tensor(np.asarray(data["poses"][0], np.float32),
                          device=dev)
    n = H * W
    bg = setting.bg
    images, audits = [], []
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            for rot in rots:
                frame = tp.prepare_frame(model, state, rot_params=torch.as_tensor(
                    rot, dtype=torch.float32, device=dev))
                parts, rows = [], []
                cam = torch.zeros(chunk, dtype=torch.int64, device=dev)
                for start in range(0, n, chunk):
                    pix = torch.clamp(start + torch.arange(chunk, device=dev),
                                      max=n - 1)
                    ro, rd, vd = pixels_to_rays(K[None], c2w[None], cam, pix,
                                                H, W, **setting.flips)
                    res = tp.forward(model, state, ro, rd, vd,
                                     near=setting.near, far=setting.far,
                                     bg=bg, render_depth=True, frame=frame)
                    parts.append(res["rgb_marched"])
                    rows.append([int(x) for x in res["budget_audit"].tolist()])
                img = torch.cat(parts)[:n].reshape(H, W, 3)
                images.append(img.float().cpu().numpy())
                audits.append(rows)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return {"images": images, "audits": audits, "mcfg": model.cfg}


def palette(n: int, seed: int = 0) -> np.ndarray:
    """The LBS-weight false colours of ``n`` joints: seaborn's hls palette
    where it is installed, else the same hues computed here, shuffled by
    ``seed`` (the rule of the program's render, worked out again)."""
    try:
        from seaborn import color_palette
        cols = np.array(color_palette("hls", n))
    except ImportError:
        hues = np.linspace(0, 1, n, endpoint=False)
        cols = np.stack([np.abs(hues * 6 - 3) - 1, 2 - np.abs(hues * 6 - 2),
                         2 - np.abs(hues * 6 - 4)], -1).clip(0, 1)
    rng = np.random.default_rng(seed)
    return cols[rng.permutation(n)]


def project(points: torch.Tensor, c2w: torch.Tensor, K: torch.Tensor,
            W: int, inverse_y: bool) -> np.ndarray:
    """Pixel coordinates (x, y) [N, 2] of ``points`` seen from ``c2w``,
    mirrored in x with the view's width where ``inverse_y`` is off, as the
    skeleton overlay of the weight images takes them."""
    j2 = tp.project_points(points.float(), c2w, K).cpu().numpy()
    if not inverse_y:
        j2 = np.copy(j2)
        j2[:, 0] = (W - 1) - j2[:, 0]
    return j2


def overlay_mask(H: int, W: int, joints_2d: np.ndarray, bones,
                 joint_r: float = 5.0, bone_r: float = 2.5) -> np.ndarray:
    """[H, W] True where a skeleton overlay drawn at ``joints_2d`` (discs
    of radius 3 at the joints, lines one pixel wide along the bones, each
    on integer-truncated coordinates) can lie: within ``joint_r`` of a
    joint or ``bone_r`` of a bone, with room for the truncation."""
    lim = 4 * max(H, W)
    pts = np.clip(np.nan_to_num(np.asarray(joints_2d, np.float64),
                                nan=-lim), -lim, lim)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    mask = np.zeros((H, W), bool)
    for px, py in pts:
        mask |= (x - px) ** 2 + (y - py) ** 2 <= joint_r ** 2
    for a, b in bones:
        (ax, ay), (bx, by) = pts[a], pts[b]
        dx, dy = bx - ax, by - ay
        den = dx * dx + dy * dy
        u = (np.clip(((x - ax) * dx + (y - ay) * dy) / den, 0.0, 1.0)
             if den > 0 else np.zeros_like(x))
        mask |= (x - ax - u * dx) ** 2 + (y - ay - u * dy) ** 2 <= bone_r ** 2
    return mask


def render_views(setting: Setting, poses: np.ndarray, Ks: np.ndarray,
                 times: np.ndarray, chunk: int, tf32: bool = False) -> Dict:
    """The reference's test views: view i from camera ``poses[i]``,
    ``Ks[i]`` at time ``times[i]``, at the render knobs of the
    configuration's own ``pcd_model_and_render`` (as
    ``cli.points_render_config`` applies them for ``--render_test``). A
    view is ``prepare_frame`` at its time (a one-element float32 tensor,
    as the frame graph reads it), then the image in ``chunk``-ray chunks,
    the last one padded by repeating the last pixel, each chunk through
    ``forward`` with depth and the LBS-weight images, every kernel its
    plain version. -> ``images``, ``weights`` (the LBS-weight images,
    without the skeleton overlay), ``joints_2d`` (each view's warped
    joints in its pixels, mirrored as the overlay takes them), ``bones``,
    ``audits`` (each view's chunks' budget audit rows), ``mcfg``. ``tf32``:
    the control."""
    mcfg, model, state = setting.build()
    model.cfg = render_knobs(model.cfg, setting.cfg["pcd_model_and_render"])
    dev = setting.device
    H, W = setting.H, setting.W
    n = H * W
    mask = (tp.get_weights(model, state).sum(0) > 0).cpu().numpy()
    cols = np.zeros((model.cfg.n_joints, 3), np.float32)
    if mask.any():
        cols[mask] = palette(int(mask.sum()))
    cols = torch.as_tensor(cols, device=dev)
    images, weights, joints_2d, audits = [], [], [], []
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            for c2w_np, K_np, t in zip(poses, Ks, times):
                K = torch.as_tensor(np.asarray(K_np, np.float32), device=dev)
                c2w = torch.as_tensor(np.asarray(c2w_np, np.float32),
                                      device=dev)
                frame = tp.prepare_frame(model, state, t=torch.full(
                    (1,), float(t), dtype=torch.float32, device=dev))
                rgb, wimg, rows = [], [], []
                cam = torch.zeros(chunk, dtype=torch.int64, device=dev)
                for start in range(0, n, chunk):
                    pix = torch.clamp(start + torch.arange(chunk, device=dev),
                                      max=n - 1)
                    ro, rd, vd = pixels_to_rays(K[None], c2w[None], cam, pix,
                                                H, W, **setting.flips)
                    res = tp.forward(model, state, ro, rd, vd,
                                     near=setting.near, far=setting.far,
                                     bg=setting.bg, render_depth=True,
                                     render_weights=True, frame=frame)
                    rgb.append(res["rgb_marched"])
                    col = torch.einsum("rbj,jc->rbc", res["lbs_w_per_sample"],
                                       cols)
                    wimg.append(composite(res["weights_for_render"], col,
                                          bg=setting.bg,
                                          alphainv_last=res[
                                              "alphainv_for_render"]))
                    rows.append([int(x) for x in res["budget_audit"].tolist()])
                images.append(torch.cat(rgb)[:n].reshape(H, W, 3)
                              .float().cpu().numpy())
                weights.append(torch.cat(wimg)[:n].reshape(H, W, 3)
                               .float().cpu().numpy())
                joints_2d.append(project(frame["joints_warped"], c2w, K, W,
                                         setting.flips["inverse_y"]))
                audits.append(rows)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return {"images": images, "weights": weights, "joints_2d": joints_2d,
            "bones": np.asarray(state["bones"]), "audits": audits,
            "mcfg": model.cfg}
