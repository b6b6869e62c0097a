"""The synthetic articulated arm scene (port of
``apnerf/data/synthetic.py``).

Two capsules joined at a hinge whose angle follows time, rendered
analytically with numpy volume marching. ``generate_scene`` writes it to
disk as a D-NeRF dataset (``transforms_*.json`` and RGBA PNGs) for
``data.load_data``; ``make_scene`` returns the ``data_dict`` that
``load_data`` builds for such a scene on a white background, without
writing image files.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils.png import write_png
from .dnerf import pose_spherical

SEG_COLORS = np.array([[0.85, 0.3, 0.25], [0.25, 0.45, 0.85]])
SEG_RADIUS = 0.16
DENSITY = 60.0
NEAR, FAR = 2.0, 6.0          # the D-NeRF near / far planes


def _seg_dist(p, a, b):
    """Distance from points p [N, 3] to the segment (a, b)."""
    s = b - a
    t = np.clip(((p - a) @ s) / (s @ s), 0.0, 1.0)
    return np.linalg.norm(p - (a + t[:, None] * s), axis=-1)


def arm_segments(t: float):
    """The two bones; the hinge angle is 1.2 t radians."""
    j0 = np.array([-0.5, 0.0, 0.0])
    j1 = np.array([0.1, 0.0, 0.0])
    theta = t * 1.2
    j2 = j1 + 0.6 * np.array([np.cos(theta), np.sin(theta), 0.0])
    return [(j0, j1), (j1, j2)]


def density_and_color(pts, t):
    """Soft-edged capsules: (sigma [N], rgb [N, 3])."""
    sigmas = np.zeros(len(pts))
    colors = np.zeros((len(pts), 3))
    total_w = np.zeros(len(pts)) + 1e-9
    for k, (a, b) in enumerate(arm_segments(t)):
        inside = np.clip((SEG_RADIUS - _seg_dist(pts, a, b)) / 0.03, 0.0, 1.0)
        sigmas = np.maximum(sigmas, DENSITY * inside)
        colors += inside[:, None] * SEG_COLORS[k]
        total_w += inside
    return sigmas, colors / total_w[:, None]


def render_image(c2w, H, W, focal, t, n_steps=96, near=NEAR, far=FAR):
    """RGBA [H, W, 4] in [0, 1] of the scene at time ``t``."""
    i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    dirs = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                     -np.ones_like(i)], -1)
    rays_d = (dirs @ c2w[:3, :3].T).reshape(-1, 3)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    # only rays passing within 1 of the origin can meet a capsule (every
    # capsule point lies within 0.86 of it): the others stay exactly 0
    d_hat = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    o_dot = (rays_o * d_hat).sum(-1)
    hit = ((rays_o * rays_o).sum(-1) - o_dot * o_dot) < 1.0
    ro, rd = rays_o[hit], rays_d[hit]
    ts = np.linspace(near, far, n_steps)
    dt = ts[1] - ts[0]
    T = np.ones(len(ro))
    rgb = np.zeros((len(ro), 3))
    acc = np.zeros(len(ro))
    for tv in ts:
        sigma, col = density_and_color(ro + rd * tv, t)
        alpha = 1.0 - np.exp(-sigma * dt)
        w = T * alpha
        rgb += w[:, None] * col
        acc += w
        T = T * (1.0 - alpha)
    rgba = np.zeros((len(rays_o), 4))
    rgba[hit] = np.concatenate([rgb, acc[:, None]], -1)
    return np.clip(rgba.reshape(H, W, 4), 0, 1)


def generate_scene(out_dir, n_times=6, n_test=2, H=64, W=64,
                   camera_angle_x=0.8, radius=4.0, overwrite=False):
    """Write a D-NeRF-format dataset to ``out_dir``: ``n_times`` training
    views at times evenly over [0, 1], ``n_test`` test views and one val
    view, cameras around the scene at 25 degrees elevation; returns the
    directory. An existing dataset is kept unless ``overwrite``."""
    if os.path.exists(os.path.join(out_dir, "transforms_train.json")) \
            and not overwrite:
        return out_dir
    for split in ("train", "test", "val"):
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    def write_split(split, n, angle0):
        frames = []
        for k in range(n):
            t = k / max(n - 1, 1)
            c2w = pose_spherical(angle0 + 360.0 * k / n, -25.0, radius)
            img = render_image(np.asarray(c2w), H, W, focal, t)
            fp = f"{split}/r_{k:03d}"
            write_png(os.path.join(out_dir, fp + ".png"),
                      (img * 255).astype(np.uint8))
            frames.append({"file_path": fp, "time": t,
                           "transform_matrix": np.asarray(c2w).tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)

    write_split("train", n_times, 30.0)
    write_split("test", n_test, 110.0)
    write_split("val", 1, 200.0)
    return out_dir


def make_scene(n_views: int, H: int, W: int, seed: int = 0,
               camera_angle_x: float = 0.8, radius: float = 4.0):
    """A stage-1 ``data_dict`` of ``n_views`` training views at times
    evenly spread over [0, 1], cameras evenly around the scene at 25
    degrees elevation from an azimuth drawn from ``seed``; images
    composited on white, masks from the opacity."""
    rng = np.random.default_rng(seed)
    angle0 = float(rng.uniform(0.0, 360.0))
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    poses, times, rgba = [], [], []
    for k in range(n_views):
        t = k / max(n_views - 1, 1)
        c2w = pose_spherical(angle0 + 360.0 * k / n_views, -25.0, radius)
        rgba.append(render_image(np.asarray(c2w, np.float64), H, W, focal, t))
        poses.append(c2w)
        times.append(t)
    rgba = np.stack(rgba).astype(np.float32)
    images = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    empty = np.zeros(0, np.int64)
    return dict(
        hwf=[H, W, focal], HW=np.array([[H, W]] * n_views),
        Ks=np.repeat(K[None], n_views, 0), near=NEAR, far=FAR,
        i_train=np.arange(n_views, dtype=np.int64), i_val=empty,
        i_test=empty, poses=np.stack(poses).astype(np.float32),
        images=images, times=np.asarray(times, np.float32),
        img_to_cam=np.arange(n_views), masks=rgba[..., 3:4],
        irregular_shape=False)
