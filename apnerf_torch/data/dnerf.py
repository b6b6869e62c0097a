"""D-NeRF (synthetic Blender) dataset loader (port of
``apnerf/data/dnerf.py``; the reference lib/load_dnerf.py:70-157).

``transforms_{train,val,test}.json`` and RGBA PNGs (read with the port's
``utils.png``); the masks are the alpha channel; a frame's time comes
from its json entry (else linear over the split); the render path is a
spherical orbit unless ``transforms_render.json`` gives one. ``half_res``
halves the images by the 2 x 2 mean (``utils.image.area_resize``) and
needs even sizes.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils.image import area_resize
from ..utils.png import read_png


def pose_spherical(theta_deg, phi_deg, radius) -> np.ndarray:
    """Camera-to-world [4, 4] on a sphere, OpenGL convention (reference
    lib/load_dnerf.py:10-67)."""
    theta, phi = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rp = np.eye(4, dtype=np.float32)
    rp[1, 1] = np.cos(phi); rp[1, 2] = -np.sin(phi)
    rp[2, 1] = np.sin(phi); rp[2, 2] = np.cos(phi)
    rt = np.eye(4, dtype=np.float32)
    rt[0, 0] = np.cos(theta); rt[0, 2] = -np.sin(theta)
    rt[2, 0] = np.sin(theta); rt[2, 2] = np.cos(theta)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    np.float32)
    return flip @ rt @ rp @ trans


def load_dnerf_data(basedir, half_res=True, testskip=1, load_test_val=False):
    """(images [N, H, W, 4] float32 in [0, 1], poses, times, render_poses,
    render_times, [H, W, focal], i_split, img_to_cam, masks [N, H, W, 1]):
    the train split, or with ``load_test_val`` the val and test splits
    (``i_split`` indexes that concatenation)."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, all_times, counts = [], [], [], [0]
    for s in splits:
        frames = metas[s]["frames"][::testskip]
        imgs, poses, times = [], [], []
        for t, frame in enumerate(frames):
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(read_png(fname))
            poses.append(np.array(frame["transform_matrix"]))
            times.append(frame.get("time", float(t) / max(len(frames) - 1, 1)))
        if times[0] != 0:
            raise ValueError(f"{s} split: time must start at 0, got "
                             f"{times[0]}")
        all_imgs.append((np.array(imgs) / 255.0).astype(np.float32))
        all_poses.append(np.array(poses).astype(np.float32))
        all_times.append(np.array(times).astype(np.float32))
        counts.append(counts[-1] + len(frames))

    if not load_test_val:
        i_split = [np.arange(counts[0], counts[1]), [], []]
        imgs, poses, times = all_imgs[0], all_poses[0], all_times[0]
    else:
        # indices into the concatenated val + test arrays
        n_val = counts[2] - counts[1]
        n_test = counts[3] - counts[2]
        i_split = [np.array([], np.int64), np.arange(n_val),
                   np.arange(n_val, n_val + n_test)]
        imgs = np.concatenate(all_imgs[1:], 0)
        poses = np.concatenate(all_poses[1:], 0)
        times = np.concatenate(all_times[1:], 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_json = os.path.join(basedir, "transforms_render.json")
    if os.path.exists(render_json):
        with open(render_json) as fp:
            meta = json.load(fp)
        render_poses = np.array(
            [f["transform_matrix"] for f in meta["frames"]], np.float32)
    else:
        n = len(np.unique(times)) + 1
        render_poses = np.stack(
            [pose_spherical(a, -20.0, 4.0)
             for a in np.linspace(180, -180, n)[:-1]], 0)
    render_times = np.linspace(0.0, 1.0, len(render_poses)).astype(np.float32)

    if half_res:
        if H % 2 or W % 2:
            raise ValueError(f"half_res needs even image sizes, got {W} x {H}")
        H, W, focal = H // 2, W // 2, focal / 2.0
        imgs = np.stack([area_resize(im, (W, H)) for im in imgs], 0)

    img_to_cam = np.arange(len(imgs))
    masks = imgs[..., 3:4]
    return (imgs.astype(np.float32), poses, times, render_poses, render_times,
            [H, W, focal], i_split, img_to_cam, masks)
