"""Watch-It-Move multi-view robot video loader (port of
``apnerf/data/wim.py``; the reference lib/load_robot.py:84-176).

Frame files ``frame_%05d_cam_%03d.png`` and per-camera ``cam_%03d.json``;
train cameras 1-9 and 11-19, test cameras 0 and 10; alpha composited onto
white; uint8 image store; ``coordinate_scale`` 0.333 for the nao robot; a
360-degree spherical render path. Frames are read with ``utils.png`` and
resized to ``size`` with ``utils.image.area_resize``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils.image import area_resize
from ..utils.png import read_png
from .dnerf import pose_spherical


def data_settings(robot_name: str, test: bool = False):
    """(chosen cameras, test cameras, coordinate_scale) of a robot."""
    coordinate_scale = 0.333 if robot_name == "nao" else 1.0
    if test:
        chosen = [0, 10]
        test_ids = [0, 10]
    else:
        chosen = list(range(1, 10)) + list(range(11, 20))
        test_ids = []
    return chosen, test_ids, coordinate_scale


def load_robot(data_dir, video_len: int = 300, size: int = 512, test=False,
               skip_images=False, step: int = 1):
    """(images uint8 [N, size, size, 3], poses, intrinsics, times,
    render_poses, render_times, render_intrinsics, [H, W], i_split,
    img_to_cam, masks uint8 [N, size, size, 1]), frame-major (every chosen
    camera at frame 0 first)."""
    robot_name = os.path.basename(os.path.normpath(data_dir))
    chosen, test_ids, coordinate_scale = data_settings(robot_name, test)

    imgs = masks = None
    times, img_to_cam, i_train, i_test = [], [], [], []
    img_scale = 1.0
    c = 0
    for f_id in range(0, video_len, step):
        for cam_pos, c_id in enumerate(chosen):
            times.append(f_id / max(video_len - 1, 1))
            if not (skip_images and f_id > 0):
                img = read_png(os.path.join(
                    data_dir, f"frame_{f_id:05d}_cam_{c_id:03d}.png"))
                if img.shape[0] != size:
                    img_scale = size / img.shape[0]
                    img = area_resize(img, (size, size))
                mask = img[..., -1:]
                fmask = mask.astype(np.float32) / 255.0
                img = img[..., :3].astype(np.float32) * fmask + (255.0 - mask)
            if imgs is None:
                n_total = video_len * len(chosen)
                imgs = np.zeros((n_total, *img.shape), np.uint8)
                masks = np.zeros((n_total, img.shape[0], img.shape[1], 1),
                                 np.uint8)
            imgs[c] = img.astype(np.uint8)
            masks[c] = mask
            (i_test if c_id in test_ids else i_train).append(c)
            img_to_cam.append(cam_pos)
            c += 1

    intrinsics, poses = [], []
    for c_id in chosen:
        with open(os.path.join(data_dir, f"cam_{c_id:03d}.json")) as f:
            config = json.load(f)
        ic = config["camera_data"]["intrinsics"]
        K = np.zeros((3, 3), np.float32)
        K[0, 0] = ic["fx"] * img_scale
        K[1, 1] = ic["fy"] * img_scale
        K[0, 2] = ic["cx"] * img_scale
        K[1, 2] = ic["cy"] * img_scale
        K[2, 2] = 1.0
        intrinsics.append(K)
        ext = np.array(config["camera_data"]["camera_view_matrix"]).T
        ext[:3, -1] = ext[:3, -1] / coordinate_scale
        poses.append(np.linalg.inv(ext))

    if skip_images:
        imgs = np.repeat(imgs[0][None], len(imgs), axis=0)

    poses = np.asarray(poses, np.float32)
    intrinsics = np.asarray(intrinsics, np.float32)
    times = np.asarray(times, np.float32)
    img_to_cam = np.asarray(img_to_cam)
    H, W = imgs.shape[1], imgs.shape[2]

    radius = float(np.sqrt((poses[:, :, -1] ** 2).sum(-1)).mean())
    render_poses = np.stack([pose_spherical(a, -20.0, radius)
                             for a in np.linspace(0, 360, 181)[:-1]], 0)
    render_times = np.linspace(0.0, 1.0, len(render_poses)).astype(np.float32)
    render_intrinsics = np.repeat(intrinsics[0][None], len(render_poses), 0)
    i_split = [np.arange(len(i_train)), np.array([]), np.array(i_test)]
    return (imgs, poses, intrinsics, times, render_poses, render_times,
            render_intrinsics, [H, W], i_split, img_to_cam, masks)
