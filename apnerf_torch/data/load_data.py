"""Dataset dispatch: dnerf / wim / zju -> the common ``data_dict`` (port
of ``apnerf/data/load_data.py``).

Parity: reference lib/load_data.py:12-88 (per-dataset near/far, intrinsics
synthesis when K is None, common key set).
"""
from __future__ import annotations

import numpy as np

from .dnerf import load_dnerf_data
from .wim import load_robot
from .zju import load_zju

NEAR_FAR = {"dnerf": (2.0, 6.0), "wim": (1.0, 6.0), "zju": (1.0, 4.0)}


def load_data(data_cfg, cfg=None, load_test_val=False, bg_col=1):
    """The dataset of ``data_cfg`` (``dataset_type`` dnerf / wim / zju) as
    a ``data_dict`` of numpy arrays (the keys of ``KEPT_KEYS``); D-NeRF
    images composited on white (``bg_col`` 1) or black."""
    K = None
    dtype_name = data_cfg.dataset_type

    if dtype_name == "dnerf":
        (images, poses, times, render_poses, render_times, hwf, i_split,
         img_to_cam, masks) = load_dnerf_data(
            data_cfg.datadir, data_cfg.half_res, data_cfg.testskip,
            load_test_val=load_test_val)
        i_train, i_val, i_test = i_split
        near, far = NEAR_FAR["dnerf"]
        if images.shape[-1] == 4:
            if bg_col == 1:
                images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
            else:
                images = images[..., :3] * images[..., -1:]
    elif dtype_name == "wim":
        (images, poses, K, times, render_poses, render_times, _ri, hw,
         i_split, img_to_cam, masks) = load_robot(
            data_cfg.datadir, skip_images=bool(data_cfg.get("skip_images", False)),
            test=load_test_val,
            # additive knob: the reference hardcodes 300-frame videos
            # (lib/load_data.py:31 / load_robot default); configurable here
            # so clips/fixtures load without 300 frames on disk
            video_len=int(data_cfg.get("video_len", 300)),
            size=int(data_cfg.get("wim_size", 512)))
        i_train, i_val, i_test = i_split
        hwf = [hw[0], hw[1], K[0, 0, 0]]
        near, far = NEAR_FAR["wim"]
    elif dtype_name == "zju":
        (images, poses, K, times, render_poses, render_times, _ri, hw,
         i_split, img_to_cam, masks, _emb) = load_zju(
            data_cfg.datadir, video_len=data_cfg.video_len, step=1,
            size=int(data_cfg.get("zju_size", 512)),
            load_test_val=load_test_val, bg_col=bg_col)
        i_train, i_val, i_test = i_split
        hwf = [hw[0], hw[1], K[0, 0, 0]]
        near, far = NEAR_FAR["zju"]
    else:
        raise NotImplementedError(f"unknown dataset type {dtype_name}")

    H, W, focal = hwf
    H, W = int(H), int(W)
    hwf = [H, W, focal]
    HW = np.array([im.shape[:2] for im in images])

    if K is None:
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                     np.float32)
    Ks = K[None].repeat(len(poses), axis=0) if K.ndim == 2 else K
    render_poses = np.asarray(render_poses)[..., :4]

    if times is None:
        times = np.zeros(images.shape[0], np.float32)
        render_times = np.zeros(render_poses.shape[0], np.float32)

    return dict(
        hwf=hwf, HW=HW, Ks=np.asarray(Ks, np.float32), near=near, far=far,
        i_train=np.asarray(i_train, dtype=np.int64),
        i_val=np.asarray(i_val, dtype=np.int64),
        i_test=np.asarray(i_test, dtype=np.int64),
        poses=np.asarray(poses, np.float32),
        render_poses=np.asarray(render_poses, np.float32),
        images=images, times=np.asarray(times, np.float32),
        render_times=np.asarray(render_times, np.float32),
        img_to_cam=np.asarray(img_to_cam), masks=masks,
        irregular_shape=False,
    )


KEPT_KEYS = {
    "hwf", "HW", "Ks", "near", "far", "i_train", "i_val", "i_test",
    "irregular_shape", "poses", "render_poses", "images", "times",
    "render_times", "img_to_cam", "masks",
}
