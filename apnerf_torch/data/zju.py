"""ZJU-MoCap loader for the WIM-preprocessed pickle caches (port of
``apnerf/data/zju.py``; the reference lib/load_zju.py:72-176).

``cache_train.pickle`` / ``cache_test.pickle`` with per-frame image and
mask arrays, raw or blosc-compressed (decoded by ``data.bloscdec``);
background compositing; ``coordinate_scale`` 1.5; a static render pose
repeated 80 times. Frames are resized to ``size`` with
``utils.image.area_resize``. Only load caches you trust: they are
pickles.
"""
from __future__ import annotations

import pickle

import numpy as np

from ..utils.image import area_resize
from . import bloscdec

COORDINATE_SCALE = 1.5  # from the WIM preprocessing


def _unpack(arr, compression):
    return bloscdec.unpack_array(arr) if compression else arr


def load_zju(pickle_path, video_len=300, size: int = 512, compression=None,
             bg_col=0, step: int = 1, load_test_val=False):
    """(images uint8 [N, size, size, 3], poses, intrinsics, times,
    render_poses, render_times, render_intrinsics, [H, W], i_split,
    img_to_cam, masks, embeddings), frame-major; ``load_test_val`` reads
    ``cache_test`` in place of ``cache_train``."""
    if load_test_val:
        pickle_path = pickle_path.replace("cache_train", "cache_test")
    with open(pickle_path, "rb") as f:
        data = pickle.load(f)

    if compression is None:
        # compressed caches store bytes, raw caches arrays
        compression = not isinstance(data["img"][0], np.ndarray)

    imgs, masks, intrinsics, poses, times, img_to_cam = [], [], [], [], [], []
    imgs_per_cam = len(np.unique(data["frame_id"]))
    id_max = video_len - 1
    video_len = min(imgs_per_cam - 1, video_len)
    unique_cams = np.unique(data["camera_id"])

    for fid in range(0, video_len, step):
        for c_id in unique_cams:
            f_id = int(c_id) * imgs_per_cam + fid
            times.append(data["frame_id"][fid] / (id_max - 1))
            img = _unpack(data["img"][f_id], compression)
            fg = _unpack(data["mask"][f_id], compression)
            if fg.ndim == 2:
                fg = fg[None]
            img = img * fg + (1 - fg) * bg_col * 255
            img = np.moveaxis(img, 0, -1)  # CHW -> HWC
            img_scale = 1.0
            if img.shape[0] != size:
                img_scale = size / img.shape[0]
                img = area_resize(img, (size, size))
            imgs.append(img.astype(np.uint8))
            masks.append(np.moveaxis(fg, 0, -1).astype(np.uint8))
            img_to_cam.append(int(c_id))
            if len(poses) < len(unique_cams):
                K = np.array(data["camera_intrinsic"][f_id],
                             np.float32) * img_scale
                K[2, 2] = 1.0
                intrinsics.append(K)
                rot = data["camera_rotation"][f_id]
                trans = data["camera_translation"][f_id] / COORDINATE_SCALE
                pose = np.concatenate(
                    [np.concatenate([rot, trans], axis=-1),
                     np.array([[0, 0, 0, 1]])], axis=0)
                poses.append(np.linalg.inv(pose))

    imgs = np.stack(imgs, 0)
    masks = np.stack(masks, 0)
    poses = np.asarray(poses, np.float32)
    intrinsics = np.asarray(intrinsics, np.float32)
    times = np.asarray(times, np.float32)
    H, W = imgs.shape[1], imgs.shape[2]

    render_poses = np.repeat(poses[None, 0], 80, axis=0).astype(np.float32)
    render_times = np.linspace(0.0, 1.0, len(render_poses)).astype(np.float32)
    render_intrinsics = np.repeat(intrinsics[0][None], len(render_poses), 0)

    if load_test_val:
        i_split = [np.array([]), np.array([]), np.arange(len(imgs))]
    else:
        i_split = [np.arange(len(imgs)), np.array([]), np.array([])]
    img_to_cam = np.asarray(img_to_cam, np.int32)
    embeddings = []
    return (imgs, poses, intrinsics, times, render_poses, render_times,
            render_intrinsics, [H, W], i_split, img_to_cam, masks, embeddings)
