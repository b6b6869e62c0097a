"""Training rays (port of ``apnerf/data/rays.py``).

The host keeps a compact record of the training pixels (image, pixel id,
rgb, mask); each step's rays are made on the device from the camera table
(``pixels_to_rays``). Batches are drawn with ``np.random.default_rng(seed)``
as in the JAX package, so both packages draw the same rays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.rays import rays_hit_bbox, vector_norm


def pixels_to_rays(Ks, poses, cam_idx, pix_id, H: int, W: int,
                   inverse_y=False, flip_x=False, flip_y=False,
                   mode="center"):
    """Rays of (camera, flat pixel id) pairs: ``Ks [C, 3, 3]``, ``poses
    [C, 4, 4]``, ``cam_idx`` and ``pix_id`` [B] -> (rays_o, rays_d,
    viewdirs), each [B, 3]; per pixel the rays of ``ops.rays.get_rays``."""
    y = torch.div(pix_id, W, rounding_mode="floor").float()
    x = (pix_id % W).float()
    if flip_x:
        x = (W - 1) - x
    if flip_y:
        y = (H - 1) - y
    if mode == "center":
        i, j = x + 0.5, y + 0.5
    else:
        i, j = x, y
    K = Ks[cam_idx]
    c2w = poses[cam_idx]
    if inverse_y:
        dirs = torch.stack([(i - K[:, 0, 2]) / K[:, 0, 0],
                            (j - K[:, 1, 2]) / K[:, 1, 1],
                            torch.ones_like(i)], -1)
    else:
        dirs = torch.stack([(i - K[:, 0, 2]) / K[:, 0, 0],
                            -(j - K[:, 1, 2]) / K[:, 1, 1],
                            -torch.ones_like(i)], -1)
    rays_d = torch.einsum("bj,bij->bi", dirs, c2w[:, :3, :3])
    rays_o = c2w[:, :3, 3]
    return rays_o, rays_d, rays_d / vector_norm(rays_d)


@dataclasses.dataclass
class RayIndex:
    """Compact host-side index of the training pixels."""
    rgb: np.ndarray            # [N, 3] (uint8 or float32, dataset dtype)
    mask: np.ndarray           # [N] float32 foreground mask value
    pix_id: np.ndarray         # [N] int32 flat pixel index in its image
    img_of: np.ndarray         # [N] int32 image index
    img_time: np.ndarray       # [n_images] float32
    img_cam: np.ndarray        # [n_images] int32
    index_to_times: Dict[float, Tuple[int, int]]
    H: int
    W: int

    @property
    def n(self) -> int:
        return len(self.rgb)

    def gather(self, sel: np.ndarray):
        """Host gather of a batch -> (rgb, mask, time, cam, pix_id)."""
        img = self.img_of[sel]
        rgb = self.rgb[sel]
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.float32) / 255.0
        return (rgb, self.mask[sel], self.img_time[img],
                self.img_cam[img], self.pix_id[sel])


def camera_hit_masks(poses, Ks, H, W, xyz_min, xyz_max, near, far,
                     inverse_y=False, flip_x=False, flip_y=False,
                     device=None) -> np.ndarray:
    """[n_cams, H*W] bool: does the pixel's ray hit the scene bbox?"""
    masks = np.zeros((len(poses), H * W), bool)
    pix = torch.arange(H * W, device=device)
    cam = torch.zeros_like(pix)
    for c in range(len(poses)):
        K = torch.as_tensor(np.asarray(Ks[c], np.float32), device=device)
        c2w = torch.as_tensor(np.asarray(poses[c], np.float32),
                              device=device)
        ro, rd, _ = pixels_to_rays(K[None], c2w[None], cam, pix, H, W,
                                   inverse_y=inverse_y, flip_x=flip_x,
                                   flip_y=flip_y)
        masks[c] = rays_hit_bbox(ro, rd, xyz_min, xyz_max, near,
                                 far).cpu().numpy()
    return masks


def build_ray_index(images, masks_imgs, times, img_to_cam, poses, Ks, H, W,
                    xyz_min, xyz_max, near, far, inverse_y=False,
                    flip_x=False, flip_y=False, device=None) -> RayIndex:
    """The training-pixel index, without the pixels whose ray misses the
    bbox. ``images [n_img, H, W, 3]``, ``masks_imgs [n_img, H, W, 1]``,
    ``times [n_img]``, ``img_to_cam [n_img]`` (rows of poses / Ks)."""
    cam_masks = camera_hit_masks(poses, Ks, H, W, xyz_min, xyz_max, near,
                                 far, inverse_y=inverse_y, flip_x=flip_x,
                                 flip_y=flip_y, device=device)
    rgb_parts, mask_parts, pix_parts, imgof_parts = [], [], [], []
    index_to_times: Dict[float, Tuple[int, int]] = {}
    top = 0
    for k in range(len(images)):
        pix = np.nonzero(cam_masks[img_to_cam[k]])[0].astype(np.int32)
        n = len(pix)
        rgb_parts.append(np.asarray(images[k]).reshape(H * W, -1)[pix, :3])
        # 0-255 alpha masks are normalised to [0, 1] (a value check)
        mk = np.asarray(masks_imgs[k], np.float32).reshape(H * W, -1)[pix, 0]
        if mk.size and mk.max() > 1.5:
            mk = mk / 255.0
        mask_parts.append(mk)
        pix_parts.append(pix)
        imgof_parts.append(np.full(n, k, np.int32))
        t = float(times[k])
        s = index_to_times[t][0] if t in index_to_times else top
        index_to_times[t] = (s, top + n)
        top += n
    return RayIndex(
        rgb=np.concatenate(rgb_parts, 0), mask=np.concatenate(mask_parts, 0),
        pix_id=np.concatenate(pix_parts, 0),
        img_of=np.concatenate(imgof_parts, 0),
        img_time=np.asarray(times, np.float32),
        img_cam=np.asarray(img_to_cam, np.int32),
        index_to_times=index_to_times, H=H, W=W)


def batch_index_generator(n, batch_size, seed=0):
    """Random batches without replacement, ``np.random.default_rng(seed)``
    (the JAX package's generator)."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.choice(n, size=batch_size, replace=False)
