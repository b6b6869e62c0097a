"""Ray generation, the slab test and dense ray sampling (port of
``apnerf/ops/rays.py``). Camera conventions (``inverse_y``, flips,
``mode``) are the JAX package's."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def get_rays(H: int, W: int, K, c2w, inverse_y=False, flip_x=False,
             flip_y=False, mode="center", device=None):
    """Per-pixel rays of one camera: (rays_o, rays_d), each [H, W, 3].
    ``mode="center"`` shoots through pixel centres, ``"lefttop"`` through
    pixel corners; ``inverse_y`` is the OpenCV convention (y down, z
    forward), otherwise OpenGL (y up, z backward)."""
    K = _tensor(K, device)
    c2w = _tensor(c2w, device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    if mode == "center":
        i, j = i + 0.5, j + 0.5
    elif mode != "lefttop":
        raise NotImplementedError(mode)
    if flip_x:
        i = i.flip(1)
    if flip_y:
        j = j.flip(0)
    if inverse_y:
        dirs = torch.stack([(i - K[0][2]) / K[0][0], (j - K[1][2]) / K[1][1],
                            torch.ones_like(i)], -1)
    else:
        dirs = torch.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                            -torch.ones_like(i)], -1)
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """NDC reparameterisation (reference lib/tineuvox.py:714-731)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox, oy, oz = rays_o.unbind(-1)
    dx, dy, dz = rays_d.unbind(-1)
    o0 = -1. / (W / (2. * focal)) * ox / oz
    o1 = -1. / (H / (2. * focal)) * oy / oz
    o2 = 1. + 2. * near / oz
    d0 = -1. / (W / (2. * focal)) * (dx / dz - ox / oz)
    d1 = -1. / (H / (2. * focal)) * (dy / dz - oy / oz)
    d2 = -2. * near / oz
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def get_rays_of_a_view(H: int, W: int, K, c2w, ndc=False, inverse_y=False,
                       flip_x=False, flip_y=False, mode="center",
                       device=None):
    """(rays_o, rays_d, viewdirs) of one view, each [H, W, 3]; viewdirs
    are taken before the NDC warp."""
    rays_o, rays_d = get_rays(H, W, K, c2w, inverse_y=inverse_y,
                              flip_x=flip_x, flip_y=flip_y, mode=mode,
                              device=device)
    viewdirs = rays_d / vector_norm(rays_d)
    if ndc:
        rays_o, rays_d = ndc_rays(H, W, float(K[0][0]), 1.,
                                  rays_o, rays_d)
    return rays_o, rays_d, viewdirs


def vector_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x^2)) over the last axis, kept (the JAX package's norm)."""
    return torch.sqrt((x * x).sum(-1, keepdim=True))


def ray_aabb(rays_o, rays_d, xyz_min, xyz_max, near, far):
    """Slab test -> (t_min, t_max), both clamped into [near, far]."""
    v = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    a = (xyz_max - rays_o) / v
    b = (xyz_min - rays_o) / v
    t_min = torch.minimum(a, b).amax(-1)
    t_max = torch.maximum(a, b).amin(-1)
    t_min = t_min.clamp(max=far).clamp(min=near)
    t_max = t_max.clamp(max=far).clamp(min=near)
    return t_min, t_max


class RaySamples(NamedTuple):
    """Dense per-ray samples: [R, S] or [R, S, 3], ``t_min`` and
    ``n_steps`` [R]."""
    pts: torch.Tensor
    valid: torch.Tensor      # inside the step count and inside the bbox
    step_id: torch.Tensor
    t_min: torch.Tensor
    n_steps: torch.Tensor


def max_n_steps(xyz_min, xyz_max, stepdist) -> int:
    """Static upper bound on per-ray samples for the bbox diagonal."""
    diag = float(np.linalg.norm(np.asarray(xyz_max) - np.asarray(xyz_min)))
    return int(math.ceil(diag / float(stepdist))) + 1


def sample_pts_on_rays(rays_o, rays_d, xyz_min, xyz_max, near, far,
                       stepdist, n_samples: int) -> RaySamples:
    """Clip each ray to the bbox, then march ``n_steps = max(ceil((t_max -
    t_min) / stepdist), 1)`` unit-direction steps from ``o + d t_min``;
    samples past ``n_steps`` or outside the bbox are masked out."""
    lo, hi = _tensor(xyz_min, rays_o.device), _tensor(xyz_max, rays_o.device)
    t_min, t_max = ray_aabb(rays_o, rays_d, lo, hi, near, far)
    n_steps = torch.clamp(torch.ceil((t_max - t_min) / stepdist),
                          min=1.0).to(torch.int32)
    rays_start = rays_o + rays_d * t_min[..., None]
    unit_d = rays_d / vector_norm(rays_d)
    step = torch.arange(n_samples, dtype=torch.float32, device=rays_o.device)
    pts = (rays_start[:, None, :]
           + unit_d[:, None, :] * (step[None, :, None] * stepdist))
    in_bbox = ((pts >= lo) & (pts <= hi)).all(-1)
    valid = (step[None, :] < n_steps[:, None].float()) & in_bbox
    step_id = torch.arange(n_samples, dtype=torch.int32,
                           device=rays_o.device).expand(valid.shape)
    return RaySamples(pts=pts, valid=valid, step_id=step_id, t_min=t_min,
                      n_steps=n_steps)


def sample_ndc_pts_on_rays(rays_o, rays_d, xyz_min, xyz_max,
                           n_samples: int) -> RaySamples:
    """Fixed-count equidistant sampling of NDC rays, ``o + d t`` at
    ``n_samples`` values of t from 0 to 1 (the reference
    ``sample_ndc_pts_on_rays``); samples outside the bbox are masked out.
    No shipped config sets ``ndc``."""
    dev = rays_o.device
    lo, hi = _tensor(xyz_min, dev), _tensor(xyz_max, dev)
    t = torch.linspace(0.0, 1.0, n_samples, device=dev)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[None, :, None]
    in_bbox = ((pts >= lo) & (pts <= hi)).all(-1)
    N = rays_o.shape[0]
    return RaySamples(
        pts=pts, valid=in_bbox,
        step_id=torch.arange(n_samples, dtype=torch.int32,
                             device=dev).expand(in_bbox.shape),
        t_min=torch.zeros(N, device=dev),
        n_steps=torch.full((N,), n_samples, dtype=torch.int32, device=dev))


def rays_hit_bbox(rays_o, rays_d, xyz_min, xyz_max, near, far):
    """Does any sample of the ray fall inside the scene bbox (reference
    ``TiNeuVox.get_mask``, lib/tineuvox.py:422-433)?"""
    t_min, t_max = ray_aabb(rays_o, rays_d, _tensor(xyz_min, rays_o.device),
                            _tensor(xyz_max, rays_o.device), near, far)
    return t_max > t_min
