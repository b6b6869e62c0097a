"""Ray generation and the slab test (port of ``apnerf/ops/rays.py``)."""
from __future__ import annotations

import torch


def get_rays(H: int, W: int, K, c2w, device=None):
    """Per-pixel rays through the pixel centres of one OpenGL-convention
    camera (the JAX defaults: ``mode="center"``, no flips, y up):
    (rays_o, rays_d), each [H, W, 3]."""
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device) + 0.5,
        torch.arange(W, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    dirs = torch.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                        -torch.ones_like(i)], -1)
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_of_a_view(H: int, W: int, K, c2w, device=None):
    """(rays_o, rays_d, viewdirs) of one view; NDC, flips and the
    inverse-y convention are not ported yet."""
    rays_o, rays_d = get_rays(H, W, K, c2w, device=device)
    viewdirs = rays_d / vector_norm(rays_d)
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
