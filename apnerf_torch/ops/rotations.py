"""Rotation utilities (port of ``apnerf/ops/rotations.py``)."""
from __future__ import annotations

import torch


def rodrigues(rvec: torch.Tensor):
    """Axis-angle -> (R [..., 3, 3], theta [...]).

    [..., 3]: axis*angle with the 1e-5 regulariser; [..., 4]: (axis, angle).
    """
    if rvec.shape[-1] == 3:
        theta = torch.sqrt(1e-5 + (rvec ** 2).sum(-1))
        axis = rvec / theta[..., None]
    elif rvec.shape[-1] == 4:
        theta = rvec[..., -1]
        axis = rvec[..., :3]
        axis = axis / torch.sqrt(1e-5 + (axis ** 2).sum(-1))[..., None]
    else:
        raise ValueError(f"rvec last dim must be 3 or 4, got {rvec.shape}")
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = torch.cos(theta)
    s = torch.sin(theta)
    R = torch.stack([
        x * x + (1. - x * x) * c,
        x * y * (1. - c) - z * s,
        x * z * (1. - c) + y * s,
        x * y * (1. - c) + z * s,
        y * y + (1. - y * y) * c,
        y * z * (1. - c) - x * s,
        x * z * (1. - c) - y * s,
        y * z * (1. - c) + x * s,
        z * z + (1. - z * z) * c,
    ], dim=-1).reshape(*axis.shape[:-1], 3, 3)
    return R, theta


def special_procrustes(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix (SVD orthonormalisation, det = +1)."""
    u, _, vt = torch.linalg.svd(M)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones(*M.shape[:-2], 2, dtype=M.dtype,
                              device=M.device), det[..., None]], dim=-1)
    return (u * d[..., None, :]) @ vt
