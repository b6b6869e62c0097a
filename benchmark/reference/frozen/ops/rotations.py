"""Rotation utilities (port of ``apnerf/ops/rotations.py``)."""
from __future__ import annotations

import math

import torch

# the nearest rotation (SVD orthonormalisation, det = +1) with its
# closed-form gradient: kernel P1 on a CUDA tensor, the plain version on a
# CPU tensor
from ..kernels.procrustes import special_procrustes  # noqa: F401


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


def rotmat_to_rotvec(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle vector [..., 3] whose
    norm is the angle in [0, pi]. Near pi, where the antisymmetric part
    vanishes, the axis comes from the diagonal of (R + I) / 2."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.acos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    scale = torch.where(small, torch.full_like(theta, 0.5),
                        theta / torch.where(small, torch.ones_like(theta),
                                            2.0 * sin_theta))
    vec = v * scale[..., None]
    near_pi = theta > math.pi - 1e-3
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) / 2.0, 0.0, 1.0))
    vec_pi = axis * torch.sign(v + 1e-20) * theta[..., None]
    return torch.where(near_pi[..., None], vec_pi, vec)


def geodesic_angle(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Relative rotation angle |log(R1 R2^T)|."""
    return torch.linalg.norm(
        rotmat_to_rotvec(R1 @ R2.transpose(-1, -2)), dim=-1)
