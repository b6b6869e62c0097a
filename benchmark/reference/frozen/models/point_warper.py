"""Linear-blend-skinning forward warp (port of
``apnerf/models/point_warper.py``): a time-conditioned ``transform_net``
gives per-joint axis-angle rotations about the parent joint, composed along
the kinematic tree and blended per point by the skinning weights."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..ops.nn import MLP
from ..ops.rotations import rodrigues, special_procrustes


@dataclasses.dataclass(frozen=True)
class WarpConfig:
    n_joints: int                 # J (root included)
    t_dim: int
    num_layers: int = 5
    hidden_dim: int = 256
    over_parameterized_rot: bool = True
    params_per_component: int = 4


class PointWarper(nn.Module):
    """Holds ``transform_net``: t_dim -> hidden x (num_layers - 1) ->
    (J + 1) * 4, ReLU between layers, no bias on the head."""

    def __init__(self, cfg: WarpConfig, device=None):
        super().__init__()
        dims = ([cfg.t_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
                + [(cfg.n_joints + 1) * cfg.params_per_component])
        self.transform_net = MLP(dims, final_bias=False, device=device)


def build_tree(joints, bones) -> Dict[str, np.ndarray]:
    """``parent_ex`` [J] and root-to-joint paths ``parent_indices`` [J, D]
    (padded with -1) from (parent, child) bone pairs; root = 0."""
    J = int(np.asarray(joints).shape[0])
    parent = {int(b[1]): int(b[0]) for b in bones}
    paths: List[List[int]] = []
    for j in range(J):
        path = []
        k = j
        while True:
            path.append(k)
            if k == 0:
                break
            k = parent.get(k, 0)
            if k == 0:
                path.append(0)
                break
        paths.append(path[::-1])
    depth = max(len(p) for p in paths)
    parent_indices = -np.ones((J, depth), np.int64)
    for j, p in enumerate(paths):
        parent_indices[j, :len(p)] = p
    parent_ex = np.array([parent.get(j, 0) for j in range(J)], np.int64)
    return {"parent_indices": parent_indices, "parent_ex": parent_ex}


def transform_params(warper: PointWarper, t_embed: torch.Tensor):
    """t_embed [..., t_dim] -> raw transform parameters [..., J+1, 4]."""
    out = warper.transform_net(t_embed)
    return out.reshape(*t_embed.shape[:-1], -1, 4)


def chain_product(mats: torch.Tensor) -> torch.Tensor:
    """Ordered product along axis 1 of [J, D, 4, 4] by log-depth halving."""
    D = mats.shape[1]
    pow2 = 1
    while pow2 < D:
        pow2 *= 2
    if pow2 != D:
        eye = torch.eye(4, dtype=mats.dtype, device=mats.device)
        mats = torch.cat([mats, eye.expand(mats.shape[0], pow2 - D, 4, 4)], 1)
    while mats.shape[1] > 1:
        mats = torch.matmul(mats[:, 0::2], mats[:, 1::2])
    return mats[:, 0]


def absolute_transforms(R, joints, parent_indices, parent_ex):
    """Per-joint absolute 4x4 transforms: each joint rotates about its
    parent's position; compose along the root-to-joint path."""
    pivot = joints[parent_ex]                                    # [J, 3]
    t = pivot - torch.einsum("jab,jb->ja", R, pivot)
    J = R.shape[0]
    M = torch.zeros((J, 4, 4), dtype=R.dtype, device=R.device)
    M[:, :3, :3] = R
    M[:, :3, 3] = t
    M[:, 3, 3] = 1.0
    eye = torch.eye(4, dtype=R.dtype, device=R.device)[None]
    M = torch.cat([eye, M], 0)                                   # -1 -> I
    return chain_product(M[parent_indices + 1])


def forward(warper: PointWarper, cfg: WarpConfig, tree, canonical_pcd,
            weights, joints, t_embed=None, rot_params=None,
            global_t: Optional[torch.Tensor] = None, rot_mask=None,
            sibling_mask=None, avg_procrustes: bool = False):
    """Warp the canonical cloud: ``xyz`` [P, 3], ``joints_rel`` [J, 3],
    ``frames`` [P, 4, 4], ``joints_warped``, ``thetas`` [J], ``global_t``.

    ``t_embed`` [t_dim], or ``rot_params`` [J, >= 4] for reposing."""
    J = cfg.n_joints
    if rot_params is None:
        p = transform_params(warper, t_embed)                    # [J+1, 4]
        global_t = p[-1, :3]
        rot_params = p[:J]
    R, thetas = rodrigues(rot_params)
    if sibling_mask is not None:
        R = R[sibling_mask]
    if rot_mask is not None:
        eye = torch.eye(3, dtype=R.dtype, device=R.device)
        R = torch.where(rot_mask[:, None, None], eye[None], R)
    bone_T = absolute_transforms(R, joints, tree["parent_indices"],
                                 tree["parent_ex"])              # [J, 4, 4]
    frames = torch.einsum("pj,jab->pab", weights, bone_T)
    if avg_procrustes:
        frames = frames.clone()
        frames[:, :3, :3] = special_procrustes(frames[:, :3, :3])
    ones = torch.ones((canonical_pcd.shape[0], 1), dtype=canonical_pcd.dtype,
                      device=canonical_pcd.device)
    xyzh = torch.cat([canonical_pcd, ones], -1)
    xyz = torch.einsum("pab,pb->pa", frames, xyzh)[:, :3]
    jh = torch.cat([joints, torch.ones((J, 1), dtype=joints.dtype,
                                       device=joints.device)], -1)
    joints_rel = torch.einsum("jab,jb->ja", bone_T, jh)[:, :3]
    if global_t is None:
        global_t = torch.zeros(3, dtype=xyz.dtype, device=xyz.device)
    xyz = xyz + global_t
    return {
        "xyz": xyz,
        "joints_rel": joints_rel,
        "frames": frames,
        "joints_warped": joints_rel + global_t,
        "thetas": thetas,
        "global_t": global_t,
    }


def get_thetas(warper: PointWarper, cfg: WarpConfig,
               ts_embed: torch.Tensor) -> torch.Tensor:
    """Per-time rotation angles ``[..., J]`` of the time embeddings
    ``ts_embed [..., t_dim]``: the axis-angle form (the first three of
    each joint's four parameters) through ``rodrigues``, as the JAX
    package's ``get_thetas`` takes them."""
    p = transform_params(warper, ts_embed)                      # [..., J+1, 4]
    _, thetas = rodrigues(p[..., :-1, :3].reshape(-1, 3))
    return thetas.reshape(*ts_embed.shape[:-1], cfg.n_joints)
