"""TemporalPoints stage-2 point model: the render and training forward,
the six training losses and skeleton simplification (port of
``apnerf/models/temporal_points.py``).

One code path and one index space: the warped cloud is always Morton-sorted
into the k-NN tables of ``kernels.knn_cells`` (pad rows included), and the
kernel-or-plain choice happens inside each kernel wrapper by device. The
static budgets (``M_act``, ``G2``, ``M_pass``, ``S_pass``), their 1024- and
128-multiple roundings and the depth-major drop order are the JAX
package's: they decide which samples survive. Every JAX ``argsort`` is a
stable sort here too.

Sampling: the fused group sampler when ``coarse_stride`` divides the
budgets, else (or under ``APNERF_FUSED_SAMPLER=0``) the
``sample_rays_compact`` / ``compact_active`` pair, as the JAX package
chooses. ``feat_net`` runs in kernel K4 (``kernels.featmlp``) under
``featmlp_kernel`` with bf16 aggregation, and otherwise in the XLA
formulation (``featnet_plain``); ``fused_agg`` takes kernel K6
(``kernels.agg``) under the JAX package's own conditions (shared mode, bf16
aggregation, no pose embedding, not ``render_pcd_direct``, not
``render_weights``, ``feat_depth == 4``). ``aggregate_pts`` reports which
ran (``knn_path``).

``prepare_frame`` and ``forward`` are differentiable: the training step
takes gradients through them. The k-NN and everything built for it (the
tables, the occupancy grid, the frame's bbox) take detached positions, as
the JAX package's ``stop_gradient`` does; so does the pose embedding's
input. K4 under training is ``FeatMLPTrain``: the kernel forward and a
backward that recomputes through ``featnet_plain`` (the JAX custom VJP).
K6 is forward-only and refuses to run with gradients enabled. The render
callers hold ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from .. import resolve_device
from ..kernels.agg import fused_subgroup_agg
from ..kernels.featmlp import FeatMLPWeights, featmlp_agg, pack_weights
from ..kernels.knn_cells import build_point_tables
from ..kinematics.skeletonizer import point_segment_distance
from ..kinematics.treeprune import flatten_merging_rules, merge_joints
from ..ops import encoding
from ..ops.activation import raw2alpha
from ..ops.knn import knn, knn_count, morton_codes
from ..ops.marching import alpha2weights, composite
from ..ops.nn import MLP, leaky_relu
from ..ops.rays import ray_aabb, vector_norm
from ..ops.rotations import rodrigues, rotmat_to_rotvec
from ..parallel import mesh as pmesh
from . import point_warper
from .tineuvox import RGBNet

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TemporalPointsConfig:
    """Field names and defaults of the JAX config, so a checkpoint's
    ``model_kwargs`` constructs it (see the JAX class for each field)."""
    n_points: int
    n_joints: int
    feat_dim: int
    neighbours: int = 8
    timebase_pe: int = 8
    posbase_pe: int = 10
    viewbase_pe: int = 4
    stepsize: float = 0.5
    voxel_size: float = 0.0
    voxel_size_ratio: float = 1.0
    act_shift: float = 0.0
    fast_color_thres: float = 1e-4
    no_view_dir: bool = False
    frozen_view_dir: bool = False
    over_parameterized_rot: bool = True
    avg_procrustes: bool = False
    re_init_mlps: bool = False
    feat_depth: int = 4
    pose_embedding_dim: int = 0
    eps: float = 1e-6
    sample_budget: int = 192
    max_steps: int = 512
    active_fraction: float = 0.30
    pass_fraction: float = 0.30
    occ_res: int = 64
    occ_dilations: int = 2
    knn_pts_tile: int = 128
    knn_rt: int = 24
    group_pass_fraction: float = 0.55
    agg_bf16: bool = True
    coarse_stride: int = 16
    knn_share: int = 1
    knn_cand: int = 12
    fused_agg: bool = False
    featmlp_kernel: bool = True

    @property
    def t_dim(self):
        return 1 + 2 * self.timebase_pe

    @property
    def pts_ch(self):
        return 3 + 3 * self.posbase_pe * 2

    @property
    def views_ch(self):
        return 0 if self.no_view_dir else 3 + 3 * self.viewbase_pe * 2

    @property
    def warp_cfg(self):
        return point_warper.WarpConfig(
            n_joints=self.n_joints, t_dim=self.t_dim,
            over_parameterized_rot=self.over_parameterized_rot)


class TemporalPoints(nn.Module):
    """Stage-2 parameters: per-point arrays and the networks. Names match
    the JAX parameter pytree (``utils.checkpoint`` maps between them).

    ``timenet_dims``: the backbone's time network, carried in checkpoints
    but not used by the render."""

    def __init__(self, cfg: TemporalPointsConfig,
                 timenet_dims: Sequence[int], device=None):
        super().__init__()
        self.cfg = cfg
        P, J, F = cfg.n_points, cfg.n_joints, cfg.feat_dim

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=F32, device=device))

        self.weights = param(P, J)
        self.joints = param(J, 3)
        self.theta_weight = param(1)
        self.gammas = param(P)
        self.canonical_feat = param(P, F)
        self.canonical_rgbs = param(P, 3)
        self.canonical_alpha = param(P)
        self.direct_eps = param(P)
        self.forward_warp = point_warper.PointWarper(cfg.warp_cfg, device)
        fin = F + cfg.pts_ch + cfg.pose_embedding_dim
        self.feat_net = MLP([fin] + [F] * cfg.feat_depth, "leaky_relu",
                            "leaky_relu", device=device)
        self.rgbnet = RGBNet(F, cfg.views_ch, device)
        self.densitynet = MLP([F, 1], device=device)
        self.timenet = MLP(list(timenet_dims), device=device)
        self.pose_embedding_net = None
        if cfg.pose_embedding_dim > 0:
            pin = J * cfg.pts_ch
            dims = ([pin, pin // 2] + [pin // 2] * (cfg.feat_depth - 2)
                    + [cfg.pose_embedding_dim])
            self.pose_embedding_net = MLP(dims, "leaky_relu", "leaky_relu",
                                          device=device)

    def forward(self, state, rays_o, rays_d, viewdirs, **kwargs):
        return forward(self, state, rays_o, rays_d, viewdirs, **kwargs)


HEADS = ("rgbnet", "densitynet", "timenet")


def init_params(cfg: TemporalPointsConfig, canonical_pcd, joints, bones,
                canonical_feat, canonical_alpha, canonical_rgbs,
                tineuvox_params, generator: torch.Generator,
                noise_gamma: float = 1e-2, device=None) -> TemporalPoints:
    """A stage-2 model on ``device`` (``None``: the CUDA device; raises
    without one), the counterpart of the JAX package's ``init_params``.

    Skinning weights from point-to-bone distances; ``rgbnet``,
    ``densitynet`` and ``timenet`` copied from the trained backbone's
    ``tineuvox_params`` (a mapping of the three in the JAX pytree layout,
    numpy leaves, as a ``fine_last.pkl`` holds them) and drawn again from
    ``generator`` only under ``cfg.re_init_mlps``; ``feat_net``, the warp's
    ``transform_net`` and ``pose_embedding_net`` drawn from ``generator``."""
    from ..utils.checkpoint import mlp_dims, params_from_jax
    device = resolve_device(device)
    P = cfg.n_points
    a = np.array([joints[b[0]] for b in bones], np.float64)
    b = np.array([joints[b[1]] for b in bones], np.float64)
    d = point_segment_distance(canonical_pcd, a, b)              # [J-1, P]
    w = (1.0 / (0.5 * np.e ** d + cfg.eps)).T
    w = np.concatenate([np.zeros((P, 1)), w], axis=-1)
    heads = params_from_jax({name: tineuvox_params[name] for name in HEADS})
    model = TemporalPoints(cfg, mlp_dims(heads, "timenet"))
    with torch.no_grad():
        model.weights.copy_(torch.as_tensor(w, dtype=F32))
        model.joints.copy_(torch.as_tensor(np.asarray(joints), dtype=F32))
        model.theta_weight.fill_(0.1)
        model.gammas.copy_(1.0 + noise_gamma * torch.randn(
            P, generator=generator))
        model.canonical_feat.copy_(torch.as_tensor(np.asarray(canonical_feat),
                                                   dtype=F32))
        model.canonical_rgbs.copy_(torch.as_tensor(np.asarray(canonical_rgbs),
                                                   dtype=F32))
        model.canonical_alpha.copy_(torch.as_tensor(
            np.asarray(canonical_alpha), dtype=F32))
        model.direct_eps.fill_(0.05)
    for net in (model.forward_warp.transform_net, model.feat_net,
                model.pose_embedding_net):
        if net is not None:
            net.reset_parameters_(generator)
    own = model.state_dict()
    missing = [k for k in own if k.split(".")[0] in HEADS and k not in heads]
    if missing or set(heads) - set(own):
        raise ValueError(f"tineuvox_params: heads of another layout (missing "
                         f"{missing}, unexpected {sorted(set(heads) - set(own))})")
    model.load_state_dict(heads, strict=False)
    if cfg.re_init_mlps:
        for name in HEADS:
            getattr(model, name).reset_parameters_(generator)
    return model.to(device)


@torch.no_grad()
def init_state(cfg: TemporalPointsConfig, canonical_pcd, joints, bones,
               skeleton_pcd, xyz_min, xyz_max, frozen_view_dir=None,
               device=None) -> Dict[str, Any]:
    """Non-learned buffers: canonical k-NN (kernel K1), kinematic tree,
    merge state, bboxes, on ``device`` (``None``: the CUDA device; raises
    without one)."""
    device = resolve_device(device)

    def t(x, dtype=F32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    pcd = t(canonical_pcd)
    _, nn_i = knn(pcd, pcd, k=cfg.neighbours)
    nn_i = nn_i.long()
    nn_dist = torch.sqrt(((pcd[:, None, :] - pcd[nn_i]) ** 2).sum(-1)
                         + cfg.eps)
    tree = point_warper.build_tree(np.asarray(joints), bones)
    J = cfg.n_joints
    bone_pairs = np.asarray(bones).reshape(-1)
    state = {
        "canonical_pcd": pcd,
        "skeleton_pcd": t(skeleton_pcd),
        "original_joints": t(joints),
        "nn_i": nn_i,
        "nn_distance": nn_dist,
        "mean_min_distance": nn_dist[:, 1].mean(),
        "bone_arap_idx": t(bone_pairs, torch.int64),
        "tree": {k: t(v, torch.int64) for k, v in tree.items()},
        "rot_mask": torch.zeros(J, dtype=torch.bool, device=device),
        "sibling_mask": torch.arange(J, device=device),
        "merge_mat": torch.eye(J, dtype=F32, device=device),
        "xyz_min": t(xyz_min),
        "xyz_max": t(xyz_max),
        "frozen_view_dir": (None if frozen_view_dir is None
                            else t(frozen_view_dir)),
        "bones": np.asarray(bones),
    }
    og = state["original_joints"][state["bone_arap_idx"]]
    state["og_joint_distance"] = og[0::2] - og[1::2]
    return state


def get_weights(model: TemporalPoints, state) -> torch.Tensor:
    """Tempered softmax skinning weights times the merge matrix."""
    theta = torch.clamp(model.theta_weight, min=model.cfg.eps)
    w = torch.softmax(model.weights / theta, dim=-1)
    return w @ state["merge_mat"]


def warp(model: TemporalPoints, state, t=None, rot_params=None):
    """Forward-warp the canonical cloud at time ``t`` (a number, or a
    one-element tensor, which a CUDA graph reads as its static input) or by
    explicit ``rot_params`` [J, 4]."""
    cfg = model.cfg
    dev = state["canonical_pcd"].device
    t_embed = None
    if t is not None:
        tt = (t.to(F32).reshape(1) if torch.is_tensor(t)
              else torch.full((1,), float(t), dtype=F32, device=dev))
        t_embed = encoding.poc_fre(
            tt, encoding.poc_freqs(cfg.timebase_pe, dev)).reshape(-1)
    weights = get_weights(model, state)
    out = point_warper.forward(
        model.forward_warp, cfg.warp_cfg, state["tree"],
        state["canonical_pcd"], weights, model.joints, t_embed=t_embed,
        rot_params=rot_params, rot_mask=state["rot_mask"],
        sibling_mask=state["sibling_mask"],
        avg_procrustes=cfg.avg_procrustes)
    out["lbs_weights"] = weights
    return out


def _compact_per_ray(valid: torch.Tensor, budget: int) -> torch.Tensor:
    """Source step of the b-th valid slot of each ray, b < budget
    (== S when the ray has fewer) -> int64 [R, budget]."""
    c = torch.cumsum(valid.to(torch.int32), dim=1)
    thresh = torch.arange(1, budget + 1, dtype=torch.int32,
                          device=valid.device)
    return (c[:, :, None] < thresh[None, None, :]).sum(1)


OCC_RES = 64


@functools.lru_cache(maxsize=64)
def _cell_floor(radius: float, margin: float, n_dil: int) -> float:
    """(sqrt(radius) + margin) / n_dil * 1.0001 in fp32, computed on the
    host's CPU as a number: a frame that a CUDA graph captures makes no
    host-to-device copy, and after the first frame no host tensor."""
    D = torch.sqrt(torch.tensor(radius, dtype=F32)) + margin
    return float(D / n_dil * 1.0001)


def build_occupancy(t_hat_pcd, bbox_min, bbox_max, radius: float,
                    occ_res: int = OCC_RES, margin: float = 0.0,
                    n_dil: int = 2):
    """Binary occupancy grid of the cloud, dilated ``n_dil`` cells, with a
    cell no smaller than (sqrt(radius) + margin) / n_dil (conservative
    lookups; see the JAX docstring) -> (grid bool [D, D, D], cell)."""
    extent = bbox_max - bbox_min
    cell = torch.clamp(extent.amax() / occ_res,
                       min=_cell_floor(radius, margin, n_dil))
    idx = torch.clamp((t_hat_pcd - bbox_min) / cell, 0, occ_res - 1).to(
        torch.int64)
    grid = torch.zeros((occ_res,) * 3, dtype=F32, device=t_hat_pcd.device)
    # the value a tensor on the device: a number would be copied from the
    # host, which a CUDA graph's capture refuses
    grid.index_put_((idx[:, 0], idx[:, 1], idx[:, 2]), grid.new_ones(()))
    grid = grid[None, None]
    for _ in range(n_dil):
        grid = Fn.max_pool3d(grid, 3, stride=1, padding=1)
    return grid[0, 0] > 0, cell


def occupancy_lookup(occ, cell, bbox_min, pts):
    dims = occ.shape[0]
    idx = torch.floor((pts - bbox_min) / cell).to(torch.int64)
    ok = ((idx >= 0) & (idx < dims)).all(-1)
    idx = idx.clamp(0, dims - 1)
    return ok & occ[idx[..., 0], idx[..., 1], idx[..., 2]]


def prepare_occupancy(cfg: TemporalPointsConfig, state, t_hat_pcd,
                      query_radius: float, calc_min_max: bool = True):
    """Per-frame bbox, occupancy grid and Morton k-NN tables of the warped
    cloud, shared by every ray chunk of the frame. All three are built from
    the detached cloud: sample positions and the k-NN carry no gradient."""
    t_hat_pcd = t_hat_pcd.detach()
    if calc_min_max:
        bb_min = t_hat_pcd.amin(0) - query_radius
        bb_max = t_hat_pcd.amax(0) + query_radius
    else:
        bb_min, bb_max = state["xyz_min"], state["xyz_max"]
    margin = (cfg.coarse_stride - 1) / 2.0 * cfg.stepsize * cfg.voxel_size
    occ, occ_cell = build_occupancy(t_hat_pcd, bb_min, bb_max, query_radius,
                                    occ_res=cfg.occ_res, margin=margin,
                                    n_dil=cfg.occ_dilations)
    return {"bb_min": bb_min, "bb_max": bb_max, "occ": occ,
            "occ_cell": occ_cell, "occ_margin": margin,
            "knn_tables": build_point_tables(
                t_hat_pcd, pts_per_tile=cfg.knn_pts_tile)}


def _budget_compact(keep_mask: torch.Tensor, values: torch.Tensor,
                    budget: int, fill: int) -> torch.Tensor:
    """The first ``budget`` entries of ``values`` whose ``keep_mask`` is
    set, in order; empty slots hold ``fill`` (the JAX cumsum + scatter
    with a drop row)."""
    pos = torch.cumsum(keep_mask.to(torch.int64), 0) - 1
    keep = keep_mask & (pos < budget)
    dest = torch.where(keep, pos, torch.full_like(pos, budget))
    out = torch.full((budget + 1,), fill, dtype=torch.int64,
                     device=values.device)
    out[dest] = values
    return out[:budget]


def _coarse_hits(occ, occ_cell, occ_margin, bb_min, start, unit_d, jc, c,
                 stepdist):
    """Occupancy hit of each coarse group of ``c`` steps [R, Sc]: at the
    group centre (clamped into the grid) when the grid's dilation margin
    covers the group half-width, else over every member."""
    half = (c - 1) / 2.0 * stepdist
    if half <= occ_margin * (1 + 1e-6) + 1e-12:
        tc = (jc * c + (c - 1) / 2.0) * stepdist
        pc = start[:, None, :] + unit_d[:, None, :] * tc[None, :, None]
        idx = torch.floor((pc - bb_min) / occ_cell).to(torch.int64).clamp(
            0, occ.shape[0] - 1)
        return occ[idx[..., 0], idx[..., 1], idx[..., 2]]
    ar = torch.arange(c, dtype=F32, device=jc.device)
    tm = (jc[:, None] * c + ar[None, :]) * stepdist
    pm = (start[:, None, None, :]
          + unit_d[:, None, None, :] * tm[None, :, :, None])
    return occupancy_lookup(occ, occ_cell, bb_min, pm).any(-1)


def _sample_groups_fused(cfg: TemporalPointsConfig, rays_o, rays_d, near,
                         far, bb_min, bb_max, occ, occ_cell, occ_margin,
                         tables, query_radius, M_act):
    """Group sampling + compaction with positions only for the selected
    groups (JAX ``_sample_groups_fused``). Returns (q [M_slots, 3],
    src [M_slots], act_ok [M_slots], step_id [R, B], act_demand)."""
    dev = rays_o.device
    stepdist = cfg.stepsize * cfg.voxel_size
    t_min, t_max = ray_aabb(rays_o, rays_d, bb_min, bb_max, near, far)
    n_steps = torch.clamp(torch.ceil((t_max - t_min) / stepdist), min=1.0)
    start = rays_o + rays_d * t_min[:, None]
    unit_d = rays_d / vector_norm(rays_d)
    S, R, B, c = cfg.max_steps, rays_o.shape[0], cfg.sample_budget, \
        cfg.coarse_stride
    Sc = (S + c - 1) // c
    Bc = B // c
    ar_c = torch.arange(c, device=dev)

    # ---- per-ray group budgeting on the groups' occupancy hits
    jc = torch.arange(Sc, dtype=F32, device=dev)
    half = (c - 1) / 2.0 * stepdist
    hit = _coarse_hits(occ, occ_cell, occ_margin, bb_min, start, unit_d, jc,
                       c, stepdist)
    hit = hit & (jc[None, :] * c < n_steps[:, None])
    src_c = _compact_per_ray(hit, Bc)                     # [R, Bc], Sc empty
    src_steps = (src_c[:, :, None] * c + ar_c).reshape(R, B)
    step_id = torch.clamp(src_steps.to(F32), max=S - 1)

    # ---- global group compaction, depth-major drop order
    M_grp = R * Bc
    G_act = M_act // c
    gvalid = src_c < Sc
    act_demand = gvalid.sum() * c
    gid = torch.arange(M_grp, device=dev)
    gsrc = _budget_compact(gvalid.t().reshape(M_grp),
                           (gid % R) * Bc + gid // R, G_act, M_grp)

    ray = torch.clamp(gsrc // Bc, max=R - 1)
    slot = torch.clamp(gsrc % Bc, max=Bc - 1)
    t_g = (src_c[ray, slot].to(F32) * c + (c - 1) / 2.0) * stepdist
    grep = start[ray] + unit_d[ray] * t_g[:, None]
    grep = torch.where((gsrc < M_grp)[:, None], grep,
                       torch.full_like(grep, 1e9))
    gperm = torch.argsort(morton_codes(grep, bb_min, bb_max), stable=True)
    gsrc = gsrc[gperm]

    if cfg.group_pass_fraction > 0:
        # hierarchical prefilter on the group midpoints (kernel K2)
        thr = float((np.sqrt(query_radius) + half) ** 2)
        gkeep = knn_count(grep[gperm], tables, thr) >= cfg.neighbours
        G2 = int(G_act * cfg.group_pass_fraction)
        G2 = min(max(128, (G2 + 127) // 128 * 128), G_act)
        if G2 < G_act:
            gsrc = _budget_compact(gkeep, gsrc, G2, M_grp)
        else:
            gsrc = torch.where(gkeep, gsrc, torch.full_like(gsrc, M_grp))

    # ---- member expansion for the selected groups only
    M_slots = gsrc.shape[0] * c
    real = gsrc < M_grp
    ray_of_g = torch.clamp(gsrc // Bc, max=R - 1)
    slot_of_g = torch.clamp(gsrc % Bc, max=Bc - 1)
    steps = src_c[ray_of_g, slot_of_g][:, None] * c + ar_c[None, :]
    step_f = steps.to(F32)
    pos_m = (start[ray_of_g][:, None, :]
             + unit_d[ray_of_g][:, None, :] * (step_f[..., None] * stepdist))
    in_bbox = ((pos_m >= bb_min) & (pos_m <= bb_max)).all(-1)
    valid_m = (real[:, None] & in_bbox & (steps < S)
               & (step_f < n_steps[ray_of_g][:, None]))
    q = torch.where(valid_m[..., None], pos_m,
                    torch.full_like(pos_m, 1e9)).reshape(M_slots, 3)
    M_full = R * B
    base = torch.where(real, ray_of_g * B + slot_of_g * c,
                       torch.full_like(ray_of_g, M_full))
    src = torch.clamp((base[:, None] + ar_c[None, :]).reshape(M_slots),
                      max=M_full)
    act_ok = q[:, 0] < 1e8
    return q, src, act_ok, step_id, act_demand


def sample_rays_compact(cfg: TemporalPointsConfig, rays_o, rays_d, near, far,
                        bbox_min, bbox_max, occ=None, occ_cell=None,
                        occ_margin=0.0):
    """Dense slab sampling against the frame's bbox plus per-ray
    compaction to ``sample_budget`` slots (JAX ``sample_rays_compact``) ->
    (pts [R, B, 3] with 1e9 in empty slots, valid [R, B], step [R, B]).

    With an occupancy grid and ``coarse_stride`` dividing the budget, whole
    groups of ``coarse_stride`` steps are budgeted on their occupancy hit;
    otherwise each step is tested."""
    dev = rays_o.device
    stepdist = cfg.stepsize * cfg.voxel_size
    t_min, t_max = ray_aabb(rays_o, rays_d, bbox_min, bbox_max, near, far)
    n_steps = torch.clamp(torch.ceil((t_max - t_min) / stepdist), min=1.0)
    start = rays_o + rays_d * t_min[:, None]
    unit_d = rays_d / vector_norm(rays_d)
    S, R, B, c = cfg.max_steps, rays_o.shape[0], cfg.sample_budget, \
        cfg.coarse_stride
    if occ is not None and B % c == 0:
        Sc = (S + c - 1) // c
        jc = torch.arange(Sc, dtype=F32, device=dev)
        hit = _coarse_hits(occ, occ_cell, occ_margin, bbox_min, start,
                           unit_d, jc, c, stepdist)
        hit = hit & (jc[None, :] * c < n_steps[:, None])
        src_c = _compact_per_ray(hit, B // c)                 # [R, B/c]
        src = (src_c[:, :, None] * c
               + torch.arange(c, device=dev)).reshape(R, B)
        step_f = src.to(F32)
        pts = start[:, None, :] + unit_d[:, None, :] * (
            step_f[..., None] * stepdist)
        in_bbox = ((pts >= bbox_min) & (pts <= bbox_max)).all(-1)
        valid = (step_f < n_steps[:, None]) & (src < S) & in_bbox
        pts = torch.where(valid[..., None], pts, torch.full_like(pts, 1e9))
        return pts, valid, torch.clamp(step_f, max=S - 1)

    step = torch.arange(S, dtype=F32, device=dev)
    pts = start[:, None, :] + unit_d[:, None, :] * (step[None, :, None]
                                                    * stepdist)
    in_bbox = ((pts >= bbox_min) & (pts <= bbox_max)).all(-1)
    valid = (step[None, :] < n_steps[:, None]) & in_bbox
    if occ is not None:
        valid = valid & occupancy_lookup(occ, occ_cell, bbox_min, pts)
    src = _compact_per_ray(valid, B)                          # [R, B]
    pts_pad = torch.cat([pts, torch.full((R, 1, 3), 1e9, device=dev)], 1)
    pts_c = torch.gather(pts_pad, 1, src[..., None].expand(R, B, 3))
    return pts_c, src < S, torch.clamp(src, max=S - 1).to(F32)


def active_budget(cfg: TemporalPointsConfig, M_full: int) -> int:
    """The static active-sample budget of ``M_full`` slots: the
    ``active_fraction`` share rounded up to a multiple of 1024, at least
    1024 and at most ``M_full``."""
    M_act = int(M_full * cfg.active_fraction)
    return min(max(1024, ((M_act + 1023) // 1024) * 1024), M_full)


def compact_active(cfg: TemporalPointsConfig, pts, valid, bb_min, bb_max,
                   tables=None, query_radius=None):
    """Global compaction of the valid samples to the active budget, Morton
    ordered (JAX ``compact_active``) -> (q [M_slots, 3], src [M_slots] flat
    index into R * B (M_full when empty), act_ok [M_slots], grouped).

    When ``coarse_stride`` divides the budgets the compaction runs over
    whole groups (``grouped`` True), in depth-major drop order; with
    ``tables`` and ``query_radius`` the groups first pass the hierarchical
    prefilter (kernel K2 on the group representatives, the min corner of
    their members, at the radius enlarged by the group length), budgeted
    by ``group_pass_fraction``. Otherwise single samples are compacted in
    depth-major order."""
    R, B = valid.shape
    dev = valid.device
    M_full = R * B
    q_full = pts.reshape(M_full, 3)
    M_act = active_budget(cfg, M_full)
    c = cfg.coarse_stride
    if B % c == 0 and M_act % c == 0:
        Bc = B // c
        M_grp = R * Bc
        G_act = M_act // c
        gv = valid.reshape(R, Bc, c).any(-1).t().reshape(M_grp)
        gid = torch.arange(M_grp, device=dev)
        gsrc = _budget_compact(gv, (gid % R) * Bc + gid // R, G_act, M_grp)
        grep = torch.cat([pts.reshape(M_grp, c, 3).amin(1),
                          torch.full((1, 3), 1e9, device=dev)], 0)[gsrc]
        gperm = torch.argsort(morton_codes(grep, bb_min, bb_max),
                              stable=True)
        gsrc = gsrc[gperm]
        if (query_radius is not None and tables is not None
                and cfg.group_pass_fraction > 0):
            stepdist = cfg.stepsize * cfg.voxel_size
            thr = float((np.sqrt(query_radius) + (c - 1) * stepdist) ** 2)
            gkeep = knn_count(grep[gperm], tables, thr) >= cfg.neighbours
            G2 = int(G_act * cfg.group_pass_fraction)
            G2 = min(max(128, (G2 + 127) // 128 * 128), G_act)
            if G2 < G_act:
                gsrc = _budget_compact(gkeep, gsrc, G2, M_grp)
            else:
                gsrc = torch.where(gkeep, gsrc, torch.full_like(gsrc, M_grp))
        M_slots = gsrc.shape[0] * c
        ray_of_g = torch.clamp(gsrc // Bc, max=R - 1)
        base = torch.where(gsrc < M_grp, ray_of_g * B + (gsrc % Bc) * c,
                           torch.full_like(gsrc, M_full))
        src = torch.clamp((base[:, None] + torch.arange(c, device=dev)
                           ).reshape(M_slots), max=M_full)
        q_groups = torch.cat([q_full.reshape(M_grp, 3 * c),
                              torch.full((1, 3 * c), 1e9, device=dev)], 0)
        q = q_groups[torch.clamp(gsrc, max=M_grp)].reshape(M_slots, 3)
        return q, src, q[:, 0] < 1e8, True
    flat_id = torch.arange(M_full, device=dev)
    src = _budget_compact(valid.t().reshape(M_full),
                          (flat_id % R) * B + flat_id // R, M_act, M_full)
    q_pad = torch.cat([q_full, torch.full((1, 3), 1e9, device=dev)], 0)
    q = q_pad[src]
    mperm = torch.argsort(morton_codes(q, bb_min, bb_max), stable=True)
    src = src[mperm]
    return q[mperm], src, src < M_full, False


def featnet_plain(layers: List[Tuple[torch.Tensor, torch.Tensor]],
                  rel_canon, feat_k, w, pose_embedding, n_pe: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """The XLA formulation of the aggregation (the JAX ``_featnet_h``
    without the kernel): h = sum_k w[..., k] * feat_net(PE(rel_canon) ++
    feat_k (++ pose embedding)), the inputs and ``layers`` (``(weight
    [dout, din], bias)`` pairs) in ``dtype``, each layer's product and
    bias add rounded to it as the JAX package rounds them, leaky-ReLU
    after every layer, the weighted K-sum in fp32. Differentiable."""
    rel_emb = encoding.poc_fre(rel_canon, encoding.poc_freqs(
        n_pe, rel_canon.device))
    x = [rel_emb.to(dtype), feat_k.to(dtype)]
    if pose_embedding is not None:
        x.append(pose_embedding.reshape(-1).to(dtype).expand(
            *rel_emb.shape[:-1], pose_embedding.numel()))
    x = torch.cat(x, -1)
    for wt, b in layers:
        x = leaky_relu(x @ wt.t() + b)
    return (x.float() * w[..., None]).sum(-2)


class FeatMLPTrain(torch.autograd.Function):
    """Kernel K4 with a gradient: the forward is ``featmlp_agg`` on the
    packed weights (the kernel on CUDA tensors), the backward recomputes
    through ``featnet_plain`` in bf16 and differentiates that, as the JAX
    package's custom VJP (``apnerf/kernels/featmlp_pallas.py``) does; no
    layer activation is kept from the forward. Gradients reach
    ``rel``, ``feat``, ``w``, the pose embedding and the bf16 layers."""

    @staticmethod
    def forward(ctx, wts: FeatMLPWeights, n_pe: int, rel, feat, w,
                pose_embedding, *layers):
        ctx.n_pe = n_pe
        ctx.save_for_backward(rel, feat, w, pose_embedding, *layers)
        return featmlp_agg(rel, feat, w, wts)

    @staticmethod
    def backward(ctx, g):
        rel, feat, w, pose, *layers = ctx.saved_tensors
        ins = [t if t is None else t.detach().requires_grad_(
            ctx.needs_input_grad[i + 2])
            for i, t in enumerate([rel, feat, w, pose, *layers])]
        wanted = [t for t in ins if t is not None and t.requires_grad]
        with torch.enable_grad():
            h = featnet_plain(list(zip(ins[4::2], ins[5::2])), ins[0],
                              ins[1], ins[2], ins[3], ctx.n_pe,
                              torch.bfloat16)
            grads = iter(torch.autograd.grad(h, wanted, g.float(),
                                             allow_unused=True))
        return (None, None, *(next(grads) if t is not None and t.requires_grad
                              else None for t in ins))


def _featnet_h(srcs: "PointSources", rel_canon, feat_k, w):
    """h = sum_k w[..., k] * feat_net(PE(rel_canon), feat_k, pose): kernel
    K4 (with its recompute backward) when the frame packed its weights,
    else the XLA formulation."""
    if not srcs.k4:
        return featnet_plain(srcs.layers, rel_canon, feat_k, w,
                             srcs.pose_embedding, srcs.n_pe, srcs.dtype)
    K = rel_canon.shape[-2]
    F = feat_k.shape[-1]
    lead = rel_canon.shape[:-2]
    h = FeatMLPTrain.apply(
        srcs.featnet, srcs.n_pe, rel_canon.reshape(-1, K, 3).float(),
        feat_k.reshape(-1, K, F).to(torch.bfloat16), w.reshape(-1, K).float(),
        srcs.pose_embedding, *(t for layer in srcs.layers for t in layer))
    return h.reshape(*lead, F)


class PointSources:
    """What every ray chunk of a frame gathers from, built once per frame
    by ``prepare_frame``: the per-point arrays permuted into the
    Morton-sorted k-NN space (pad rows are zeros; ``gather`` reads them),
    ``feat_net``'s layers in the aggregation type (bf16 under ``agg_bf16``,
    else fp32), and, when kernel K4 or K6 may run, those layers packed for
    the kernels (biases included, the frame's pose embedding folded into
    the layer-1 bias)."""

    def __init__(self, model: TemporalPoints, state, tables, t_hat_pcd,
                 inv_rot, lbs_weights, pose_embedding):
        cfg = model.cfg
        self.model = model
        self.perm = tables["perm"]
        self.Pp = tables["pts_sorted"].shape[0]
        self.dtype = torch.bfloat16 if cfg.agg_bf16 else F32
        self.n_pe = cfg.posbase_pe
        self.geo = torch.cat([self.permute(t_hat_pcd),
                              self.permute(inv_rot.reshape(-1, 9))], -1)
        self.feat = self.permute(model.canonical_feat)
        self.lbs = None if lbs_weights is None else self.permute(lbs_weights)
        self.mean_min_distance = state["mean_min_distance"]
        self.pose_embedding = pose_embedding
        self.layers = [(l.weight.to(self.dtype), l.bias.to(self.dtype))
                       for l in model.feat_net.layers]
        self.featnet = None
        if cfg.agg_bf16 and (cfg.fused_agg or (cfg.featmlp_kernel
                                               and cfg.feat_depth >= 2)):
            with torch.no_grad():
                self.featnet = pack_weights(
                    [(wt.detach(), b.detach()) for wt, b in self.layers],
                    cfg.feat_dim, cfg.posbase_pe,
                    None if pose_embedding is None
                    else pose_embedding.detach())

    @property
    def has_pose_embedding(self) -> bool:
        return self.pose_embedding is not None

    @property
    def k4(self) -> bool:
        """Does the exact and the non-fused shared aggregation run K4?"""
        cfg = self.model.cfg
        return (self.featnet is not None and cfg.featmlp_kernel
                and cfg.feat_depth >= 2)

    def gather(self, idx):
        """Position + inverse rotation [..., 12] (fp32) and features
        [..., F] (in the aggregation type) of the sorted rows ``idx``.
        ``index_select``, whose backward sums into the tables with
        ``index_add_`` (fp32: the features are cast after the gather);
        indexing's sort-based backward took ~80 ms of a training step for
        the ~0.6 M rows the exact step gathers at the nerf family's width
        (NVIDIA H100 80GB HBM3, 700 W)."""
        flat = idx.reshape(-1)
        geo = self.geo.index_select(0, flat).reshape(*idx.shape, -1)
        feat = self.feat.index_select(0, flat).to(self.dtype)
        return geo, feat.reshape(*idx.shape, -1)

    def permute(self, arr):
        out = arr[self.perm]
        pad = self.Pp - out.shape[0]
        if pad:
            out = torch.cat([out, out.new_zeros((pad, *out.shape[1:]))], 0)
        return out

    def direct(self):
        """The per-point tables of the direct point-cloud render
        (``render_pcd_direct``): Gaussian width ``sig``, clipped canonical
        alpha and rgb."""
        m = self.model
        return (self.permute(self.mean_min_distance
                             * torch.clamp(m.direct_eps, min=0.0)),
                self.permute(torch.clamp(m.canonical_alpha, 0, 1)),
                self.permute(torch.clamp(m.canonical_rgbs, 0, 1)))


def _views_emb(cfg, state, viewdirs, ray_of):
    """View-direction encoding per slot (None without view dirs)."""
    if cfg.no_view_dir:
        return None
    freqs = encoding.poc_freqs(cfg.viewbase_pe, viewdirs.device)
    if state["frozen_view_dir"] is not None:
        ve = encoding.poc_fre(state["frozen_view_dir"], freqs)
        return ve.expand(*ray_of.shape, ve.shape[-1])
    return encoding.poc_fre(viewdirs, freqs)[ray_of]


def _heads(model: TemporalPoints, h, views_emb):
    cfg = model.cfg
    density = model.densitynet(h)[..., 0]
    alpha = raw2alpha(density, cfg.act_shift,
                      cfg.stepsize * cfg.voxel_size_ratio)
    return alpha, torch.sigmoid(model.rgbnet(h, views_emb))


def _aggregate_subgroup_shared(model: TemporalPoints, state, srcs, viewdirs,
                               q, src, act_ok, R, B, M_full, M_act,
                               query_radius, tables, act_demand,
                               render_pcd_direct=False, render_weights=False,
                               mesh=None):
    """Subgroup-shared k-NN aggregation (``knn_share > 1``): ``knn_cand``
    candidates per subgroup of ``share`` consecutive samples (kernel K3 on
    the subgroup midpoints), pass-compaction on the midpoint's kth
    distance at the enlarged radius, then each member's exact top-K of the
    candidates. Error is one-sided vs the exact path (JAX docstring).

    With ``cfg.fused_agg`` (and the JAX package's further conditions, see
    the module docstring) everything from the member-candidate distances
    to the weighted reduction is kernel K6; otherwise the ranking runs
    here and ``feat_net`` through ``_featnet_h`` (K4 or the XLA
    formulation). ``mesh``: the midpoints' k-NN and the passing subgroups'
    work split over the ranks (``parallel.mesh.shard_rows``)."""
    cfg = model.cfg
    K = cfg.neighbours
    kc = int(cfg.knn_cand)
    share = int(cfg.knn_share)
    if kc < K:
        raise ValueError(f"knn_cand {kc} < neighbours {K}")
    dev = q.device
    G_sub = q.shape[0] // share
    span = (share - 1) * cfg.stepsize * cfg.voxel_size
    r2_sel = float((np.sqrt(query_radius) + span / 2.0) ** 2)

    qg = q.reshape(G_sub, share, 3)
    ok_g = act_ok.reshape(G_sub, share)[..., None]
    lo = torch.where(ok_g, qg, torch.full_like(qg, 1e9)).amin(1)
    hi = torch.where(ok_g, qg, torch.full_like(qg, -1e9)).amax(1)
    reps = torch.where(ok_g.any(1), 0.5 * (lo + hi), torch.full_like(lo, 2e9))
    d2r, idx = pmesh.shard_rows(
        mesh, lambda r: knn(r, None, kc, radius2=r2_sel, point_tables=tables),
        reps)

    # ---- subgroup pass-compaction (budget as pass_fraction)
    sub_ok = d2r[:, K - 1] <= r2_sel
    pass_demand = sub_ok.sum() * share
    S_pass = max(128, int(M_act * cfg.pass_fraction) // share)
    S_pass = min(((S_pass + 127) // 128) * 128, G_sub)
    src_g = src.reshape(G_sub, share)
    act_g = act_ok.reshape(G_sub, share)
    if S_pass < G_sub:
        psrc = _budget_compact(sub_ok, torch.arange(G_sub, device=dev),
                               S_pass, G_sub)
        pass_ok_sub = psrc < G_sub
        psl = torch.clamp(psrc, max=G_sub - 1)
        q_sub = qg[psl]
        src_sub = torch.where(pass_ok_sub[:, None], src_g[psl],
                              torch.full_like(src_g[psl], M_full))
        idx, d2r = idx[psl], d2r[psl]
        ok_sub = act_g[psl] & pass_ok_sub[:, None]
    else:
        S_pass = G_sub
        q_sub = qg
        src_sub = torch.where(sub_ok[:, None], src_g,
                              torch.full_like(src_g, M_full))
        ok_sub = act_g & sub_ok[:, None]
    fused = (cfg.fused_agg and cfg.agg_bf16 and not srcs.has_pose_embedding
             and not render_pcd_direct and not render_weights
             and cfg.feat_depth == 4)
    res = pmesh.shard_rows(
        mesh, lambda *a: _shared_slots(model, state, srcs, viewdirs, R, B,
                                       r2_sel, fused, render_pcd_direct,
                                       render_weights, *a),
        q_sub, src_sub, idx, d2r)

    # ---- scatter back to [R, B], one row per subgroup (a subgroup's slots
    # are consecutive and share-aligned in the flat R*B space)
    sample_ok = ok_sub & (res.pop("kd2") <= query_radius)  # [S_pass, share]
    n_rows = M_full // share
    dst_row = torch.where(src_sub[:, 0] < M_full, src_sub[:, 0] // share,
                          torch.full_like(src_sub[:, 0], n_rows))

    def scatter(x):
        x = torch.where(sample_ok.reshape(*sample_ok.shape,
                                          *(1,) * (x.dim() - 2)),
                        x, torch.zeros_like(x))
        out = x.new_zeros((n_rows + 1, *x.shape[1:]))
        out[dst_row] = x
        return out[:n_rows].reshape(R, B, *x.shape[2:])

    out = {
        "alpha": scatter(res.pop("alpha")),
        "rgb": scatter(res.pop("rgb")),
        "valid": scatter(sample_ok),
        "budget_audit": torch.stack([
            act_demand, act_demand.new_full((), M_act), pass_demand,
            act_demand.new_full((), S_pass * share)]),
        "knn_path": "shared_fused" if fused else "shared",
    }
    # the direct render's alpha_direct / rgb_direct and lbs_w
    for key, val in res.items():
        out[key] = scatter(val)
    return out


def _shared_slots(model: TemporalPoints, state, srcs, viewdirs, R, B, r2_sel,
                  fused, render_pcd_direct, render_weights, q_sub, src_sub,
                  idx, d2r):
    """The work of the passing subgroups ``q_sub`` [S, share, 3] (their
    slots ``src_sub``, candidates ``idx`` / ``d2r`` [S, kc]): the members'
    ranking and aggregation, ``feat_net`` and the heads -> ``alpha``,
    ``rgb``, ``kd2`` (the member's kth distance) and the render's extras,
    per member."""
    cfg = model.cfg
    K = cfg.neighbours
    kc = int(cfg.knn_cand)
    share = q_sub.shape[1]
    dev = q_sub.device
    # slots beyond the midpoint's in-radius count carry (+inf, 0): mask
    # them out of every member's ranking
    cand_valid = d2r <= r2_sel                           # [S_pass, kc]

    views_emb = _views_emb(cfg, state, viewdirs,
                           torch.clamp(src_sub // B, max=R - 1))
    idxl = idx.long()
    geo, feat_k = srcs.gather(idxl)                     # [S, kc, 12 / F]
    rot = geo[..., 3:]                                   # [S, kc, 9]
    direct = {}
    if fused:
        if torch.is_grad_enabled():
            raise ValueError("fused_agg (kernel K6) is forward-only: render "
                             "under torch.inference_mode() or train with "
                             "fused_agg=False")
        # kernel K6: invalid candidate slots go to a far sentinel, so they
        # rank last and a sample whose top-K reaches one is rejected
        # through kd2 (one-sided, as the inf mask below)
        nbr = torch.where(cand_valid[..., None], geo[..., :3],
                          torch.full_like(geo[..., :3], 2e9))
        h, kd2 = fused_subgroup_agg(q_sub, nbr, rot, feat_k, srcs.featnet,
                                    K, cfg.eps)
    else:
        rel_p = q_sub[:, :, None, :] - geo[:, None, :, :3]   # [S, sh, kc, 3]
        to_nn = (rel_p ** 2).sum(-1)                     # [S, share, kc]
        inf = torch.full_like(to_nn, float("inf"))
        to_nn = torch.where(cand_valid[:, None, :], to_nn, inf)
        if kc == K:
            # every valid candidate is a neighbour: no ranking needed
            # (invalid slots carry inf, zero weight, and reject through kd2)
            top = torch.ones_like(to_nn, dtype=torch.bool)
            kd2 = to_nn.amax(-1)
            w = torch.where(torch.isfinite(to_nn), 1.0 / (to_nn + cfg.eps),
                            torch.zeros_like(to_nn))
        else:
            # exact per-member top-K of the kc candidates; ties by position
            ar = torch.arange(kc, device=dev)
            less = (to_nn[..., :, None] > to_nn[..., None, :]) | (
                (to_nn[..., :, None] == to_nn[..., None, :])
                & (ar[:, None] > ar[None, :]))
            rank = less.sum(-1)                          # a permutation
            top = rank < K
            kd2 = torch.where(top, to_nn, -inf).amax(-1)
            w = torch.where(top, 1.0 / (to_nn + cfg.eps),
                            torch.zeros_like(to_nn))
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
        if kc > K:
            # gather the K winners in rank order (the JAX one-hot
            # contractions at HIGHEST precision select the same values)
            win = torch.argsort(rank, dim=-1)[..., :K]   # [S, share, K]
            w_sel = torch.gather(w, -1, win)
            rel_sel = torch.gather(rel_p, 2,
                                   win[..., None].expand(-1, -1, -1, 3))
            S_, sh = win.shape[:2]
            rot_sel = torch.gather(rot[:, None].expand(S_, sh, kc, 9), 2,
                                   win[..., None].expand(-1, -1, -1, 9))
            F = feat_k.shape[-1]
            feat_sel = torch.gather(feat_k[:, None].expand(S_, sh, kc, F), 2,
                                    win[..., None].expand(-1, -1, -1, F))
            rel_canon = torch.einsum(
                "mskab,mskb->mska",
                rot_sel.reshape(*rot_sel.shape[:3], 3, 3), rel_sel)
        else:
            w_sel = w
            feat_sel = feat_k[:, None].expand(-1, share, -1, -1)
            rel_canon = torch.einsum(
                "mkab,mskb->mska", rot.reshape(rot.shape[0], kc, 3, 3), rel_p)
        h = _featnet_h(srcs, rel_canon, feat_sel, w_sel)
        if render_pcd_direct:
            sig_all, a_all, c_all = srcs.direct()
            sig = sig_all[idxl][:, None, :]              # [S, 1, kc]
            w_dir = torch.where(
                top, torch.exp(-(to_nn ** 2) / (2.0 * sig ** 2 + 1e-12)),
                torch.zeros_like(to_nn))
            w_dir_col = w_dir / (w_dir.sum(-1, keepdim=True) + 1e-12)
            direct["alpha_direct"] = (w_dir / K
                                      * a_all[idxl][:, None, :]).sum(-1)
            direct["rgb_direct"] = (w_dir_col[..., None]
                                    * c_all[idxl][:, None, :, :]).sum(2)
    alpha, rgb = _heads(model, h, views_emb)
    out = {"alpha": alpha, "rgb": rgb, "kd2": kd2, **direct}
    if render_weights and srcs.lbs is not None:
        lw = srcs.lbs[idxl]                              # [S, kc, J]
        out["lbs_w"] = (lw[:, None] * w[..., None]).sum(2)
    return out


def _aggregate_exact(model: TemporalPoints, state, srcs, viewdirs, q, src,
                     act_ok, R, B, M_full, M_act, query_radius, tables,
                     act_demand, render_pcd_direct=False,
                     render_weights=False, mesh=None):
    """Exact two-phase k-NN aggregation: count within the radius (K2;
    ``count >= K`` is the reference's kth-neighbour cutoff), compact the
    survivors to the pass budget, select K (K3), aggregate (``_featnet_h``:
    K4 or the XLA formulation). ``mesh``: the count and the passing
    slots' work split over the ranks (``parallel.mesh.shard_rows``)."""
    cfg = model.cfg
    K = cfg.neighbours
    dev = q.device
    M_slots = q.shape[0]
    cnt = pmesh.shard_rows(
        mesh, lambda qb: knn_count(qb, tables, float(query_radius)), q)
    nn_ok = (cnt >= K) & act_ok

    M_pass = int(M_act * cfg.pass_fraction)
    M_pass = min(max(1024, ((M_pass + 1023) // 1024) * 1024), M_slots)
    if M_pass < M_slots:
        psrc = _budget_compact(nn_ok, torch.arange(M_slots, device=dev),
                               M_pass, M_slots)
        pass_ok = psrc < M_slots
        psl = torch.clamp(psrc, max=M_slots - 1)
        q = q[psl]
        src = torch.where(pass_ok, src[psl], torch.full_like(psrc, M_full))
        n_slots = M_pass
    else:
        pass_ok = nn_ok
        src = torch.where(nn_ok, src, torch.full_like(src, M_full))
        n_slots = M_slots

    res = pmesh.shard_rows(
        mesh, lambda *a: _exact_slots(model, state, srcs, viewdirs, R, B,
                                      query_radius, tables,
                                      render_pcd_direct, render_weights, *a),
        q, src)

    # exact kth distance of the selected set decides the radius cutoff
    dst = torch.where(pass_ok & (res.pop("kth") <= query_radius), src,
                      torch.full_like(src, M_full))

    def scatter(x):
        out = x.new_zeros((M_full + 1, *x.shape[1:]))
        out[dst] = x
        return out[:M_full].reshape(R, B, *x.shape[1:])

    out = {
        "alpha": scatter(res.pop("alpha")),
        "rgb": scatter(res.pop("rgb")),
        "valid": scatter(torch.ones_like(pass_ok)),
        "budget_audit": torch.stack([
            act_demand, act_demand.new_full((), M_act), nn_ok.sum(),
            act_demand.new_full((), n_slots)]),
        "knn_path": "exact",
    }
    # the direct render's alpha_direct / rgb_direct and lbs_w
    for key, val in res.items():
        out[key] = scatter(val)
    return out


def _exact_slots(model: TemporalPoints, state, srcs, viewdirs, R, B,
                 query_radius, tables, render_pcd_direct, render_weights, q,
                 src):
    """The work of the passing slots ``q`` [n, 3] (``src`` their flat
    sample): K (K3), the aggregation, ``feat_net`` and the heads ->
    ``alpha``, ``rgb``, ``kth`` (the kth distance) and the render's
    extras, per slot."""
    cfg = model.cfg
    K = cfg.neighbours
    _, idx = knn(q, None, K, radius2=float(query_radius), point_tables=tables)
    views_emb = _views_emb(cfg, state, viewdirs,
                           torch.clamp(src // B, max=R - 1))
    idxl = idx.long()
    geo, feat_k = srcs.gather(idxl)                     # [n, K, 12 / F]
    rel_p = q[:, None, :] - geo[..., :3]
    to_nn = (rel_p ** 2).sum(-1)
    w = 1.0 / (to_nn + cfg.eps)
    w = w / w.sum(-1, keepdim=True)
    rel_canon = torch.einsum("mkab,mkb->mka",
                             geo[..., 3:].reshape(q.shape[0], K, 3, 3), rel_p)
    h = _featnet_h(srcs, rel_canon, feat_k, w)
    alpha, rgb = _heads(model, h, views_emb)
    out = {"alpha": alpha, "rgb": rgb, "kth": to_nn.amax(-1)}
    if render_pcd_direct:
        sig_all, a_all, c_all = srcs.direct()
        w_dir = torch.exp(-(to_nn ** 2) / (2.0 * sig_all[idxl] ** 2 + 1e-12))
        w_dir_col = w_dir / (w_dir.sum(-1, keepdim=True) + 1e-12)
        out["alpha_direct"] = (w_dir / K * a_all[idxl]).sum(-1)
        out["rgb_direct"] = (w_dir_col[..., None] * c_all[idxl]).sum(1)
    if render_weights and srcs.lbs is not None:
        out["lbs_w"] = (srcs.lbs[idxl] * w[..., None]).sum(1)
    return out


def aggregate_pts(model: TemporalPoints, state, frame, rays_o, rays_d,
                  viewdirs, near, far, query_radius, render_pcd_direct=False,
                  render_weights=False, mesh=None):
    """k-NN feature aggregation along rays, from a ``prepare_frame``
    output -> per-sample [R, B(, .)] arrays, the valid mask, ``step_id``
    and ``knn_path``, which aggregation ran: "exact", "shared" or
    "shared_fused" (kernel K6)."""
    cfg = model.cfg
    occ_info = frame["occ_info"]
    R = rays_o.shape[0]
    B = cfg.sample_budget
    M_full = R * B
    M_act = active_budget(cfg, M_full)
    c = cfg.coarse_stride
    tables = occ_info["knn_tables"]
    bb_min, bb_max = occ_info["bb_min"], occ_info["bb_max"]
    if (B % c == 0 and M_act % c == 0
            and os.environ.get("APNERF_FUSED_SAMPLER", "1") == "1"):
        q, src, act_ok, step_id, act_demand = _sample_groups_fused(
            cfg, rays_o, rays_d, near, far, bb_min, bb_max, occ_info["occ"],
            occ_info["occ_cell"], occ_info["occ_margin"], tables,
            query_radius, M_act)
        grouped = True
    else:
        pts, valid, step_id = sample_rays_compact(
            cfg, rays_o, rays_d, near, far, bb_min, bb_max,
            occ=occ_info["occ"], occ_cell=occ_info["occ_cell"],
            occ_margin=occ_info["occ_margin"])
        q, src, act_ok, grouped = compact_active(
            cfg, pts, valid, bb_min, bb_max, tables=tables,
            query_radius=query_radius)
        act_demand = valid.sum()
    share = int(cfg.knn_share)
    # the JAX package takes exact k-NN unless the samples came in groups
    # that share divides; so does the port
    shared = share > 1 and grouped and c % share == 0
    agg = _aggregate_subgroup_shared if shared else _aggregate_exact
    out = agg(model, state, frame["point_sources"], viewdirs, q, src, act_ok,
              R, B, M_full, M_act, query_radius, tables, act_demand,
              render_pcd_direct=render_pcd_direct,
              render_weights=render_weights, mesh=mesh)
    out["step_id"] = step_id
    return out


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate/det 3x3 inverse plus one Newton-Schulz step."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    x = inv / det[..., None, None]
    eye2 = 2.0 * torch.eye(3, dtype=m.dtype, device=m.device)
    return x @ (eye2 - m @ x)


def prepare_frame(model: TemporalPoints, state, t=None, rot_params=None,
                  query_radius: float = 0.01, calc_min_max: bool = True):
    """Per-frame state shared by all ray chunks: warp, inverse frames,
    pose embedding, occupancy grid, k-NN tables and the point sources the
    chunks gather from. Differentiable in the model's parameters."""
    cfg = model.cfg
    wout = warp(model, state, t=t, rot_params=rot_params)
    Rm = wout["frames"][:, :3, :3]
    wout["inv_rot"] = (Rm.transpose(-1, -2) if cfg.avg_procrustes
                       else _inv3x3(Rm))
    wout["pose_embedding"] = None
    if cfg.pose_embedding_dim > 0:
        delta = (model.joints - wout["joints_rel"]).detach()
        emb = encoding.poc_fre(delta, encoding.poc_freqs(cfg.posbase_pe,
                                                         delta.device))
        wout["pose_embedding"] = model.pose_embedding_net(emb.reshape(1, -1))
    wout["occ_info"] = prepare_occupancy(cfg, state, wout["xyz"],
                                         query_radius, calc_min_max)
    wout["point_sources"] = PointSources(
        model, state, wout["occ_info"]["knn_tables"], wout["xyz"],
        wout["inv_rot"], wout["lbs_weights"], wout["pose_embedding"])
    return wout


def forward(model: TemporalPoints, state, rays_o, rays_d, viewdirs, t=None,
            rot_params=None, near=0.0, far=1e9, bg=1.0,
            query_radius: float = 0.01, render_depth: bool = False,
            render_weights: bool = False, render_pcd_direct: bool = False,
            calc_min_max: bool = True, frame=None,
            mesh=None) -> Dict[str, Any]:
    """warp -> aggregate -> composite for one chunk of rays. ``frame``: a
    precomputed ``prepare_frame`` output shared across chunks.

    ``mesh`` (``parallel.mesh``): every rank passes the whole batch, warps
    the cloud and samples and compacts the rays whole, so every budget is
    the global batch's and the surviving samples are the single-device
    run's; the k-NN kernels, ``feat_net`` and the heads run on the rank's
    block of the slots and are all-gathered before the scatter back
    (``parallel.mesh.shard_rows``)."""
    cfg = model.cfg
    wout = frame if frame is not None else prepare_frame(
        model, state, t=t, rot_params=rot_params, query_radius=query_radius,
        calc_min_max=calc_min_max)
    agg = aggregate_pts(model, state, wout, rays_o, rays_d, viewdirs, near,
                        far, query_radius,
                        render_pcd_direct=render_pcd_direct,
                        render_weights=render_weights, mesh=mesh)
    thres = cfg.fast_color_thres

    def ray_weights(alpha):
        valid = agg["valid"]
        if thres > 0:
            valid = valid & (alpha > thres)
        weights, alphainv_last = alpha2weights(alpha, valid)
        if thres > 0:
            weights = torch.where(weights > thres, weights,
                                  torch.zeros_like(weights))
        return weights, alphainv_last

    weights, alphainv_last = ray_weights(agg["alpha"])
    out = {
        "t_hat_pcd": wout["xyz"],
        "rgb_marched": composite(weights, agg["rgb"], bg=bg,
                                 alphainv_last=alphainv_last),
        "alphainv_last": alphainv_last,
        "weights_per_sample": weights,
        "thetas": wout["thetas"],
        "global_t": wout["global_t"],
        "joints_rel": wout["joints_rel"],
        "joints_warped": wout["joints_warped"],
        "lbs_weights": wout["lbs_weights"],
        "budget_audit": agg["budget_audit"],
        "knn_path": agg["knn_path"],
    }
    if render_depth:
        out["depth"] = composite(weights, agg["step_id"])
    if render_pcd_direct:
        wd, ainv_d = ray_weights(agg["alpha_direct"])
        out["rgb_marched_direct"] = composite(wd, agg["rgb_direct"], bg=bg,
                                              alphainv_last=ainv_d)
        out["alphainv_last_direct"] = ainv_d
    if render_weights and "lbs_w" in agg:
        out["lbs_w_per_sample"] = agg["lbs_w"]
        out["weights_for_render"] = weights
        out["alphainv_for_render"] = alphainv_last
    return out


FILL_KEYS = ("active_demand", "active_budget", "pass_demand", "pass_budget")


def budget_fill(rows: torch.Tensor) -> torch.Tensor:
    """How full the static budgets ran over the ``budget_audit`` rows
    ``rows`` [..., 4] (active demand, active budget, passing demand,
    passing budget): [4], summed over the rows, of min(active demand,
    active budget), the active budget, min(passing demand, passing
    budget) and the passing budget (``FILL_KEYS``)."""
    r = rows.reshape(-1, 2, 2)
    return torch.minimum(r, r[..., 1:]).sum(0).reshape(4)


def project_points(points: torch.Tensor, c2w: torch.Tensor,
                   K: torch.Tensor) -> torch.Tensor:
    """3D -> 2D projection: points [N, 3], c2w [4, 4], K [3, 3] -> [N, 2]
    pixel coordinates."""
    w2c = torch.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    pix = cam @ K.T
    return pix[:, :2] / pix[:, 2:]


@torch.no_grad()
def simplify_skeleton(model: TemporalPoints, state, times,
                      deg_threshold: float = 10.0,
                      five_percent_heuristic: bool = False):
    """Prune zero-motion bones and merge same-motion siblings.

    ``times``: [T] train times. Returns (new_state, info): the new state
    carries the updated ``rot_mask`` / ``sibling_mask`` / ``merge_mat``
    (``get_weights`` and ``warp`` read them), ``info`` the joints and bones
    before and after, for rendering and reporting."""
    cfg = model.cfg
    J = cfg.n_joints
    dev = state["canonical_pcd"].device
    tt = torch.as_tensor(np.asarray(times, np.float32), device=dev)
    t_embed = encoding.poc_fre(tt.reshape(-1, 1),
                               encoding.poc_freqs(cfg.timebase_pe, dev))
    p = point_warper.transform_params(model.forward_warp, t_embed)
    T = tt.shape[0]                                      # p: [T, J+1, 4]
    if cfg.over_parameterized_rot:
        rot_angles = p[:, :J, -1].cpu().numpy()
        R, _ = rodrigues(p[:, :J, :].reshape(-1, 4))
    else:
        rot_angles = (np.sqrt((p[:, :J, :3].cpu().numpy() ** 2).sum(-1))
                      % (2 * np.pi))
        R, _ = rodrigues(p[:, :J, :3].reshape(-1, 3))
    R = R.reshape(T, J, 3, 3).cpu().numpy()

    # pairwise rotation similarity through the relative geodesic angle
    rel = np.einsum("tiab,tjcb->tijac", R, R)            # R_i R_j^T
    ang = np.linalg.norm(
        rotmat_to_rotvec(torch.as_tensor(rel.reshape(-1, 3, 3))).numpy(),
        axis=-1).reshape(T, J, J)
    if five_percent_heuristic:
        th_count = int(T * 0.05)
        sim = (np.rad2deg(ang) >= deg_threshold).sum(0) <= th_count
        zero_motion = ((np.rad2deg(np.abs(rot_angles)) >= deg_threshold)
                       .sum(0) <= th_count)
    else:
        deg_std = np.rad2deg(np.sqrt((ang ** 2).mean(0)))
        sim = deg_std <= deg_threshold
        # the reference's average heuristic takes no square root
        zero_motion = np.rad2deg((rot_angles ** 2).mean(0)) <= deg_threshold
    np.fill_diagonal(sim, True)

    prune = zero_motion.copy()
    prune[0] = False                                     # never the root

    joints_np = model.joints.detach().cpu().numpy()
    bones = [list(map(int, b)) for b in np.asarray(state["bones"])]
    (new_joints, new_bones, merging_rules, joints_to_keep, rotations_to_keep,
     _, sibling_rules) = merge_joints(
        joints_np, bones, prune, sim, convert_merging_rules=False)

    flat = np.asarray(flatten_merging_rules(merging_rules))
    merge_mat = np.zeros((J, J), np.float32)
    merge_mat[np.arange(J), flat] = 1.0                  # columns sum weights

    new_state = dict(state)
    new_state["rot_mask"] = state["rot_mask"] | torch.as_tensor(prune,
                                                                device=dev)
    new_state["sibling_mask"] = torch.as_tensor(
        sibling_rules.astype(np.int64), device=dev)
    new_state["merge_mat"] = torch.as_tensor(merge_mat, device=dev)
    info = {
        "prune_bones": prune, "merging_rules": merging_rules,
        "joints_to_keep": joints_to_keep, "new_joints": new_joints,
        "new_bones": new_bones, "rotations_to_keep": rotations_to_keep,
        "old_joints": joints_np, "old_bones": bones,
    }
    return new_state, info


# ----------------------------------------------------------------------
# The training losses (reference lib/temporalpoints.py:714-800)
# ----------------------------------------------------------------------

def neighbour_rows(x, nn_i) -> torch.Tensor:
    """``x[nn_i]`` for the k-NN indices ``nn_i [P, k]`` through
    ``index_select``, whose backward sums each row's k gradients with
    ``index_add_``, in a fixed order on the CPU. Indexing's backward is
    ``index_put_(accumulate=True)``, which on the CPU adds from several
    threads at once above 32,768 elements, so that two runs of a step
    differ in the last bits."""
    rows = x.index_select(0, nn_i.reshape(-1))
    return rows.reshape(*nn_i.shape, *x.shape[1:])


def arap_loss(state, warped_pcd, eps: float = 1e-6) -> torch.Tensor:
    """As-rigid-as-possible: summed change of the canonical k-NN distances
    after the warp."""
    nn = neighbour_rows(warped_pcd, state["nn_i"])
    warped_nn = torch.sqrt(((warped_pcd[:, None, :] - nn) ** 2).sum(-1)
                           + eps)
    return (state["nn_distance"] - warped_nn).abs().sum()


def neighbour_weight_tv_loss(state, lbs_weights) -> torch.Tensor:
    """Mean absolute skinning-weight difference to the k-NN neighbours."""
    nn = neighbour_rows(lbs_weights, state["nn_i"])
    return (lbs_weights[:, None, :] - nn).abs().mean()


def weight_sparsity_loss(lbs_weights, eps: float = 1e-6) -> torch.Tensor:
    """Binary entropy of the skinning weights."""
    w = lbs_weights
    return -(w * torch.log(w + eps)
             + (1 - w) * torch.log(1 - w + eps)).mean()


def transformation_reg_loss(global_t, thetas) -> torch.Tensor:
    """L1 of the global translation and the joint angles, per joint."""
    return (global_t.abs().sum() + thetas.abs().sum()) / thetas.shape[0]


def joint_chamfer_loss(state, joints) -> torch.Tensor:
    """Summed squared distance of each joint to the skeleton voxels."""
    d = ((joints[:, None, :] - state["skeleton_pcd"][None]) ** 2).sum(-1)
    return d.amin(1).sum()


def batch_chamfer_2d(projected, mask_pts) -> torch.Tensor:
    """Symmetric chamfer between projected points [V, N, 2] and mask
    pixels [V, M, 2] (reference get_batch_chamfer_loss)."""
    d = ((projected[:, :, None, :] - mask_pts[:, None, :, :]) ** 2).sum(-1)
    return d.amin(2).mean() + d.amin(1).mean()
