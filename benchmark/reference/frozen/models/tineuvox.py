"""The TiNeuVox backbone (port of ``apnerf/models/tineuvox.py``).

``TiNeuVox`` holds the parameters under the JAX package's top-level keys
(``feature``, ``timenet``, ``camnet``, ``deformation_net``, ``featurenet``,
``densitynet``, ``rgbnet``), so the ``lrate_<key>`` optimizer grouping and
``utils.checkpoint`` carry over. ``feature`` is the voxel grid
``[X, Y, Z, C]``, channels last. The model's ``cfg`` is a
``TiNeuVoxConfig``; ``scale_volume_grid`` replaces both.

``forward`` renders a batch of rays in one of three layouts: the
coarse-group occupancy pipeline (``occ_grid``, ``active_budget`` and
``occ_group > 1``), per-sample compaction (``active_budget`` alone) and
the dense ``[rays, steps]`` layout. The JAX package's budget chunking and
fusion barriers are TPU compiler workarounds and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..ops import compaction, encoding
from ..ops.activation import raw2alpha
from ..ops.consts import device_vector
from ..ops.grid import mult_dist_interp, resize_trilinear, \
    total_variation_grad
from ..ops.marching import alpha2weights, composite
from ..ops.nn import MLP, init_linear_
from ..ops.rays import max_n_steps, ray_aabb, sample_pts_on_rays, \
    vector_norm
from ..parallel import mesh as pmesh

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TiNeuVoxConfig:
    """Static model configuration: the reference constructor's kwargs plus
    the derived grid geometry (the JAX package's ``TiNeuVoxConfig``)."""
    xyz_min: Tuple[float, float, float]
    xyz_max: Tuple[float, float, float]
    num_voxels: int
    num_voxels_base: int
    voxel_dim: int = 12
    defor_depth: int = 5
    net_width: int = 128
    posbase_pe: int = 10
    viewbase_pe: int = 4
    timebase_pe: int = 8
    gridbase_pe: int = 2
    alpha_init: float = 1e-3
    fast_color_thres: float = 1e-4
    no_view_dir: bool = False
    add_cam: bool = False
    feat_only: bool = False
    # one occupancy lookup per ``occ_group`` consecutive ray steps, at the
    # group centre, against a grid with one extra dilation
    occ_group: int = 4
    # bf16 deformation / featurenet activations and weights (the
    # parameters stay fp32)
    mlp_bf16: bool = False

    @property
    def extent(self):
        return (np.asarray(self.xyz_max, np.float64)
                - np.asarray(self.xyz_min, np.float64))

    @property
    def voxel_size(self) -> float:
        return float((self.extent.prod() / self.num_voxels) ** (1.0 / 3.0))

    @property
    def voxel_size_base(self) -> float:
        return float((self.extent.prod() / self.num_voxels_base)
                     ** (1.0 / 3.0))

    @property
    def voxel_size_ratio(self) -> float:
        return self.voxel_size / self.voxel_size_base

    @property
    def world_size(self) -> Tuple[int, int, int]:
        ws = (self.extent / self.voxel_size).astype(np.int64)
        return tuple(int(x) for x in ws)

    @property
    def act_shift(self) -> float:
        return float(np.log(1.0 / (1.0 - self.alpha_init) - 1.0))

    @property
    def times_ch(self) -> int:
        return 1 + 2 * self.timebase_pe

    @property
    def views_ch(self) -> int:
        return 0 if self.no_view_dir else 3 + 3 * self.viewbase_pe * 2

    @property
    def rgb_views_ch(self) -> int:
        """The colour head's view channels: the view encoding, and with
        ``add_cam`` camnet's output beside it, as the reference TiNeuVox
        sizes its RGBNet (the JAX package's head omits camnet's channels,
        so its add_cam forward fails on the shape)."""
        if self.no_view_dir or not self.add_cam:
            return self.views_ch
        return self.views_ch + self.timenet_output

    @property
    def pts_ch(self) -> int:
        return 3 + 3 * self.posbase_pe * 2

    @property
    def timenet_output(self) -> int:
        return self.voxel_dim + self.voxel_dim * 2 * self.gridbase_pe

    @property
    def grid_ch(self) -> int:
        g = self.voxel_dim * 3
        return g + g * 2 * self.gridbase_pe

    @property
    def featurenet_input(self) -> int:
        if self.feat_only:
            return self.grid_ch
        return self.grid_ch + self.timenet_output + self.pts_ch

    def n_samples(self, stepsize: float) -> int:
        """Global sample count, the distortion loss normaliser."""
        ws = np.asarray(self.world_size, np.float64)
        return int(np.linalg.norm(ws + 1) / stepsize) + 1

    def max_steps(self, stepsize: float) -> int:
        """Static per-ray sample budget: bbox diagonal / step distance."""
        return max_n_steps(self.xyz_min, self.xyz_max,
                           stepsize * self.voxel_size)

    def with_num_voxels(self, num_voxels: int) -> "TiNeuVoxConfig":
        return dataclasses.replace(self, num_voxels=num_voxels)

    def get_kwargs(self) -> Dict[str, Any]:
        """Checkpoint-reconstruction kwargs (the JAX package's, with
        ``mlp_bf16`` and ``occ_group``)."""
        return {
            "xyz_min": tuple(self.xyz_min), "xyz_max": tuple(self.xyz_max),
            "num_voxels": self.num_voxels,
            "num_voxels_base": self.num_voxels_base,
            "alpha_init": self.alpha_init,
            "fast_color_thres": self.fast_color_thres,
            "voxel_dim": self.voxel_dim, "defor_depth": self.defor_depth,
            "net_width": self.net_width, "posbase_pe": self.posbase_pe,
            "viewbase_pe": self.viewbase_pe, "timebase_pe": self.timebase_pe,
            "gridbase_pe": self.gridbase_pe, "add_cam": self.add_cam,
            "no_view_dir": self.no_view_dir, "feat_only": self.feat_only,
            "mlp_bf16": self.mlp_bf16, "occ_group": self.occ_group,
        }


class RGBNet(nn.Module):
    """``feature_linears`` (width -> width), then ``views_linears``
    (width + views_ch -> width // 2 -> 3, ReLU between)."""

    def __init__(self, width: int, views_ch: int, device=None):
        super().__init__()
        self.feature_linears = nn.Linear(width, width, device=device)
        self.views_linears = MLP([width + views_ch, width // 2, 3],
                                 device=device)

    def reset_parameters_(self, generator: torch.Generator) -> "RGBNet":
        init_linear_(self.feature_linears, generator)
        self.views_linears.reset_parameters_(generator)
        return self

    def forward(self, h: torch.Tensor,
                views_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        feat = self.feature_linears(h)
        if views_emb is not None:
            feat = torch.cat([feat, views_emb], dim=-1)
        return self.views_linears(feat)


class TiNeuVox(nn.Module):
    """Stage-1 parameters (names as the JAX pytree's keys) and ``cfg``."""

    def __init__(self, cfg: TiNeuVoxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        W = cfg.net_width
        self.feature = nn.Parameter(torch.zeros(
            (*cfg.world_size, cfg.voxel_dim), dtype=F32, device=device))
        self.timenet = MLP([cfg.times_ch, W, cfg.timenet_output],
                           device=device)
        self.camnet = (MLP([cfg.times_ch, W, cfg.timenet_output],
                           device=device) if cfg.add_cam else None)
        self.deformation_net = MLP(
            [cfg.pts_ch + cfg.timenet_output] + [W] * (cfg.defor_depth - 1)
            + [3], device=device)
        self.featurenet = MLP([cfg.featurenet_input, W],
                              final_activation="relu", device=device)
        self.densitynet = MLP([W, 1], device=device)
        self.rgbnet = RGBNet(W, cfg.rgb_views_ch, device)

    def reset_parameters_(self, generator: torch.Generator) -> "TiNeuVox":
        """Zero grid; every network drawn from ``generator`` with the
        ``torch.nn.Linear`` bounds (the JAX package's init, not its
        numbers)."""
        with torch.no_grad():
            self.feature.zero_()
        for net in (self.timenet, self.camnet, self.deformation_net,
                    self.featurenet, self.densitynet, self.rgbnet):
            if net is not None:
                net.reset_parameters_(generator)
        return self

    def forward(self, rays_o, rays_d, viewdirs, times_sel, near, far,
                stepsize, bg, n_max_steps, **kwargs):
        return forward(self, rays_o, rays_d, viewdirs, times_sel, near, far,
                       stepsize, bg, n_max_steps, **kwargs)


def init_model(cfg: TiNeuVoxConfig, generator: torch.Generator,
               device=None) -> TiNeuVox:
    """A fresh stage-1 model, networks drawn from ``generator``, on
    ``device`` (``None``: the CUDA device; raises without one)."""
    return TiNeuVox(cfg).reset_parameters_(generator).to(
        resolve_device(device))


def _act_dtype(cfg: TiNeuVoxConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.mlp_bf16 else F32


def _bbox(cfg: TiNeuVoxConfig, device):
    return (device_vector(cfg.xyz_min, device),
            device_vector(cfg.xyz_max, device))


def apply_deformation(net: MLP, pts_emb, t_feature, act_dt=F32):
    """The deformation MLP's offset added to the raw xyz (the first 3
    channels of the PE); the MLP runs in ``act_dt``, the sum in fp32."""
    h = torch.cat([pts_emb, t_feature], -1)
    dt = None if act_dt == F32 else act_dt
    dx = net(h.to(act_dt), dtype=dt)
    return pts_emb[..., :3] + dx.float()


def query_density_features(model: TiNeuVox, pts, times_feature,
                           canonical: bool = False):
    """PE, deformation, multi-scale grid interp, featurenet: ``pts
    [..., 3]`` -> (h [..., W] fp32, warped pts [..., 3]). ``canonical``:
    no deformation, the grid is read at ``pts``."""
    cfg = model.cfg
    dev = pts.device
    act_dt = _act_dtype(cfg)
    pts_emb = encoding.poc_fre(pts, encoding.poc_freqs(cfg.posbase_pe, dev))
    pts_delta = pts if canonical else apply_deformation(
        model.deformation_net, pts_emb, times_feature, act_dt)
    lo, hi = _bbox(cfg, dev)
    vox_feat = mult_dist_interp(model.feature, pts_delta, lo, hi)
    vox_emb = encoding.poc_fre(vox_feat,
                               encoding.poc_freqs(cfg.gridbase_pe, dev))
    if cfg.feat_only:
        h_in = vox_emb
    else:
        h_in = torch.cat([vox_emb, pts_emb, times_feature], -1)
    h = model.featurenet(h_in.to(act_dt),
                         dtype=None if act_dt == F32 else act_dt)
    return h.float(), pts_delta


def time_feature(model: TiNeuVox, times_sel):
    t_emb = encoding.poc_fre(times_sel, encoding.poc_freqs(
        model.cfg.timebase_pe, times_sel.device))
    return model.timenet(t_emb)


def _views_emb(model: TiNeuVox, viewdirs, cam_sel=None):
    """The colour head's view input: the view encoding and, with
    ``add_cam``, ``camnet`` of the encoded camera ids ``cam_sel [N, 1]``
    beside it; None with ``no_view_dir``."""
    cfg = model.cfg
    if cfg.no_view_dir:
        return None
    dev = viewdirs.device
    v_emb = encoding.poc_fre(viewdirs, encoding.poc_freqs(cfg.viewbase_pe,
                                                          dev))
    if cfg.add_cam:
        if cam_sel is None:
            # the JAX package fails inside poc_fre here; no trainer or
            # renderer of either package passes camera ids
            raise ValueError("add_cam: the colour head takes camnet's "
                             "features of the camera ids, so forward needs "
                             "cam_sel [N, 1]")
        cam_emb = encoding.poc_fre(cam_sel.float(), encoding.poc_freqs(
            cfg.timebase_pe, dev))
        v_emb = torch.cat([v_emb, model.camnet(cam_emb)], -1)
    return v_emb


def _heads(model: TiNeuVox, h, views, interval):
    density = model.densitynet(h)[..., 0]
    alpha = raw2alpha(density, model.cfg.act_shift, interval)
    rgb = torch.sigmoid(model.rgbnet(h, views))
    return alpha, rgb


def _spread_unfilled(ray: torch.Tensor, filled: torch.Tensor,
                     N: int) -> torch.Tensor:
    """Ray of each budget slot; the unfilled slots, whose results are
    masked out, go round the N rays instead of all to the last one as in
    the JAX package: hundreds of thousands of equal indices would make the
    backward of the ray-table gathers one serial sum."""
    slot = torch.arange(ray.shape[0], device=ray.device)
    return torch.where(filled, ray, slot % N)


def _active_pipeline(model: TiNeuVox, pts_act, tfeat_act, views_act,
                     filled, interval):
    """Deformation + grid interp + heads on the compacted samples."""
    h, pts_delta = query_density_features(model, pts_act, tfeat_act)
    alpha, rgb = _heads(model, h, views_act, interval)
    alpha = torch.where(filled, alpha, torch.zeros_like(alpha))
    return alpha, rgb, pts_delta


def forward(model: TiNeuVox, rays_o, rays_d, viewdirs, times_sel, near, far,
            stepsize, bg, n_max_steps: int, occ_grid=None,
            active_budget=None, cam_sel=None, mesh=None) -> Dict[str, Any]:
    """Volume render rays ``[N, 3]`` at times ``[N, 1]`` with
    ``n_max_steps`` samples a ray (``cfg.max_steps(stepsize)``).

    ``occ_grid`` [X', Y', Z'] bool prunes samples in empty cells;
    ``active_budget`` runs only that many valid samples through the
    networks; ``cam_sel`` [N, 1], the camera ids, is needed with
    ``add_cam``. Per-sample outputs are [N, S].

    ``mesh`` (``parallel.mesh``): every rank passes the whole batch and
    samples and compacts it whole, so the budget is the global batch's and
    the surviving slots are the single-device run's; the deformation, the
    grid gather and the heads run on the rank's block of the slots (of
    the rays without a budget) and are all-gathered
    (``parallel.mesh.shard_rows``)."""
    cfg = model.cfg
    N = rays_o.shape[0]
    dev = rays_o.device
    tfeat = time_feature(model, times_sel)                         # [N, Ct]
    stepdist = stepsize * cfg.voxel_size
    lo, hi = _bbox(cfg, dev)
    S = n_max_steps
    interval = stepsize * cfg.voxel_size_ratio
    step_id = torch.arange(S, dtype=torch.int32, device=dev).expand(N, S)
    M_full = N * S
    # group size for the occupancy test: the group half-width must stay
    # within one occupancy cell (= voxel_size) for the centre test against
    # the extra-dilated grid to be conservative
    G = int(cfg.occ_group)
    if G > 1 and (active_budget is None or occ_grid is None
                  or stepsize * (G - 1) / 2.0 > 1.0):
        G = 1

    if active_budget is not None and occ_grid is not None and G > 1:
        # coarse groups: one occupancy lookup per G steps, group-level
        # compaction, member positions recomputed from the ray table
        SG = (S + G - 1) // G
        t_min, t_max = ray_aabb(rays_o, rays_d, lo, hi, near, far)
        n_steps_r = torch.clamp(torch.ceil((t_max - t_min) / stepdist),
                                min=1.0).to(torch.int64)
        rays_start = rays_o + rays_d * t_min[:, None]
        unit_d = rays_d / vector_norm(rays_d)
        gsteps = torch.arange(SG, device=dev)
        gcentre_t = (gsteps.float() * G + (G - 1) / 2.0) * stepdist
        centre = (rays_start[:, None, :]
                  + unit_d[:, None, :] * gcentre_t[None, :, None])
        # clamp, not reject: a group whose centre lies just outside the
        # bbox may still have members inside
        centre = torch.maximum(torch.minimum(centre, hi), lo)
        occ_g = compaction.occupancy_lookup_xyz(occ_grid, lo, hi, centre)
        valid_g = occ_g & (gsteps[None, :] * G < n_steps_r[:, None])
        budget_g = -(-int(active_budget) // G)
        A = budget_g * G
        src_g, filled_g = compaction.compact_flat(valid_g.reshape(N * SG),
                                                  budget_g)
        ray_g = _spread_unfilled(src_g // SG, filled_g, N)
        g_of = torch.clamp(src_g % SG, max=SG - 1)
        member = torch.arange(G, device=dev)
        t_mem = (g_of[:, None].float() * G + member.float()) * stepdist
        pts_act = (rays_start[ray_g][:, None, :]
                   + unit_d[ray_g][:, None, :] * t_mem[..., None]
                   ).reshape(A, 3)
        step_act = (g_of[:, None] * G + member).reshape(-1)
        in_bb = ((pts_act >= lo) & (pts_act <= hi)).all(-1)
        ns_act = n_steps_r[ray_g].repeat_interleave(G)
        filled = filled_g.repeat_interleave(G) & in_bb & (step_act < ns_act)
        ray_of = ray_g.repeat_interleave(G)
        src = torch.where(filled, ray_of * S + step_act,
                          torch.full_like(step_act, M_full))
        tfeat_act = tfeat[ray_of]
    elif active_budget is not None:
        # per-sample compaction
        samples = sample_pts_on_rays(rays_o, rays_d, lo, hi, near, far,
                                     stepdist, S)
        valid = samples.valid
        if occ_grid is not None:
            valid = valid & compaction.occupancy_lookup_xyz(
                occ_grid, lo, hi, samples.pts)
        src, filled = compaction.compact_flat(valid.reshape(M_full),
                                              int(active_budget))
        pts_pad = torch.cat([samples.pts.reshape(M_full, 3),
                             torch.zeros(1, 3, device=dev)], 0)
        pts_act = pts_pad[src]
        ray_of = _spread_unfilled(src // S, filled, N)
        tfeat_act = tfeat[ray_of]

    v_emb = _views_emb(model, viewdirs, cam_sel)
    if active_budget is not None:
        views_act = None if v_emb is None else v_emb[ray_of]
        alpha_act, rgb_act, pts_delta = pmesh.shard_rows(
            mesh, lambda *a: _active_pipeline(model, *a, interval),
            pts_act, tfeat_act, views_act, filled)
        alpha = compaction.scatter_back(alpha_act, src, M_full).reshape(N, S)
        rgb = compaction.scatter_back(rgb_act, src, M_full).reshape(N, S, 3)
        valid = compaction.scatter_back(filled, src, M_full,
                                        fill=False).reshape(N, S)
    else:
        samples = sample_pts_on_rays(rays_o, rays_d, lo, hi, near, far,
                                     stepdist, S)
        valid = samples.valid
        if occ_grid is not None:
            valid = valid & compaction.occupancy_lookup_xyz(
                occ_grid, lo, hi, samples.pts)
        tfeat_b = tfeat[:, None, :].expand(N, S, tfeat.shape[-1])
        views = (None if v_emb is None
                 else v_emb[:, None, :].expand(N, S, v_emb.shape[-1]))

        def dense(pts, tf, vw):
            h, delta = query_density_features(model, pts, tf)
            return (*_heads(model, h, vw, interval), delta)

        alpha, rgb, pts_delta = pmesh.shard_rows(mesh, dense, samples.pts,
                                                 tfeat_b, views)

    thres = cfg.fast_color_thres
    if thres > 0:
        valid = valid & (alpha > thres)
    weights, alphainv_last = alpha2weights(alpha, valid)
    if thres > 0:
        weights = torch.where(weights > thres, weights,
                              torch.zeros_like(weights))
    rgb_marched = composite(weights, rgb, bg=bg, alphainv_last=alphainv_last)
    depth = composite(weights, step_id.float())
    n_samples_global = cfg.n_samples(stepsize)
    out = {
        "rgb_marched": rgb_marched,
        "depth": depth.detach(),
        "alphainv_last": alphainv_last,
        "weights": weights,
        "raw_alpha": alpha,
        "raw_rgb": rgb,
        "valid": valid,
        "s": (step_id.float() + 0.5) / n_samples_global,
        "n_max": n_samples_global,
        "ray_pts_delta": pts_delta,
    }
    return out


def ray_density(model: TiNeuVox, rays_o, rays_d, times_sel, near, far,
                stepsize, n_max_steps: int) -> Dict[str, Any]:
    """Density-only render of rays ``[N, 3]`` at times ``[N, 1]`` (the
    reference ``TiNeuVox.ray_density``): the grid read at the raw sample
    points, without the deformation, and no colour head -> ``weights``,
    ``s``, ``n_max``, ``valid`` ([N, S] where per sample)."""
    cfg = model.cfg
    N = rays_o.shape[0]
    S = n_max_steps
    tfeat = time_feature(model, times_sel)
    lo, hi = _bbox(cfg, rays_o.device)
    samples = sample_pts_on_rays(rays_o, rays_d, lo, hi, near, far,
                                 stepsize * cfg.voxel_size, S)
    tfeat_b = tfeat[:, None, :].expand(N, S, tfeat.shape[-1])
    h, _ = query_density_features(model, samples.pts, tfeat_b,
                                  canonical=True)
    density = model.densitynet(h)[..., 0]
    alpha = raw2alpha(density, cfg.act_shift,
                      stepsize * cfg.voxel_size_ratio)
    valid = samples.valid
    thres = cfg.fast_color_thres
    if thres > 0:
        valid = valid & (alpha > thres)
    weights, _ = alpha2weights(alpha, valid)
    if thres > 0:
        weights = torch.where(weights > thres, weights,
                              torch.zeros_like(weights))
    n_samples_global = cfg.n_samples(stepsize)
    return {"weights": weights,
            "s": (samples.step_id.float() + 0.5) / n_samples_global,
            "n_max": n_samples_global, "valid": valid}


# --------------------------------------------------------------------------
# dense grid evaluation, progressive scaling, TV
# --------------------------------------------------------------------------

def grid_xyz_coords(cfg: TiNeuVoxConfig, sampling_freq: float = 1.0,
                    world_size=None) -> np.ndarray:
    """World coordinates [X, Y, Z, 3] of a grid spanning the bbox with
    ``world_size`` (default the model's) times ``sampling_freq`` nodes an
    axis (reference ``get_grid_xyz``)."""
    ws = world_size or cfg.world_size
    axes = [np.linspace(cfg.xyz_min[d], cfg.xyz_max[d],
                        int(ws[d] * sampling_freq)) for d in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).astype(np.float32)


@torch.no_grad()
def eval_alpha_volume(model: TiNeuVox, grid_xyz, time_sel, stepsize,
                      canonical: bool = False, batch: int = 2 ** 18,
                      want_features: bool = False, viewdir=None):
    """Alpha at the points ``grid_xyz [..., 3]`` at one time, ``batch``
    points at a time; numpy in and out. ``canonical``: without the
    deformation. ``want_features``: also the rgb (seen from ``viewdir``,
    zeros when None) and the featurenet output ``h`` -> (alpha [...],
    rgb [..., 3], feat [..., W]); reference ``get_grid_as_point_cloud``."""
    cfg = model.cfg
    dev = model.feature.device
    shape = np.asarray(grid_xyz).shape[:-1]
    pts_all = torch.as_tensor(np.asarray(grid_xyz, np.float32).reshape(-1, 3))
    tfeat = time_feature(model, torch.full((1, 1), float(time_sel),
                                           device=dev))
    interval = stepsize * cfg.voxel_size_ratio
    ve = None
    if want_features and cfg.add_cam and not cfg.no_view_dir:
        # the colour head takes camera ids that a point of the grid has
        # not; the JAX package fails on the head's shape here
        raise ValueError("add_cam: eval_alpha_volume has no camera ids for "
                         "the colour head")
    if want_features and not cfg.no_view_dir:
        vd = torch.as_tensor(np.zeros(3, np.float32) if viewdir is None
                             else np.asarray(viewdir, np.float32),
                             device=dev).reshape(1, 3)
        ve = encoding.poc_fre(vd, encoding.poc_freqs(cfg.viewbase_pe, dev))
    alphas, rgbs, feats = [], [], []
    for i in range(0, pts_all.shape[0], batch):
        pts = pts_all[i:i + batch].to(dev)
        h, _ = query_density_features(model, pts,
                                      tfeat.expand(pts.shape[0], -1),
                                      canonical=canonical)
        density = model.densitynet(h)[..., 0]
        alphas.append(raw2alpha(density, cfg.act_shift, interval).cpu())
        if want_features:
            rgbs.append(torch.sigmoid(model.rgbnet(
                h, None if ve is None else ve.expand(pts.shape[0], -1)))
                .cpu())
            feats.append(h.cpu())
    alpha = torch.cat(alphas).numpy().reshape(shape)
    if not want_features:
        return alpha
    return (alpha, torch.cat(rgbs).numpy().reshape(*shape, -1),
            torch.cat(feats).numpy().reshape(*shape, -1))


@torch.no_grad()
def scale_volume_grid(model: TiNeuVox, num_voxels: int) -> TiNeuVox:
    """Trilinear align-corners resize of the feature grid to the
    resolution of ``num_voxels``; replaces ``model.feature`` and
    ``model.cfg`` (an optimizer built before must be rebuilt)."""
    new_cfg = model.cfg.with_num_voxels(num_voxels)
    model.feature = nn.Parameter(resize_trilinear(
        model.feature.float(), new_cfg.world_size))
    model.cfg = new_cfg
    return model


@torch.no_grad()
def feature_tv_grad(model: TiNeuVox, weight: float, photo_grad, dense: bool):
    """The feature grid's TV gradient with the reference's caller-side
    scaling (``weight * max(world_size) / 128``). ``dense`` False: only
    entries whose photometric gradient is nonzero receive it (the CUDA
    kernel's ``grad != 0`` skip, channel included). Add it to the gradient
    after the backward."""
    w = weight * max(model.cfg.world_size) / 128.0
    g = total_variation_grad(model.feature.float(), w)
    if dense:
        return g
    return torch.where(photo_grad != 0.0, g, torch.zeros_like(g))
