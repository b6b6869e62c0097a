"""The reference of a stage-2 training step: the frozen plain path.

``build_model``, ``project_views`` and the loss of ``loss_fn`` are copies
of the program's ``train/stage2.py`` when the benchmark was defined, on
the frozen modules of ``frozen/`` (every kernel its plain version). The
reference builds the model from the scene and the seed as ``train_pcd``
does, and runs the steps eagerly with the rows the program drew: the
time, the cameras and pixels of the rays, the chamfer views, the mask
points and the cloud rows. It reads the rays' colours and masks from its
own copy of the images, and reports where the program's differ.

``half_batch`` is a fault planted in the reference put in the program's
place: the loss over the first half of the rays only.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .frozen.data import rays as raydata
from .frozen.models import temporal_points as tp
from .frozen.models.tineuvox import TiNeuVoxConfig
from .frozen.train.masked_adam import MaskedAdam
from .frozen.utils.checkpoint import params_to_jax

class AttrDict(dict):
    """A mapping whose keys read as attributes (nested ones too)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @classmethod
    def of(cls, d):
        if isinstance(d, dict):
            return cls({k: cls.of(v) for k, v in d.items()})
        return d


def heads_tree(heads: Dict[str, np.ndarray]):
    """The backbone heads (state-dict names) in the JAX pytree layout."""
    return params_to_jax({k: torch.from_numpy(v) for k, v in heads.items()})


def build_model(cfg, canonical, skeleton, tineuvox_params, tineuvox_cfg,
                seed, max_steps, device):
    """``train/stage2.build_model`` (no view-dir freeze, no budget given)."""
    cfg_train = cfg.pcd_train_config
    cfg_model = cfg.pcd_model_and_render
    pcd = np.asarray(canonical["pcd"], np.float32)
    joints = np.asarray(skeleton["joints"], np.float32)
    bones = [list(map(int, b)) for b in skeleton["bones"]]
    wbs = float(cfg_model.world_bound_scale)
    xyz_min = np.asarray(canonical["xyz_min"]) * wbs
    xyz_max = np.asarray(canonical["xyz_max"]) * wbs
    voxel_size = float(canonical["voxel_size"])
    stepsize = float(cfg_model.stepsize)
    diag = float(np.linalg.norm(xyz_max - xyz_min))
    max_steps = max_steps or int(np.ceil(diag / (stepsize * voxel_size))) + 1
    sample_budget = (int(cfg_model.get("sample_budget", 0))
                     or min(192, max_steps))
    sample_budget = min(sample_budget, max_steps)
    dflt = tp.TemporalPointsConfig
    mcfg = tp.TemporalPointsConfig(
        n_points=len(pcd), n_joints=len(joints),
        feat_dim=int(np.asarray(canonical["feat"]).shape[-1]),
        neighbours=8,
        timebase_pe=tineuvox_cfg.timebase_pe,
        posbase_pe=tineuvox_cfg.posbase_pe,
        viewbase_pe=tineuvox_cfg.viewbase_pe,
        stepsize=stepsize, voxel_size=voxel_size,
        voxel_size_ratio=tineuvox_cfg.voxel_size_ratio,
        act_shift=tineuvox_cfg.act_shift,
        fast_color_thres=float(cfg_model.fast_color_thres),
        no_view_dir=tineuvox_cfg.no_view_dir,
        frozen_view_dir=False,
        over_parameterized_rot=bool(cfg_train.over_parameterized_rot),
        avg_procrustes=bool(cfg_train.get("avg_procrustes", False)),
        re_init_mlps=bool(cfg_train.get("re_init_mlps", False)),
        pose_embedding_dim=int(cfg_train.pose_embedding_dim),
        sample_budget=int(sample_budget), max_steps=int(max_steps),
        active_fraction=float(cfg_model.get("active_fraction", 0.30)),
        pass_fraction=float(cfg_model.get("pass_fraction", 0.30)),
        coarse_stride=int(cfg_model.get("coarse_stride",
                                        dflt.coarse_stride)),
        group_pass_fraction=float(cfg_model.get("group_pass_fraction",
                                                dflt.group_pass_fraction)),
        knn_share=int(cfg_model.get("knn_share", dflt.knn_share)),
        knn_cand=int(cfg_model.get("knn_cand", dflt.knn_cand)),
        occ_res=int(cfg_model.get("occ_res", 64)),
        occ_dilations=int(cfg_model.get("occ_dilations", 2)),
        fused_agg=False,
        featmlp_kernel=bool(cfg_model.get("featmlp_train", False)))
    model = tp.init_params(mcfg, pcd, joints, bones, canonical["feat"],
                           canonical["alphas"], canonical["rgbs"],
                           tineuvox_params,
                           torch.Generator().manual_seed(seed),
                           device=device)
    state = tp.init_state(mcfg, pcd, joints, bones, skeleton["skeleton_pcd"],
                          xyz_min, xyz_max, device=device)
    return mcfg, model, state


def project_views(points, poses, Ks):
    w2c = torch.linalg.inv_ex(poses).inverse
    cam = (torch.einsum("vab,nb->vna", w2c[:, :3, :3], points)
           + w2c[:, None, :3, 3])
    pix = torch.einsum("vna,vba->vnb", cam, Ks)
    return pix[..., :2] / pix[..., 2:]


def loss_fn(model, state, cfg_train, Ks, poses, H, W, near, far, bg,
            n_chamfer_views, flips, batch, half_batch=False):
    """(loss, terms, budget audit row) of ``train/stage2.make_loss_fn``."""
    w = {k: float(cfg_train.get(f"weight_{k}", 0)) for k in (
        "render", "arap", "tv", "sparsity", "transformation_reg",
        "joint_chamfer", "chamfer2D")}
    n = batch["cam"].shape[0] // 2 if half_batch else batch["cam"].shape[0]
    ro, rd, vd = raydata.pixels_to_rays(Ks, poses, batch["cam"][:n],
                                        batch["pix"][:n], H, W, **flips)
    res = tp.forward(model, state, ro, rd, vd, t=batch["t"], near=near,
                     far=far, bg=bg)
    terms = {"mse": torch.mean((res["rgb_marched"] - batch["rgb"][:n]) ** 2)}
    loss = torch.zeros((), device=ro.device)
    if w["render"] > 0:
        loss = loss + w["render"] * terms["mse"]
    if w["arap"] > 0:
        terms["arap"] = tp.arap_loss(state, res["t_hat_pcd"])
        loss = loss + w["arap"] * terms["arap"]
    if w["tv"] > 0:
        terms["weight_tv"] = tp.neighbour_weight_tv_loss(
            state, res["lbs_weights"])
        loss = loss + w["tv"] * terms["weight_tv"]
    if w["sparsity"] > 0:
        terms["sparsity"] = tp.weight_sparsity_loss(res["lbs_weights"])
        loss = loss + batch["sparsity_on"] * w["sparsity"] * terms["sparsity"]
    if w["transformation_reg"] > 0:
        terms["trans_reg"] = tp.transformation_reg_loss(res["global_t"],
                                                        res["thetas"])
        loss = loss + w["transformation_reg"] * terms["trans_reg"]
    if w["joint_chamfer"] > 0:
        terms["joint_chamfer"] = tp.joint_chamfer_loss(state, model.joints)
        loss = loss + w["joint_chamfer"] * terms["joint_chamfer"]
    if w["chamfer2D"] > 0 and n_chamfer_views > 0:
        proj = project_views(res["t_hat_pcd"][batch["chamfer_pcd_idx"]],
                             batch["chamfer_poses"], batch["chamfer_Ks"])
        if not flips["inverse_y"]:
            proj = torch.stack([(H - 1) - proj[..., 0], proj[..., 1]], -1)
        proj = proj.flip(-1)
        terms["chamfer2d"] = tp.batch_chamfer_2d(proj,
                                                 batch["chamfer_mask_pts"])
        loss = loss + w["chamfer2D"] * terms["chamfer2d"]
    return loss, terms, res["budget_audit"]


class Setting:
    """The reference's model, optimizer and everything a step reads, built
    from the scene as ``train_pcd`` builds the program's."""

    def __init__(self, cfg: Dict[str, Any], scene, seed: int, device):
        self.cfg = AttrDict.of(cfg)
        self.scene = scene
        self.device = torch.device(device)
        data = scene.data
        self.H, self.W = int(data["HW"][0][0]), int(data["HW"][0][1])
        self.near, self.far = float(data["near"]), float(data["far"])
        self.flips = {k: bool(cfg["data"][k])
                      for k in ("inverse_y", "flip_x", "flip_y")}
        ct = self.cfg.pcd_train_config
        self.bg = float(ct.bg_col)
        times = np.asarray(data["times"])
        unique = np.unique(times)
        n_views_min = min(int((times == t).sum()) for t in unique)
        self.n_chamfer_views = (min(5, n_views_min)
                                if float(ct.get("weight_chamfer2D", 0)) > 0
                                else 0)
        self.weight_start = int(ct.get("weight_start_iter", 0))
        # the image of each (time, camera)
        self.image_of = {(float(np.float32(t)), int(c)): k for k, (t, c) in
                         enumerate(zip(times, data["img_to_cam"]))}
        self.tcfg = TiNeuVoxConfig(**scene.backbone)
        self.seed = seed
        self.Ks = torch.as_tensor(np.asarray(data["Ks"], np.float32),
                                  device=self.device)
        self.poses = torch.as_tensor(np.asarray(data["poses"], np.float32),
                                     device=self.device)

    def build(self):
        mcfg, model, state = build_model(
            self.cfg, self.scene.canonical, self.scene.skeleton,
            heads_tree(self.scene.heads), self.tcfg, self.seed,
            self.cfg.get("max_steps"), self.device)
        return mcfg, model, state

    def pixels(self, img: int, pix: np.ndarray):
        """(rgb [N, 3] float32, mask [N]) of image ``img`` at ``pix``."""
        data = self.scene.data
        rgb = np.asarray(data["images"][img]).reshape(-1, 3)[pix]
        mask = np.asarray(data["masks"][img], np.float32).reshape(-1)[pix]
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.float32) / 255.0
        return rgb.astype(np.float32), mask

    def batch(self, step: int, drawn: Dict[str, Any]):
        """(device batch, mismatches): the program's rows with the
        reference's own colours and masks; ``mismatches`` counts the rays,
        and mask points, where the program's values differ from the
        images'."""
        t = float(np.float32(np.asarray(drawn["t"]).reshape(-1)[0]))
        cam = np.asarray(drawn["cam"], np.int64).reshape(-1)
        pix = np.asarray(drawn["pix"], np.int64).reshape(-1)
        rgb = np.zeros((len(cam), 3), np.float32)
        mask = np.zeros(len(cam), np.float32)
        bad = 0
        for c in np.unique(cam):
            sel = cam == c
            img = self.image_of.get((t, int(c)))
            if img is None:
                bad += int(sel.sum())
                continue
            rgb[sel], mask[sel] = self.pixels(img, pix[sel])
        bad += int((np.abs(rgb - np.asarray(drawn["rgb"], np.float32))
                    .max(-1) > 0).sum())
        bad += int((mask != np.asarray(drawn["mask"], np.float32)
                    .reshape(-1)).sum())
        dev = self.device
        out = {"rgb": torch.as_tensor(rgb, device=dev),
               "mask": torch.as_tensor(mask, device=dev),
               "t": torch.full((1,), t, device=dev),
               "cam": torch.as_tensor(cam, device=dev),
               "pix": torch.as_tensor(pix, device=dev),
               "sparsity_on": torch.tensor(
                   1.0 if step >= self.weight_start else 0.0, device=dev)}
        if self.n_chamfer_views > 0:
            pts = np.asarray(drawn["chamfer_mask_pts"], np.float32)
            poses = np.asarray(drawn["chamfer_poses"], np.float32)
            data = self.scene.data
            # each view's mask points must lie on the mask of the image of
            # this time seen from that view's camera
            for v in range(len(pts)):
                cams = np.nonzero(np.all(np.isclose(
                    np.asarray(data["poses"]), poses[v]), axis=(1, 2)))[0]
                img = next((self.image_of[(t, int(c))] for c in cams
                            if (t, int(c)) in self.image_of), None)
                if img is None:
                    bad += len(pts[v])
                    continue
                m = np.asarray(data["masks"][img], np.float32)[..., 0]
                yx = pts[v].astype(np.int64)
                bad += int((m[yx[:, 0], yx[:, 1]] <= 0).sum())
            out.update(
                chamfer_poses=torch.as_tensor(poses, device=dev),
                chamfer_Ks=torch.as_tensor(np.asarray(
                    drawn["chamfer_Ks"], np.float32), device=dev),
                chamfer_mask_pts=torch.as_tensor(pts, device=dev),
                chamfer_pcd_idx=torch.as_tensor(np.asarray(
                    drawn["chamfer_pcd_idx"], np.int64), device=dev))
        return out, bad


def run_steps(setting: Setting, drawn: List[Dict[str, Any]],
              tf32: bool = False, half_batch: bool = False):
    """The reference's steps on the program's rows -> dict: ``p0`` (the
    starting parameters), ``mcfg``, ``losses``, ``grads1`` (the first step's
    gradient as the optimizer gets it), ``p_end`` (after the last step),
    ``audits`` (each step's budget audit row), ``mismatches``. ``tf32``:
    the control, its matrix products in TF32."""
    mcfg, model, state = setting.build()
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg_train = setting.cfg.pcd_train_config
    opt = MaskedAdam(model, cfg_train)
    out = {"p0": p0, "losses": [], "audits": [], "mismatches": 0,
           "mcfg": mcfg}
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for i, d in enumerate(drawn):
            batch, bad = setting.batch(i + 1, d)
            out["mismatches"] += bad
            opt.advance()
            model.zero_grad(set_to_none=True)
            loss, _, audit = loss_fn(model, state, cfg_train, setting.Ks,
                                     setting.poses, setting.H, setting.W,
                                     setting.near, setting.far, setting.bg,
                                     setting.n_chamfer_views, setting.flips,
                                     batch, half_batch=half_batch)
            loss.backward()
            grads = {n: p.grad for n, p in model.named_parameters()}
            opt.apply(grads)
            out["losses"].append(float(loss.detach()))
            out["audits"].append([int(x) for x in audit.tolist()])
            if i == 0:
                out["grads1"] = {n: (None if g is None else g.detach().clone())
                                 for n, g in grads.items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    out["p_end"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, state, opt
    return out
