"""Stage-2 trainer: the TemporalPoints point model (port of
``apnerf/train/stage2.py``, the reference ``train_pcd``, run.py:417-819).

Time-curriculum sampling with the inverse-proportional time sampler, each
step's rays drawn from one time's contiguous range of the ray index, the
seven-term loss (render MSE, ARAP, skinning-weight TV, weight sparsity
from ``weight_start_iter``, transformation regulariser, joint chamfer, 2D
mask chamfer), autograd through the point model's forward, masked Adam
with per-step lr decay, and mid-stage checkpoints with resume.

Host randomness draws from ``np.random.default_rng(seed)`` and the
sampler's own generator in the JAX package's order, so both packages
train on the same times and rays. The parameters are made by
``init_params`` from a ``torch.Generator``; the JAX package's ``jax.random``
draws differ.

Deliberate differences from the JAX package: the startup budget audit
raises instead of printing "skipped" when it fails (on the card a caught
exception would hide a kernel fault), and a checkpoint also carries the
host random state (``host_rng``), so a run resumed from the port's own
checkpoint takes the same batches as one never interrupted (from the JAX
package's checkpoint, which has none, it starts the generators anew, as
the JAX package does). Not ported yet (raise ``NotImplementedError``): the
multi-device ``mesh`` and the tensorboard previews (``tensorboard_path``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device
from ..data import rays as raydata
from ..models import temporal_points as tp
from ..ops.knn import knn
from ..utils import checkpoint as ckpt
from ..utils.samplers import InverseProportionalSampler, curriculum_window
from .masked_adam import MaskedAdam

CH_M = 3000   # mask pixels a chamfer view
CH_N = 3000   # warped points projected for the chamfer


def build_model(cfg, canonical, skeleton, tineuvox_params, tineuvox_cfg,
                seed=0, frozen_view_dir=None, sample_budget=None,
                max_steps=None, device=None):
    """(model config, ``TemporalPoints``, state) from the export artifacts
    and the backbone, on ``device`` (``None``: the CUDA device; raises
    without one). ``tineuvox_params``: the backbone's parameters in the
    JAX pytree layout (``utils.checkpoint.params_to_jax``), of which the
    heads are copied; ``tineuvox_cfg``: its ``TiNeuVoxConfig``. Kernel K1
    runs in ``init_state``."""
    device = resolve_device(device)
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
    sample_budget = (sample_budget
                     or int(cfg_model.get("sample_budget", 0))
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
        frozen_view_dir=frozen_view_dir is not None,
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
        # K6 has no backward: off in training (the render switches it on
        # from the scene config). K4 has one (the recompute backward) and
        # runs only when the config opts in through featmlp_train.
        fused_agg=False,
        featmlp_kernel=bool(cfg_model.get("featmlp_train", False)))
    model = tp.init_params(mcfg, pcd, joints, bones, canonical["feat"],
                           canonical["alphas"], canonical["rgbs"],
                           tineuvox_params,
                           torch.Generator().manual_seed(seed),
                           device=device)
    state = tp.init_state(mcfg, pcd, joints, bones, skeleton["skeleton_pcd"],
                          xyz_min, xyz_max, frozen_view_dir=frozen_view_dir,
                          device=device)
    return mcfg, model, state


def project_views(points, poses, Ks):
    """Pixel coordinates [V, N, 2] of ``points`` [N, 3] in each camera
    (``poses`` [V, 4, 4] camera-to-world, ``Ks`` [V, 3, 3])."""
    w2c = torch.linalg.inv(poses)
    cam = (torch.einsum("vab,nb->vna", w2c[:, :3, :3], points)
           + w2c[:, None, :3, 3])
    pix = torch.einsum("vna,vba->vnb", cam, Ks)
    return pix[..., :2] / pix[..., 2:]


def make_loss_fn(model: tp.TemporalPoints, state, cfg_train, Ks, poses,
                 H, W, near, far, bg, n_chamfer_views: int, inverse_y=False,
                 flip_x=False, flip_y=False):
    """``loss_fn(batch) -> (loss, metrics)``: the stage-2 forward of the
    batch's rays at its time and the weighted sum of the terms whose
    weight is positive (``metrics`` holds each term and ``mse``)."""
    w_render = float(cfg_train.get("weight_render", 0))
    w_arap = float(cfg_train.get("weight_arap", 0))
    w_tv = float(cfg_train.get("weight_tv", 0))
    w_sparse = float(cfg_train.get("weight_sparsity", 0))
    w_trans = float(cfg_train.get("weight_transformation_reg", 0))
    w_jcham = float(cfg_train.get("weight_joint_chamfer", 0))
    w_cham2d = float(cfg_train.get("weight_chamfer2D", 0))

    def loss_fn(batch):
        ro, rd, vd = raydata.pixels_to_rays(
            Ks, poses, batch["cam"], batch["pix"], H, W,
            inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y)
        res = tp.forward(model, state, ro, rd, vd, t=batch["t"], near=near,
                         far=far, bg=bg)
        metrics: Dict[str, torch.Tensor] = {}
        mse = torch.mean((res["rgb_marched"] - batch["rgb"]) ** 2)
        metrics["mse"] = mse
        loss = torch.zeros((), device=mse.device)
        if w_render > 0:
            loss = loss + w_render * mse
        if w_arap > 0:
            metrics["arap"] = tp.arap_loss(state, res["t_hat_pcd"])
            loss = loss + w_arap * metrics["arap"]
        if w_tv > 0:
            metrics["weight_tv"] = tp.neighbour_weight_tv_loss(
                state, res["lbs_weights"])
            loss = loss + w_tv * metrics["weight_tv"]
        if w_sparse > 0:
            metrics["sparsity"] = tp.weight_sparsity_loss(res["lbs_weights"])
            loss = loss + (batch["sparsity_on"] * w_sparse
                           * metrics["sparsity"])
        if w_trans > 0:
            metrics["trans_reg"] = tp.transformation_reg_loss(
                res["global_t"], res["thetas"])
            loss = loss + w_trans * metrics["trans_reg"]
        if w_jcham > 0:
            metrics["joint_chamfer"] = tp.joint_chamfer_loss(state,
                                                             model.joints)
            loss = loss + w_jcham * metrics["joint_chamfer"]
        if w_cham2d > 0 and n_chamfer_views > 0:
            proj = project_views(res["t_hat_pcd"][batch["chamfer_pcd_idx"]],
                                 batch["chamfer_poses"], batch["chamfer_Ks"])
            if not inverse_y:
                proj = torch.stack([(H - 1) - proj[..., 0], proj[..., 1]],
                                   -1)
            proj = proj.flip(-1)                     # (x, y) -> (row, col)
            metrics["chamfer2d"] = tp.batch_chamfer_2d(
                proj, batch["chamfer_mask_pts"])
            loss = loss + w_cham2d * metrics["chamfer2d"]
        return loss, metrics

    return loss_fn


def make_train_step(model: tp.TemporalPoints, state, cfg_train,
                    optimizer: MaskedAdam, Ks, poses, H, W, near, far, bg,
                    n_chamfer_views: int, inverse_y=False, flip_x=False,
                    flip_y=False):
    """``step(batch) -> metrics`` (detached, ``loss`` included): the loss,
    its backward and one masked-Adam update of ``model`` in place."""
    loss_fn = make_loss_fn(model, state, cfg_train, Ks, poses, H, W, near,
                           far, bg, n_chamfer_views, inverse_y=inverse_y,
                           flip_x=flip_x, flip_y=flip_y)

    def step(batch):
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch)
        loss.backward()
        optimizer.update({n: p.grad for n, p in model.named_parameters()})
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    return step


@torch.no_grad()
def budget_audit(model: tp.TemporalPoints, state, ray_index, Ks, poses, H,
                 W, near, far, flips, probe_n: int = 2048) -> None:
    """Print how full the static sample budgets run at the first training
    time on the first ``probe_n`` rays of the index (the JAX package's
    startup audit). Kernel K3 runs here."""
    mcfg = model.cfg
    dev = state["canonical_pcd"].device
    sel0 = np.arange(min(probe_n, ray_index.n))
    _, _, t0, cam0, pix0 = ray_index.gather(sel0)
    ro, rd, _ = raydata.pixels_to_rays(
        Ks, poses, torch.as_tensor(cam0, dtype=torch.int64, device=dev),
        torch.as_tensor(pix0, dtype=torch.int64, device=dev), H, W, **flips)
    frame = tp.prepare_frame(model, state, t=float(t0[0]))
    occ_info = frame["occ_info"]
    pts, valid, _ = tp.sample_rays_compact(
        mcfg, ro, rd, near, far, occ_info["bb_min"], occ_info["bb_max"],
        occ=occ_info["occ"], occ_cell=occ_info["occ_cell"],
        occ_margin=occ_info["occ_margin"])
    per_ray = valid.sum(1).cpu().numpy()
    n_valid = int(per_ray.sum())
    m_act = tp.active_budget(mcfg, valid.numel())
    q, _, act_ok, _ = tp.compact_active(mcfg, pts, valid, occ_info["bb_min"],
                                        occ_info["bb_max"])
    d2p, _ = knn(q, None, mcfg.neighbours, radius2=0.01,
                 point_tables=occ_info["knn_tables"])
    n_pass = int(((d2p[:, -1] <= 0.01) & act_ok).sum())
    m_pass = min(max(1024, (int(m_act * mcfg.pass_fraction) + 1023)
                     // 1024 * 1024), m_act)
    print(f"stage2: budget audit — sample_budget {mcfg.sample_budget} "
          f"(per-ray demand p99 {int(np.percentile(per_ray, 99))}, "
          f"max {int(per_ray.max())}), active budget {m_act} vs "
          f"valid {n_valid} "
          f"({'TRUNCATING' if n_valid > m_act else 'ok'}), "
          f"pass budget {m_pass} vs radius-passing {n_pass} "
          f"({'TRUNCATING' if n_pass > m_pass else 'ok'}), "
          f"occ_res {mcfg.occ_res}")


def train_pcd(cfg, data_dict, canonical, skeleton, tineuvox_params,
              tineuvox_cfg, scene_bbox, seed=0, n_iters=None, log_every=1000,
              callback=None, sample_budget=None, tensorboard_path=None,
              i_save=5000, ckpt_path=None, ckpt_every=0, mesh=None,
              max_steps=None, device=None):
    """Run stage-2 training; returns (model, model config, state, stats).

    ``device``: ``None`` is the CUDA device (raises without one); ``"cpu"``
    runs on the CPU. ``tineuvox_params`` / ``tineuvox_cfg``,
    ``sample_budget`` and ``max_steps`` (``None``: the steps across the
    cloud's box) as in ``build_model``. ``stats`` holds ``psnr``, ``loss``
    and ``terms`` (every metric) at each logged step; ``callback(step,
    model, mcfg, state, stats)`` runs after each log. With ``ckpt_path``
    and ``ckpt_every``: a checkpoint (model, Adam state, step, host random
    state) every ``ckpt_every`` steps and a resume from one found at
    ``ckpt_path``."""
    if mesh is not None:
        raise NotImplementedError("multi-device stage-2 training (mesh) is "
                                  "not ported")
    if tensorboard_path:
        raise NotImplementedError("the tensorboard previews and comparison "
                                  "video are not ported")
    dev = resolve_device(device)
    cfg_train = cfg.pcd_train_config
    n_iters = n_iters or int(cfg_train.N_iters)
    rng = np.random.default_rng(seed)
    flips = dict(inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
                 flip_y=cfg.data.flip_y)

    H, W = int(data_dict["HW"][0][0]), int(data_dict["HW"][0][1])
    i_train = data_dict["i_train"]
    images, masks = data_dict["images"], data_dict["masks"]
    near, far = data_dict["near"], data_dict["far"]
    ray_index = raydata.build_ray_index(
        [images[i] for i in i_train], [masks[i] for i in i_train],
        data_dict["times"][i_train], data_dict["img_to_cam"][i_train],
        data_dict["poses"], data_dict["Ks"], H, W, scene_bbox[0],
        scene_bbox[1], near, far, device=dev, **flips)

    frozen_view_dir = None
    if bool(cfg_train.get("use_global_view_dir", False)):
        frozen_view_dir = -np.asarray(data_dict["poses"][0][:3, 2],
                                      np.float32)
    mcfg, model, state = build_model(cfg, canonical, skeleton,
                                     tineuvox_params, tineuvox_cfg,
                                     seed=seed,
                                     frozen_view_dir=frozen_view_dir,
                                     sample_budget=sample_budget,
                                     max_steps=max_steps, device=dev)
    Ks = torch.as_tensor(np.asarray(data_dict["Ks"], np.float32), device=dev)
    poses = torch.as_tensor(np.asarray(data_dict["poses"], np.float32),
                            device=dev)
    budget_audit(model, state, ray_index, Ks, poses, H, W, near, far, flips)

    optimizer = MaskedAdam(model, cfg_train)
    unique_times = np.unique(np.asarray(data_dict["times"])[i_train])
    sampler = InverseProportionalSampler(len(unique_times), seed=seed)
    start_step = 0
    if ckpt_path and os.path.isfile(ckpt_path):
        payload = ckpt.load_checkpoint(ckpt_path)
        start_step = int(payload["global_step"])
        sd = ckpt.params_from_jax(payload["params"])
        model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
        if payload.get("opt_state") is not None:
            optimizer.load_state_from_jax(payload["opt_state"])
        host = payload.get("host_rng")
        if host is not None:
            rng.bit_generator.state = host["rng"]
            sampler.rng.bit_generator.state = host["sampler_rng"]
            sampler.counts = np.asarray(host["sampler_counts"], np.float64)
        print(f"stage2: resuming from {ckpt_path} at step {start_step}")

    def save_progress(step):
        ckpt.save_checkpoint(
            ckpt_path, dataclasses.asdict(mcfg),
            ckpt.params_to_jax(model.state_dict()),
            extra={"opt_state": optimizer.state_to_jax(),
                   "host_rng": {"rng": rng.bit_generator.state,
                                "sampler_rng": sampler.rng.bit_generator.state,
                                "sampler_counts": sampler.counts.copy()}},
            global_step=step)

    canonical_idx = int(np.argmin(np.abs(unique_times
                                         - float(cfg.data.canonical_t))))
    full_t_iter = int(cfg_train.full_t_iter)
    weight_start_iter = int(cfg_train.get("weight_start_iter", 0))
    n_rand = int(cfg_train.N_rand)
    pose_one_each = bool(cfg_train.get("pose_one_each", False))
    w_cham2d = float(cfg_train.get("weight_chamfer2D", 0))

    times_tr = np.asarray(data_dict["times"])[i_train]
    imgs_by_time = {t: np.nonzero(times_tr == t)[0] for t in unique_times}
    n_views_min = min(len(v) for v in imgs_by_time.values())
    n_chamfer_views = min(5, n_views_min) if w_cham2d > 0 else 0
    step_fn = make_train_step(model, state, cfg_train, optimizer, Ks, poses,
                              H, W, near, far, float(cfg_train.bg_col),
                              n_chamfer_views, **flips)

    mask_pix = []
    if n_chamfer_views > 0:
        for i in i_train:
            m = np.asarray(masks[i]).reshape(H, W)
            ys, xs = np.nonzero(m > 0)
            if len(ys) == 0:
                ys, xs = np.zeros(1, np.int64), np.zeros(1, np.int64)
            mask_pix.append(np.stack([ys, xs], -1).astype(np.float32))

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    stats: Dict[str, Any] = {"psnr": [], "loss": [], "terms": []}
    t0 = time.time()
    for global_step in range(1 + start_step, n_iters + 1):
        t_max, t_min = curriculum_window(global_step, len(unique_times),
                                         full_t_iter, canonical_idx)
        rnd_i = sampler.sample(t_min, t_max)
        t_key = float(unique_times[rnd_i])
        b_lo, b_hi = ray_index.index_to_times[t_key]
        sel = rng.integers(b_lo, b_hi, size=n_rand)
        rgb, mval, _, cam, pix = ray_index.gather(sel)
        batch = {
            "rgb": tensor(rgb), "mask": tensor(mval),
            "t": np.float32(t_key),
            "cam": tensor(cam, torch.int64), "pix": tensor(pix, torch.int64),
            "sparsity_on": 1.0 if global_step >= weight_start_iter else 0.0,
        }
        if n_chamfer_views > 0:
            img_rows = imgs_by_time[t_key]
            pick = rng.permutation(len(img_rows))[:n_chamfer_views]
            rows = img_rows[pick]
            if pose_one_each:
                cams_sel = ray_index.img_cam[rows]
            else:
                cams_sel = pick % len(data_dict["poses"])
            mask_pts = np.stack([
                mask_pix[r][rng.integers(0, len(mask_pix[r]), CH_M)]
                for r in rows], 0)
            cams_t = tensor(cams_sel, torch.int64)
            batch["chamfer_poses"] = poses[cams_t]
            batch["chamfer_Ks"] = Ks[cams_t]
            batch["chamfer_mask_pts"] = tensor(mask_pts)
            batch["chamfer_pcd_idx"] = tensor(
                rng.integers(0, mcfg.n_points, CH_N), torch.int64)

        metrics = step_fn(batch)

        if global_step % log_every == 0 or global_step == n_iters:
            terms = {k: float(v) for k, v in metrics.items()}
            psnr = -10.0 * np.log10(max(terms["mse"], 1e-12))
            stats["psnr"].append(psnr)
            stats["loss"].append(terms["loss"])
            stats["terms"].append(terms)
            print(f"stage2: iter {global_step:6d} | loss "
                  f"{terms['loss']:.5f} | psnr {psnr:5.2f} | "
                  f"t {t_min}-{t_max} | {time.time() - t0:.1f}s")
            if callback is not None:
                callback(global_step, model, mcfg, state, stats)
        if ckpt_path and ckpt_every and global_step % ckpt_every == 0:
            save_progress(global_step)
    return model, mcfg, state, stats
