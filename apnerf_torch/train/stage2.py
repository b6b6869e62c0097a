"""Stage-2 trainer: the TemporalPoints point model (port of
``apnerf/train/stage2.py``, the reference ``train_pcd``, run.py:417-819).

Time-curriculum sampling with the inverse-proportional time sampler, each
step's rays drawn from one time's contiguous range of the ray index, the
seven-term loss (render MSE, ARAP, skinning-weight TV, weight sparsity
from ``weight_start_iter``, transformation regulariser, joint chamfer, 2D
mask chamfer), autograd through the point model's forward, masked Adam
with per-step lr decay, mid-stage checkpoints with resume, and with a
``tensorboard_path`` the previews: the loss terms as scalars and, every
``i_save`` steps, three training views beside their renders
(``payload``) and a GT | direct | full | LBS-weights panel sequence
(``video_panels``, also written as a video there).

On a CUDA device each training step is one replay of a captured CUDA
graph (``make_graphed_step``, the counterpart of the JAX package's jitted
step): forward, the seven terms, backward and the masked-Adam update, with
every value that changes from step to step (the rays' pixels and colours,
the time, the sparsity switch, the chamfer views, the Adam step sizes) in
static inputs that the host fills in stream order, so it draws step i + 1
while the card runs step i; it reads back only at the log, checkpoint and
preview steps. On the CPU the same body runs eagerly. ``make_train_step``
is the eager step, the yardstick.

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
the JAX package does); a failure to write the comparison video is not
caught (``render.write_video`` has an encoder of its own). The previews'
writer is ``torch.utils.tensorboard.SummaryWriter`` where tensorboard
imports; without it, nothing is written and, as in the JAX package, no
preview view is drawn from the batch generator.

With ``mesh`` (``parallel.mesh``, one process a rank: NCCL on the card,
gloo on the CPU) the training is data-parallel as in the JAX package:
every rank builds the model (K1 on each; the parameters and the state
then broadcast from rank 0), draws the same global batch from the same
host random stream, samples and compacts it whole under the global
budgets (the surviving samples are the single-device run's), runs K2, K3,
``feat_net`` and the heads on its block of the slots
(``temporal_points.forward(mesh=)``), and the gradients are summed over
the ranks (``MaskedAdam.reduce``) before the ZeRO-1 update. The terms
that are no sum over rays (ARAP, the weight TV and sparsity, the
transformation regulariser, the joint and 2D mask chamfers), which every
rank computes whole, enter the summed gradient once
(``parallel.mesh.count_once``). ``N_rand`` must divide over the ranks.
Only rank 0 writes checkpoints (the single-device format) and previews;
the other ranks draw the previews' views from the host stream all the
same, so that the streams stay equal.
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
from ..ops.marching import composite
from ..parallel import mesh as pmesh
from ..render.render import write_video
from ..render.renderers import weight_palette
from ..utils import checkpoint as ckpt
from ..utils.graphs import GraphedStep
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
    # inv_ex: inv's own error check reads the device's status back
    w2c = torch.linalg.inv_ex(poses).inverse
    cam = (torch.einsum("vab,nb->vna", w2c[:, :3, :3], points)
           + w2c[:, None, :3, 3])
    pix = torch.einsum("vna,vba->vnb", cam, Ks)
    return pix[..., :2] / pix[..., 2:]


def make_loss_fn(model: tp.TemporalPoints, state, cfg_train, Ks, poses,
                 H, W, near, far, bg, n_chamfer_views: int, inverse_y=False,
                 flip_x=False, flip_y=False, mesh=None):
    """``loss_fn(batch) -> (loss, metrics)``: the stage-2 forward of the
    batch's rays at its time and the weighted sum of the terms whose
    weight is positive (``metrics`` holds each term and ``mse``).
    ``mesh``: the forward's slot work split over the ranks, and the terms
    that every rank computes whole counted once in the ranks' summed
    gradient; the loss is the same on every rank."""
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
                         far=far, bg=bg, mesh=mesh)
        metrics: Dict[str, torch.Tensor] = {}

        def once(x):
            return pmesh.count_once(x, mesh)

        mse = torch.mean((res["rgb_marched"] - batch["rgb"]) ** 2)
        metrics["mse"] = mse
        loss = torch.zeros((), device=mse.device)
        if w_render > 0:
            loss = loss + w_render * mse
        if w_arap > 0:
            metrics["arap"] = tp.arap_loss(state, res["t_hat_pcd"])
            loss = loss + w_arap * once(metrics["arap"])
        if w_tv > 0:
            metrics["weight_tv"] = tp.neighbour_weight_tv_loss(
                state, res["lbs_weights"])
            loss = loss + w_tv * once(metrics["weight_tv"])
        if w_sparse > 0:
            metrics["sparsity"] = tp.weight_sparsity_loss(res["lbs_weights"])
            loss = loss + (batch["sparsity_on"] * w_sparse
                           * once(metrics["sparsity"]))
        if w_trans > 0:
            metrics["trans_reg"] = tp.transformation_reg_loss(
                res["global_t"], res["thetas"])
            loss = loss + w_trans * once(metrics["trans_reg"])
        if w_jcham > 0:
            metrics["joint_chamfer"] = tp.joint_chamfer_loss(state,
                                                             model.joints)
            loss = loss + w_jcham * once(metrics["joint_chamfer"])
        if w_cham2d > 0 and n_chamfer_views > 0:
            proj = project_views(res["t_hat_pcd"][batch["chamfer_pcd_idx"]],
                                 batch["chamfer_poses"], batch["chamfer_Ks"])
            if not inverse_y:
                proj = torch.stack([(H - 1) - proj[..., 0], proj[..., 1]],
                                   -1)
            proj = proj.flip(-1)                     # (x, y) -> (row, col)
            metrics["chamfer2d"] = tp.batch_chamfer_2d(
                proj, batch["chamfer_mask_pts"])
            loss = loss + w_cham2d * once(metrics["chamfer2d"])
        return loss, metrics

    return loss_fn


def make_step_body(model: tp.TemporalPoints, state, cfg_train,
                   optimizer: MaskedAdam, Ks, poses, H, W, near, far, bg,
                   n_chamfer_views: int, inverse_y=False, flip_x=False,
                   flip_y=False):
    """``body(batch) -> (metrics, grads)``: the loss, its backward and the
    masked-Adam update of the step that ``optimizer.advance()`` counted;
    ``metrics`` detached (``loss`` included), ``grads`` the gradient of
    each parameter by name (None where none reaches it). Under the
    optimizer's mesh (``MaskedAdam(mesh=)``) the forward's slot work is
    split over the ranks and ``grads`` are summed over them."""
    loss_fn = make_loss_fn(model, state, cfg_train, Ks, poses, H, W, near,
                           far, bg, n_chamfer_views, inverse_y=inverse_y,
                           flip_x=flip_x, flip_y=flip_y, mesh=optimizer.mesh)

    def body(batch):
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch)
        loss.backward()
        grads = optimizer.reduce({n: p.grad
                                  for n, p in model.named_parameters()})
        optimizer.apply(grads)
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}, grads

    return body


def make_train_step(model: tp.TemporalPoints, state, cfg_train,
                    optimizer: MaskedAdam, Ks, poses, H, W, near, far, bg,
                    n_chamfer_views: int, inverse_y=False, flip_x=False,
                    flip_y=False):
    """``step(batch) -> metrics`` (detached, ``loss`` included): the loss,
    its backward and one masked-Adam update of ``model`` in place, run
    eagerly (the yardstick of ``make_graphed_step``; the parameters'
    ``grad`` hold the step's gradients after it)."""
    body = make_step_body(model, state, cfg_train, optimizer, Ks, poses, H,
                          W, near, far, bg, n_chamfer_views,
                          inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y)

    def step(batch):
        optimizer.advance()
        return body(batch)[0]

    return step


def step_inputs(n_rand: int, n_chamfer_views: int, device):
    """The static inputs of a training step, by batch key: zero tensors of
    the batch's shapes and types (``t`` [1], ``sparsity_on`` a scalar)."""
    f32, i64 = torch.float32, torch.int64
    spec = {"rgb": ((n_rand, 3), f32), "mask": ((n_rand,), f32),
            "t": ((1,), f32), "cam": ((n_rand,), i64),
            "pix": ((n_rand,), i64), "sparsity_on": ((), f32)}
    if n_chamfer_views > 0:
        V = n_chamfer_views
        spec.update(chamfer_poses=((V, 4, 4), f32),
                    chamfer_Ks=((V, 3, 3), f32),
                    chamfer_mask_pts=((V, CH_M, 2), f32),
                    chamfer_pcd_idx=((CH_N,), i64))
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in spec.items()}


def make_graphed_step(model: tp.TemporalPoints, state, cfg_train,
                      optimizer: MaskedAdam, Ks, poses, H, W, near, far, bg,
                      n_chamfer_views: int, n_rand: int, inverse_y=False,
                      flip_x=False, flip_y=False) -> GraphedStep:
    """``step(batch) -> (metrics, grads)`` of ``make_step_body`` as one
    CUDA-graph replay on a CUDA device (the first call: the step run
    eagerly, then captured), eagerly on the CPU. ``batch`` holds the
    step's host values by ``step_inputs`` key; each call loads them into
    the static inputs and advances the optimizer. The outputs are the
    graph's: the next call overwrites them."""
    body = make_step_body(model, state, cfg_train, optimizer, Ks, poses, H,
                          W, near, far, bg, n_chamfer_views,
                          inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y)
    inputs = step_inputs(n_rand, n_chamfer_views, Ks.device)
    return GraphedStep(lambda: (lambda: body(inputs)), inputs, Ks.device,
                       prepare=optimizer.advance,
                       thread_local=optimizer.mesh is not None)


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
    ``ckpt_path``. ``mesh`` (``parallel.mesh.make_mesh``): data-parallel
    training over its ranks, each of which calls this with the same
    arguments (see the module docstring); ``N_rand`` must divide over
    them."""
    dev = resolve_device(device)
    cfg_train = cfg.pcd_train_config
    if mesh is not None and int(cfg_train.N_rand) % mesh.world:
        raise ValueError(f"N_rand ({int(cfg_train.N_rand)}) must divide "
                         f"over the mesh ({mesh.world} ranks)")
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
    pmesh.put_replicated(model, mesh, state)
    Ks = torch.as_tensor(np.asarray(data_dict["Ks"], np.float32), device=dev)
    poses = torch.as_tensor(np.asarray(data_dict["poses"], np.float32),
                            device=dev)
    if pmesh.writer(mesh):
        # a diagnostic print: rank 0's is every rank's
        budget_audit(model, state, ray_index, Ks, poses, H, W, near, far,
                     flips)

    optimizer = MaskedAdam(model, cfg_train, mesh=mesh)
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
        # every rank gathers the ZeRO-1 moments; rank 0 writes
        opt_state = optimizer.state_to_jax()
        if not pmesh.writer(mesh):
            return
        ckpt.save_checkpoint(
            ckpt_path, dataclasses.asdict(mcfg),
            ckpt.params_to_jax(model.state_dict()),
            extra={"opt_state": opt_state,
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
    step_fn = make_graphed_step(model, state, cfg_train, optimizer, Ks,
                                poses, H, W, near, far,
                                float(cfg_train.bg_col), n_chamfer_views,
                                n_rand, **flips)
    poses_np = np.asarray(data_dict["poses"], np.float32)
    Ks_np = np.asarray(data_dict["Ks"], np.float32)

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

    writer = None
    previews_on = False
    if tensorboard_path:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            print("stage2: tensorboard unavailable, logging to console only")
        else:
            previews_on = True
            if pmesh.writer(mesh):
                writer = SummaryWriter(tensorboard_path)
    bg = float(cfg_train.bg_col)

    def view_rays(cam, factor):
        """The rays of camera ``cam``'s view at 1 / ``factor`` size."""
        h, w = H // factor, W // factor
        K = np.array(data_dict["Ks"][cam], np.float32)
        K[:2, :3] /= factor
        pix = torch.arange(h * w, device=dev)
        return raydata.pixels_to_rays(
            tensor(K)[None], tensor(data_dict["poses"][cam])[None],
            torch.zeros_like(pix), pix, h, w, **flips)

    def gt_image(row, factor):
        gt = np.asarray(data_dict["images"][i_train[row]], np.float32)
        if gt.max() > 1.5:
            gt = gt / 255.0
        return gt[::factor, ::factor, :3]

    @torch.no_grad()
    def render_preview(img_row, factor=4):
        """(render, gt image) of training image row ``img_row``."""
        ro, rd, vd = view_rays(int(ray_index.img_cam[img_row]), factor)
        res = tp.forward(model, state, ro, rd, vd,
                         t=float(ray_index.img_time[img_row]), near=near,
                         far=far, bg=bg)
        rgb = res["rgb_marched"].cpu().numpy()
        return (rgb.reshape(H // factor, W // factor, 3),
                gt_image(img_row, factor))

    @torch.no_grad()
    def render_comparison_video(n_frames=6, factor=4):
        """GT | direct-pcd | full | LBS-weights panels of the first
        training camera over times evenly in [0, 1] -> [T, h, 4w, 3]
        (reference run.py:772-811)."""
        h, w = H // factor, W // factor
        # the palette here: it imports seaborn where installed (seconds)
        w_cols = tensor(weight_palette(mcfg.n_joints).astype(np.float32))
        cam0 = int(ray_index.img_cam[0])
        ro, rd, vd = view_rays(cam0, factor)
        cam_rows = np.where(ray_index.img_cam == cam0)[0]
        frames = []
        for tq in np.linspace(0.0, 1.0, n_frames):
            # GT: this camera's training image nearest in time
            r = cam_rows[np.argmin(
                np.abs(ray_index.img_time[cam_rows] - tq))]
            res = tp.forward(model, state, ro, rd, vd,
                             t=float(np.float32(tq)), near=near, far=far,
                             bg=bg, render_weights=True,
                             render_pcd_direct=True)
            col = torch.einsum("rbj,jc->rbc", res["lbs_w_per_sample"],
                               w_cols)
            wimg = composite(res["weights_for_render"], col, bg=bg,
                             alphainv_last=res["alphainv_for_render"])
            panels = [gt_image(r, factor)] + [
                x.cpu().numpy().reshape(h, w, 3)
                for x in (res["rgb_marched_direct"], res["rgb_marched"],
                          wimg)]
            frames.append(np.clip(np.concatenate(panels, axis=1), 0, 1))
        return np.stack(frames)

    def previews(step):
        rows = rng.integers(0, len(i_train), 3)
        if writer is None:
            # a rank other than 0 keeps its host stream equal to rank 0's
            return
        panels = []
        for r in rows:
            pred, gt = render_preview(int(r))
            panels.append(np.concatenate([gt, pred], axis=1))
        grid = np.clip(np.concatenate(panels, axis=0), 0, 1)
        writer.add_image("payload", grid.transpose(2, 0, 1), step)
        vid = render_comparison_video()
        writer.add_images("video_panels", vid.transpose(0, 3, 1, 2), step)
        write_video(os.path.join(tensorboard_path,
                                 f"comparison_{step:06d}.mp4"), vid, fps=4)

    try:
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
                "rgb": rgb, "mask": mval, "t": t_key, "cam": cam, "pix": pix,
                "sparsity_on": (1.0 if global_step >= weight_start_iter
                                else 0.0),
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
                batch["chamfer_poses"] = poses_np[cams_sel]
                batch["chamfer_Ks"] = Ks_np[cams_sel]
                batch["chamfer_mask_pts"] = mask_pts
                batch["chamfer_pcd_idx"] = rng.integers(0, mcfg.n_points,
                                                        CH_N)

            metrics, _ = step_fn(batch)

            if global_step % log_every == 0 or global_step == n_iters:
                terms = {k: float(v) for k, v in metrics.items()}
                psnr = -10.0 * np.log10(max(terms["mse"], 1e-12))
                stats["psnr"].append(psnr)
                stats["loss"].append(terms["loss"])
                stats["terms"].append(terms)
                print(f"stage2: iter {global_step:6d} | loss "
                      f"{terms['loss']:.5f} | psnr {psnr:5.2f} | "
                      f"t {t_min}-{t_max} | {time.time() - t0:.1f}s")
                if writer is not None:
                    writer.add_scalar("metrics/PSNR", psnr, global_step)
                    for k in ("mse", "arap", "weight_tv", "sparsity",
                              "trans_reg", "joint_chamfer", "chamfer2d",
                              "loss"):
                        if k in terms:
                            writer.add_scalar(f"metrics/{k}", terms[k],
                                              global_step)
                    writer.add_scalar("metrics/eps_time", time.time() - t0,
                                      global_step)
                if callback is not None:
                    callback(global_step, model, mcfg, state, stats)
            if ckpt_path and ckpt_every and global_step % ckpt_every == 0:
                save_progress(global_step)
            if previews_on and (global_step % i_save == 0
                                or global_step == 1):
                previews(global_step)
    finally:
        if writer is not None:
            writer.close()
    return model, mcfg, state, stats
