"""Stage-1 trainer: TiNeuVox backbone reconstruction (port of
``apnerf/train/stage1.py``).

Frustum bbox, progressive grid upscaling with an optimizer rebuild, the
mask-cache ray index, photometric + background-entropy + mask-BCE +
per-point-rgb + distortion losses, the TV gradient added to the feature
gradient after the backward, masked Adam with per-step lr decay, the
density-derived occupancy grid with a static active-sample budget, and
mid-stage checkpoints with resume.

``cfg`` is duck-typed as the JAX package's config: ``.train_config``,
``.model_and_render`` and ``.data``, each a mapping with attribute access
and ``.get``. Ray microbatching follows the JAX package: ``ray_microbatch``
0 (the default) splits a batch of more than 4096 rays into
``microbatches(N_rand)`` equal parts, 1 keeps it whole, n > 1 splits it in
n; each part takes its own forward and backward under the active budget
of its own rays, the gradients are summed in fp32 and scaled by 1/n before
the TV gradient and the one masked-Adam update.

With ``mesh`` (``parallel.mesh``, one process a rank: NCCL on the card,
gloo on the CPU) the training is data-parallel as in the JAX package:
every rank draws the same global batch, samples and compacts it whole
under the global active budget (so the surviving samples are the
single-device run's), runs the grid gather, the MLPs and the heads on its
block of the slots (``tineuvox.forward(mesh=)``), and the gradients are
summed over the ranks (``MaskedAdam.reduce``) before the TV gradient, the
``skip_zero_grad_fields`` mask and the ZeRO-1 update, whose all-gather
gives every rank the whole parameters. ``N_rand`` must divide over the
ranks, and there is no microbatching under a mesh. Only rank 0 writes
checkpoints; they have the single-device format.

On a CUDA device each training step is one replay of a captured CUDA
graph (``make_graphed_step``), one graph per *segment* as the JAX package
jits one program per grid resolution: a ``pg_scale`` rebuild, the
occupancy switch and ``step_to_half`` (the feature grid cast to bf16)
each start a new segment, whose first step runs eagerly and is captured.
The batch, the occupancy grid (refreshed every ``occupancy_update_every``
steps by a copy into the segment's static grid) and the Adam step sizes
are static inputs. The TV switches ``tv_on`` / ``tv_dense`` are host flags
that pick a branch of the step, so a segment keeps one graph for each
setting it meets. On the CPU the same body runs eagerly;
``make_train_step`` is the eager step, the yardstick. While the recorder of
``utils.profiling`` is on, the loop records its spans, one unit a step:
``stage1.draw``, ``stage1.segment`` (a new segment), ``stage1.occupancy``
(a refresh, which reads the grid back) and ``stage1.log``.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device
from ..data import rays as raydata
from ..models import tineuvox
from ..ops import compaction, marching
from ..ops.rays import get_rays_of_a_view
from ..parallel import mesh as pmesh
from ..utils import checkpoint as ckpt
from ..utils import profiling
from ..utils.graphs import GraphedStep
from .masked_adam import MaskedAdam


def compute_bbox_by_cam_frustrm(HW, Ks, poses, i_train, img_to_cam, near,
                                far, ndc=False, inverse_y=False, flip_x=False,
                                flip_y=False):
    """Scene bbox = union of the training camera frustums (numpy)."""
    xyz_min = np.full(3, np.inf)
    xyz_max = np.full(3, -np.inf)
    for idx in i_train:
        H, W = HW[idx]
        cam = img_to_cam[idx]
        ro, rd, vd = get_rays_of_a_view(
            int(H), int(W), Ks[cam], poses[cam], ndc=ndc, inverse_y=inverse_y,
            flip_x=flip_x, flip_y=flip_y)
        d = rd if ndc else vd
        pts = torch.stack([ro + d * near, ro + d * far]).numpy()
        xyz_min = np.minimum(xyz_min, pts.reshape(-1, 3).min(0))
        xyz_max = np.maximum(xyz_max, pts.reshape(-1, 3).max(0))
    return xyz_min, xyz_max


def microbatches(n_rand: int, ray_microbatch: int = 0, mesh=None) -> int:
    """The number of ray microbatches a step of ``n_rand`` rays takes:
    ``ray_microbatch``, or for 0 the JAX package's rule, ceil(n_rand /
    4096) raised until it divides ``n_rand`` (1 under a ``mesh``: the two
    are alternatives). Raises ``ValueError`` when the count does not
    divide ``n_rand``, or is above 1 under a mesh."""
    n_micro = int(ray_microbatch)
    if mesh is not None:
        if n_micro > 1:
            raise ValueError("ray microbatching and mesh data parallelism "
                             "are alternatives: set ray_microbatch to 0 or "
                             "1 under a mesh")
        return 1
    if n_micro == 0:
        n_micro = -(-n_rand // 4096)
        while n_micro > 1 and n_rand % n_micro:
            n_micro += 1
    if n_micro < 1 or n_rand % n_micro:
        raise ValueError(f"N_rand ({n_rand}) must divide by ray_microbatch "
                         f"({n_micro})")
    return n_micro


def active_budget(n_rand: int, n_steps: int, occ_frac: float):
    """(budget, demanded): the static active-sample budget for ``n_rand``
    rays of ``n_steps`` steps at ``occ_frac``, as the JAX package rounds
    it: up to a power of two (at least 4096) up to 2^19, above that up to
    a multiple of 2^19."""
    demanded = int(n_rand * n_steps * occ_frac)
    chunk = 1 << 19
    if demanded > chunk:
        return -(-demanded // chunk) * chunk, demanded
    return max(4096, 1 << max(demanded - 1, 1).bit_length()), demanded


def make_loss_fn(model: tineuvox.TiNeuVox, cfg_train, Ks, poses, H, W,
                 near, far, bg, inverse_y=False, flip_x=False, flip_y=False,
                 active_budget=None, mesh=None):
    """``loss_fn(batch, occ) -> (loss, mse)``: render the batch's rays
    through ``model`` and sum the weighted stage-1 losses. ``mesh``: the
    forward's slot work split over the ranks (``tineuvox.forward``); the
    loss is the whole batch's on every rank."""
    stepsize = float(cfg_train["_stepsize"])
    w_main = float(cfg_train["weight_main"])
    w_entropy = float(cfg_train.get("weight_entropy_last", 0.0))
    w_mask = float(cfg_train.get("weight_mask_loss", 0.0))
    w_rgbper = float(cfg_train.get("weight_rgbper", 0.0))
    w_dist = float(cfg_train.get("weight_distortion", 0.0))

    def loss_fn(batch, occ):
        ro, rd, vd = raydata.pixels_to_rays(
            Ks, poses, batch["cam"], batch["pix"], H, W,
            inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y)
        res = tineuvox.forward(model, ro, rd, vd, batch["time"][:, None],
                               near, far, stepsize, bg,
                               model.cfg.max_steps(stepsize), occ_grid=occ,
                               active_budget=active_budget, mesh=mesh)
        target = batch["rgb"]
        mse = torch.mean((res["rgb_marched"] - target) ** 2)
        loss = w_main * mse
        if w_entropy > 0 or w_mask > 0:
            pout = torch.clamp(res["alphainv_last"], 1e-6, 1 - 1e-6)
        if w_entropy > 0:
            ent = -(pout * torch.log(pout)
                    + (1 - pout) * torch.log(1 - pout)).mean()
            loss = loss + w_entropy * ent
        if w_mask > 0:
            tgt_inv = 1.0 - batch["mask"]
            bce = -(tgt_inv * torch.log(pout)
                    + (1 - tgt_inv) * torch.log(1 - pout)).mean()
            loss = loss + w_mask * bce
        if w_rgbper > 0:
            rgbper = ((res["raw_rgb"] - target[:, None, :]) ** 2).sum(-1)
            rgbper = (rgbper * res["weights"].detach()).sum()
            loss = loss + w_rgbper * rgbper / target.shape[0]
        if w_dist > 0:
            loss = loss + w_dist * marching.distortion_loss(
                res["weights"], res["s"], 1.0 / res["n_max"])
        return loss, mse

    return loss_fn


def make_step_body(model: tineuvox.TiNeuVox, cfg_train,
                   optimizer: MaskedAdam, Ks, poses, H, W, near, far, bg,
                   inverse_y=False, flip_x=False, flip_y=False,
                   active_budget=None, n_micro: int = 1):
    """``body(batch, occ, tv_on, tv_dense) -> (loss, mse, grads)``: loss,
    backward, the TV gradient added to the feature gradient after the
    backward (the reference's ``feature_total_variation_add_grad``) when
    ``tv_on``, then the masked-Adam update of the step that
    ``optimizer.advance()`` counted; ``grads`` by parameter name, as the
    update took them. With ``n_micro`` > 1 the batch's rays are cut into
    ``n_micro`` equal consecutive parts (views), each with its own forward
    and backward (``active_budget`` is then a part's); the gradients, loss
    and mse are summed in fp32 in part order and scaled by 1 / n_micro, as
    the JAX package's ``grad_fn`` accumulates them.

    Under the optimizer's mesh (``MaskedAdam(mesh=)``) the forward's slot
    work is split over the ranks and the gradients are summed over them
    (``MaskedAdam.reduce``) before the TV gradient and the update."""
    loss_fn = make_loss_fn(model, cfg_train, Ks, poses, H, W, near, far, bg,
                           inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y,
                           active_budget=active_budget, mesh=optimizer.mesh)
    w_tv = float(cfg_train.get("weight_tv_feature", 0.0))
    params = dict(model.named_parameters())

    def loss_and_grads(batch, occ):
        if n_micro == 1:
            model.zero_grad(set_to_none=True)
            loss, mse = loss_fn(batch, occ)
            loss.backward()
            return loss.detach(), mse.detach(), {
                n: p.grad for n, p in model.named_parameters()}
        n_rays = batch["rgb"].shape[0]
        if n_rays % n_micro:
            raise ValueError(f"N_rand ({n_rays}) must divide by "
                             f"ray_microbatch ({n_micro})")
        m = n_rays // n_micro
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in params.items()}
        loss_sum = mse_sum = 0.0
        for i in range(n_micro):
            part = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, mse = loss_fn(part, occ)
            for (n, _), g in zip(params.items(), torch.autograd.grad(
                    loss, list(params.values()), allow_unused=True)):
                if g is not None:
                    acc[n].add_(g)
            loss_sum = loss_sum + loss.detach()
            mse_sum = mse_sum + mse.detach()
        inv = 1.0 / n_micro
        return loss_sum * inv, mse_sum * inv, {n: g * inv
                                               for n, g in acc.items()}

    def body(batch, occ, tv_on, tv_dense):
        loss, mse, grads = loss_and_grads(batch, occ)
        grads = optimizer.reduce(grads)
        if w_tv > 0 and tv_on:
            g = grads["feature"]
            g = torch.zeros_like(model.feature) if g is None else g
            grads["feature"] = g + tineuvox.feature_tv_grad(
                model, w_tv / batch["rgb"].shape[0], g, tv_dense)
        optimizer.apply(grads)
        return loss, mse, grads

    return body


def make_train_step(model: tineuvox.TiNeuVox, cfg_train,
                    optimizer: MaskedAdam, Ks, poses, H, W, near, far, bg,
                    inverse_y=False, flip_x=False, flip_y=False,
                    active_budget=None, n_micro: int = 1):
    """``step(batch, tv_on, occ=None, tv_dense=True) -> (loss, mse)``: one
    step of ``make_step_body`` run eagerly (the yardstick of
    ``make_graphed_step``)."""
    body = make_step_body(model, cfg_train, optimizer, Ks, poses, H, W,
                          near, far, bg, inverse_y=inverse_y, flip_x=flip_x,
                          flip_y=flip_y, active_budget=active_budget,
                          n_micro=n_micro)

    def step(batch, tv_on, occ=None, tv_dense=True):
        optimizer.advance()
        return body(batch, occ, tv_on, tv_dense)[:2]

    return step


def step_inputs(n_rand: int, occ_shape, device):
    """The static inputs of a training step, by batch key, and ``occ``
    (the occupancy grid, bool ``occ_shape``) when ``occ_shape`` is given:
    zero tensors."""
    f32, i64 = torch.float32, torch.int64
    spec = {"rgb": ((n_rand, 3), f32), "mask": ((n_rand,), f32),
            "time": ((n_rand,), f32), "cam": ((n_rand,), i64),
            "pix": ((n_rand,), i64)}
    if occ_shape is not None:
        spec["occ"] = (tuple(occ_shape), torch.bool)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in spec.items()}


def make_graphed_step(model: tineuvox.TiNeuVox, cfg_train,
                      optimizer: MaskedAdam, Ks, poses, H, W, near, far, bg,
                      n_rand: int, inverse_y=False, flip_x=False,
                      flip_y=False, active_budget=None,
                      occ_shape=None, n_micro: int = 1) -> GraphedStep:
    """One segment's steps: ``step(batch, (tv_on, tv_dense)) -> (loss,
    mse, grads)`` of ``make_step_body`` as one CUDA-graph replay on a
    CUDA device (a graph per setting of the two flags; its first call is
    the step run eagerly, then captured), eagerly on the CPU. ``batch``
    holds the step's host arrays by ``step_inputs`` key; each call loads
    them into the static inputs and advances the optimizer. With
    ``occ_shape`` the step reads the occupancy grid from the static input
    ``step.inputs["occ"]``, which the caller refills in place. The
    outputs are the graph's: the next call overwrites them. With
    ``n_micro`` > 1 the microbatches are views of the static batch, and
    their forwards and backwards are all in the one graph."""
    body = make_step_body(model, cfg_train, optimizer, Ks, poses, H, W,
                          near, far, bg, inverse_y=inverse_y, flip_x=flip_x,
                          flip_y=flip_y, active_budget=active_budget,
                          n_micro=n_micro)
    inputs = step_inputs(n_rand, occ_shape, Ks.device)
    batch = {k: v for k, v in inputs.items() if k != "occ"}
    occ = inputs.get("occ")

    def keyed(tv_on, tv_dense):
        return lambda: body(batch, occ, tv_on, tv_dense)

    return GraphedStep(keyed, inputs, Ks.device, prepare=optimizer.advance,
                       thread_local=optimizer.mesh is not None)


def refresh_occupancy(model: tineuvox.TiNeuVox, stepsize: float):
    """The occupancy grid: alpha > max(fast_color_thres, 1e-6) at any of 4
    times over the grid's nodes, dilated twice, plus once more for the
    coarse-group centre test when ``occ_group`` > 1."""
    cfg = model.cfg
    grid_xyz = tineuvox.grid_xyz_coords(cfg, 1.0)
    acc = None
    for t in (0.0, 1.0 / 3, 2.0 / 3, 1.0):
        a = tineuvox.eval_alpha_volume(model, grid_xyz, t, stepsize)
        acc = a if acc is None else np.maximum(acc, a)
    occ = torch.as_tensor(acc > max(cfg.fast_color_thres, 1e-6),
                          device=model.feature.device)
    n_dilate = 3 if int(cfg.occ_group) > 1 else 2
    for _ in range(n_dilate):
        occ = compaction.build_occupancy_grid(occ)
    return occ


def scene_rep_reconstruction(cfg, data_dict, seed=0, n_iters=None,
                             log_every=1000, step_to_half=100000,
                             callback=None, ckpt_path=None, ckpt_every=0,
                             mesh=None, device=None):
    """Run stage-1 training end to end; returns (model, model_cfg, stats).

    ``device``: ``None`` is the CUDA device (raises without one);
    ``"cpu"`` runs on the CPU. On CUDA the deformation and
    feature MLPs run in bf16 (``mlp_bf16``, as the JAX package on its
    accelerator); on the CPU everything is fp32. With ``ckpt_path`` and
    ``ckpt_every``: periodic ``fine_progress.pkl`` checkpoints (model, Adam
    state, step) and an automatic resume from one. ``stats`` holds
    ``psnr``, ``loss`` and ``seconds`` (wall time since the start) at each
    logged step.

    ``mesh`` (``parallel.mesh.make_mesh``): data-parallel training over its
    ranks, each of which calls this with the same arguments (see the module
    docstring); ``N_rand`` must divide over them. The model returned is
    the same on every rank."""
    n_rand = int(cfg.train_config["N_rand"])
    if mesh is not None and n_rand % mesh.world:
        raise ValueError(f"N_rand ({n_rand}) must divide over the mesh "
                         f"({mesh.world} ranks)")
    n_micro = microbatches(n_rand, cfg.train_config.get("ray_microbatch", 0),
                           mesh)
    dev = resolve_device(device)
    cfg_model = cfg.model_and_render
    cfg_train = dict(cfg.train_config)
    n_iters = n_iters or int(cfg_train["N_iters"])
    xyz_min, xyz_max = compute_bbox_by_cam_frustrm(
        data_dict["HW"], data_dict["Ks"], data_dict["poses"],
        data_dict["i_train"], data_dict["img_to_cam"], data_dict["near"],
        data_dict["far"], ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
        flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
    wbs = float(cfg_model.world_bound_scale)
    if abs(wbs - 1.0) > 1e-9:
        shift = (xyz_max - xyz_min) * (wbs - 1) / 2
        xyz_min, xyz_max = xyz_min - shift, xyz_max + shift

    pg_scale = list(cfg_train.get("pg_scale", []))
    num_voxels = int(cfg_model.num_voxels)
    if pg_scale:
        num_voxels = int(num_voxels / (2 ** len(pg_scale)))
    model_cfg = tineuvox.TiNeuVoxConfig(
        xyz_min=tuple(xyz_min), xyz_max=tuple(xyz_max),
        num_voxels=num_voxels,
        num_voxels_base=int(cfg_model.num_voxels_base),
        voxel_dim=int(cfg_model.voxel_dim),
        defor_depth=int(cfg_model.defor_depth),
        net_width=int(cfg_model.net_width),
        alpha_init=float(cfg_model.alpha_init),
        fast_color_thres=float(cfg_model.fast_color_thres),
        no_view_dir=bool(cfg_model.no_view_dir),
        add_cam=bool(cfg.data.get("add_cam", False)),
        mlp_bf16=bool(cfg_model.get("mlp_bf16", True)) and dev.type == "cuda")
    model = tineuvox.init_model(model_cfg, torch.Generator().manual_seed(seed),
                                dev)

    i_train = data_dict["i_train"]
    images, masks = data_dict["images"], data_dict["masks"]
    H, W = int(data_dict["HW"][0][0]), int(data_dict["HW"][0][1])
    near, far = data_dict["near"], data_dict["far"]
    flips = dict(inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
                 flip_y=cfg.data.flip_y)
    ray_index = raydata.build_ray_index(
        [images[i] for i in i_train], [masks[i] for i in i_train],
        data_dict["times"][i_train], data_dict["img_to_cam"][i_train],
        data_dict["poses"], data_dict["Ks"], H, W, xyz_min, xyz_max, near,
        far, device=dev, **flips)
    Ks = torch.as_tensor(np.asarray(data_dict["Ks"], np.float32), device=dev)
    poses = torch.as_tensor(np.asarray(data_dict["poses"], np.float32),
                            device=dev)
    bg = float(cfg_train["bg_col"])
    stepsize = float(cfg_model.stepsize)
    cfg_train["_stepsize"] = stepsize
    gen = raydata.batch_index_generator(ray_index.n, n_rand, seed=seed)

    # occupancy-pruned sampling after a warm-up: a density-derived
    # occupancy grid and a static active-sample budget
    occ_start = int(cfg_train.get("occupancy_start", 1000))
    occ_every = int(cfg_train.get("occupancy_update_every", 500))
    occ_frac = float(cfg_train.get("active_fraction", 0.25))
    use_occ = (bool(cfg_train.get("use_occupancy", True))
               and occ_start <= n_iters)
    occ = None

    def build_segment(occupancy_active, optimizer=None):
        """A segment's graphed step (and a new optimizer unless one is
        given)."""
        optimizer = optimizer or MaskedAdam(model, cfg_train, mesh=mesh)
        budget = None
        if n_micro > 1:
            print(f"stage1: ray microbatching x{n_micro} "
                  f"({n_rand // n_micro} rays/microbatch, grads "
                  "accumulated)")
        if occupancy_active:
            n_s = model.cfg.max_steps(stepsize)
            budget, demanded = active_budget(n_rand // n_micro, n_s,
                                             occ_frac)
            per = f", per microbatch x{n_micro})" if n_micro > 1 else ")"
            print(f"stage1: budget audit — active budget {budget} of "
                  f"{demanded} demanded ({n_rand // n_micro} rays x {n_s} "
                  f"steps x {occ_frac:g} active_fraction{per} — padding "
                  f"{budget - demanded} "
                  f"({100 * (budget / max(demanded, 1) - 1):.1f}% over)")
        step = make_graphed_step(
            model, cfg_train, optimizer, Ks, poses, H, W, near, far, bg,
            n_rand, active_budget=budget,
            occ_shape=model.cfg.world_size if occupancy_active else None,
            n_micro=n_micro, **flips)
        return step, optimizer

    start_step = 0
    resume = None
    if ckpt_path and os.path.isfile(ckpt_path):
        resume = ckpt.load_checkpoint(ckpt_path)
        start_step = int(resume["global_step"])
        model = ckpt.tineuvox_from_jax(resume["model_kwargs"],
                                       resume["params"], dev)
        print(f"stage1: resuming from {ckpt_path} at step {start_step}")
    pmesh.put_replicated(model, mesh)
    occupancy_active = bool(use_occ and start_step >= occ_start)
    step_fn, optimizer = build_segment(occupancy_active)
    if resume is not None:
        if resume.get("opt_state") is not None:
            optimizer.load_state_from_jax(resume["opt_state"])
        if occupancy_active:
            occ = refresh_occupancy(model, stepsize)
            step_fn.inputs["occ"].copy_(occ)
    print(f"stage1: world size {model.cfg.world_size} x "
          f"{model.cfg.voxel_dim} on {dev}")

    tv_before = float(cfg_train.get("tv_before", 1e9))
    tv_after = float(cfg_train.get("tv_after", 0))
    tv_every = int(cfg_train.get("tv_every", 1))
    tv_feature_before = float(cfg_train.get("tv_feature_before", 1e9))
    w_tv = float(cfg_train.get("weight_tv_feature", 0.0))
    stats: Dict[str, Any] = {"psnr": [], "loss": [], "seconds": []}
    t0 = time.time()
    for global_step in range(1 + start_step, n_iters + 1):
        profiling.set_unit(("stage1", global_step))
        # a new segment when the graph would read a grid, an optimizer or
        # a parameter's storage that the step no longer uses
        half = global_step == step_to_half
        if half:
            model.feature.data = model.feature.data.to(torch.bfloat16)
        rebuild = False
        if global_step in pg_scale:
            n_rest = len(pg_scale) - pg_scale.index(global_step) - 1
            tineuvox.scale_volume_grid(
                model, int(int(cfg_model.num_voxels) / (2 ** n_rest)))
            print(f"stage1: step {global_step}: grid rescaled to "
                  f"{model.cfg.world_size}")
            rebuild = True
        if use_occ and global_step == occ_start:
            occupancy_active = True
            rebuild = True
        if rebuild or half:
            with profiling.scope("stage1.segment"):
                step_fn, optimizer = build_segment(
                    occupancy_active, None if rebuild else optimizer)
        refresh = occupancy_active and (rebuild
                                        or global_step % occ_every == 0)
        if occupancy_active and (refresh or half):
            with profiling.scope("stage1.occupancy"):
                if refresh:
                    occ = refresh_occupancy(model, stepsize)
                step_fn.inputs["occ"].copy_(occ)

        with profiling.scope("stage1.draw", mirror=True):
            rgb, mval, tval, cam, pix = ray_index.gather(next(gen))
        tv_on = (w_tv > 0 and tv_after < global_step < tv_before
                 and global_step % tv_every == 0)
        # the graph's key: tv_dense matters only with tv_on
        tv_key = (True, global_step < tv_feature_before) if tv_on \
            else (False, True)
        loss, mse, _ = step_fn(
            {"rgb": rgb, "mask": mval, "time": tval, "cam": cam,
             "pix": pix}, tv_key)

        if global_step % log_every == 0 or global_step == n_iters:
            with profiling.scope("stage1.log"):
                loss, mse = float(loss), float(mse)
            psnr = -10.0 * np.log10(max(mse, 1e-12))
            stats["psnr"].append(psnr)
            stats["loss"].append(loss)
            stats["seconds"].append(time.time() - t0)
            print(f"stage1: iter {global_step:6d} | loss {loss:.6f} "
                  f"| psnr {psnr:5.2f} | {time.time() - t0:.1f}s")
            if callback is not None:
                callback(global_step, model, model.cfg, stats)
        if ckpt_path and ckpt_every and global_step % ckpt_every == 0:
            ckpt.save_tineuvox(ckpt_path, model, optimizer, global_step,
                               write=pmesh.writer(mesh))
    return model, model.cfg, stats
