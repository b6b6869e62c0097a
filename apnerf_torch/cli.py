"""Command line: train / render / repose (port of ``apnerf/cli.py``, the
reference ``run.py`` surface, run.py:33-78, 1242-1415).

    python -m apnerf_torch.cli --config <cfg>
    python -m apnerf_torch.cli --config <cfg> --render_only --load_test_val \\
        --render_test --render_pcd --eval_psnr
    python -m apnerf_torch.cli --config <cfg> --render_only --repose_pcd \\
        --degree_threshold 30

Training runs stage 1 (unless ``fine_last.pkl`` exists), the export and
stage 2 into ``<basedir>/<expname>``; the render branch evaluates the test
views, renders the video path, reposes the point model and draws the
canonical skeleton. The flags and their defaults are the JAX package's.
Everything runs on the CUDA device: ``main(argv, device="cpu")`` is the
CPU, for tests.

Multi-device training and rendering: ``--train_devices N`` /
``--render_devices N`` above 1 start N processes, one a card (``cuda:0`` ...
``cuda:N-1``, an NCCL group on ``localhost``), each running this command
with the mesh of ``parallel`` (the trainers' and renderers' ``mesh=``);
with fewer than N cards the command raises before it loads data. Under
``torchrun --nproc_per_node N`` it joins the group that is there instead.
Rank 0 writes every file; the export runs on rank 0 and its artifacts go
to the others. Where the two flags are both above 1 they must be equal; a
phase without a mesh (training or rendering at one device) runs on rank 0
alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import random
import socket
import sys
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .config import dump_config, load_config
from .data.load_data import KEPT_KEYS, load_data
from .models import temporal_points as tp
from .parallel import distributed
from .parallel import mesh as pmesh
from .render import render
from .render.renderers import make_backbone_renderer, make_points_renderer
from .utils import checkpoint as ckpt


def config_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render_only", action="store_true")
    p.add_argument("--render_test", action="store_true")
    p.add_argument("--overwrite_cache", action="store_true")
    p.add_argument("--use_cache", action="store_true")
    p.add_argument("--render_video", action="store_true")
    p.add_argument("--load_test_val", action="store_true")
    p.add_argument("--joint_placement", action="store_true")
    p.add_argument("--visualise_weights", action="store_true")
    p.add_argument("--visualise_canonical", action="store_true")
    p.add_argument("--repose_pcd", action="store_true")
    p.add_argument("--first_stage_only", action="store_true")
    p.add_argument("--second_stage_only", action="store_true")
    p.add_argument("--debug_bone_merging", action="store_true")
    p.add_argument("--visualise_warp", action="store_true")
    p.add_argument("--render_pcd_direct", action="store_true")
    p.add_argument("--render_pcd", action="store_true")
    p.add_argument("--render_video_factor", type=int, default=0)
    p.add_argument("--eval_ssim", action="store_true")
    p.add_argument("--eval_lpips_alex", action="store_true")
    p.add_argument("--eval_lpips_vgg", action="store_true")
    p.add_argument("--eval_psnr", action="store_true")
    p.add_argument("--ablation_tag", type=str)
    p.add_argument("--degree_threshold", type=float, default=0.0)
    p.add_argument("--skip_load_images", action="store_true")
    p.add_argument("--i_print", type=int, default=1000)
    p.add_argument("--i_save", type=int, default=5000)
    # mid-stage checkpoint cadence; 0 = follow --i_save
    p.add_argument("--ckpt_every", type=int, default=0)
    p.add_argument("--fre_test", type=int, default=500000)
    p.add_argument("--basedir_append_suffix", type=str, default="")
    p.add_argument("--step_to_half", type=int, default=100000)
    p.add_argument("--export_bbox_and_cams_only", type=str, default="")
    # multi-device rays-DP (no reference counterpart): N > 1 ranks, one a
    # card
    p.add_argument("--render_devices", type=int, default=0)
    p.add_argument("--train_devices", type=int, default=0)
    return p


def seed_everything(seed):
    np.random.seed(seed)
    random.seed(seed)


def load_everything(args, cfg):
    """The dataset with the pickle cache (reference run.py:366-401)."""
    datadir = cfg.data.datadir
    cache_dir = datadir if os.path.isdir(datadir) else \
        datadir.split(".pickle")[0]
    os.makedirs(cache_dir, exist_ok=True)
    cache_file = os.path.join(cache_dir, "cache.pkl")
    if args.use_cache and not args.overwrite_cache \
            and os.path.isfile(cache_file):
        with open(cache_file, "rb") as f:
            return pickle.load(f)
    cfg.data.skip_images = bool(args.skip_load_images)
    bg_col = cfg.train_config.get("bg_col", None)
    data_dict = load_data(cfg.data, cfg, args.load_test_val, bg_col=bg_col)
    data_dict = {k: v for k, v in data_dict.items() if k in KEPT_KEYS}
    if args.use_cache and _rank() == 0:
        with open(cache_file, "wb") as f:
            pickle.dump(data_dict, f)
    return data_dict


def n_devices(args) -> int:
    """The ranks a command line takes: the larger of ``--train_devices``
    and ``--render_devices`` (1 for both at most 1); two counts above 1
    must be equal."""
    t, r = int(args.train_devices), int(args.render_devices)
    if t > 1 and r > 1 and t != r:
        raise ValueError(f"--train_devices {t} and --render_devices {r}: "
                         "one process group serves both, so they must be "
                         "equal")
    return max(t, r, 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, argv) -> None:
    """One spawned rank: card ``rank``, the NCCL group, then ``main``."""
    distributed.initialize(world, rank,
                           init_method=f"tcp://localhost:{port}",
                           device="cuda")
    try:
        main(argv)
    finally:
        distributed.shutdown()


def launch(argv, n: int, device=None) -> None:
    """Run the command line ``argv`` on ``n`` spawned ranks, one a CUDA
    card; raises (before anything is loaded) with fewer than ``n`` cards,
    and when a rank fails."""
    if device is not None and torch.device(device).type != "cuda":
        raise RuntimeError(f"{n} devices: one process a CUDA card; on "
                           f"{device} run the ranks under torchrun")
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < n:
        raise RuntimeError(f"{n} devices asked for; this host has "
                           f"{n_cards} CUDA devices")
    torch.multiprocessing.spawn(_rank_main, args=(n, _free_port(), argv),
                                nprocs=n, join=True)


def _mesh(n: int, what: str) -> Optional[pmesh.Mesh]:
    if n <= 1:
        return None
    mesh = pmesh.make_mesh(n)
    print(f"{what}: rays-DP over {mesh.world} ranks (rank {mesh.rank})")
    return mesh


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def train(args, cfg, save_path, data_dict, stages=(1, 2), device=None,
          mesh=None):
    """Stage 1 into ``fine_last.pkl`` (skipped when it exists), the export
    into ``pcds/`` and stage 2 into ``temporalpoints_last.pkl``. ``mesh``:
    both trainers over its ranks, each of which calls this; rank 0 writes
    and exports."""
    from .train import stage1, stage2
    from .train.export import export_point_cloud

    write = pmesh.writer(mesh)
    if write:
        os.makedirs(save_path, exist_ok=True)
        with open(os.path.join(save_path, "args.txt"), "w") as f:
            for k in sorted(vars(args)):
                f.write(f"{k} = {getattr(args, k)}\n")
        dump_config(cfg, os.path.join(save_path, "config.py"))

    ck1 = os.path.join(save_path, "fine_last.pkl")
    if 1 in stages:
        if os.path.isfile(ck1):
            print("fine_last.pkl exists, skipping stage 1")
        else:
            model, _, _ = stage1.scene_rep_reconstruction(
                cfg, data_dict, seed=args.seed, log_every=args.i_print,
                step_to_half=args.step_to_half,
                ckpt_path=os.path.join(save_path, "fine_progress.pkl"),
                ckpt_every=args.ckpt_every or args.i_save, device=device,
                mesh=mesh)
            if write:
                ckpt.save_tineuvox(ck1, model)
            pmesh.barrier(mesh)

    if 2 in stages:
        payload = ckpt.load_checkpoint(ck1)
        model = ckpt.tineuvox_from_jax(payload["model_kwargs"],
                                       payload["params"], device)
        mcfg = model.cfg
        unique_times = np.unique(np.asarray(data_dict["times"]))
        cidx = int(np.argmin(np.abs(unique_times
                                    - float(cfg.data.canonical_t))))
        pcd = cfg.pcd_model_and_render
        art = [None]
        if write:
            art[0] = export_point_cloud(
                model, save_path, float(unique_times[cidx]),
                float(cfg.model_and_render.stepsize),
                pcd_density_threshold=float(pcd.pcd_density_threshold),
                skeleton_density_threshold=float(
                    pcd.skeleton_density_threshold),
                bone_length=float(pcd.bone_length),
                canonical_pcd_num=float(pcd.canonical_pcd_num),
                # ZJU subjects can take the SMPL joint prior (reference
                # run.py:1215-1231, opt-in through the config)
                smpl_skeleton_datadir=(str(cfg.data.datadir)
                                       if bool(pcd.get("smpl_skeleton",
                                                       False))
                                       else None))
        if mesh is not None:
            dist.broadcast_object_list(art, 0, group=mesh.group)
        art = art[0]
        del model
        scene_bbox = (np.asarray(mcfg.xyz_min), np.asarray(mcfg.xyz_max))
        tb_path = os.path.join("./logs/tensorboard",
                               os.path.basename(os.path.normpath(save_path)))
        model2, _, state, _ = stage2.train_pcd(
            cfg, data_dict, art["canonical"], art["skeleton"],
            payload["params"], mcfg, scene_bbox, seed=args.seed,
            log_every=args.i_print, tensorboard_path=tb_path,
            i_save=args.i_save,
            ckpt_path=os.path.join(save_path, "temporalpoints_progress.pkl"),
            ckpt_every=args.ckpt_every or args.i_save, device=device,
            mesh=mesh)
        if write:
            ckpt.save_temporalpoints(
                os.path.join(save_path, "temporalpoints_last.pkl"), model2,
                state, tineuvox_kwargs=mcfg.get_kwargs())
        pmesh.barrier(mesh)


def main(argv=None, device=None):
    """Run the command line ``argv`` (``None``: ``sys.argv``) on
    ``device`` (``None``: the CUDA device; raises without one). With
    ``--train_devices`` / ``--render_devices`` above 1: on that many
    spawned ranks (``launch``), or in the group of ``torchrun``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = config_parser().parse_args(argv)
    n = n_devices(args)
    if n > 1 and not (dist.is_initialized() or "WORLD_SIZE" in os.environ):
        return launch(argv, n, device)
    device = resolve_device(device)
    if n > 1:
        distributed.initialize(device=device)
    cfg = load_config(args.config)
    seed_everything(args.seed)
    data_dict = load_everything(args, cfg)
    save_path = os.path.join(cfg.basedir, cfg.expname)

    if not args.render_only:
        stages = [1] if args.first_stage_only else (
            [2] if args.second_stage_only else [1, 2])
        mesh = _mesh(args.train_devices, "train")
        if mesh is not None or _rank() == 0:
            train(args, cfg, save_path, data_dict, stages=stages,
                  device=device, mesh=mesh)
        _barrier()

    if not (args.render_test or args.render_video or args.repose_pcd
            or args.visualise_canonical):
        return

    cfg.basedir += args.basedir_append_suffix
    near, far = data_dict["near"], data_dict["far"]
    stepsize = float(cfg.model_and_render.stepsize)
    bg = float(cfg.train_config.bg_col)
    prune_info = None
    mesh = _mesh(args.render_devices, "render")
    if mesh is None and _rank() != 0:
        return
    write = pmesh.writer(mesh)

    # repose is a point-model feature (reference run.py:1355-1396): the
    # stage-2 checkpoint is implied, with or without --render_pcd
    if not (args.render_pcd or args.repose_pcd):
        model = ckpt.load_tineuvox(os.path.join(save_path, "fine_last.pkl"),
                                   device)
        renderer = make_backbone_renderer(model, stepsize, near, far, bg,
                                          mesh=mesh)
        ckpt_name = "fine_last"
    else:
        model, state = ckpt.load_temporalpoints(
            os.path.join(save_path, "temporalpoints_last.pkl"), device)
        model.cfg = points_render_config(model.cfg, cfg)
        if args.degree_threshold > 0:
            times = np.unique(np.asarray(data_dict["times"]))
            state, prune_info = tp.simplify_skeleton(
                model, state, times, deg_threshold=args.degree_threshold,
                five_percent_heuristic=True)
            print(f"pruned {int(prune_info['prune_bones'].sum())} of "
                  f"{len(prune_info['prune_bones'])} joints")
        renderer = make_points_renderer(
            model, state, near, far, bg,
            render_weights=renders_weights(model.cfg),
            render_pcd_direct=args.render_pcd_direct,
            poses=data_dict["poses"], Ks=data_dict["Ks"], mesh=mesh)
        ckpt_name = "temporalpoints_last"

    flags = dict(inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
                 flip_y=cfg.data.flip_y)

    if args.render_test:
        outdir = os.path.join(save_path, f"render_test_{ckpt_name}")
        if write:
            os.makedirs(outdir, exist_ok=True)
        if prune_info is not None and write:
            with open(os.path.join(outdir, "threshold.txt"), "w") as f:
                f.write(f"{args.degree_threshold}\n")
                f.write(f"Static joints: "
                        f"{int(prune_info['prune_bones'].sum())} / "
                        f"{len(prune_info['prune_bones'])}")
        i_test = data_dict["i_test"]
        cams = data_dict["img_to_cam"][i_test]
        out = render.render_viewpoints(
            renderer, data_dict["poses"][cams], data_dict["HW"][i_test],
            data_dict["Ks"][cams], data_dict["times"][i_test],
            gt_imgs=[np.asarray(data_dict["images"][i]) for i in i_test],
            savedir=outdir, eval_psnr=args.eval_psnr,
            eval_ssim=args.eval_ssim, eval_lpips_alex=args.eval_lpips_alex,
            eval_lpips_vgg=args.eval_lpips_vgg, device=device, **flags)
        if write:
            render.write_video(os.path.join(outdir, "test_video.rgb.mp4"),
                               out["rgbs"])
        if args.eval_psnr:
            print("Testing psnr", np.mean(out["psnrs"]), "(avg)")

    if args.render_video:
        outdir = os.path.join(save_path, f"render_video_{ckpt_name}_time")
        if write:
            os.makedirs(outdir, exist_ok=True)
        rp = data_dict["render_poses"]
        out = render.render_viewpoints(
            renderer, rp, np.repeat(data_dict["HW"][0][None], len(rp), 0),
            np.repeat(data_dict["Ks"][0][None], len(rp), 0),
            data_dict["render_times"], savedir=outdir,
            render_factor=args.render_video_factor, device=device, **flags)
        d = out["depths"]
        if write:
            render.write_video(os.path.join(outdir, "video.rgb.mp4"),
                               out["rgbs"])
            render.write_video(os.path.join(outdir, "video.disp.mp4"),
                               d / max(d.max(), 1e-8))
        if len(out["weights"]) and write:
            render.write_video(os.path.join(outdir, "video.weights.mp4"),
                               out["weights"])

    if args.repose_pcd:
        repose(model, state, data_dict, near, far, bg, seed=args.seed,
               savedir=(os.path.join(save_path,
                                     f"render_video_repose_{args.seed}")
                        if write else None),
               render_factor=args.render_video_factor, device=device,
               mesh=mesh, **flags)

    if args.visualise_canonical and args.render_pcd and write:
        from .kinematics.visualize import visualise_skeletonizer
        with torch.no_grad():
            weights = tp.get_weights(model, state).cpu().numpy()
        joints = model.joints.detach().cpu().numpy()
        if prune_info is not None:
            joints_v, bones_v = prune_info["new_joints"], \
                prune_info["new_bones"]
        else:
            joints_v, bones_v = joints, np.asarray(state["bones"])
        visualise_skeletonizer(
            state["skeleton_pcd"].cpu().numpy(), joints[0], joints_v,
            bones_v, state["canonical_pcd"].cpu().numpy(), weights,
            save_path=os.path.join(save_path, "canonical_skeleton.png"))


def points_render_config(mcfg: tp.TemporalPointsConfig,
                         cfg: Mapping[str, Any]) -> tp.TemporalPointsConfig:
    """``mcfg`` with the render-time knobs of the scene configuration
    ``cfg`` (its ``pcd_model_and_render`` mapping).

    The knobs follow the configuration, not the checkpoint: ``knn_share`` /
    ``knn_cand`` / ``coarse_stride`` are inference-time approximation /
    speed trade-offs, so a model trained exact can be re-rendered with the
    subgroup-shared k-NN without retraining. ``fused_agg`` may be switched
    on here because rendering is forward-only (checkpoints always carry
    False). ``render_exact=True`` is the one-knob escape back to the exact
    per-sample k-NN. An approximate mode is announced loudly."""
    pcd = cfg["pcd_model_and_render"]
    ov: Dict[str, Any] = {k: int(pcd[k])
                          for k in ("knn_share", "knn_cand", "coarse_stride")
                          if k in pcd}
    if "fused_agg" in pcd:
        ov["fused_agg"] = bool(pcd["fused_agg"])
    if bool(pcd.get("render_exact", False)):
        ov["knn_share"] = 1
    mcfg = dataclasses.replace(mcfg, **ov)
    share = int(mcfg.knn_share)
    if share > 1:
        impact = (">= 60 dB vs exact" if share <= 4 else
                  ">= 50 dB vs exact" if share <= 16 else
                  "~50 dB vs exact (measured at share 32)")
        print(f"render: APPROXIMATE subgroup-shared KNN active "
              f"(knn_share={share}, impact class {impact}); set "
              f"pcd_model_and_render.render_exact=True for exact KNN")
    return mcfg


def renders_weights(mcfg: tp.TemporalPointsConfig) -> bool:
    """Whether the points renderer draws the LBS-weight images: not when
    the configuration asks for the fused aggregation (kernel K6), which
    does not give the per-sample skinning weights those images need."""
    if mcfg.fused_agg:
        print("render: fused_agg: the LBS-weight images are not rendered")
    return not mcfg.fused_agg


def repose(model, state, data_dict, near, far, bg, seed: int = 0,
           savedir: Optional[str] = None, render_factor: int = 0,
           chunk: int = 8192, device=None, mesh=None,
           **flags) -> Dict[str, Any]:
    """Random repose animation: seeded random target rotations (row j is
    axis_xyz, angle of joint j; the root stays fixed), a 30-step ramp there
    and back, rendered from the first camera of ``data_dict`` through
    ``render_viewpoints`` on ``device`` (``None``: the CUDA device; raises
    without one), with LBS-weight images unless ``fused_agg``
    (``renders_weights``). Returns its result (60 frames); with
    ``savedir`` the frames and videos are written there. ``mesh``: each
    frame's chunks over its ranks (``make_points_renderer``).

    For a manual animation edit ``target``."""
    rng = np.random.default_rng(seed)
    J = model.cfg.n_joints
    steps = 30
    target = rng.normal(size=(J, 4)).astype(np.float32) * 0.2
    target[0] = 0.0
    ramp = np.linspace(0, 1, steps, dtype=np.float32)[:, None, None]
    rot_seq = target[None] * ramp
    rot_seq = np.concatenate([rot_seq, rot_seq[::-1]], 0)
    steps = len(rot_seq)

    poses = np.repeat(data_dict["poses"][0][None], steps, 0)
    Ks = np.repeat(data_dict["Ks"][0][None], steps, 0)
    renderer = make_points_renderer(
        model, state, near, far, bg,
        render_weights=renders_weights(model.cfg), poses=poses, Ks=Ks,
        mesh=mesh)

    def make_view(i, t):
        return renderer(i, None, rot_params=rot_seq[i])
    make_view.mesh = mesh

    out = render.render_viewpoints(
        make_view, poses, np.repeat(data_dict["HW"][0][None], steps, 0), Ks,
        np.zeros(steps), savedir=savedir, render_factor=render_factor,
        chunk=chunk, device=device, **flags)
    if savedir is not None:
        render.write_video(os.path.join(savedir, "train_video.rgb.mp4"),
                           out["rgbs"])
        if len(out["weights"]):
            render.write_video(os.path.join(savedir, "video.weights.mp4"),
                               out["weights"])
    return out


if __name__ == "__main__":
    main()
