"""Where the time of a stage-2 training step goes, on one GPU.

    python -m apnerf_torch.train.profile_stage2 [--stage1-steps 110]
                                                [--warmup 5] [--steps 5]
                                                [--trace DIR]

Trains stage 1 of the nerf family at full width on a 6-view 400 x 400 arm
scene for ``--stage1-steps`` steps (pg_scale [4], occupancy from step 2,
as ``chip_smoke.py``'s phases 4 and 7), exports it at the nerf family's
thresholds, then runs ``train_pcd`` (8192 rays, every loss term, the
family's sample budget of 192: ``max_steps`` 192, since the arm is crossed
in fewer steps, so the fused group sampler runs, as in phase 7) and
records ``--steps`` steps after ``--warmup`` with ``torch.profiler``: the
window's wall time, the device's busy and idle share (the union of the
kernels' intervals), and device time by group (K2, K3, K4, GEMMs, the
rest) and by kernel. Every step ends in a host sync (the loss is logged),
as in ``chip_smoke.py``'s step times. ``--trace`` also writes the Chrome
trace there. Both ways, as ``profile_stage1`` does: graphed (``train_pcd``
as it runs, each step a CUDA-graph replay after the first) and eager
(``make_train_step`` behind the same call, ``eager_steps``), each with the
kernels a step, the host's launch calls a step, the capture's ms and the
peak memory of the run.
"""
from __future__ import annotations

import argparse
import tempfile
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

from .profile_stage1 import (GEMM_MARKS, EagerStep, profile_window,
                             recorded_steps, report)

# substrings of the hand-written kernels' names (csrc/*.cu); K1 shares K3's
# scan but runs once, in build_model, before the profiled window
OWN = {"K2 knn_count": ("knn_count",), "K3 knn_radius": ("knn_topk_kernel",),
       "K4 featmlp": ("RowFront",)}


def _group(name: str) -> str:
    for group, marks in OWN.items():
        if any(m in name for m in marks):
            return group
    if any(m in name for m in GEMM_MARKS):
        return "GEMM (MLPs)"
    return "other"


@contextmanager
def eager_steps(made=None):
    """Within: ``train_pcd`` steps through ``make_train_step`` (eagerly)
    instead of its graph; ``made``, a list, receives the step object."""
    from . import stage2

    def eager(model, state, cfg_train, optimizer, Ks, poses, H, W, near,
              far, bg, n_chamfer_views, n_rand, inverse_y=False,
              flip_x=False, flip_y=False):
        step = stage2.make_train_step(
            model, state, cfg_train, optimizer, Ks, poses, H, W, near, far,
            bg, n_chamfer_views, inverse_y=inverse_y, flip_x=flip_x,
            flip_y=flip_y, full=True)
        inputs = stage2.step_inputs(n_rand, n_chamfer_views, Ks.device)
        out = EagerStep(inputs, lambda: step(inputs))
        if made is not None:
            made.append(out)
        return out

    with mock.patch.object(stage2, "make_graphed_step", eager):
        yield


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage1-steps", type=int, default=110)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--trace", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stage2: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..config import nerf_default
    from ..data.synthetic import make_scene
    from ..models.temporal_points import HEADS
    from ..utils.checkpoint import params_to_jax
    from .export import export_point_cloud
    from .stage1 import scene_rep_reconstruction
    from .stage2 import train_pcd

    data = make_scene(6, 400, 400, seed=0)
    n = args.warmup + args.steps
    cfg = nerf_default(N_iters=args.stage1_steps, pg_scale=[4],
                       occupancy_start=2)
    s1, s1cfg, _ = scene_rep_reconstruction(
        cfg, data, seed=0, log_every=args.stage1_steps, device="cuda")
    pm = cfg.pcd_model_and_render
    with tempfile.TemporaryDirectory() as d:
        art = export_point_cloud(
            s1, d, float(cfg.data.canonical_t),
            float(cfg.model_and_render.stepsize),
            pcd_density_threshold=float(pm.pcd_density_threshold),
            skeleton_density_threshold=float(pm.skeleton_density_threshold),
            bone_length=float(pm.bone_length),
            canonical_pcd_num=float(pm.canonical_pcd_num), overwrite=True)
    heads = params_to_jax({k: v for k, v in s1.state_dict().items()
                           if k.split(".")[0] in HEADS})
    bbox = (np.asarray(s1cfg.xyz_min), np.asarray(s1cfg.xyz_max))
    del s1
    from . import stage2
    for way in ("graphed", "eager"):
        made, out = [], {}
        steps_of = (recorded_steps(stage2, made) if way == "graphed"
                    else eager_steps(made))

        def train(callback):
            out["mcfg"] = train_pcd(
                cfg, data, art["canonical"], art["skeleton"], heads, s1cfg,
                bbox, seed=0, n_iters=n, log_every=1, callback=callback,
                max_steps=192, device="cuda")[1]

        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with steps_of:
            prof, window_us = profile_window(train, args.warmup, args.steps)
        mcfg = out["mcfg"]
        print(f"profile_stage2 {way}: {len(art['canonical']['pcd'])} "
              f"points, {mcfg.n_joints} joints, sample_budget "
              f"{mcfg.sample_budget}")
        report(f"profile_stage2 {way}", prof, window_us, args.steps, _group,
               made, torch.cuda.max_memory_allocated(), args.trace)
        del made
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
