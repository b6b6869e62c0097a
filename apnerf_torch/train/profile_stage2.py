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
trace there.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from .profile_stage1 import GEMM_MARKS, _kernel_intervals, _union_us

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
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    wall = {}

    def callback(step, model, mcfg, state, stats):
        if step == args.warmup:
            torch.cuda.synchronize()
            prof.start()
            wall["t0"] = time.perf_counter()
        elif step == n:
            torch.cuda.synchronize()
            wall["t1"] = time.perf_counter()
            prof.stop()

    torch.cuda.reset_peak_memory_stats()
    _, mcfg, _, _ = train_pcd(cfg, data, art["canonical"], art["skeleton"],
                              heads, s1cfg, bbox, seed=0, n_iters=n,
                              log_every=1, callback=callback, max_steps=192,
                              device="cuda")
    window_us = (wall["t1"] - wall["t0"]) * 1e6
    kernels = _kernel_intervals(prof)
    busy = _union_us(kernels)
    by_group, by_name = defaultdict(float), defaultdict(float)
    for name, s, e in kernels:
        by_group[_group(name)] += e - s
        by_name[name] += e - s
    dev_total = sum(by_group.values())
    print(f"profile_stage2: {args.steps} steps after {args.warmup}, "
          f"{len(art['canonical']['pcd'])} points, {mcfg.n_joints} joints, "
          f"sample_budget {mcfg.sample_budget}, "
          f"{torch.cuda.get_device_name(0)}: window "
          f"{window_us / 1e3:.1f} ms ({window_us / 1e3 / args.steps:.1f} "
          f"ms/step), device busy {busy / 1e3:.1f} ms "
          f"({busy / 1e3 / args.steps:.1f} ms/step), idle share "
          f"{1 - busy / window_us:.3f}, {len(kernels) / args.steps:.0f} "
          f"kernels a step, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for g, t in sorted(by_group.items(), key=lambda x: -x[1]):
        print(f"profile_stage2: group {g}: {t / 1e3 / args.steps:.3f} ms a "
              f"step ({t / dev_total:.3f} of device time, "
              f"{t / window_us:.3f} of the step)")
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:20]:
        print(f"profile_stage2: kernel {t / 1e3 / args.steps:8.3f} ms a step"
              f"  {name[:110]}")
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace,
                                              "stage2_trace.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
