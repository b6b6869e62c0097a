"""Where the time of a stage-1 training step goes, on one GPU.

    python -m apnerf_torch.train.profile_stage1 [--warmup 5] [--steps 3]
                                                [--trace DIR]

Trains the nerf family at full width (160^3 x 12 grid, 4096 rays a step,
the occupancy path from step 2, no grid rebuild) on a 6-view 400 x 400 arm
scene, and records ``--steps`` steps after ``--warmup`` with
``torch.profiler``: the window's wall time, the device's busy and idle
share (the union of the kernels' intervals), and device time by group
(K5, GEMMs, the rest) and by kernel. ``--trace`` also writes the Chrome
trace there. Every step ends in a host sync (the loss is logged), as in
``chip_smoke.py``'s step times.
"""
from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict

import torch

GEMM_MARKS = ("gemm", "Gemm", "nvjet", "cutlass", "xmma", "sm90_")
K5_MARKS = ("accumulate_kernel", "plan_kernel", "combine_kernel")


def _group(name: str) -> str:
    if any(m in name for m in K5_MARKS):
        return "K5 scatter"
    if any(m in name for m in GEMM_MARKS):
        return "GEMM (MLPs)"
    return "other"


def _kernel_intervals(prof):
    """(name, start_us, end_us) of every device kernel in the profile."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((s, e) for _, s, e in intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--trace", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stage1: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..config import nerf_default
    from ..data.synthetic import make_scene
    from .stage1 import scene_rep_reconstruction

    data = make_scene(6, 400, 400, seed=0)
    n = args.warmup + args.steps
    cfg = nerf_default(N_iters=n, pg_scale=[], occupancy_start=2)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    wall = {}

    def callback(step, model, model_cfg, stats):
        if step == args.warmup:
            torch.cuda.synchronize()
            prof.start()
            wall["t0"] = time.perf_counter()
        elif step == n:
            torch.cuda.synchronize()
            wall["t1"] = time.perf_counter()
            prof.stop()

    scene_rep_reconstruction(cfg, data, seed=0, log_every=1,
                             callback=callback, device="cuda")
    window_us = (wall["t1"] - wall["t0"]) * 1e6
    kernels = _kernel_intervals(prof)
    busy = _union_us(kernels)
    by_group, by_name = defaultdict(float), defaultdict(float)
    for name, s, e in kernels:
        by_group[_group(name)] += e - s
        by_name[name] += e - s
    dev_total = sum(by_group.values())
    print(f"profile_stage1: {args.steps} steps after {args.warmup}, "
          f"{torch.cuda.get_device_name(0)}: window {window_us / 1e3:.1f} ms "
          f"({window_us / 1e3 / args.steps:.1f} ms/step), device busy "
          f"{busy / 1e3:.1f} ms, idle share {1 - busy / window_us:.3f}, "
          f"{len(kernels)} kernels")
    for g, t in sorted(by_group.items(), key=lambda x: -x[1]):
        print(f"profile_stage1: group {g}: {t / 1e3:.2f} ms "
              f"({t / dev_total:.3f} of device time)")
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:20]:
        print(f"profile_stage1: kernel {t / 1e3:8.2f} ms  {name[:110]}")
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace,
                                              "stage1_trace.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
