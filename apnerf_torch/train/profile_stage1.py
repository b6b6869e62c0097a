"""Where the time of a stage-1 training step goes, on one GPU.

    python -m apnerf_torch.train.profile_stage1 [--warmup 5] [--steps 3]
                                                [--trace DIR]

Trains the nerf family at full width (160^3 x 12 grid, 4096 rays a step,
the occupancy path from step 2, no grid rebuild) on a 6-view 400 x 400 arm
scene two ways: graphed (the trainer as it runs, each step a CUDA-graph
replay after its segment's first) and eager (``make_train_step`` behind
the same call, ``eager_steps``: the yardstick). Each way records
``--steps`` steps after ``--warmup`` with ``torch.profiler``: the window's
wall time, the device's busy and idle share (the union of the kernels'
intervals), kernels a step, the host's launch calls a step
(``cudaLaunchKernel`` and the like against ``cudaGraphLaunch``, and the
static inputs' copies), the captures' ms, the peak memory of the run, and
device time by group (K5, GEMMs, the rest) and by kernel. ``--trace``
also writes the Chrome traces there. Every step ends in a host sync (the
loss is logged), as in ``chip_smoke.py``'s step times.
"""
from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from unittest import mock

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


class EagerStep:
    """The eager step behind a graphed step's call: ``step(batch, key)``
    loads the batch into the same static inputs and runs ``run(key)``."""

    def __init__(self, inputs, run):
        self.inputs = inputs
        self.run = run
        self.capture_ms = {}

    def __call__(self, batch, key=()):
        from ..utils.graphs import load_static
        for name, value in batch.items():
            load_static(self.inputs[name], value)
        return self.run(*key)


@contextmanager
def eager_steps(made=None):
    """Within: ``scene_rep_reconstruction``'s segments step through
    ``make_train_step`` (eagerly) instead of their graphs; ``made``, a
    list, receives every segment's step object either way."""
    from . import stage1

    def eager(model, cfg_train, optimizer, Ks, poses, H, W, near, far, bg,
              n_rand, inverse_y=False, flip_x=False, flip_y=False,
              active_budget=None, occ_shape=None):
        step = stage1.make_train_step(
            model, cfg_train, optimizer, Ks, poses, H, W, near, far, bg,
            inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y,
            active_budget=active_budget)
        inputs = stage1.step_inputs(n_rand, occ_shape, Ks.device)
        batch = {k: v for k, v in inputs.items() if k != "occ"}

        def run(tv_on, tv_dense):
            return (*step(batch, tv_on, inputs.get("occ"), tv_dense), None)
        out = EagerStep(inputs, run)
        if made is not None:
            made.append(out)
        return out

    with mock.patch.object(stage1, "make_graphed_step", eager):
        yield


@contextmanager
def recorded_steps(module, made):
    """Within: ``module.make_graphed_step``'s step objects appended to
    ``made``."""
    real = module.make_graphed_step

    def record(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]
    with mock.patch.object(module, "make_graphed_step", record):
        yield


def host_calls(prof) -> dict:
    """``profile_render.host_launch_calls`` (kernel and graph launches) and
    the host's asynchronous copies (``copy``: a step's static inputs, the
    logged metrics' readback) of a profile."""
    from ..render.profile_render import host_launch_calls
    calls = host_launch_calls(prof)
    calls["copy"] = sum(e.count for e in prof.key_averages()
                        if e.key in ("cudaMemcpyAsync", "cuMemcpyAsync"))
    return calls


def profile_window(train, warmup: int, steps: int):
    """``train(callback)`` runs training; ``callback(step)`` at every
    logged step starts the profiler after step ``warmup`` and stops it
    after ``warmup + steps`` -> (profiler, window us)."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    wall = {}

    def callback(step, *args):
        if step == warmup:
            torch.cuda.synchronize()
            prof.start()
            wall["t0"] = time.perf_counter()
        elif step == warmup + steps:
            torch.cuda.synchronize()
            wall["t1"] = time.perf_counter()
            prof.stop()

    train(callback)
    return prof, (wall["t1"] - wall["t0"]) * 1e6


def report(tag, prof, window_us, steps, group, made, peak, trace=""):
    """Print a profiled window's readings, a step each."""
    kernels = _kernel_intervals(prof)
    busy = _union_us(kernels)
    host = host_calls(prof)
    by_group, by_name = defaultdict(float), defaultdict(float)
    for name, s, e in kernels:
        by_group[group(name)] += e - s
        by_name[name] += e - s
    dev_total = sum(by_group.values()) or 1.0
    capture = [round(v, 1) for st in made for v in st.capture_ms.values()]
    print(f"{tag}: {steps} steps, {torch.cuda.get_device_name(0)}: window "
          f"{window_us / 1e3:.1f} ms ({window_us / 1e3 / steps:.2f} "
          f"ms/step), device busy {busy / 1e3 / steps:.2f} ms/step, idle "
          f"share {1 - busy / window_us:.3f}, {len(kernels) / steps:.0f} "
          f"kernels a step, host launch calls a step "
          f"{ {k: v / steps for k, v in host.items()} }, captures "
          f"{capture} ms, peak device memory {peak / 2 ** 30:.2f} GiB")
    for g, t in sorted(by_group.items(), key=lambda x: -x[1]):
        print(f"{tag}: group {g}: {t / 1e3 / steps:.3f} ms a step "
              f"({t / dev_total:.3f} of device time)")
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:12]:
        print(f"{tag}: kernel {t / 1e3 / steps:8.3f} ms a step  "
              f"{name[:110]}")
    if trace:
        os.makedirs(trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace, tag.replace(" ", "_") + "_trace.json"))


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
    from . import stage1

    data = make_scene(6, 400, 400, seed=0)
    cfg = nerf_default(N_iters=args.warmup + args.steps, pg_scale=[],
                       occupancy_start=2)
    for way in ("graphed", "eager"):
        made = []
        steps_of = (recorded_steps(stage1, made) if way == "graphed"
                    else eager_steps(made))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with steps_of:
            prof, window_us = profile_window(
                lambda cb: stage1.scene_rep_reconstruction(
                    cfg, data, seed=0, log_every=1, callback=cb,
                    device="cuda"), args.warmup, args.steps)
        report(f"profile_stage1 {way}", prof, window_us, args.steps,
               _group, made, torch.cuda.max_memory_allocated(), args.trace)
        del made
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
