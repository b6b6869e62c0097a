"""Where the time of a rendered frame goes, on one GPU.

    python -m apnerf_torch.render.profile_render [--views 3] [--trace DIR]

Renders the bench scene (10^4 points, 24 joints, F = 128, K = 8, random
weights from a seed) at 400 x 400 in 8192-ray chunks through
``make_points_renderer`` + ``render_viewpoints`` in the three k-NN modes
(exact, shared, fused), each two ways: graphed (the renderer's image
function: two CUDA-graph replays a view) and eager (the image function
removed: the chunk loop from Python). For each: the capture's ms and the
peak memory of the first pass (the graphs captured in it), then
``--views`` views under ``torch.profiler``: the window's wall time, the
device's busy and idle share (the union of the kernels' intervals), the
share of device time of the hand-written kernels (K2 / K3 the k-NN, K4
``featmlp``, K6 ``agg``), the kernels a frame, the host's launch calls a
frame (``cudaLaunchKernel`` and the like against ``cudaGraphLaunch``), and
the kernels that take the most device time. In the eager frames the K2 /
K3 wrappers run inside profiler ranges; the Chrome trace says which
runtime calls each range made and, by their CUPTI correlation ids, which
kernels those calls launched. (``prof.events()`` cannot be asked this: it
ties a runtime call to the kernels of the operation whose External id
equals the call's correlation id, two numberings that overlap in the
first profile of a process, so it shows unrelated PyTorch kernels under a
range; the trace line counts such calls.) ``--trace`` keeps the Chrome
traces there.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

from ..train.profile_stage1 import _kernel_intervals, _union_us

H = W = 400
FOCAL = 555.0
CHUNK = 8192
# substrings of the hand-written kernels' names (csrc/*.cu); K3 is the
# top-k scan of csrc/knn_scan.cuh, which K1 shares (K1 runs at a load, not
# inside the profiled frames)
OWN = {"K4 featmlp": ("RowFront",), "K6 agg": ("SubgroupFront",),
       "K2 knn_count": ("knn_count",), "K3 knn_radius": ("knn_topk_kernel",)}


def _group(name: str) -> str:
    for group, marks in OWN.items():
        if any(m in name for m in marks):
            return group
    return "other"


# the K2 / K3 wrappers of kernels/knn_cells.py and the names of their
# profiler ranges (which must not hold a kernel's name: see OWN)
WRAPPERS = {"knn_count_cuda": "wrapper of K2", "knn_radius_cuda":
            "wrapper of K3"}


@contextmanager
def wrapper_ranges():
    """Run the K2 / K3 wrappers inside the profiler ranges of WRAPPERS."""
    from ..kernels import knn_cells as kc

    def ranged(name):
        fn = getattr(kc, name)

        def call(*args, **kw):
            with torch.profiler.record_function(WRAPPERS[name]):
                return fn(*args, **kw)
        return call
    k2, k3 = WRAPPERS
    with mock.patch.object(kc, k2, ranged(k2)), \
            mock.patch.object(kc, k3, ranged(k3)):
        yield


def range_launches(path):
    """By wrapper range, from the Chrome trace at ``path``: the ranges, the
    runtime calls made inside them (on the range's thread, within its
    span), the kernels of those calls' correlation ids by group, and the
    calls whose correlation id is also the External id of an operation
    with kernels (the ties ``prof.events()`` reports), with those
    operations' names."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    kernels, op_kernels, owner = defaultdict(list), defaultdict(int), {}
    for e in events:
        args = e.get("args", {})
        if e.get("cat") == "kernel":
            kernels[args.get("correlation")].append(_group(e["name"]))
            op_kernels[args.get("External id")] += 1
        elif e.get("cat") in ("cpu_op", "user_annotation") and \
                "External id" in args:
            owner[args["External id"]] = e["name"]
    ranges = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in \
                WRAPPERS.values():
            ranges[e["tid"]].append(e)
    rows = {name: dict(ranges=0, calls=0, kernels=defaultdict(int),
                       clashes=defaultdict(int))
            for name in WRAPPERS.values()}
    for rs in ranges.values():
        for r in rs:
            rows[r["name"]]["ranges"] += 1
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        for r in ranges.get(e["tid"], ()):
            if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]:
                row, corr = rows[r["name"]], e["args"].get("correlation")
                row["calls"] += 1
                for g in kernels.get(corr, ()):
                    row["kernels"][g] += 1
                if op_kernels.get(corr):
                    row["clashes"][owner.get(corr, "?")] += 1
    return rows


# the host's calls that launch one kernel, and those that launch a graph
LAUNCH_CALLS = {"kernel": ("cudaLaunchKernel", "cudaLaunchKernelExC",
                           "cuLaunchKernel", "cuLaunchKernelEx"),
                "graph": ("cudaGraphLaunch", "cuGraphLaunch")}


def host_launch_calls(prof) -> dict:
    """The launch calls of a profile by kind (``LAUNCH_CALLS``)."""
    counts = dict.fromkeys(LAUNCH_CALLS, 0)
    for e in prof.key_averages():
        for kind, names in LAUNCH_CALLS.items():
            if e.key in names:
                counts[kind] += e.count
    return counts


def cameras(n):
    """``n`` cameras on an arc about the cloud at distance 3, times over
    the whole motion (the views of ``chip_smoke.py``'s phase 6)."""
    poses = np.repeat(np.eye(4, dtype=np.float32)[None], n, 0)
    for i, a in enumerate(np.linspace(-0.3, 0.3, n)):
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [3.0 * np.sin(a), 0.0, 3.0 * np.cos(a)]
    Ks = np.repeat(np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2],
                             [0, 0, 1]], np.float32)[None], n, 0)
    return poses, Ks, np.array([[H, W]] * n), \
        np.linspace(0.0, 1.0, n).astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--views", type=int, default=3)
    p.add_argument("--trace", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_render: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from .. import cli, kernels
    from ..data.bench_scene import bench_model
    from .render import render_viewpoints
    from .renderers import chunk_loop, make_points_renderer

    model, state = bench_model()
    base = model.cfg
    shared = dict(knn_share=16, knn_cand=8, coarse_stride=32)
    modes = {mode: cli.points_render_config(
        base, {"pcd_model_and_render": over}) for mode, over in (
            ("exact", dict(render_exact=True)),
            ("shared", dict(shared, fused_agg=False)),
            ("fused", dict(shared, fused_agg=True)))}
    poses, Ks, HW, times = cameras(args.views)

    def profiled(mode, way):
        model.cfg = modes[mode]
        view = make_points_renderer(model, state, 0.5, 6.0, 1.0,
                                    render_weights=False)
        if way == "eager":
            graphed, view = view, lambda i, t: chunk_loop(graphed(i, t))

        def render():
            return render_viewpoints(view, poses, HW, Ks, times,
                                     chunk=CHUNK, verbose=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        render()                              # warm-up, build, capture
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        calls = getattr(view, "graphs", None)
        capture = (sum(c.capture_ms for c in calls.calls.values())
                   if calls is not None else 0.0)
        kernels.reset_launches()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        with wrapper_ranges():
            render()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
        prof.stop()
        return prof, window_us, capture, peak

    n = args.views
    for mode in modes:
        for way in ("graphed", "eager"):
            tag = f"{mode} {way}"
            prof, window_us, capture, peak = profiled(mode, way)
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            host = host_launch_calls(prof)
            # the ranges show up on the device's side too: they are no
            # kernels
            ivals = [iv for iv in _kernel_intervals(prof)
                     if iv[0] not in WRAPPERS.values()]
            busy = _union_us(ivals)
            by_group, by_name, count = (defaultdict(float),
                                        defaultdict(float), defaultdict(int))
            for name, s, e in ivals:
                by_group[_group(name)] += e - s
                by_name[name] += e - s
                count[name] += 1
            dev_total = sum(by_group.values()) or 1.0
            print(f"profile_render {tag}: {n} views of {H}x{W}, "
                  f"{torch.cuda.get_device_name(0)}: "
                  f"{window_us / 1e3 / n:.1f} ms/frame under the profiler, "
                  f"device busy {busy / 1e3 / n:.1f} ms/frame, idle share "
                  f"{1 - busy / window_us:.3f}, {len(ivals) // n} kernels "
                  f"a frame, host launch calls a frame "
                  f"{ {k: v / n for k, v in host.items()} }, capture "
                  f"{capture:.1f} ms, peak memory of the first pass "
                  f"{peak / 2 ** 30:.3f} GiB, launches {launches}")
            for g, t in sorted(by_group.items(), key=lambda x: -x[1]):
                print(f"profile_render {tag}: group {g}: {t / 1e3 / n:.2f} "
                      f"ms/frame ({t / dev_total:.3f} of device time)")
            for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
                print(f"profile_render {tag}: kernel {t / 1e3 / n:7.2f} "
                      f"ms/frame in {count[name] // n:5d} launches  "
                      f"{name[:100]}")
            out_dir = args.trace or tempfile.mkdtemp()
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"render_{mode}_{way}_trace.json")
            prof.export_chrome_trace(path)
            # a replay runs no wrapper: the ranges are the eager frame's
            rows = range_launches(path) if way == "eager" else {}
            for name, row in rows.items():
                own = ", ".join(f"{c / n:.1f} {g}" for g, c in
                                row["kernels"].items() if g != "other")
                clash = sum(row["clashes"].values())
                ops = ", ".join(sorted(row["clashes"]))[:120] or "none"
                print(f"profile_render {tag}: {name}: "
                      f"{row['ranges'] / n:.0f} calls a frame, "
                      f"{row['calls'] / n:.1f} runtime calls a frame "
                      f"inside, launching {own or 'no own kernel'} and "
                      f"{row['kernels']['other'] / n:.1f} PyTorch kernels a "
                      f"frame; {clash / n:.1f} of the calls a frame carry a "
                      f"correlation id that is also an operation's External "
                      f"id ({ops}: prof.events() ties that operation's "
                      f"kernels to them)")
            if not args.trace:
                os.remove(path)
                os.rmdir(out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
