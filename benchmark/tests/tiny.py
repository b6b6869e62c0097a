"""Tiny cells for the harness's CPU tests (not a test module): a
configuration of the benchmark shrunk so that a whole run, the program's
loop and the reference, takes seconds on the CPU."""
from __future__ import annotations

import copy

from benchmark import run as bench


def tiny_config(cfg):
    cfg = copy.deepcopy(cfg)
    cam = cfg["cameras"]
    scale = 48 / cam["size"]
    cam.update(size=48, focal=cam["focal"] * scale)
    if cam["layout"] == "monocular":
        cam["n_images"] = 4
    else:
        cam.update(n_cams=2, n_times=3)
    cfg["model_and_render"].update(net_width=32, num_voxels=24 ** 3,
                                   num_voxels_base=24 ** 3)
    cfg["train_config"]["N_rand"] = 256
    cfg["pcd_model_and_render"].update(canonical_pcd_num=600,
                                       sample_budget=32)
    cfg["pcd_train_config"]["N_rand"] = 256
    cfg["max_steps"] = 32
    return cfg


def tiny_context(workload, seed=3, trace=False, **traffic):
    spec = bench.bench_spec()
    ctx = bench.context(spec, workload, seed, 0.2, trace, device="cpu")
    ctx.config = tiny_config(ctx.config)
    ctx.traffic = dict(ctx.traffic, **traffic)
    if "chunk" in ctx.traffic:
        ctx.traffic.update(chunk=512, warmup_frames=2, trace_frames=2,
                           sample_frames=2)
    else:
        ctx.traffic.update(warmup_steps=4, trace_steps=2)
    if "train_config" in ctx.traffic:
        ctx.traffic["train_config"] = dict(ctx.traffic["train_config"],
                                           occupancy_update_every=3)
    return spec, ctx
