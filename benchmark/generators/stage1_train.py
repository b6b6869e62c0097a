"""Closed-loop stage-1 training through ``scene_rep_reconstruction``, as
users call it, in the phase that most of a run's steps are in: the full
grid, no ``pg_scale`` rebuild left, the occupancy path on. The traffic
file's ``train_config`` overrides put the run in that phase from its
first step (``pg_scale`` empty, ``occupancy_start`` 1); the rest is as
``stage2_train``: ``warmup_steps``, ``check_steps``, ``trace_steps``,
``log_every``, the step object of ``stage1.make_graphed_step`` wrapped,
and the reference (``reference.stage1``) following the checked steps on
the rows the program drew.

End-to-end: ``train_step_ms``, ``setup_s``. Traced, the work a step
needs besides: the filled samples, K5's bytes and G1's (its rows, live
rows and the grid points they touch counted in the reference's steps,
``reference.stage1.counting_grid_rows``).
"""
from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from ..reference import stage1 as ref
from ..scene import make_scene, seed_of
from ..work import g1_bound, k5_bound, tineuvox_step
from .common import Window, WindowClosed, free_device, peaks, program_config
from .stage2_train import CHECKED, clone, compare, host_copy, on_host


def run(ctx) -> Dict:
    from unittest import mock

    from apnerf_torch.train import stage1

    traffic = ctx.traffic
    n_check = int(traffic["check_steps"])
    scene = make_scene(ctx.config, ctx.seed, ctx.device)
    cfg = program_config(ctx.config)
    cfg["train_config"] = type(cfg)(
        {**cfg["train_config"], **traffic["train_config"]})
    win = Window(ctx, int(traffic["warmup_steps"]),
                 int(traffic["trace_steps"]))
    rec = {"drawn": [], "losses": []}
    real_make = stage1.make_graphed_step

    def make(*args, **kwargs):
        step = real_make(*args, **kwargs)
        model = next(a for a in args if isinstance(a, torch.nn.Module))
        params = dict(model.named_parameters())

        def call(batch, *a, **kw):
            n = win.count + 1
            if n == 1:
                rec["p0"] = clone(params)
            if n <= n_check:
                rec["drawn"].append(host_copy(batch))
            out = step(batch, *a, **kw)
            if n <= n_check:
                rec["losses"].append(out[0].detach().clone())
            if n == 1:
                rec["grads1"] = {k: (None if g is None else g.detach()
                                     .clone()) for k, g in out[2].items()}
            if n == n_check:
                rec["p_end"] = clone(params)
            win.tick()
            return out
        call.inputs = step.inputs
        return call

    with mock.patch.object(stage1, "make_graphed_step", make):
        try:
            stage1.scene_rep_reconstruction(
                cfg, scene.data, seed=seed_of(ctx.seed),
                n_iters=int(cfg.train_config.N_iters),
                log_every=int(traffic["log_every"]), device=ctx.device)
            raise RuntimeError("scene_rep_reconstruction ended before the "
                               "window closed")
        except WindowClosed:
            pass
    losses = [float(x) for x in rec.pop("losses")]
    drawn = rec.pop("drawn")
    prog = {k: {n: (None if v is None else v.cpu()) for n, v in rec[k]
                .items()} for k in ("p0", "grads1", "p_end")}
    del rec
    peak = free_device()

    setting = ref.Setting(ctx.config, traffic["train_config"], scene,
                          seed_of(ctx.seed), ctx.device)
    grid_calls = []
    with ref.counting_grid_rows(grid_calls):
        r = on_host(ref.run_steps(setting, drawn))
    gaps = compare(dict(prog, losses=losses), r)
    lim = ctx.limits
    checks = [("rows_mismatched", float(r["mismatches"]),
               lim["rows_mismatched"])]
    checks += [(k, gaps[k], lim[k]) for k in CHECKED]
    out = {"attempted": win.units,
           "failed": sum(not np.isfinite(x) for x in losses),
           "checks": checks, "memory_peak_bytes": peak,
           "e2e": {"train_step_ms": 1e3 * win.seconds / win.units,
                   "setup_s": win.setup_s},
           "loss_gap_by_step": gaps["loss_gap_by_step"]}
    if ctx.extra.get("controls"):
        out["controls"] = {
            name: compare(on_host(ref.run_steps(setting, drawn, **kw)), r)
            for name, kw in (("tf32", {"tf32": True}),
                             ("half_batch", {"half_batch": True}))}
    if ctx.trace:
        filled = float(np.mean(r["filled"]))
        mcfg = r["cfg"]
        ops = tineuvox_step(mcfg, filled, int(cfg.train_config.N_rand),
                            train=True)
        g1 = g1_bound(grid_calls, len(drawn), peaks())
        print(f"stage1: G1's calls {grid_calls}, {g1['bytes']!r} bytes a "
              f"step", file=sys.stderr)
        out["reading"] = {
            "trace": win.reading(), "unit_s": win.seconds / win.units,
            "peaks": peaks(),
            "work": {"ops": ops,
                     "k5": k5_bound(r["world_size"], mcfg.voxel_dim,
                                    filled, peaks()),
                     "g1": g1,
                     "counts": {"filled": filled}}}
    return out
