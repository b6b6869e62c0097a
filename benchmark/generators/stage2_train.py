"""Closed-loop stage-2 training through ``train_pcd``, as users call it.

The traffic file gives ``warmup_steps`` (set-up: the first step, which
the program runs eagerly and captures, and replays after it),
``check_steps`` (the first steps, which the reference follows),
``trace_steps`` (the traced window) and ``log_every`` (the program's log
readback, the command line's default). ``train_pcd`` runs at the
configuration's ``N_iters`` and is ended from inside its loop once the
window has closed.

The step object that ``train_pcd`` builds (``stage2.make_graphed_step``)
is wrapped, not replaced: the wrapper keeps a copy of the parameters
before the first step and after the last checked one, of the rows each
checked step drew, of their losses and of the first step's gradients as
the optimizer gets them (all queued on the device, no wait), and counts
the steps for the window. After the window the reference builds its own
model from the same scene and seed and follows the checked steps on those
rows (``reference.stage2``).

End-to-end: ``train_step_ms``, the window's wall time over its steps, the
host's batch draw and the log readback included; ``setup_s``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..reference import stage2 as ref
from ..scene import make_scene, seed_of
from ..work import mean_counts, point_model, samples
from .common import (Window, WindowClosed, free_device, leaf_gap,
                     moving_leaves, peaks, program_config)


def host_copy(batch: Dict) -> Dict:
    return {k: np.array(v, copy=True) for k, v in batch.items()}


def clone(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in params.items()}


def shape_of(mcfg) -> Dict:
    """The point model's shapes that ``work.point_model`` counts."""
    return dict(F=mcfg.feat_dim, K=mcfg.neighbours, pts_ch=mcfg.pts_ch,
                views_ch=mcfg.views_ch, pose_dim=mcfg.pose_embedding_dim,
                feat_depth=mcfg.feat_depth, J=mcfg.n_joints,
                t_dim=mcfg.t_dim, knn_share=mcfg.knn_share,
                knn_cand=mcfg.knn_cand, agg_bf16=mcfg.agg_bf16)


CHECKED = ("start_gap", "loss_gap", "grad_norm_gap", "change_norm_gap")


def on_host(r: Dict) -> Dict:
    return {k: ({n: (None if t is None else t.cpu()) for n, t in v.items()}
                if isinstance(v, dict) else v) for k, v in r.items()}


def compare(prog: Dict, r: Dict) -> Dict:
    """The numbers that decide ``correct``, of ``prog`` (``p0``,
    ``grads1``, ``p_end``, ``losses``) against the reference's ``r``:
    ``start_gap`` (the largest difference of a starting parameter),
    ``loss_gap`` (the largest relative gap of a step's loss; each step's
    in ``loss_gap_by_step``), ``grad_norm_gap`` (the first gradient's
    worst leaf) and ``change_norm_gap`` (the worst leaf of the change over
    the checked steps, of the leaves whose reference gradient is not
    nought to rounding)."""
    by_step = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   r["losses"])]
    change = {n: prog["p_end"][n] - prog["p0"][n] for n in prog["p0"]}
    ref_change = {n: r["p_end"][n] - r["p0"][n] for n in r["p0"]}
    return {
        "start_gap": max(float((prog["p0"][n] - r["p0"][n]).abs().max())
                         for n in r["p0"]),
        "loss_gap": max(by_step), "loss_gap_by_step": by_step,
        "grad_norm_gap": leaf_gap(prog["grads1"], r["grads1"]),
        "change_norm_gap": leaf_gap(change, ref_change,
                                    moving_leaves(r["grads1"]))}


def run(ctx) -> Dict:
    from unittest import mock

    from apnerf_torch.models.tineuvox import TiNeuVoxConfig
    from apnerf_torch.train import stage2
    from apnerf_torch.utils.checkpoint import params_to_jax

    traffic = ctx.traffic
    n_check = int(traffic["check_steps"])
    scene = make_scene(ctx.config, ctx.seed, ctx.device)
    cfg = program_config(ctx.config)
    heads = params_to_jax({k: torch.from_numpy(v)
                           for k, v in scene.heads.items()})
    win = Window(ctx, int(traffic["warmup_steps"]),
                 int(traffic["trace_steps"]))
    rec = {"drawn": [], "losses": [], "steps": []}
    real_make = stage2.make_graphed_step

    def make(*args, **kwargs):
        step = real_make(*args, **kwargs)
        model = next(a for a in args if isinstance(a, torch.nn.Module))
        params = dict(model.named_parameters())
        rec["steps"].append(step)

        def call(batch, *a, **kw):
            n = win.count + 1
            if n == 1:
                rec["p0"] = clone(params)
            if n <= n_check:
                rec["drawn"].append(host_copy(batch))
            out = step(batch, *a, **kw)
            if n <= n_check:
                rec["losses"].append(out[0]["loss"].detach().clone())
            if n == 1:
                rec["grads1"] = {k: (None if g is None else g.detach()
                                     .clone()) for k, g in out[1].items()}
            if n == n_check:
                rec["p_end"] = clone(params)
            win.tick()
            return out
        return call

    with mock.patch.object(stage2, "make_graphed_step", make):
        try:
            stage2.train_pcd(
                cfg, scene.data, scene.canonical, scene.skeleton, heads,
                TiNeuVoxConfig(**scene.backbone), scene.bbox,
                seed=seed_of(ctx.seed),
                n_iters=int(cfg.pcd_train_config.N_iters),
                log_every=int(traffic["log_every"]),
                max_steps=ctx.config.get("max_steps"), device=ctx.device)
            raise RuntimeError("train_pcd ended before the window closed")
        except WindowClosed:
            pass
    losses = [float(x) for x in rec.pop("losses")]
    drawn = rec.pop("drawn")
    prog = {k: {n: (None if v is None else v.cpu()) for n, v in rec[k]
                .items()} for k in ("p0", "grads1", "p_end")}
    del rec
    peak = free_device()

    setting = ref.Setting(ctx.config, scene, seed_of(ctx.seed), ctx.device)
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
        # the control (TF32) and the fault (half of the batch) put in the
        # program's place, read against the same reference
        out["controls"] = {
            name: compare(on_host(ref.run_steps(setting, drawn, **kw)), r)
            for name, kw in (("tf32", {"tf32": True}),
                             ("half_batch", {"half_batch": True}))}
    if ctx.trace:
        mcfg = r["mcfg"]
        counts = mean_counts([samples([a]) for a in r["audits"]])
        out["reading"] = {
            "trace": win.reading(), "unit_s": win.seconds / win.units,
            "peaks": peaks(),
            "work": {"ops": point_model(shape_of(mcfg), counts, train=True,
                                        at_time=True), "counts": counts}}
    return out
