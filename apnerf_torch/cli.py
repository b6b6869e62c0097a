"""The render half of the command line (port of ``apnerf/cli.py``'s render
branch): the render-time configuration overrides and the repose animation,
as functions of plain arguments. ``main``, the argument parser, the config
files and the dataset loaders are not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np

from .models.temporal_points import TemporalPointsConfig
from .render import render
from .render.renderers import make_points_renderer


def points_render_config(mcfg: TemporalPointsConfig,
                         cfg: Mapping[str, Any]) -> TemporalPointsConfig:
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


def repose(model, state, data_dict, near, far, bg, seed: int = 0,
           savedir: Optional[str] = None, render_factor: int = 0,
           chunk: int = 8192, device=None, **flags) -> Dict[str, Any]:
    """Random repose animation: seeded random target rotations (row j is
    axis_xyz, angle of joint j; the root stays fixed), a 30-step ramp there
    and back, rendered from the first camera of ``data_dict`` through
    ``render_viewpoints`` on ``device`` (``None``: the CUDA device; raises
    without one). Returns its result (60 frames); with ``savedir`` the
    frames and videos are written there.

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
    renderer = make_points_renderer(model, state, near, far, bg, poses=poses,
                                    Ks=Ks)

    def make_view(i, t):
        return renderer(i, None, rot_params=rot_seq[i])

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
