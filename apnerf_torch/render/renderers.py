"""Per-model chunk renderers for ``render.render_viewpoints`` (port of
``apnerf/render/renderers.py``).

A renderer is ``for_view(i, t, ...) -> chunk_fn``; ``chunk_fn(rays_o,
rays_d, viewdirs) -> dict`` renders one chunk of rays, and its
``finish()``, called after the view's last chunk, returns what belongs to
the whole view (the 2D joints for the skeleton overlay) and runs the
budget audit. The JAX package rolls a view's chunks into one ``lax.scan``
to save dispatches; here the chunks are a plain loop under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models import temporal_points as tp
from ..models import tineuvox
from ..ops.marching import composite
from ..ops.rays import get_rays_of_a_view


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("multi-device rendering (mesh) is not "
                                  "ported")


def make_backbone_renderer(model: tineuvox.TiNeuVox, stepsize, near, far, bg,
                           mesh=None):
    """Chunk renderer for the TiNeuVox backbone: ``for_view(i, t)``."""
    _no_mesh(mesh)
    n_steps = model.cfg.max_steps(stepsize)

    def for_view(i, t):
        @torch.inference_mode()
        def fn(ro, rd, vd):
            times = torch.full((ro.shape[0], 1), float(t), device=ro.device)
            res = tineuvox.forward(model, ro, rd, vd, times, near, far,
                                   stepsize, bg, n_steps)
            return {"rgb_marched": res["rgb_marched"], "depth": res["depth"]}
        return fn

    return for_view


def _warn_audit(audit) -> None:
    """Budget-audit warning from one [act_demand, act_granted, pass_demand,
    pass_granted] row (a renderer prints it once in its lifetime)."""
    if audit[0] > audit[1] or audit[2] > audit[3]:
        print("render: budget audit — static sampling budgets "
              f"truncated (active {audit[0]}/{audit[1]}, "
              f"radius-pass {audit[2]}/{audit[3]}); raise "
              "active_fraction/pass_fraction if quality "
              "matters more than speed")


def weight_palette(n: int, seed: int = 0) -> np.ndarray:
    """LBS-weight false colours: seaborn's hls palette when installed
    (as the JAX package), else the same hues computed here."""
    try:
        from seaborn import color_palette
        cols = np.array(color_palette("hls", n))
    except ImportError:
        hues = np.linspace(0, 1, n, endpoint=False)
        cols = np.stack([np.abs(hues * 6 - 3) - 1, 2 - np.abs(hues * 6 - 2),
                         2 - np.abs(hues * 6 - 4)], -1).clip(0, 1)
    rng = np.random.default_rng(seed)
    return cols[rng.permutation(n)]


def make_points_renderer(model: tp.TemporalPoints, state, near, far, bg,
                         render_weights: bool = True,
                         render_pcd_direct: bool = False, poses=None,
                         Ks=None, mesh=None):
    """Chunk renderer for a stage-2 point model: ``for_view(i, t,
    rot_params=None)`` warps the cloud once (``prepare_frame``, at time
    ``t`` or in the pose ``rot_params`` [J, 4]) and returns the chunk
    function. A chunk gives ``rgb_marched`` (the direct point-cloud render
    with ``render_pcd_direct``), ``depth``, ``acc`` (accumulated opacity),
    ``weights`` (LBS-weight colours, with ``render_weights``), the chunk's
    ``budget_audit`` row and ``knn_path``. With ``poses`` and ``Ks`` the
    view's ``finish()`` adds ``joints_2d`` and ``bones``. The budget audit
    warns once per renderer, over the worst chunk of its first view."""
    _no_mesh(mesh)
    cfg = model.cfg
    dev = state["canonical_pcd"].device
    mask = (tp.get_weights(model, state).sum(0) > 0).cpu().numpy()
    cols = np.zeros((cfg.n_joints, 3), np.float32)
    if mask.any():
        cols[mask] = weight_palette(int(mask.sum()))
    cols_dev = torch.as_tensor(cols, device=dev)

    @torch.inference_mode()
    def for_view(i, t, rot_params=None):
        use_rot = rot_params is not None
        frame = tp.prepare_frame(
            model, state, t=None if use_rot else float(t or 0.0),
            rot_params=(torch.as_tensor(rot_params, dtype=torch.float32,
                                        device=dev) if use_rot else None))
        audits = []

        @torch.inference_mode()
        def fn(ro, rd, vd):
            res = tp.forward(model, state, ro, rd, vd, near=near, far=far,
                             bg=bg, render_depth=True,
                             render_weights=render_weights,
                             render_pcd_direct=render_pcd_direct, frame=frame)
            out = {"rgb_marched": res["rgb_marched"], "depth": res["depth"],
                   "acc": res["weights_per_sample"].sum(-1),
                   "budget_audit": res["budget_audit"],
                   "knn_path": res["knn_path"]}
            if render_pcd_direct:
                out["rgb_marched"] = res["rgb_marched_direct"]
            if render_weights:
                col = torch.einsum("rbj,jc->rbc", res["lbs_w_per_sample"],
                                   cols_dev)
                out["weights"] = composite(
                    res["weights_for_render"], col, bg=bg,
                    alphainv_last=res["alphainv_for_render"])
            audits.append(res["budget_audit"])
            return out

        @torch.inference_mode()
        def finish() -> Dict[str, np.ndarray]:
            extras = {}
            if not for_view._audited and audits:
                # the worst chunk of the whole view: the first chunk is
                # often background with next to no demand
                for_view._audited = True
                _warn_audit(torch.stack(audits).amax(0).tolist())
            if poses is not None and Ks is not None and i < len(poses):
                j2 = tp.project_points(
                    frame["joints_warped"],
                    torch.as_tensor(np.asarray(poses[i], np.float32),
                                    device=dev),
                    torch.as_tensor(np.asarray(Ks[i], np.float32),
                                    device=dev))
                extras["joints_2d"] = j2.cpu().numpy()
                extras["bones"] = np.asarray(state["bones"])
            return extras

        fn.finish = finish
        return fn

    for_view._audited = False
    return for_view


@torch.inference_mode()
def render_view(model: tp.TemporalPoints, state, H: int, W: int, K, c2w,
                t: Optional[float] = None,
                rot_params: Optional[torch.Tensor] = None,
                near: float = 0.5, far: float = 6.0, bg: float = 1.0,
                chunk: int = 8192,
                render_weights: bool = True) -> Dict[str, torch.Tensor]:
    """Render one H x W view at time ``t`` or pose ``rot_params`` ->
    ``rgb`` [H, W, 3], ``depth`` [H, W], ``acc`` [H, W] (accumulated
    opacity), ``weights`` [H, W, 3] (LBS colours, with ``render_weights``),
    ``knn_path`` and the per-chunk ``budget_audit`` rows, as tensors on the
    model's device.

    One view of ``make_points_renderer``: ``prepare_frame`` runs once, then
    every chunk reuses it. The last chunk is padded by repeating pixels and
    cut back."""
    dev = state["canonical_pcd"].device
    fn = make_points_renderer(model, state, near, far, bg,
                              render_weights=render_weights)(
        0, t, rot_params=rot_params)
    ro, rd, vd = (x.reshape(-1, 3) for x in get_rays_of_a_view(
        H, W, K, c2w, device=dev))
    n = H * W
    keys = {"rgb": "rgb_marched", "depth": "depth", "acc": "acc"}
    if render_weights:
        keys["weights"] = "weights"
    parts = {k: [] for k in keys}
    audits, path = [], None
    for s in range(0, n, chunk):
        sel = torch.arange(s, s + chunk, device=dev).clamp(max=n - 1)
        res = fn(ro[sel], rd[sel], vd[sel])
        m = min(chunk, n - s)
        for k, src in keys.items():
            parts[k].append(res[src][:m])
        audits.append(res["budget_audit"])
        path = res["knn_path"]
    result = {k: torch.cat(v).reshape(H, W, *v[0].shape[1:])
              for k, v in parts.items()}
    result["budget_audit"] = torch.stack(audits)
    result["knn_path"] = path
    return result
