"""One-view renderer for a stage-2 point model (port of the single-device
``make_points_renderer`` in ``apnerf/render/renderers.py``):
``prepare_frame`` once per frame, then a loop over ray chunks giving rgb,
depth and the LBS-weight colour image."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models import temporal_points as tp
from ..ops.marching import composite
from ..ops.rays import get_rays_of_a_view


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
    ``knn_path`` and the per-chunk ``budget_audit`` rows.

    ``prepare_frame`` runs once, then every chunk reuses it. The last chunk
    is padded by repeating pixels and cut back."""
    cfg = model.cfg
    dev = state["canonical_pcd"].device
    frame = tp.prepare_frame(model, state, t=t, rot_params=rot_params)
    ro, rd, vd = (x.reshape(-1, 3) for x in get_rays_of_a_view(
        H, W, K, c2w, device=dev))
    n = H * W
    cols = None
    if render_weights:
        mask = (tp.get_weights(model, state).sum(0) > 0).cpu().numpy()
        pal = np.zeros((cfg.n_joints, 3), np.float32)
        if mask.any():
            pal[mask] = weight_palette(int(mask.sum()))
        cols = torch.as_tensor(pal, device=dev)
    outs = {"rgb": [], "depth": [], "acc": [], "weights": [],
            "budget_audit": []}
    path = None
    for s in range(0, n, chunk):
        sel = torch.arange(s, s + chunk, device=dev).clamp(max=n - 1)
        res = tp.forward(model, state, ro[sel], rd[sel], vd[sel], near=near,
                         far=far, bg=bg, render_depth=True,
                         render_weights=render_weights, frame=frame)
        m = min(chunk, n - s)
        outs["rgb"].append(res["rgb_marched"][:m])
        outs["depth"].append(res["depth"][:m])
        outs["acc"].append(res["weights_per_sample"].sum(-1)[:m])
        outs["budget_audit"].append(res["budget_audit"])
        path = res["knn_path"]
        if render_weights:
            col = torch.einsum("rbj,jc->rbc", res["lbs_w_per_sample"], cols)
            outs["weights"].append(composite(
                res["weights_for_render"], col, bg=bg,
                alphainv_last=res["alphainv_for_render"])[:m])
    result = {
        "rgb": torch.cat(outs["rgb"]).reshape(H, W, 3),
        "depth": torch.cat(outs["depth"]).reshape(H, W),
        "acc": torch.cat(outs["acc"]).reshape(H, W),
        "budget_audit": torch.stack(outs["budget_audit"]),
        "knn_path": path,
    }
    if render_weights:
        result["weights"] = torch.cat(outs["weights"]).reshape(H, W, 3)
    return result
