"""The reference of a reposed frame: the frozen plain path.

The model is built from the scene and the seed as the program's
``train/stage2.build_model`` builds it (``reference.stage2``), the render
knobs of the configuration's ``render`` block applied as
``cli.points_render_config`` applies them. A frame is ``prepare_frame`` in
the pose, then the image in ``chunk``-ray chunks, the last one padded by
repeating the last pixel, each chunk through ``forward`` as the view
function of ``make_points_renderer`` calls it (depth on, no LBS-weight
images), every kernel its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .frozen.data.rays import pixels_to_rays
from .frozen.models import temporal_points as tp
from .stage2 import Setting  # noqa: F401  (the renders' setting too)


def render_knobs(mcfg, render: Dict):
    """``cli.points_render_config``: the render block's knobs on ``mcfg``."""
    ov = {k: int(render[k]) for k in ("knn_share", "knn_cand",
                                      "coarse_stride") if k in render}
    if "fused_agg" in render:
        ov["fused_agg"] = bool(render["fused_agg"])
    return dataclasses.replace(mcfg, **ov)


def render_frames(setting: Setting, rots: List[np.ndarray], chunk: int,
                  tf32: bool = False) -> Dict:
    """The reference's images [H, W, 3] of the poses ``rots`` from the
    scene's first camera -> ``images``, ``audits`` (each frame's chunks'
    budget audit rows), ``mcfg``. ``tf32``: the control."""
    mcfg, model, state = setting.build()
    model.cfg = render_knobs(model.cfg, setting.cfg["render"])
    data = setting.scene.data
    H, W = setting.H, setting.W
    dev = setting.device
    K = torch.as_tensor(np.asarray(data["Ks"][0], np.float32), device=dev)
    c2w = torch.as_tensor(np.asarray(data["poses"][0], np.float32),
                          device=dev)
    n = H * W
    bg = setting.bg
    images, audits = [], []
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            for rot in rots:
                frame = tp.prepare_frame(model, state, rot_params=torch.as_tensor(
                    rot, dtype=torch.float32, device=dev))
                parts, rows = [], []
                cam = torch.zeros(chunk, dtype=torch.int64, device=dev)
                for start in range(0, n, chunk):
                    pix = torch.clamp(start + torch.arange(chunk, device=dev),
                                      max=n - 1)
                    ro, rd, vd = pixels_to_rays(K[None], c2w[None], cam, pix,
                                                H, W, **setting.flips)
                    res = tp.forward(model, state, ro, rd, vd,
                                     near=setting.near, far=setting.far,
                                     bg=bg, render_depth=True, frame=frame)
                    parts.append(res["rgb_marched"])
                    rows.append([int(x) for x in res["budget_audit"].tolist()])
                img = torch.cat(parts)[:n].reshape(H, W, 3)
                images.append(img.float().cpu().numpy())
                audits.append(rows)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return {"images": images, "audits": audits, "mcfg": model.cfg}
