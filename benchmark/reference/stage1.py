"""The reference of a stage-1 training step: the frozen plain path.

``frozen/train/stage1.py`` is a copy of the program's ``train/
stage1.py`` when the benchmark was defined, on the frozen modules (every
kernel its plain version, K5's in the grid backward too). ``Setting``
sets the model up from the scene and the seed as
``scene_rep_reconstruction`` does (the cameras' frustum box, the grid,
``init_model`` with the seed, the occupancy grid and the static active
budget of a run whose occupancy path is on from its first step), and
``run_steps`` follows the program's steps eagerly on the rows it drew,
reading colours and masks from its own images.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List

import numpy as np
import torch

from .frozen.models import tineuvox
from .frozen.ops import compaction
from .frozen.train import stage1 as s1
from .frozen.train.masked_adam import MaskedAdam
from .stage2 import AttrDict


class Setting:
    """What the reference's stage-1 steps read, built from the scene."""

    def __init__(self, cfg: Dict[str, Any], overrides: Dict[str, Any],
                 scene, seed: int, device):
        self.cfg = AttrDict.of(cfg)
        self.scene = scene
        self.seed = seed
        self.device = torch.device(device)
        data = scene.data
        self.flips = {k: bool(cfg["data"][k])
                      for k in ("inverse_y", "flip_x", "flip_y")}
        self.cfg_train = dict(cfg["train_config"], **overrides)
        self.stepsize = float(cfg["model_and_render"]["stepsize"])
        self.cfg_train["_stepsize"] = self.stepsize
        self.H, self.W = int(data["HW"][0][0]), int(data["HW"][0][1])
        self.near, self.far = float(data["near"]), float(data["far"])
        self.bg = float(self.cfg_train["bg_col"])
        times = np.asarray(data["times"])
        self.image_of = {(float(np.float32(t)), int(c)): k for k, (t, c) in
                         enumerate(zip(times, data["img_to_cam"]))}
        self.Ks = torch.as_tensor(np.asarray(data["Ks"], np.float32),
                                  device=self.device)
        self.poses = torch.as_tensor(np.asarray(data["poses"], np.float32),
                                     device=self.device)

    def build(self):
        """(model, occupancy grid, active budget)."""
        data, mr = self.scene.data, self.cfg.model_and_render
        xyz_min, xyz_max = s1.compute_bbox_by_cam_frustrm(
            data["HW"], data["Ks"], data["poses"], data["i_train"],
            data["img_to_cam"], data["near"], data["far"],
            ndc=bool(self.cfg.data.ndc), **self.flips)
        wbs = float(mr.world_bound_scale)
        shift = (xyz_max - xyz_min) * (wbs - 1) / 2
        xyz_min, xyz_max = xyz_min - shift, xyz_max + shift
        mcfg = tineuvox.TiNeuVoxConfig(
            xyz_min=tuple(xyz_min), xyz_max=tuple(xyz_max),
            num_voxels=int(mr.num_voxels),
            num_voxels_base=int(mr.num_voxels_base),
            voxel_dim=int(mr.voxel_dim), defor_depth=int(mr.defor_depth),
            net_width=int(mr.net_width), alpha_init=float(mr.alpha_init),
            fast_color_thres=float(mr.fast_color_thres),
            no_view_dir=bool(mr.no_view_dir),
            add_cam=bool(self.cfg.data.get("add_cam", False)),
            mlp_bf16=self.device.type == "cuda")
        model = tineuvox.init_model(
            mcfg, torch.Generator().manual_seed(self.seed), self.device)
        budget, _ = s1.active_budget(
            int(self.cfg_train["N_rand"]), model.cfg.max_steps(self.stepsize),
            float(self.cfg_train.get("active_fraction", 0.25)))
        occ = s1.refresh_occupancy(model, self.stepsize)
        return model, occ, budget

    def batch(self, drawn: Dict[str, Any]):
        """(device batch, mismatches): the program's rows, the reference's
        colours and masks."""
        data = self.scene.data
        t = np.asarray(drawn["time"], np.float32).reshape(-1)
        cam = np.asarray(drawn["cam"], np.int64).reshape(-1)
        pix = np.asarray(drawn["pix"], np.int64).reshape(-1)
        rgb = np.zeros((len(cam), 3), np.float32)
        mask = np.zeros(len(cam), np.float32)
        bad = 0
        for key in set(zip(t.tolist(), cam.tolist())):
            sel = (t == key[0]) & (cam == key[1])
            img = self.image_of.get((float(np.float32(key[0])), key[1]))
            if img is None:
                bad += int(sel.sum())
                continue
            im = np.asarray(data["images"][img]).reshape(-1, 3)[pix[sel]]
            if im.dtype == np.uint8:
                im = im.astype(np.float32) / 255.0
            rgb[sel] = im
            mask[sel] = np.asarray(data["masks"][img], np.float32).reshape(
                -1)[pix[sel]]
        bad += int((np.abs(rgb - np.asarray(drawn["rgb"], np.float32))
                    .max(-1) > 0).sum())
        bad += int((mask != np.asarray(drawn["mask"], np.float32)
                    .reshape(-1)).sum())
        dev = self.device
        return {"rgb": torch.as_tensor(rgb, device=dev),
                "mask": torch.as_tensor(mask, device=dev),
                "time": torch.as_tensor(t, device=dev),
                "cam": torch.as_tensor(cam, device=dev),
                "pix": torch.as_tensor(pix, device=dev)}, bad


@contextmanager
def counting_filled(counts: List[int]):
    """Within: every active-sample compaction of the frozen forward adds
    its filled samples to ``counts`` (the samples the step's MLPs and grid
    reads need)."""
    real = compaction.scatter_back

    def scatter_back(values, src, M, fill=0.0):
        if values.dtype == torch.bool:
            counts.append(int(values.sum()))
        return real(values, src, M, fill)
    compaction.scatter_back = scatter_back
    try:
        yield
    finally:
        compaction.scatter_back = real


def touched(grid_shape, xyz: torch.Tensor, xyz_min, xyz_max) -> int:
    """The points of a grid of ``grid_shape`` [X, Y, Z, C] that the
    multi-scale sample at ``xyz`` reads: over the three scales (strides
    1, 2, 4 of the 4k+1-padded grid, ``ops.grid.mult_dist_interp``), each
    row's eight corners that lie inside the unpadded grid, counted once."""
    dims = torch.tensor(grid_shape[:3], device=xyz.device)
    padded = [-(-(n - 1) // 4) * 4 + 1 for n in grid_shape[:3]]
    unit = ((xyz.detach() - xyz_min) / (xyz_max - xyz_min)).reshape(-1, 3)
    keys = []
    for s in (1, 2, 4):
        ns = torch.tensor([(p - 1) // s + 1 for p in padded],
                          device=xyz.device)
        i0 = torch.floor(unit * (ns - 1).float()).long()
        for d in range(8):
            c = i0 + torch.tensor([d >> 2, (d >> 1) & 1, d & 1],
                                  device=xyz.device)
            p = c * s
            ok = ((c >= 0) & (c < ns) & (p < dims)).all(-1)
            p = p[ok]
            keys.append((p[:, 0] * dims[1] + p[:, 1]) * dims[2] + p[:, 2])
    return int(torch.unique(torch.cat(keys)).numel())


@contextmanager
def counting_grid_rows(calls: List[Dict[str, int]]):
    """Within: every multi-scale grid sample of the frozen forward that
    takes gradients (a training step's; not the occupancy refresh's) adds
    to ``calls`` its ``rows`` (samples), ``touched`` (the grid points they
    read), ``cells`` and ``channels`` (its grid); its backward adds the
    ``live`` rows, whose cotangent is not all zero, and ``touched_live``,
    the grid points those read (G1's work, ``work.g1_bound``)."""
    real = tineuvox.mult_dist_interp

    def mult_dist_interp(grid, xyz, xyz_min, xyz_max):
        out = real(grid, xyz, xyz_min, xyz_max)
        if out.requires_grad:
            shape = tuple(grid.shape)
            with torch.no_grad():
                call = {"rows": int(xyz.numel() // 3), "live": 0,
                        "touched": touched(shape, xyz, xyz_min, xyz_max),
                        "touched_live": 0,
                        "cells": int(grid.numel() // grid.shape[-1]),
                        "channels": int(grid.shape[-1])}
            calls.append(call)
            pts = xyz.detach().reshape(-1, 3)

            def live(g):
                with torch.no_grad():
                    rows = (g.reshape(-1, g.shape[-1]) != 0).any(-1)
                    call["live"] = int(rows.sum())
                    call["touched_live"] = touched(shape, pts[rows],
                                                   xyz_min, xyz_max)
            out.register_hook(live)
        return out
    tineuvox.mult_dist_interp = mult_dist_interp
    try:
        yield
    finally:
        tineuvox.mult_dist_interp = real


def run_steps(setting: Setting, drawn: List[Dict[str, Any]],
              tf32: bool = False, half_batch: bool = False) -> Dict:
    """As ``reference.stage2.run_steps``, for stage 1; ``filled`` holds
    each step's active samples, ``world_size`` the grid's."""
    model, occ, budget = setting.build()
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = MaskedAdam(model, setting.cfg_train)
    body = s1.make_step_body(model, setting.cfg_train, opt, setting.Ks,
                             setting.poses, setting.H, setting.W,
                             setting.near, setting.far, setting.bg,
                             active_budget=budget, **setting.flips)
    out = {"p0": p0, "losses": [], "filled": [], "mismatches": 0,
           "world_size": model.cfg.world_size, "cfg": model.cfg}
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for i, d in enumerate(drawn):
            batch, bad = setting.batch(d)
            out["mismatches"] += bad
            if half_batch:
                n = batch["rgb"].shape[0] // 2
                batch = {k: v[:n] for k, v in batch.items()}
            opt.advance()
            filled: List[int] = []
            with counting_filled(filled):
                loss, _, grads = body(batch, occ, False, True)
            out["losses"].append(float(loss))
            out["filled"].append(sum(filled))
            if i == 0:
                out["grads1"] = {n: (None if g is None else g.detach().clone())
                                 for n, g in grads.items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    out["p_end"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    return out
