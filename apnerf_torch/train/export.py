"""Point-cloud and skeleton export, the stage 1 -> stage 2 interface (port
of ``apnerf/train/export.py``, the reference ``export_point_cloud``,
run.py:1081-1240).

The canonical alpha volume of the stage-1 model is evaluated on a dense
grid; the grid's sampling frequency is searched (bracketing steps of 0.1
under a 30-round guard, then up to 10 halvings) until the cleaned volume
holds about ``canonical_pcd_num`` points; the canonical point cloud
(positions, rgb, features, alpha, bounds, voxel size) is saved, the volume
re-binarised at the skeleton threshold and skeletonised, or, for a ZJU
subject with ``smpl_skeleton_datadir``, given the SMPL joint prior
(``kinematics.zju_skeletons``). Artifacts are pickles with the key schema
of the JAX package (and the reference's tars; the canonical one adds
``sampling_freq``, the frequency found), plus ASCII ``.pcd`` files for
external viewers. The reference's own export (``pcds/canonical.tar`` /
``skeleton.tar``, written by ``torch.save``) seeds stage 2 when present.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..kinematics.morphology import preprocess_volume
from ..kinematics.skeletonizer import create_skeleton
from ..kinematics.zju_skeletons import smpl_skeleton_for
from ..models import tineuvox


def _numpy_globals():
    """The numpy globals a pickled array needs, under the module names of
    numpy 1 and 2 (the globals the JAX package's tar reader allows)."""
    core = getattr(np, "_core", None) or np.core
    out = [np.ndarray, np.dtype]
    # numpy >= 1.25 builds a dtype through its class (np.dtypes)
    dtypes = getattr(np, "dtypes", None)
    if dtypes is not None:
        out += [getattr(dtypes, n) for n in dir(dtypes)
                if n.endswith("DType")]
    for fn in (core.multiarray._reconstruct, core.multiarray.scalar):
        out += [(fn, f"numpy.{m}.multiarray.{fn.__name__}")
                for m in ("core", "_core")]
    return out


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return type(obj)((k, _to_numpy(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def load_reference_tar(path):
    """A ``torch.save`` archive of the reference's export, read with
    ``torch.load(weights_only=True)`` and numpy's array globals allowed:
    tensors become numpy arrays (bf16 as fp32), containers and scalars
    pass through. Any other global raises ``pickle.UnpicklingError``."""
    with torch.serialization.safe_globals(_numpy_globals()):
        return _to_numpy(torch.load(path, map_location="cpu",
                                    weights_only=True))


def write_pcd(path, points, colors=None):
    """Minimal ASCII ``.pcd`` writer: xyz, and rgb packed into a float."""
    points = np.asarray(points, np.float32)
    n = len(points)
    fields = "x y z" + (" rgb" if colors is not None else "")
    sizes = "4 4 4" + (" 4" if colors is not None else "")
    types = "F F F" + (" F" if colors is not None else "")
    counts = "1 1 1" + (" 1" if colors is not None else "")
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write(f"VERSION 0.7\nFIELDS {fields}\nSIZE {sizes}\n"
                f"TYPE {types}\nCOUNT {counts}\nWIDTH {n}\nHEIGHT 1\n"
                f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n")
        if colors is not None:
            rgb = (np.clip(colors, 0, 1) * 255).astype(np.uint32)
            packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
            packed_f = packed.view(np.float32)
            for p, c in zip(points, packed_f):
                f.write(f"{p[0]} {p[1]} {p[2]} {c}\n")
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")


def export_point_cloud(model: tineuvox.TiNeuVox, out_dir, canonical_t: float,
                       stepsize: float, viewdir=None,
                       pcd_density_threshold=0.05,
                       skeleton_density_threshold=0.05,
                       bone_length=10.0, canonical_pcd_num=1e4,
                       overwrite=False, smpl_skeleton_datadir=None):
    """Export the stage-1 ``model`` -> ``{"canonical": ..., "skeleton":
    ...}``, written to ``out_dir/pcds`` (``canonical.pkl``,
    ``skeleton.pkl`` and their ``.pcd``); existing pickles are returned
    unless ``overwrite``; else the reference's tars
    (``canonical.tar`` and ``skeleton.tar``) there, when both exist.
    ``smpl_skeleton_datadir``: a ZJU subject's data path, whose SMPL joint
    prior replaces the skeletonizer when one is found. The model runs on
    its own device."""
    pcd_dir = os.path.join(out_dir, "pcds")
    os.makedirs(pcd_dir, exist_ok=True)
    can_path = os.path.join(pcd_dir, "canonical.pkl")
    skel_path = os.path.join(pcd_dir, "skeleton.pkl")
    if (os.path.exists(can_path) and os.path.exists(skel_path)
            and not overwrite):
        with open(can_path, "rb") as f:
            canonical = pickle.load(f)
        with open(skel_path, "rb") as f:
            skeleton = pickle.load(f)
        return {"canonical": canonical, "skeleton": skeleton}
    can_tar = os.path.join(pcd_dir, "canonical.tar")
    skel_tar = os.path.join(pcd_dir, "skeleton.tar")
    if (os.path.exists(can_tar) and os.path.exists(skel_tar)
            and not overwrite):
        canonical = load_reference_tar(can_tar)
        skeleton = load_reference_tar(skel_tar)
        skeleton["bones"] = [list(map(int, b)) for b in skeleton["bones"]]
        print("export: loaded reference torch artifacts "
              f"({len(canonical['pcd'])} points, "
              f"{len(skeleton['bones'])} bones)")
        return {"canonical": canonical, "skeleton": skeleton}
    model_cfg = model.cfg

    def volume_at(freq):
        grid_xyz = tineuvox.grid_xyz_coords(model_cfg, freq)
        alpha = tineuvox.eval_alpha_volume(model, grid_xyz, canonical_t,
                                           stepsize)
        mask = preprocess_volume(alpha, pcd_density_threshold, sigma=0)
        return grid_xyz, alpha, mask

    # bracket the sampling frequency around canonical_pcd_num points
    # (reference run.py:1157-1191), at most 30 rounds
    freq, freq_up, freq_low = 1.0, None, None
    grid_xyz, alpha, mask = volume_at(freq)
    n = int(mask.sum())
    guard = 0
    while (freq_up is None or freq_low is None) and guard < 30:
        guard += 1
        if n > canonical_pcd_num:
            freq_up = freq
            if freq_low is None:
                freq = max(freq - 0.1, 0.05)
        elif n < canonical_pcd_num:
            freq_low = freq
            if freq_up is None:
                freq = freq + 0.1
        else:
            freq_up = freq_low = freq
            break
        if freq_up is None or freq_low is None:
            grid_xyz, alpha, mask = volume_at(freq)
            n = int(mask.sum())
    if freq_up is None or freq_low is None:
        # the guard expired (the reference loops forever here): the target
        # is unreachable, so go on with the last volume
        print(f"export: sampling-freq search did not bracket "
              f"{canonical_pcd_num} points (best {n} at freq {freq:.3f}); "
              "proceeding with the closest volume")
        freq_up = freq_low = freq
    for _ in range(10):
        if freq_up == freq_low:
            break
        freq = (freq_up + freq_low) / 2
        grid_xyz, alpha, mask = volume_at(freq)
        n = int(mask.sum())
        print(f"export: sampling freq {freq:.3f} -> {n} points")
        if n > canonical_pcd_num:
            freq_up = freq
        elif n < canonical_pcd_num:
            freq_low = freq
        else:
            break

    points = grid_xyz[mask]
    alpha_pts, rgb_pts, feat_pts = tineuvox.eval_alpha_volume(
        model, points[None, None], canonical_t, stepsize,
        want_features=True, viewdir=viewdir)
    alpha_pts = alpha_pts.reshape(-1)
    rgb_pts = rgb_pts.reshape(len(points), -1)
    feat_pts = feat_pts.reshape(len(points), -1)

    canonical = {
        "pcd": points.astype(np.float32),
        "rgbs": rgb_pts.astype(np.float32),
        "feat": feat_pts.astype(np.float32),
        "raw_feat": feat_pts.astype(np.float32),
        "alphas": alpha_pts.astype(np.float32),
        "t": float(canonical_t),
        "xyz_min": points.min(0),
        "xyz_max": points.max(0),
        "voxel_size": model_cfg.voxel_size,
        "sampling_freq": float(freq),
    }
    with open(can_path, "wb") as f:
        pickle.dump(canonical, f)
    write_pcd(os.path.join(pcd_dir, "canonical.pcd"), points, rgb_pts)

    skeleton = None
    if smpl_skeleton_datadir is not None:
        skeleton = smpl_skeleton_for(smpl_skeleton_datadir)
        if skeleton is not None:
            print("export: using SMPL joint prior for the skeleton")
    if skeleton is None:
        binary = preprocess_volume(alpha, skeleton_density_threshold,
                                   sigma=0)
        skeleton = create_skeleton(binary, grid_xyz, bone_length=bone_length)
    with open(skel_path, "wb") as f:
        pickle.dump(skeleton, f)
    write_pcd(os.path.join(pcd_dir, "skeleton.pcd"),
              skeleton["skeleton_pcd"])
    print(f"export: {len(skeleton['bones'])} bones extracted, "
          f"{len(points)} canonical points")
    return {"canonical": canonical, "skeleton": skeleton}
