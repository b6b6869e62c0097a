"""Point-cloud and skeleton export, the stage 1 -> stage 2 interface (port
of ``apnerf/train/export.py``, the reference ``export_point_cloud``,
run.py:1081-1240).

The canonical alpha volume of the stage-1 model is evaluated on a dense
grid; the grid's sampling frequency is searched (bracketing steps of 0.1
under a 30-round guard, then up to 10 halvings) until the cleaned volume
holds about ``canonical_pcd_num`` points; the canonical point cloud
(positions, rgb, features, alpha, bounds, voxel size) is saved, the volume
re-binarised at the skeleton threshold and skeletonised. Artifacts are
pickles with the key schema of the JAX package (and the reference's
tars; the canonical one adds ``sampling_freq``, the frequency found),
plus ASCII ``.pcd`` files for external viewers.

Not ported yet (raise ``NotImplementedError``): seeding stage 2 from the
reference's torch tars (``pcds/canonical.tar``) and the ZJU SMPL skeleton
prior (``smpl_skeleton_datadir``); both wait for the dataset loaders.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..kinematics.morphology import preprocess_volume
from ..kinematics.skeletonizer import create_skeleton
from ..models import tineuvox


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
    unless ``overwrite``. The model runs on its own device."""
    if smpl_skeleton_datadir is not None:
        raise NotImplementedError("the ZJU SMPL skeleton prior is not ported")
    model_cfg = model.cfg
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
    if (os.path.exists(os.path.join(pcd_dir, "canonical.tar"))
            and os.path.exists(os.path.join(pcd_dir, "skeleton.tar"))
            and not overwrite):
        raise NotImplementedError("loading the reference's torch export "
                                  "tars is not ported")

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

    binary = preprocess_volume(alpha, skeleton_density_threshold, sigma=0)
    skeleton = create_skeleton(binary, grid_xyz, bone_length=bone_length)
    with open(skel_path, "wb") as f:
        pickle.dump(skeleton, f)
    write_pcd(os.path.join(pcd_dir, "skeleton.pcd"),
              skeleton["skeleton_pcd"])
    print(f"export: {len(skeleton['bones'])} bones extracted, "
          f"{len(points)} canonical points")
    return {"canonical": canonical, "skeleton": skeleton}
