"""Skeleton and bone-merging figures (port of
``apnerf/kinematics/visualize.py``): PNGs drawn with matplotlib, which is
imported inside each function and needed only there (the reference shows
open3d windows, skeletonizer.py:329-423 and lib/treeprune.py:230-296)."""
from __future__ import annotations

import numpy as np


def visualise_skeletonizer(skeleton_points, root, joints, bones, pcd,
                           weights, old_joints=None, old_bones=None,
                           save_path="skeleton_vis.png"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 7))
    ax = fig.add_subplot(121, projection="3d")
    if pcd is not None and weights is not None:
        rng = np.random.default_rng(0)
        palette = rng.random((weights.shape[1], 3))
        cols = weights @ palette
        ax.scatter(pcd[:, 0], pcd[:, 1], pcd[:, 2], c=np.clip(cols, 0, 1),
                   s=2, alpha=0.5)
    ax.set_title("skinning weights")

    ax2 = fig.add_subplot(122, projection="3d")
    ax2.scatter(skeleton_points[:, 0], skeleton_points[:, 1],
                skeleton_points[:, 2], c="k", s=2)
    for b0, b1 in bones:
        seg = np.stack([joints[b0], joints[b1]])
        ax2.plot(seg[:, 0], seg[:, 1], seg[:, 2], "b-o", markersize=3)
    ax2.scatter(*np.asarray(root), c="r", s=40)
    for i, j in enumerate(joints):
        ax2.text(j[0], j[1], j[2], f"j{i}", fontsize=6)
    ax2.set_title("skeleton")
    fig.savefig(save_path, dpi=110, bbox_inches="tight")
    print(f"visualise_skeletonizer: wrote {save_path}")
    return save_path


def visualise_merging(joints, bones, new_joints, new_bones, prune,
                      merging_rules, save_path="merging_vis.png"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 7))
    ax = fig.add_subplot(121, projection="3d")
    for i, (b0, b1) in enumerate(bones):
        col = "r" if prune[b1] else "b"
        seg = np.stack([joints[b0], joints[b1]])
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "-o", color=col,
                markersize=3)
    for i in range(len(joints)):
        if merging_rules[i] != i:
            seg = np.stack([joints[i], joints[merging_rules[i]]])
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "k-", linewidth=0.7)
        ax.text(*joints[i], f"j{i}", fontsize=6)
    ax.set_title("before (red = pruned, black = merge rule)")

    ax2 = fig.add_subplot(122, projection="3d")
    for b0, b1 in new_bones:
        seg = np.stack([new_joints[b0], new_joints[b1]])
        ax2.plot(seg[:, 0], seg[:, 1], seg[:, 2], "b-o", markersize=3)
    ax2.set_title("after merging")
    fig.savefig(save_path, dpi=110, bbox_inches="tight")
    print(f"visualise_merging: wrote {save_path}")
    return save_path
