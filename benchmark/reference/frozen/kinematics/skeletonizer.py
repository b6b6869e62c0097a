"""Skeleton and skinning-weight extraction from a binary density volume
(port of ``apnerf/kinematics/skeletonizer.py``, the reference
``create_skeleton``, skeletonizer.py:209-327): clean the volume, 3-D
thinning (``morphology.skeletonize_3d``, C++), the 26-neighbourhood
distance graph over the skeleton voxels, Floyd-Warshall for the most
central voxel as root, a distance-ordered BFS that cuts the skeleton into
bones of about ``bone_length`` voxels, the sibling clean-up heuristic, and
soft skinning weights from point-to-bone-segment distances.

The JAX package's deliberate differences from the reference hold here too:
a heap with a LIFO tie-break in place of the insertion-sorted DistQueue
(the same pop order), and the true euclidean bone length in the
keep-the-longest-sibling rule.
"""
from __future__ import annotations

import heapq
import itertools

import numpy as np
from scipy.sparse.csgraph import shortest_path
from scipy.special import softmax

from .morphology import preprocess_volume, skeletonize_3d


def build_skeleton_graph(points: np.ndarray):
    """26-neighbourhood adjacency among integer skeleton voxels.

    Returns (dense distance matrix [n, n] with 0 = no edge, neighbour lists
    sorted by edge length).
    """
    diff = points[:, None, :] - points[None, :, :]
    adjacent = np.all(np.abs(diff) <= 1, axis=-1)
    np.fill_diagonal(adjacent, False)
    dist = np.sqrt((diff ** 2).sum(-1))
    graph = adjacent * dist
    neighbours = []
    for i in range(len(points)):
        idx = np.nonzero(adjacent[i])[0]
        order = np.argsort(dist[i, idx])
        neighbours.append((idx[order], dist[i, idx[order]]))
    return graph, neighbours


def segment_skeleton(neighbours, root: int, bone_length: float):
    """Distance-ordered BFS turning the voxel skeleton into joints + bones
    (semantics of reference ``bfs``, skeletonizer.py:86-124)."""
    visited = {root}
    joints = [root]
    bones = []
    counter = itertools.count()
    # NEGATED tie-break counter: the reference's insertion-sorted DistQueue
    # (skeletonizer.py:60-74) inserts a new element BEFORE existing
    # equal-distance elements (argmin of `distances < d` = first index with
    # distance >= d), so among ties the NEWEST pops first. A heap keyed
    # (dist, -counter) reproduces that LIFO-among-equals order exactly;
    # (dist, +counter) would pop oldest-first and claim voxels in a
    # different order on the (constant) sqrt-edge-length ties.
    heap = [(0.0, -next(counter), root, root, 0.0)]
    while heap:
        cm_dist, _, node, prev_joint, dist_prev = heapq.heappop(heap)
        nbrs, dists = neighbours[node]
        to_visit = [(n, d) for n, d in zip(nbrs, dists) if n not in visited]
        if dist_prev >= bone_length or not to_visit:
            bones.append([prev_joint, node])
            joints.append(node)
            prev_joint = node
            dist_prev = 0.0
        for n, d in to_visit:
            visited.add(n)
            heapq.heappush(heap, (cm_dist + d, -next(counter), n,
                                  prev_joint, dist_prev + d))
    return joints, bones


def clean_bones(joints, bones, points):
    """Sibling-cleanup heuristic (reference skeletonizer.py:269-296): among
    bones sharing a start joint, keep the ones whose tails have children; if
    none do, keep only the longest."""
    starts = np.array([b[0] for b in bones])
    tails = np.array([b[1] for b in bones])
    has_child = np.isin(tails, starts)
    delete = set()
    for s in np.unique(starts):
        group = np.nonzero(starts == s)[0]
        if has_child[group].any():
            delete.update(int(i) for i in group if not has_child[i])
        else:
            lengths = [np.linalg.norm(points[bones[i][0]].astype(float)
                                      - points[bones[i][1]])
                       for i in group]
            keep = group[int(np.argmax(lengths))]
            delete.update(int(i) for i in group if i != keep)
    bones = [b for i, b in enumerate(bones) if i not in delete]
    used = set(np.unique(np.asarray(bones)))
    joints = [j for j in joints if j in used]
    return joints, bones


def point_segment_distance(p, a, b, eps=1e-12):
    """Distance from points p [N,3] to each segment (a[m], b[m]) -> [M, N].

    Vectorised equivalent of the reference's masked three-case computation
    (skeletonizer.py:126-163)."""
    p = np.asarray(p, np.float64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    s = b - a                                        # [M, 3]
    w = p[None, :, :] - a[:, None, :]                # [M, N, 3]
    ps = (w * s[:, None, :]).sum(-1)                 # [M, N]
    l2 = (s * s).sum(-1)[:, None]                    # [M, 1]
    t = np.clip(ps / np.maximum(l2, eps), 0.0, 1.0)
    closest = a[:, None, :] + t[..., None] * s[:, None, :]
    return np.linalg.norm(p[None] - closest, axis=-1)


def weight_from_bones(joints, bones, pcd, theta=0.05):
    """Soft skinning weights: softmax over 1/(0.5 e^dist) per bone
    (reference skeletonizer.py:165-189)."""
    a = np.array([joints[b[0]] for b in bones], np.float64)
    b = np.array([joints[b[1]] for b in bones], np.float64)
    d = point_segment_distance(pcd, a, b)            # [n_bones, n_pts]
    weights = (1.0 / (0.5 * np.e ** d + 1e-6)).T
    return softmax(weights / theta, axis=1)


def create_skeleton(alpha_volume, grid_xyz, bone_length=10.0, threshold=0.05,
                    sigma=0, weight_theta=0.1, bone_heursitic=True):
    """Extract skeleton, joints, bones and skinning weights from a volume.

    Same signature/return contract as the reference (skeletonizer.py:209-327),
    including the ``bone_heursitic`` spelling.
    """
    binary_volume = preprocess_volume(alpha_volume, threshold=threshold,
                                      sigma=0)
    if sigma > 0:
        binary_smooth = preprocess_volume(alpha_volume, threshold=threshold,
                                          sigma=sigma)
    else:
        binary_smooth = binary_volume

    skeleton = skeletonize_3d(binary_smooth)
    points = np.argwhere(skeleton).astype(np.int64)   # integer voxel coords

    graph, neighbours = build_skeleton_graph(points)
    D = shortest_path(graph, directed=True, method="FW")
    root_idx = int(np.argmin(D.sum(1)))

    joints, bones = segment_skeleton(neighbours, root_idx, bone_length)
    if bone_heursitic:
        joints, bones = clean_bones(joints, bones, points)

    # bone endpoints as indices into the joint list
    joint_pos = {j: k for k, j in enumerate(joints)}
    bones = [[joint_pos[b0], joint_pos[b1]] for b0, b1 in bones]

    # grid space -> world space
    grid_xyz = np.asarray(grid_xyz)
    xyz_max = grid_xyz.max(axis=(0, 1, 2))
    xyz_min = grid_xyz.min(axis=(0, 1, 2))
    vol_max = np.array(binary_volume.shape, np.float64)
    world = (points / vol_max[None, :]) * (xyz_max - xyz_min) + xyz_min
    world = world.astype(np.float32)

    pcd = grid_xyz[binary_volume > 0]
    weights = weight_from_bones(world[joints], bones, pcd, theta=weight_theta)

    return {
        "skeleton_pcd": world,
        "root": world[root_idx],
        "joints": world[joints],
        "bones": bones,
        "pcd": pcd,
        "weights": weights,
    }
