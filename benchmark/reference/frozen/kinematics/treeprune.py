"""Kinematic-tree simplification: prune zero-motion bones, merge siblings
(the port's own copy of ``apnerf/kinematics/treeprune.py``, without its
visualisation demo). Pure NumPy, host-side.

Semantics:
* every leaf-to-root path is rewritten keeping only unpruned joints (and
  junction joints, which anchor branching),
* new bones come from consecutive kept joints along those paths,
* each new bone's rotation is taken from the original child of the bone's
  start joint that is an ancestor of (or equal to) the bone's tail,
* weights of pruned joints merge transitively into their nearest unpruned
  ancestor (``merging_rules``),
* siblings with similar motion are clustered (transitively, in combination
  order) and merged onto one representative (``sibling_transfer_rules``).
"""
from __future__ import annotations

from itertools import combinations

import numpy as np


def cluster_children(children, rotation_similarity_matrix):
    """Greedy transitive clustering of same-motion siblings
    (reference lib/treeprune.py:5-39). Returns {keep_idx: merged_indices}."""
    similar = [c for c in combinations(children, 2)
               if rotation_similarity_matrix[c[0], c[1]]]
    clusters = []
    for c1, c2 in similar:
        placed = False
        for cluster in clusters:
            if c1 in cluster or c2 in cluster:
                cluster.update((c1, c2))
                placed = True
        if not placed:
            clusters.append({c1, c2})
    rules = {}
    for cluster in clusters:
        idx = np.array(sorted(cluster))
        rules[idx[0]] = idx[1:]
    return rules


def merge_joints(joints, bones, prune_bones, rotation_similarity_matrix,
                 root_idx=0, convert_merging_rules=True):
    joints = np.asarray(joints)
    prune = np.asarray(prune_bones).astype(bool)
    J = len(joints)
    assert J == len(prune)

    parent = {b[1]: b[0] for b in bones}
    children = {j: [] for j in range(J)}
    for child, par in parent.items():
        children[par].append(child)
    multi_child = np.array([len(children[j]) > 1 for j in range(J)])
    is_leaf = np.array([len(children[j]) == 0 for j in range(J)])

    # --- kept paths leaf -> root -------------------------------------
    paths, paths_og = [], []
    for leaf in np.nonzero(is_leaf)[0]:
        j = int(leaf)
        path, path_og = [], []
        while j != root_idx:
            p = parent[j]
            if (not prune[j]) or multi_child[p]:
                if not path and not multi_child[p]:
                    path.append(j)
                path.append(p)
            path_og.append(j)
            j = p
        if not path:
            path.append(root_idx)
        elif path[-1] != root_idx:
            path.append(root_idx)
        path.reverse()
        paths.append(path)
        path_og.append(root_idx)
        path_og.reverse()
        paths_og.append(path_og)

    # --- new bones / joints (original indexing) ----------------------
    bone_set = set()
    for path in paths:
        for a, b in zip(path[:-1], path[1:]):
            bone_set.add((a, b))
    if not bone_set:
        # every non-root joint pruned: degenerate single-root skeleton.
        # (The reference crashes here — lib/treeprune.py:94-97 indexes with
        # an empty float array; only reachable on motionless scenes.)
        merging_rules = np.full(J, root_idx, dtype=np.int32)
        merging_rules[root_idx] = root_idx
        joints_to_keep = np.zeros(J, bool)
        joints_to_keep[root_idx] = True
        rotations_to_keep = joints_to_keep.copy()
        return (joints[[root_idx]], np.zeros((0, 2), np.int32),
                merging_rules, joints_to_keep, rotations_to_keep,
                np.zeros(1, np.int32), np.arange(J, dtype=np.int32))
    new_bones = np.array(sorted(bone_set))
    new_joint_idx = np.unique(new_bones)
    new_joints = joints[new_joint_idx]

    # --- rotation source per new bone ---------------------------------
    def branch_child(start, tail):
        """Original child of ``start`` lying on a root-leaf path through
        ``tail``."""
        kids = children[start]
        if len(kids) == 1:
            return kids[0]
        for c in kids:
            for og in paths_og:
                if c in og and tail in og:
                    return c
        return kids[-1]

    rot_keep_idx = np.array([branch_child(a, b) for a, b in new_bones])
    rotations_to_keep = np.zeros(J, bool)
    rotations_to_keep[rot_keep_idx] = True
    rotations_to_keep[root_idx] = True

    # dense renumbering of rotation sources, ordered by new-bone tail
    order = np.argsort(new_bones[:, 1])
    rk_sorted = rot_keep_idx[order]
    switch = np.copy(rk_sorted)
    for rank, old in enumerate(np.unique(rk_sorted)):
        switch[rk_sorted == old] = rank
    rotation_switch_mask = np.concatenate([[0], switch + 1])

    joints_to_keep = np.zeros(J, bool)
    joints_to_keep[new_joint_idx] = True

    # reindex bones to the compacted joint list, sorted by tail
    remap = {int(old): new for new, old in enumerate(new_joint_idx)}
    new_bones = np.array([[remap[a], remap[b]] for a, b in new_bones])
    new_bones = new_bones[np.argsort(new_bones[:, 1])]

    # --- weight merging: pruned joint -> nearest unpruned ancestor ----
    merging_rules = np.arange(J, dtype=np.int32)
    for leaf in np.nonzero(is_leaf)[0]:
        j = int(leaf)
        pending = []
        while True:
            if prune[j]:
                pending.append(j)
            else:
                for p in pending:
                    merging_rules[p] = j
                pending = []
            j = parent[j]
            if j == root_idx:
                for p in pending:
                    merging_rules[p] = root_idx
                break

    # --- sibling merging ----------------------------------------------
    sibling_transfer_rules = np.arange(J, dtype=np.int32)
    for kids in children.values():
        free = [c for c in kids if merging_rules[c] == c]
        if len(free) > 1:
            for keep, merged in cluster_children(
                    free, rotation_similarity_matrix).items():
                merging_rules[merged] = keep
                sibling_transfer_rules[merged] = keep

    if convert_merging_rules:
        # map old-tree targets to their nearest kept joint along each path
        translation = {i: None for i in range(J)}
        for path, path_og in zip(paths, paths_og):
            pending = []
            for j in path_og:
                if j not in path:
                    pending.append(j)
                else:
                    for p in pending:
                        translation[p] = j
                    translation[j] = j
                    pending = []
        remapped = np.copy(merging_rules)
        for old, new in translation.items():
            if new is not None:
                remapped[merging_rules == old] = new
        merging_rules = remapped

    return (new_joints, new_bones, merging_rules, joints_to_keep,
            rotations_to_keep, rotation_switch_mask, sibling_transfer_rules)


def flatten_merging_rules(merging_rules):
    """Resolve merge chains to fixpoints (lib/temporalpoints.py:345-354)."""
    out = []
    for i in range(len(merging_rules)):
        j = i
        while True:
            j = int(merging_rules[j])
            if j == int(merging_rules[j]):
                out.append(j)
                break
    return out
