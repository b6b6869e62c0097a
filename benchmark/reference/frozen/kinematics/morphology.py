"""Host-side 3-D morphology: thinning, hole filling, largest component
(port of ``apnerf/kinematics/morphology.py``).

The thinning is C++ (``apnerf_torch/native/skeletonize3d.cpp``), built with
``g++`` at first use into ``apnerf_torch/_build/`` (``utils.native``); a
failed build raises: there is no silent fallback. ``skeletonize_python``
is the same thinning in Python, slow, kept as the plain version the tests
hold the library to.
The rest is ``scipy.ndimage``.
"""
from __future__ import annotations

import ctypes
from itertools import product

import numpy as np
from scipy import ndimage

from ..utils.native import build_cxx

_lib = None


def load_library() -> ctypes.CDLL:
    """Build (once per source and flags) and load the thinning library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build_cxx("skeletonize3d.cpp", "apnerf_skel")
    lib.apnerf_skeletonize3d.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.apnerf_skeletonize3d.restype = ctypes.c_int
    _lib = lib
    return lib


def skeletonize_3d(volume: np.ndarray) -> np.ndarray:
    """Medial-axis thinning of a binary volume -> binary skeleton."""
    vol = np.ascontiguousarray(np.asarray(volume).astype(np.uint8))
    load_library().apnerf_skeletonize3d(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        vol.shape[0], vol.shape[1], vol.shape[2], 10000)
    return vol.astype(bool)


def _euler_patch(nb: np.ndarray) -> int:
    """Euler characteristic of the union of the closed unit cubes of a
    3x3x3 neighbourhood."""
    vert = np.zeros((4, 4, 4), bool)
    ex = np.zeros((3, 4, 4), bool)
    ey = np.zeros((4, 3, 4), bool)
    ez = np.zeros((4, 4, 3), bool)
    fxy = np.zeros((3, 3, 4), bool)
    fxz = np.zeros((3, 4, 3), bool)
    fyz = np.zeros((4, 3, 3), bool)
    cubes = 0
    for i, j, k in product(range(3), range(3), range(3)):
        if not nb[i, j, k]:
            continue
        cubes += 1
        vert[i:i + 2, j:j + 2, k:k + 2] = True
        ex[i, j:j + 2, k:k + 2] = True
        ey[i:i + 2, j, k:k + 2] = True
        ez[i:i + 2, j:j + 2, k] = True
        fxy[i, j, k:k + 2] = True
        fxz[i, j:j + 2, k] = True
        fyz[i:i + 2, j, k] = True
    return int(vert.sum() - (ex.sum() + ey.sum() + ez.sum())
               + (fxy.sum() + fxz.sum() + fyz.sum()) - cubes)


def skeletonize_python(volume: np.ndarray) -> np.ndarray:
    """The thinning of ``skeletonize_3d`` in Python: the plain version
    (slow; small volumes only)."""
    v = np.asarray(volume).astype(bool)

    def inside(x, y, z):
        return (0 <= x < v.shape[0] and 0 <= y < v.shape[1]
                and 0 <= z < v.shape[2])

    def neighbourhood(x, y, z):
        nb = np.zeros((3, 3, 3), bool)
        for i, j, k in product(range(-1, 2), repeat=3):
            if inside(x + i, y + j, z + k):
                nb[i + 1, j + 1, k + 1] = v[x + i, y + j, z + k]
        return nb

    def deletable(x, y, z, d):
        dx, dy, dz = d
        if inside(x + dx, y + dy, z + dz) and v[x + dx, y + dy, z + dz]:
            return False
        # anti-collapse guard: more than one voxel thick along d
        if not (inside(x - dx, y - dy, z - dz)
                and v[x - dx, y - dy, z - dz]):
            return False
        nb = neighbourhood(x, y, z)
        if nb.sum() - 1 <= 1:
            return False
        before = _euler_patch(nb)
        nb[1, 1, 1] = False
        if _euler_patch(nb) != before:
            return False
        _, n = ndimage.label(nb, structure=np.ones((3, 3, 3)))
        return n == 1

    dirs = [(0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0),
            (-1, 0, 0)]
    changed = True
    while changed:
        changed = False
        for d in dirs:
            cand = [tuple(c) for c in np.argwhere(v)
                    if deletable(*tuple(c), d)]
            for c in cand:
                if deletable(*c, d):
                    v[c] = False
                    changed = True
    return v


def gaussian(volume, sigma):
    return ndimage.gaussian_filter(np.asarray(volume, np.float64), sigma)


def remove_small_holes(binary, area_threshold: int = 256) -> np.ndarray:
    """Fill background cavities (6-connected, not touching the border)
    smaller than ``area_threshold`` voxels."""
    bg = ~binary.astype(bool)
    lab, n = ndimage.label(bg)
    if n == 0:
        return binary.astype(bool)
    sizes = np.bincount(lab.ravel(), minlength=n + 1)
    border = np.unique(np.concatenate([
        lab[0].ravel(), lab[-1].ravel(), lab[:, 0].ravel(),
        lab[:, -1].ravel(), lab[:, :, 0].ravel(), lab[:, :, -1].ravel()]))
    fill = sizes < area_threshold
    fill[0] = False
    fill[border] = False
    return binary.astype(bool) | fill[lab]


def largest_component(binary, connectivity: int = 26) -> np.ndarray:
    """Keep the largest connected component (``cc3d.largest_k(k=1)``)."""
    structure = np.ones((3, 3, 3)) if connectivity == 26 else None
    lab, n = ndimage.label(binary.astype(bool), structure=structure)
    if n <= 1:
        return binary.astype(bool)
    sizes = np.bincount(lab.ravel(), minlength=n + 1)[1:]
    return lab == (np.argmax(sizes) + 1)


def preprocess_volume(alpha_volume, threshold, sigma=1) -> np.ndarray:
    """Gaussian smooth -> threshold -> fill holes -> largest component
    (reference run.py:1133-1140 / skeletonizer.py:191-207)."""
    vol = np.asarray(alpha_volume, np.float64)
    if sigma > 0:
        vol = gaussian(vol, sigma)
    binary = vol > threshold
    binary = remove_small_holes(binary, area_threshold=2 ** 8)
    return largest_component(binary, connectivity=26)
