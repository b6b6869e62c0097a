"""Static-budget sample compaction and occupancy grids (port of
``apnerf/ops/compaction.py``).

A validity mask selects the work, a cumsum packs the valid samples into a
buffer of static size, and the results scatter back into the dense
layout. Duplicate destinations occur only at the sentinel slot, which is
sliced away, so neither scatter depends on the order of duplicate writes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .consts import device_vector


def compact_flat(valid_flat: torch.Tensor, budget: int):
    """Indices of the first ``budget`` valid entries of ``valid_flat [M]``:
    (src [budget] int64 with sentinel M, filled [budget] bool)."""
    M = valid_flat.shape[0]
    pos = torch.cumsum(valid_flat.to(torch.int64), 0) - 1
    keep = valid_flat & (pos < budget)
    dest = torch.where(keep, pos, torch.full_like(pos, budget))
    src = torch.full((budget + 1,), M, dtype=torch.int64,
                     device=valid_flat.device)
    src.scatter_(0, dest, torch.arange(M, device=valid_flat.device))
    src = src[:budget]
    return src, src < M


def scatter_back(values: torch.Tensor, src: torch.Tensor, M: int, fill=0.0):
    """Inverse of ``compact_flat``: ``values[i]`` lands at ``src[i]`` of a
    dense [M, ...] buffer (the sentinel M drops); differentiable in
    ``values``."""
    out = torch.full((M + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    return out.index_put((src,), values)[:M]


def build_occupancy_grid(flags_volume: torch.Tensor) -> torch.Tensor:
    """Dilate a boolean volume [X, Y, Z] by one cell (26-neighbourhood)."""
    g = flags_volume.to(torch.float32)[None, None]
    return F.max_pool3d(g, 3, stride=1, padding=1)[0, 0] > 0


def occupancy_lookup_xyz(occ: torch.Tensor, xyz_min: torch.Tensor,
                         xyz_max: torch.Tensor, pts: torch.Tensor):
    """Boolean occupancy at world points ``pts [..., 3]`` (nearest-cell
    semantics of the reference maskcache_lookup)."""
    dims = device_vector(occ.shape, pts.device, torch.int64)
    u = (pts - xyz_min) / (xyz_max - xyz_min)
    idx = torch.floor(u * dims.float()).to(torch.int64)
    ok = ((idx >= 0) & (idx < dims)).all(-1)
    idx = torch.minimum(idx.clamp(min=0), dims - 1)
    return ok & occ[idx[..., 0], idx[..., 1], idx[..., 2]]
