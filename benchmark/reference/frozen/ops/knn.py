"""Morton codes and the k-NN entry points (port of ``apnerf/ops/knn.py``).

The port always works in the Morton-sorted, padded point space of
``kernels.knn_cells.build_point_tables`` for radius queries; the kernel or
its plain version is chosen inside each wrapper by the tensors' device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


_SPREAD: Dict[torch.device, torch.Tensor] = {}


def _spread_table(device: torch.device) -> torch.Tensor:
    """Every 10-bit value with its bits moved two places apart (bit b to
    bit 3b), once per device: a lookup takes one gather where the shifts
    and masks took twelve launches an axis."""
    table = _SPREAD.get(device)
    if table is None:
        x = torch.arange(1024, dtype=torch.int64)
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        table = _SPREAD[device] = x.to(device)
    return table


def morton_codes(points: torch.Tensor, lo: Optional[torch.Tensor] = None,
                 hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """30-bit Morton codes (10 bits per axis) as int64.

    ``lo``/``hi`` fix the normalisation box; default is the point bbox.
    Equal to the JAX package's uint32 codes."""
    if lo is None:
        lo = points.amin(0)
    if hi is None:
        hi = points.amax(0)
    u = ((points - lo) / torch.clamp(hi - lo, min=1e-9)).clamp(0.0, 1.0)
    g = torch.clamp((u * 1024.0).to(torch.int64), 0, 1023)
    s = _spread_table(points.device)[g]
    return s[:, 0] | (s[:, 1] << 1) | (s[:, 2] << 2)


def knn(queries: torch.Tensor, points: Optional[torch.Tensor], k: int,
        radius2: Optional[float] = None,
        point_tables: Optional[Dict[str, torch.Tensor]] = None):
    """k nearest points per query -> (d2 [M, k] ascending, idx [M, k]).

    ``radius2=None``: exact brute force over ``points``, indices in the
    original point order (kernel K1). Otherwise radius-bounded over
    ``point_tables`` (kernel K3): only points with d2 <= radius2, indices
    in the Morton-sorted space, empty slots (+inf, 0)."""
    if radius2 is None:
        from ..kernels.knn_brute import knn_brute
        return knn_brute(queries, points, k)
    from ..kernels.knn_cells import knn_radius
    return knn_radius(queries, point_tables, k, float(radius2))


def knn_count(queries: torch.Tensor, point_tables: Dict[str, torch.Tensor],
              radius2: float) -> torch.Tensor:
    """Per-query count of points with d2 <= radius2 (kernel K2) -> [M]."""
    from ..kernels.knn_cells import knn_count as _count
    return _count(queries, point_tables, float(radius2))


def nn1(queries: torch.Tensor, points: torch.Tensor):
    """Nearest point of each query -> (d2 [M], idx [M]): ``knn`` at k = 1,
    so kernel K1 on a CUDA tensor (the chamfer building block)."""
    d2, idx = knn(queries, points, k=1)
    return d2[:, 0], idx[:, 0]


def chamfer(pcd1: torch.Tensor, pcd2: torch.Tensor):
    """Both directions' squared nearest distances, raw (the reference's
    ``get_chamfer_loss(..., get_raw=True)``) -> (d [N1], d [N2])."""
    d1, _ = nn1(pcd1, pcd2)
    d2, _ = nn1(pcd2, pcd1)
    return d1, d2


def batch_chamfer(pcd1: torch.Tensor, pcd2: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer loss of ``pcd1 [B, N, D]`` and ``pcd2 [B, M, D]``
    over dense pairwise squared distances (D = 2 or 3): the mean nearest
    distance each way, summed."""
    d = ((pcd1[:, :, None, :] - pcd2[:, None, :, :]) ** 2).sum(-1)
    return d.amin(2).mean() + d.amin(1).mean()
