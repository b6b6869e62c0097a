"""Voxel-grid trilinear interpolation, multi-scale sampling, resize and the
TV gradient (port of ``apnerf/ops/grid.py``).

Grid layout: ``[X, Y, Z, C]``, channels last, as in the JAX package.

The grid gradient of the trilinear gather is the JAX package's custom VJP
(``_corner_gather``), on every device: contributions are binned by the
sample's *base cell* of the extended ``[X+1, Y+1, Z+1]`` grid with one
stable sort of M keys, accumulated with all 8 corners as separate channel
blocks by kernel K5 (``kernels/scatter.py``, transposed layout), then
reduced onto the grid by 8 shifted slices. Only K5 itself picks its plain
version (CPU tensors) or the CUDA kernel (CUDA tensors). Unlike the JAX
package, samples whose cotangent is all zero (the unfilled slots of an
active-sample budget, all at one position) are keyed out of range and
dropped by K5: the sum is bit-for-bit the same, and they no longer pile up
in one window of the kernel.

``mult_dist_interp`` on CUDA tensors is kernel G1 (``kernels/trilerp.py``),
which computes the same multi-scale sample and gradient without the padded
and strided copies, the corner tables and the saved corners.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import on_cpu, trilerp
from ..kernels.scatter import sorted_window_accumulate
from .consts import device_vector


def grid_interp(grid: torch.Tensor, xyz: torch.Tensor, xyz_min, xyz_max):
    """Trilinear sample of ``grid [X, Y, Z, C]`` at world points ``xyz
    [..., 3]``: ``F.grid_sample(align_corners=True, padding_mode='zeros')``
    with bbox min at index 0 and bbox max at index ``size - 1``."""
    last = device_vector([n - 1.0 for n in grid.shape[:3]], xyz.device)
    u = (xyz - xyz_min) / (xyz_max - xyz_min) * last
    return _interp_at_indices(grid, u)


def _corner_tables(dims, i0: torch.Tensor, frac: torch.Tensor):
    """Per-corner (lin index [M, 8], weight [M, 8]), corner order
    k = dx*4 + dy*2 + dz; out-of-grid corners get weight 0."""
    sx, sy, sz = dims
    i1 = i0 + 1
    lins, ws = [], []
    for dx in (0, 1):
        ix = i1[:, 0] if dx else i0[:, 0]
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        for dy in (0, 1):
            iy = i1[:, 1] if dy else i0[:, 1]
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            for dz in (0, 1):
                iz = i1[:, 2] if dz else i0[:, 2]
                wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
                ok = ((ix >= 0) & (ix < sx) & (iy >= 0) & (iy < sy)
                      & (iz >= 0) & (iz < sz)).to(frac.dtype)
                lins.append((ix.clamp(0, sx - 1) * sy + iy.clamp(0, sy - 1))
                            * sz + iz.clamp(0, sz - 1))
                ws.append(wx * wy * wz * ok)
    return torch.stack(lins, 1), torch.stack(ws, 1)


def _grid_grad(dims, upd: torch.Tensor, lin_ext: torch.Tensor,
               live: torch.Tensor, C: int):
    """d/dgrid [sx*sy*sz, C] from the per-sample corner contributions
    ``upd [M, 8*C]`` (corner-major) and their extended base cells. Rows
    that are not ``live`` (an all-zero cotangent: their contribution is
    exactly 0) get an out-of-range key, sort last, and K5 drops them."""
    sx, sy, sz = dims
    M = upd.shape[0]
    ex, ey, ez = sx + 1, sy + 1, sz + 1
    n_cells = ex * ey * ez
    key = torch.where(live, lin_ext, torch.full_like(lin_ext, n_cells))
    order = torch.argsort(key, stable=True)
    idx_sorted = key[order].to(torch.int32)
    # corner k's contribution to grid cell p sits at extended cell
    # p + off_k, off_k = ((1-dx)*ey + (1-dy))*ez + (1-dz). Every cell of
    # the grid reads in range: p + off_k <= n_cells - 1 - (maxoff - off_k),
    # so the reduce covers the first n_cells - maxoff columns only.
    maxoff = (ey + 1) * ez + 1
    n_red = n_cells - maxoff

    def accum_chunk(upd_c: torch.Tensor, Cc: int) -> torch.Tensor:
        acc = sorted_window_accumulate(idx_sorted, upd_c, n_cells,
                                       transposed=True)     # [8*Cc, n_cells]
        red = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    k = (dx * 2 + dy) * 2 + dz
                    off = ((1 - dx) * ey + (1 - dy)) * ez + (1 - dz)
                    red = red + acc[k * Cc:(k + 1) * Cc, off:off + n_red]
        cells = red.as_strided((Cc, sx, sy, sz), (n_red, ey * ez, ez, 1))
        return cells.permute(1, 2, 3, 0).reshape(-1, Cc)

    CG = min(C, 12)                 # channel chunk: bounds [8*CG, n_cells]
    if C % CG:
        CG = C
    if CG == C:
        return accum_chunk(upd[order], C)
    upd8 = upd.reshape(M, 8, C)[order]
    return torch.cat([accum_chunk(upd8[:, :, c0:c0 + CG].reshape(M, 8 * CG),
                                  CG) for c0 in range(0, C, CG)], -1)


class _CornerGather(torch.autograd.Function):
    """``sum_k grid_flat[lin[:, k]] * w[:, k, None] -> [M, C]``, with the
    JAX package's custom backward: d/dw from the saved corner values, and
    d/dgrid through the base-cell binned accumulation (``_grid_grad``)."""

    @staticmethod
    def forward(ctx, grid_flat, w, lin, lin_ext, dims):
        vals = grid_flat[lin]                                   # [M, 8, C]
        ctx.save_for_backward(vals, w, lin_ext)
        ctx.dims = dims
        return (vals * w[:, :, None]).sum(1)

    @staticmethod
    def backward(ctx, g):
        vals, w, lin_ext = ctx.saved_tensors
        M, _, C = vals.shape
        dgrid = dw = None
        if ctx.needs_input_grad[1]:
            dw = (vals * g[:, None, :]).sum(-1)
        if ctx.needs_input_grad[0]:
            upd = (g[:, None, :] * w[:, :, None]).reshape(M, 8 * C)
            dgrid = _grid_grad(ctx.dims, upd, lin_ext, (g != 0).any(-1), C)
        return dgrid, dw, None, None, None


def _interp_at_indices(grid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Trilinear interp of ``grid [X, Y, Z, C]`` at fractional voxel
    indices ``u [..., 3]``."""
    sx, sy, sz, C = grid.shape
    lead = u.shape[:-1]
    u = u.reshape(-1, 3)
    i0f = torch.floor(u)
    i0 = i0f.to(torch.int64)
    lins, ws = _corner_tables((sx, sy, sz), i0, u - i0f)
    # extended-grid base cell (all-clipped rows carry w == 0)
    bx = (i0[:, 0] + 1).clamp(0, sx)
    by = (i0[:, 1] + 1).clamp(0, sy)
    bz = (i0[:, 2] + 1).clamp(0, sz)
    lin_ext = (bx * (sy + 1) + by) * (sz + 1) + bz
    out = _CornerGather.apply(grid.reshape(-1, C).float(), ws, lins,
                              lin_ext, (sx, sy, sz))
    return out.reshape(*lead, C)


def pad_to_mult4(grid: torch.Tensor) -> torch.Tensor:
    """Zero-pad each spatial dim to ``ceil((n-1)/4)*4 + 1`` on the high
    side (reference ``mult_dist_interp`` padding)."""
    pads = [int(math.ceil((n - 1) / 4.0) * 4 - n + 1) for n in grid.shape[:3]]
    return F.pad(grid, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))


def mult_dist_interp(grid: torch.Tensor, xyz: torch.Tensor, xyz_min,
                     xyz_max) -> torch.Tensor:
    """Multi-scale (stride 1/2/4) trilinear features [..., 3C], channel
    order [fine | stride 2 | stride 4]; all scales take the same
    bbox-normalised coordinate on the 4k+1-padded grid (reference
    ``TiNeuVox.mult_dist_interp``). Kernel G1 (``kernels/trilerp.py``) on
    CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(grid, xyz):
        return mult_dist_interp_plain(grid, xyz, xyz_min, xyz_max)
    return trilerp.mult_dist_interp_cuda(grid, xyz, xyz_min, xyz_max)


def mult_dist_interp_plain(grid: torch.Tensor, xyz: torch.Tensor, xyz_min,
                           xyz_max) -> torch.Tensor:
    """Plain version of ``mult_dist_interp``, the JAX package's per-scale
    path: the padded grid, its strided views, ``_interp_at_indices``."""
    g = pad_to_mult4(grid.float())
    unit = (xyz - xyz_min) / (xyz_max - xyz_min)
    outs = []
    for s in (1, 2, 4):
        gs = g[::s, ::s, ::s]
        last = device_vector([n - 1.0 for n in gs.shape[:3]], xyz.device)
        outs.append(_interp_at_indices(gs, unit * last))
    return torch.cat(outs, -1)


def resize_trilinear(grid: torch.Tensor, new_shape) -> torch.Tensor:
    """align_corners=True trilinear resize of ``grid [X, Y, Z, C]``
    (progressive grid upscaling)."""
    axes = []
    for src, dst in zip(grid.shape[:3], new_shape):
        if dst == 1:
            axes.append(torch.zeros(1, device=grid.device))
        else:
            axes.append(torch.arange(dst, dtype=torch.float32,
                                     device=grid.device) * (src - 1)
                        / (dst - 1))
    u = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    return _interp_at_indices(grid, u)


def total_variation_grad(grid: torch.Tensor, weight: float, mask=None):
    """Analytic clamped-6-neighbour TV gradient (reference
    ``total_variation_add_grad``): ``(weight/6) * sum_n clamp(v_i - v_n,
    -1, 1)`` over the axis neighbours, boundary terms zero; voxels where
    ``mask [X, Y, Z]`` is False get none."""
    g = 0.0
    for axis in range(3):
        n = grid.shape[axis]
        for direction in (1, -1):
            if direction > 0:
                shifted = torch.cat([grid.narrow(axis, 0, 1),
                                     grid.narrow(axis, 0, n - 1)], axis)
            else:
                shifted = torch.cat([grid.narrow(axis, 1, n - 1),
                                     grid.narrow(axis, n - 1, 1)], axis)
            g = g + torch.clamp(grid - shifted, -1.0, 1.0)
    g = (weight / 6.0) * g
    if mask is not None:
        g = torch.where(mask[..., None], g, torch.zeros_like(g))
    return g


def total_variation(grid: torch.Tensor, mask=None) -> torch.Tensor:
    """The clamped-6-neighbour TV as a loss whose gradient is
    ``total_variation_grad``'s clamped differences: over the three forward
    differences d, ``phi(d) = d^2 / 2`` for |d| <= 1, else ``|d| - 1/2``,
    summed and divided by the voxel count. ``mask [X, Y, Z]``: only edges
    with an active end count."""
    def phi(d):
        ad = d.abs()
        return torch.where(ad <= 1.0, 0.5 * d * d, ad - 0.5)

    total = 0.0
    for axis in range(3):
        p = phi(torch.diff(grid, dim=axis))
        if mask is not None:
            n = grid.shape[axis]
            m = mask.narrow(axis, 0, n - 1) | mask.narrow(axis, 1, n - 1)
            p = torch.where(m[..., None], p, torch.zeros_like(p))
        total = total + p.sum()
    return total / (grid.shape[0] * grid.shape[1] * grid.shape[2])
