"""G1: the stage-1 multi-scale trilinear sample of the feature grid and its
gradient (``csrc/trilerp.cu``).

``mult_dist_interp_cuda`` is ``ops/grid.py``'s ``mult_dist_interp`` on a
CUDA device: the grid ``[X, Y, Z, C]`` sampled at strides 1, 2 and 4 of
its 4k+1-padded copy, at the bbox-normalised points, -> ``[..., 3C]``
(``[fine | stride 2 | stride 4]``). Its plain version is that module's
per-scale path (``mult_dist_interp_plain``), which CPU tensors take; there
is no TPU kernel (the JAX package leaves the sample to XLA).

The forward is one kernel (``trilerp``); it saves the grid and the
coordinates, not the corners. The backward (``trilerp_grad``, three
kernels) recomputes the corners: one kernel a sample forms d/dunit and each
scale's key (the extended base cell, or ``n_cells`` for a row whose
cotangent is all zero); the keys of the three scales, offset apart, take
one stable sort; one kernel writes K5's rows in that order; K5
(``kernels/scatter.py``) accumulates each scale; one kernel folds the 8
corner blocks and the three scales into the gradient. Forward and grid
gradient are bit-equal to the plain path on the card; d/dunit differs by
rounding only (float64 inside the kernel).
"""
from __future__ import annotations

import torch

from . import LAUNCHES, check, raise_on_error, stream_handle
from .scatter import MAX_C, sorted_window_accumulate_cuda

STRIDES = (1, 2, 4)


def geometry(shape):
    """Per stride of ``STRIDES``, for a grid of spatial ``shape``: (the
    strided padded grid's size, its extended grid's cell count, where its
    keys start in the joint sort) -- ``scale_of`` in csrc/trilerp.cu."""
    padded = [(n + 2) // 4 * 4 + 1 for n in shape[:3]]
    out, off = [], 0
    for s in STRIDES:
        dims = tuple((p - 1) // s + 1 for p in padded)
        n_cells = (dims[0] + 1) * (dims[1] + 1) * (dims[2] + 1)
        out.append((dims, n_cells, off))
        off += n_cells + 1
    return out


def channel_chunk(C: int) -> int:
    """Channels a K5 call takes, as ``ops/grid.py`` ``_grid_grad`` cuts
    them (a cell's sum does not depend on the cut)."""
    CG = min(C, 12)
    return C if C % CG else CG


def _vec4(C: int, *tensors) -> int:
    return int(C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _dims(grid: torch.Tensor, M: int):
    X, Y, Z, C = grid.shape
    if 3 * M * 8 * C >= 2 ** 32 or X * Y * Z * C >= 2 ** 31:
        raise ValueError("trilerp: sizes exceed the kernels' 32-bit indices")
    return X, Y, Z, C


def trilerp_cuda(grid: torch.Tensor, unit: torch.Tensor) -> torch.Tensor:
    """Launch the forward on the tensors' CUDA device: ``grid [X, Y, Z,
    C]``, ``unit [M, 3]`` -> ``[M, 3C]``."""
    M = unit.shape[0]
    X, Y, Z, C = _dims(grid, M)
    check(grid, "grid", torch.float32, (X, Y, Z, C))
    check(unit, "unit", torch.float32, (M, 3))
    from .build import load_library
    lib = load_library()
    out = torch.empty((M, 3 * C), dtype=torch.float32, device=grid.device)
    if M:
        LAUNCHES["trilerp"] += 1
        raise_on_error(lib.trilerp_launch(
            grid.data_ptr(), unit.data_ptr(), M, X, Y, Z, C,
            _vec4(C, grid, out), out.data_ptr(), stream_handle(grid)),
            "trilerp")
    return out


def trilerp_grad_cuda(grid: torch.Tensor, unit: torch.Tensor,
                      g: torch.Tensor, grid_grad: bool = True):
    """Launch the backward on the tensors' CUDA device: ``g = dL/dout [M,
    3C]`` -> (``dL/dgrid [X, Y, Z, C]``, None unless ``grid_grad``;
    ``dL/dunit [M, 3]``)."""
    M = unit.shape[0]
    X, Y, Z, C = _dims(grid, M)
    check(grid, "grid", torch.float32, (X, Y, Z, C))
    check(unit, "unit", torch.float32, (M, 3))
    check(g, "g", torch.float32, (M, 3 * C))
    from .build import load_library
    lib = load_library()
    dev, stream = grid.device, stream_handle(grid)
    dunit = torch.empty_like(unit)
    keys = torch.empty(3 * M, dtype=torch.int32, device=dev)
    if M:
        LAUNCHES["trilerp_grad"] += 1
        raise_on_error(lib.trilerp_grad_launch(
            grid.data_ptr(), unit.data_ptr(), g.data_ptr(), M, X, Y, Z, C,
            _vec4(C, grid, g), dunit.data_ptr(), keys.data_ptr(), stream),
            "trilerp_grad")
    if not grid_grad:
        return None, dunit
    if not M:
        return torch.zeros_like(grid), dunit
    CG = channel_chunk(C)
    if 8 * CG > MAX_C:
        raise ValueError(f"trilerp: K5 takes at most {MAX_C} channels, "
                         f"8 corners x {CG} here")
    keys_sorted, order = torch.sort(keys, stable=True)
    idx = torch.empty(3 * M, dtype=torch.int32, device=dev)
    upd = torch.empty((3 * M, 8 * CG), dtype=torch.float32, device=dev)
    dgrid = torch.empty_like(grid)
    geo = geometry(grid.shape)
    for c0 in range(0, C, CG):
        LAUNCHES["trilerp_grad"] += 1
        raise_on_error(lib.trilerp_rows_launch(
            unit.data_ptr(), g.data_ptr(), order.data_ptr(),
            keys_sorted.data_ptr(), M, X, Y, Z, C, c0, CG,
            _vec4(C, g, upd), idx.data_ptr(),
            upd.data_ptr(), stream), "trilerp_rows")
        acc = [sorted_window_accumulate_cuda(
            idx[i * M:(i + 1) * M], upd[i * M:(i + 1) * M], n_cells,
            transposed=True) for i, (_, n_cells, _) in enumerate(geo)]
        LAUNCHES["trilerp_grad"] += 1
        raise_on_error(lib.trilerp_fold_launch(
            *(a.data_ptr() for a in acc), X, Y, Z, C, c0, CG,
            dgrid.data_ptr(), stream), "trilerp_fold")
    return dgrid, dunit


class _MultiScaleTrilerp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, unit):
        ctx.save_for_backward(grid, unit)
        return trilerp_cuda(grid, unit)

    @staticmethod
    def backward(ctx, g):
        grid, unit = ctx.saved_tensors
        dgrid, dunit = trilerp_grad_cuda(grid, unit, g.contiguous(),
                                         ctx.needs_input_grad[0])
        return dgrid, dunit if ctx.needs_input_grad[1] else None


def mult_dist_interp_cuda(grid: torch.Tensor, xyz: torch.Tensor, xyz_min,
                          xyz_max) -> torch.Tensor:
    """``ops/grid.py`` ``mult_dist_interp`` through G1: ``grid [X, Y, Z,
    C]`` at world points ``xyz [..., 3]`` -> ``[..., 3C]``, differentiable
    in both."""
    unit = (xyz - xyz_min) / (xyz_max - xyz_min)
    lead = unit.shape[:-1]
    out = _MultiScaleTrilerp.apply(grid.float().contiguous(),
                                   unit.reshape(-1, 3).contiguous())
    return out.reshape(*lead, out.shape[-1])
