"""Per-ray transmittance, compositing and the distortion loss, dense
layout (port of ``apnerf/ops/marching.py``). The CUDA reference's early
exit at ``T < 1e-3`` is a mask: no weight after the stop step, and
``alphainv_last`` freezes at the stop value. Gradients come from autograd
of the same masked expressions, as in the JAX package; the transmittance's
running product has a backward of its own (``cumprod``), which PyTorch's
reads back from the device and a CUDA graph cannot capture."""
from __future__ import annotations

from typing import Optional

import torch

EARLY_STOP_T = 1e-3


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod(x, -1)`` whose backward asks the host nothing.
    PyTorch's backward reads whether ``x`` holds a zero and then takes one
    of two formulas; this one computes both sides on the device and picks
    per entry, with the same operations in the same order, so its result
    is PyTorch's bit for bit: before a row's first zero, the reversed
    cumulative sum of ``y * g`` over ``x``; at the first zero, the
    product of what precedes it times the sum of ``g`` against the running
    product up to the next zero; after it, zero."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, -1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        w = y * g
        zeros = torch.cumsum(x == 0, -1)
        before = zeros == 0
        rsum = torch.where(before, w, 0.0).flip(-1).cumsum(-1).flip(-1)
        grad = torch.where(before, rsum / x, 0.0)
        seg = zeros == 1
        first = seg & (x == 0)
        run = torch.where(seg & ~first, x, 1.0).cumprod(-1)
        s = (run * torch.where(seg, g, 0.0)).sum(-1, keepdim=True)
        y_excl = torch.cat([torch.ones_like(y[..., :1]), y[..., :-1]], -1)
        return torch.where(first, s * y_excl, grad)


def cumprod(x: torch.Tensor) -> torch.Tensor:
    """Running product along the last axis (``_Cumprod``)."""
    return _Cumprod.apply(x)


def alpha2weights(alpha: torch.Tensor, valid: Optional[torch.Tensor] = None,
                  early_stop: float = EARLY_STOP_T):
    """alpha [R, S] (near -> far) -> (weights [R, S], alphainv_last [R])."""
    if valid is not None:
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    t_incl = cumprod(1.0 - alpha)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]],
                       dim=-1)
    weights = torch.where(t_excl >= early_stop, alpha * t_excl,
                          torch.zeros_like(alpha))
    stopped = t_incl < early_stop
    first_stop = stopped.to(torch.int32).argmax(dim=-1, keepdim=True)
    t_at_stop = torch.gather(t_incl, -1, first_stop)[..., 0]
    alphainv_last = torch.where(stopped.any(dim=-1), t_at_stop,
                                t_incl[..., -1])
    return weights, alphainv_last


def composite(weights: torch.Tensor, values: torch.Tensor, bg=None,
              alphainv_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of ``weights * values`` along the sample axis, plus background.

    weights [R, S]; values [R, S, C] or [R, S]."""
    if values.dim() == weights.dim() + 1:
        out = (weights[..., None] * values).sum(dim=-2)
    else:
        out = (weights * values).sum(dim=-1)
    if bg is not None:
        out = out + alphainv_last[..., None] * bg
    return out


def distortion_loss(weights: torch.Tensor, s: torch.Tensor, interval,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mip-NeRF-360 distortion loss, dense per-ray form: per ray
    ``sum_ij w_i w_j |s_i - s_j| + interval / 3 * sum_i w_i^2`` through the
    O(S) prefix-sum identity (samples sorted along S), summed over rays
    and divided by their number."""
    if valid is not None:
        weights = torch.where(valid, weights, torch.zeros_like(weights))
    w_cum = torch.cumsum(weights, -1) - weights
    ws = weights * s
    ws_cum = torch.cumsum(ws, -1) - ws
    loss_bi = 2.0 * (ws * w_cum - weights * ws_cum)
    loss_uni = (1.0 / 3.0) * interval * weights ** 2
    return (loss_bi.sum() + loss_uni.sum()) / weights.shape[0]
