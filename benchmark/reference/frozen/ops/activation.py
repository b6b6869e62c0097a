"""Density -> alpha (port of ``apnerf/ops/activation.py``).

alpha = 1 - (1 + exp(density + shift)) ** (-interval), with the JAX
package's custom backward: the reference CUDA kernel's ``min(e, 1e10)``
overflow guard (lib/cuda/render_utils_kernel.cu:404).
"""
from __future__ import annotations

import torch


class _Raw2Alpha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, density, shift: float, interval: float):
        e = torch.exp(density + shift)
        ctx.save_for_backward(e)
        ctx.interval = interval
        return 1.0 - torch.pow(1.0 + e, -interval)

    @staticmethod
    def backward(ctx, g):
        (e,) = ctx.saved_tensors
        interval = ctx.interval
        grad = (torch.clamp(e, max=1e10) * torch.pow(1.0 + e, -interval - 1.0)
                * interval * g)
        return grad, None, None


def raw2alpha(density: torch.Tensor, shift: float,
              interval: float) -> torch.Tensor:
    """alpha = 1 - (1 + exp(density + shift)) ** (-interval); d/d density
    is ``min(e, 1e10) * (1 + e) ** (-interval - 1) * interval``."""
    return _Raw2Alpha.apply(density, float(shift), float(interval))


def activate_density(density: torch.Tensor, interval: float,
                     act_shift: float) -> torch.Tensor:
    """Density -> alpha as the reference ``TiNeuVox.activate_density``:
    ``raw2alpha(density, act_shift, interval)``."""
    return raw2alpha(density, act_shift, interval)
