"""Per-ray transmittance and compositing, dense layout (forward of
``apnerf/ops/marching.py``). The CUDA reference's early exit at
``T < 1e-3`` is a mask: no weight after the stop step, and
``alphainv_last`` freezes at the stop value."""
from __future__ import annotations

from typing import Optional

import torch

EARLY_STOP_T = 1e-3


def alpha2weights(alpha: torch.Tensor, valid: Optional[torch.Tensor] = None,
                  early_stop: float = EARLY_STOP_T):
    """alpha [R, S] (near -> far) -> (weights [R, S], alphainv_last [R])."""
    if valid is not None:
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    t_incl = torch.cumprod(1.0 - alpha, dim=-1)
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
