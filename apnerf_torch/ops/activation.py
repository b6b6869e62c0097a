"""Density -> alpha (forward of ``apnerf/ops/activation.py:raw2alpha``)."""
from __future__ import annotations

import torch


def raw2alpha(density: torch.Tensor, shift: float,
              interval: float) -> torch.Tensor:
    """alpha = 1 - (1 + exp(density + shift)) ** (-interval)."""
    e = torch.exp(density + shift)
    return 1.0 - torch.pow(1.0 + e, -interval)
