"""The TiNeuVox colour head (port of ``apnerf/models/tineuvox.py``
``init_rgbnet`` / ``apply_rgbnet``); the backbone is not ported yet."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.nn import MLP, init_linear_


class RGBNet(nn.Module):
    """``feature_linears`` (width -> width), then ``views_linears``
    (width + views_ch -> width // 2 -> 3, ReLU between)."""

    def __init__(self, width: int, views_ch: int, device=None):
        super().__init__()
        self.feature_linears = nn.Linear(width, width, device=device)
        self.views_linears = MLP([width + views_ch, width // 2, 3],
                                 device=device)

    def reset_parameters_(self, generator: torch.Generator) -> "RGBNet":
        init_linear_(self.feature_linears, generator)
        self.views_linears.reset_parameters_(generator)
        return self

    def forward(self, h: torch.Tensor,
                views_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        feat = self.feature_linears(h)
        if views_emb is not None:
            feat = torch.cat([feat, views_emb], dim=-1)
        return self.views_linears(feat)
