"""Dense layers as ``nn.Module``s (port of ``apnerf/ops/nn.py``).

JAX stores a layer as ``{"w": [din, dout], "b": [dout]}``; ``nn.Linear``
keeps ``weight`` as ``[dout, din]``. ``utils.checkpoint`` transposes
between the two.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``torch.nn.LeakyReLU`` default slope (0.01), as the JAX package."""
    return F.leaky_relu(x, negative_slope=0.01)


_ACTIVATIONS = {"relu": torch.relu, "leaky_relu": leaky_relu}


def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Uniform +-1/sqrt(fan_in) for weight and bias (``torch.nn.Linear``
    default bounds) drawn from an explicit generator."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        w = torch.rand(layer.weight.shape, generator=generator) * 2 - 1
        layer.weight.copy_(w * bound)
        if layer.bias is not None:
            b = torch.rand(layer.bias.shape, generator=generator) * 2 - 1
            layer.bias.copy_(b * bound)


class MLP(nn.Module):
    """``dims[0] -> dims[1] -> ... -> dims[-1]``; ``activation`` between
    layers, ``final_activation`` (or none) after the last."""

    def __init__(self, dims: Sequence[int], activation: str = "relu",
                 final_activation: Optional[str] = None,
                 final_bias: bool = True, device=None):
        super().__init__()
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1],
                      bias=final_bias or i < n - 1, device=device)
            for i in range(n))
        self.activation = activation
        self.final_activation = final_activation

    def reset_parameters_(self, generator: torch.Generator) -> "MLP":
        for layer in self.layers:
            init_linear_(layer, generator)
        return self

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``dtype`` (e.g. bf16): run the layers with the weights cast to
        it (the parameters stay as they are); ``x`` must be of that type."""
        act = _ACTIVATIONS[self.activation]
        for i, layer in enumerate(self.layers):
            if dtype is None:
                x = layer(x)
            else:
                x = F.linear(x, layer.weight.to(dtype),
                             None if layer.bias is None
                             else layer.bias.to(dtype))
            if i < len(self.layers) - 1:
                x = act(x)
            elif self.final_activation is not None:
                x = _ACTIVATIONS[self.final_activation](x)
        return x
