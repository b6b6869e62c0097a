"""Small constant tensors made on the device."""
from __future__ import annotations

from typing import Sequence

import torch


def device_vector(values: Sequence[float], device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, the same
    numbers, each filled in on the device: no host-to-device copy, which a
    CUDA graph's capture refuses."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out
