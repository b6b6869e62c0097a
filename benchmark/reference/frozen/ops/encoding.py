"""Positional (frequency) encoding (port of ``apnerf/ops/encoding.py``)."""
from __future__ import annotations

import torch


def poc_freqs(n: int, device=None) -> torch.Tensor:
    """Frequency buffer [2^0 .. 2^(n-1)] in float32, exact: integer shifts
    made on ``device``, with no host-to-device copy (a CUDA graph may
    capture it)."""
    one = torch.ones(n, dtype=torch.int64, device=device)
    return (one << torch.arange(n, device=device)).float()


def poc_fre(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Frequency-encode ``x`` (..., C) -> (..., C * (1 + 2 * len(freqs))).

    Layout: raw input, then all sins, then all cosines; the frequency axis
    is flattened inside each axis (channel ``a * n + i``).
    """
    emb = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], dim=-1)


def poc_dim(c: int, n_freqs: int) -> int:
    """Output channel count of ``poc_fre`` for input dim ``c``."""
    return c + 2 * c * n_freqs
