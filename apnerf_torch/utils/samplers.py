"""Host-side samplers of the stage-2 time curriculum (port of
``apnerf/utils/samplers.py``): ``InverseProportionalSampler`` (reference
lib/utils.py:29-41) and the growing time window around the canonical frame
(reference run.py:545-584). numpy only; a sampler draws from its
``np.random.default_rng(seed)`` exactly as the JAX package's does, so both
packages sample the same times.
"""
from __future__ import annotations

import math

import numpy as np


class InverseProportionalSampler:
    """Sample indices with probability inversely proportional to their
    visit counts (favours under-trained timesteps)."""

    def __init__(self, i_max: int, seed: int = 0):
        self.i_max = i_max
        self.counts = np.ones(i_max)
        self.rng = np.random.default_rng(seed)

    def sample(self, i_min: int = 0, i_max=None) -> int:
        i_max = i_max or self.i_max
        p = 1.0 / self.counts[i_min:i_max]
        p = p / p.sum()
        idx = int(self.rng.choice(np.arange(i_min, i_max), p=p))
        self.counts[idx] += 1
        return idx


def curriculum_range(canonical_idx: int, max_len: int, num: float):
    """Growing window around the canonical time index
    (reference ``get_range``, run.py:545-561). Returns (t_max, t_min)."""
    t_max = math.ceil(canonical_idx + num / 2)
    t_min = math.ceil(canonical_idx - num / 2)
    if num >= max_len:
        return max_len, 0
    if t_max > max_len:
        t_min -= t_max % max_len
        t_max = max_len
    elif t_min < 0:
        t_max += abs(t_min)
        t_min = 0
    return t_max, t_min


def curriculum_window(step: int, n_times: int, full_t_iter: int,
                      canonical_idx: int):
    num = min(max((n_times / full_t_iter) * step, 1), n_times)
    return curriculum_range(canonical_idx, n_times, num)
