"""Masked Adam with per-group learning rates (port of
``apnerf/train/masked_adam.py``).

* one learning rate per top-level parameter key, ``lrate_<key>`` of the
  train config (the reference's ``lrate_*`` reflection); a key with none,
  or lr 0, is frozen: its parameters and moments never change,
* per-step decay ``0.1 ** ((t - 1) / (lrate_decay * 1000))`` and the bias
  correction folded into the step size, both in fp32 as in the JAX
  package,
* ``skip_zero_grad_fields``: entries whose gradient is exactly 0 keep
  their parameter and both moments (the sparse voxel-grid update).

Moments are fp32 tensors keyed by ``state_dict`` name. A step is two
parts, so that a CUDA graph can replay the second: ``advance()`` counts
on the host and loads each training key's step size, computed in numpy
fp32, into the static device vector ``step_sizes``; ``apply(grads)``
updates the parameters and both moments in place (under
``torch.no_grad``), reading its step sizes from that vector.
``update(grads)`` is both. A checkpoint reads and restores those same
moment tensors (``state_to_jax`` / ``load_state_from_jax``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.checkpoint import params_from_jax, params_to_jax
from ..utils.graphs import load_static


class MaskedAdam:
    b1, b2, eps = 0.9, 0.99, 1e-8

    def __init__(self, model: torch.nn.Module, cfg_train):
        self.decay_steps = float(cfg_train["lrate_decay"]) * 1000.0
        self.params = dict(model.named_parameters())
        keys = dict.fromkeys(n.split(".")[0] for n in self.params)
        self.lrs = {k: float(cfg_train.get(f"lrate_{k}", 0.0)) for k in keys}
        self.skip_fields = set(cfg_train.get("skip_zero_grad_fields", []))
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params.items()}
        # the keys that train, and each one's slot in step_sizes
        self.slot = {k: i for i, k in enumerate(
            k for k in keys if self.lrs[k] != 0.0)}
        dev = next(iter(self.params.values())).device
        self.step_sizes = torch.zeros(len(self.slot), dtype=torch.float32,
                                      device=dev)

    def _step_size(self, lr: float) -> np.float32:
        f32 = np.float32
        t = f32(self.count)
        decay = f32(0.1) ** ((t - f32(1.0)) / f32(self.decay_steps))
        corr = np.sqrt(f32(1.0) - f32(self.b2) ** t) / (
            f32(1.0) - f32(self.b1) ** t)
        return f32(lr) * decay * corr

    def advance(self) -> None:
        """Count one step and load the step sizes of that count into
        ``step_sizes``, in stream order."""
        self.count += 1
        load_static(self.step_sizes, np.array(
            [self._step_size(self.lrs[k]) for k in self.slot], np.float32))

    @torch.no_grad()
    def apply(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """The update of the step ``advance`` counted; ``grads`` maps each
        parameter name to its gradient (None counts as zero)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        for name, p in self.params.items():
            key = name.split(".")[0]
            if key not in self.slot:
                continue
            step_size = self.step_sizes[self.slot[key]]
            g = grads.get(name)
            g = torch.zeros_like(p, dtype=torch.float32) if g is None \
                else g.float()
            m_old, v_old = self.mu[name], self.nu[name]
            m = b1 * m_old + (1 - b1) * g
            v = b2 * v_old + (1 - b2) * g * g
            delta = step_size * m / (torch.sqrt(v) + eps)
            p32 = p.float()
            if key in self.skip_fields:
                keep = g == 0.0
                m = torch.where(keep, m_old, m)
                v = torch.where(keep, v_old, v)
                p_new = torch.where(keep, p32, p32 - delta)
            else:
                p_new = p32 - delta
            p.copy_(p_new)
            m_old.copy_(m)
            v_old.copy_(v)

    def update(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One step: ``advance`` then ``apply``."""
        self.advance()
        self.apply(grads)

    def state_to_jax(self) -> Dict:
        """``{"count", "mu", "nu"}`` as the JAX package's
        ``MaskedAdamState`` pytrees (numpy leaves)."""
        return {"count": np.asarray(self.count, np.int32),
                "mu": params_to_jax(self.mu), "nu": params_to_jax(self.nu)}

    def load_state_from_jax(self, saved: Dict) -> None:
        """Inverse of ``state_to_jax``: the moments are copied into this
        optimizer's own tensors, which a captured step reads."""
        self.count = int(np.asarray(saved["count"]))
        for attr in ("mu", "nu"):
            sd = params_from_jax(saved[attr])
            for n, m in getattr(self, attr).items():
                m.copy_(sd[n])
