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

Moments are fp32 tensors keyed by ``state_dict`` name. Parameters are
updated in place; the update runs under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.checkpoint import params_from_jax, params_to_jax


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

    def _step_size(self, lr: float) -> np.float32:
        f32 = np.float32
        t = f32(self.count)
        decay = f32(0.1) ** ((t - f32(1.0)) / f32(self.decay_steps))
        corr = np.sqrt(f32(1.0) - f32(self.b2) ** t) / (
            f32(1.0) - f32(self.b1) ** t)
        return f32(lr) * decay * corr

    @torch.no_grad()
    def update(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One step; ``grads`` maps each parameter name to its gradient
        (None counts as zero)."""
        self.count += 1
        b1, b2, eps = self.b1, self.b2, self.eps
        for name, p in self.params.items():
            key = name.split(".")[0]
            lr = self.lrs[key]
            if lr == 0.0:
                continue
            step_size = float(self._step_size(lr))
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
            self.mu[name], self.nu[name] = m, v

    def state_to_jax(self) -> Dict:
        """``{"count", "mu", "nu"}`` as the JAX package's
        ``MaskedAdamState`` pytrees (numpy leaves)."""
        return {"count": np.asarray(self.count, np.int32),
                "mu": params_to_jax(self.mu), "nu": params_to_jax(self.nu)}

    def load_state_from_jax(self, saved: Dict) -> None:
        """Inverse of ``state_to_jax``; moments land on the parameters'
        devices."""
        self.count = int(np.asarray(saved["count"]))
        for attr in ("mu", "nu"):
            sd = params_from_jax(saved[attr])
            setattr(self, attr, {n: sd[n].to(p.device)
                                 for n, p in self.params.items()})
