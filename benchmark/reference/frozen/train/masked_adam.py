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

With a ``mesh`` (``parallel.mesh``, the counterpart of the JAX trainers'
``zero1_mesh``): ``reduce(grads)`` sums the ranks' gradients in fp32 (one
all-reduce), which the step reads before anything that looks at them (the
TV gradient, the ``skip_zero_grad_fields`` mask ``g == 0``: a voxel no
rank touched, not one this rank did not touch), and the moments are
ZeRO-1 split: of every parameter of at least ``zero1_min_size`` elements a
rank holds and updates the moments of its contiguous range of the
flattened parameter (``parallel.mesh.zero1_split``), then one all-gather
of the ranks' updated ranges gives every rank the whole parameters. Each
element takes the same fp32 arithmetic as without a mesh. ``state_to_jax``
gathers whole moments (every rank must call it), so a ZeRO-1 checkpoint
has the single-device format; ``load_state_from_jax`` takes the rank's
ranges.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..utils.checkpoint import params_from_jax, params_to_jax
from ..utils.graphs import load_static


class MaskedAdam:
    b1, b2, eps = 0.9, 0.99, 1e-8

    def __init__(self, model: torch.nn.Module, cfg_train, mesh=None,
                 zero1_min_size: Optional[int] = pmesh.ZERO1_MIN_SIZE):
        self.mesh = mesh
        self.decay_steps = float(cfg_train["lrate_decay"]) * 1000.0
        self.params = dict(model.named_parameters())
        keys = dict.fromkeys(n.split(".")[0] for n in self.params)
        self.lrs = {k: float(cfg_train.get(f"lrate_{k}", 0.0)) for k in keys}
        self.skip_fields = set(cfg_train.get("skip_zero_grad_fields", []))
        self.count = 0
        # ZeRO-1: elements a rank holds of each split parameter's moments
        self.split = {} if mesh is None or zero1_min_size is None else {
            n: c for n, p in self.params.items()
            if (c := pmesh.zero1_split(p.numel(), mesh.world,
                                       zero1_min_size)) is not None}
        self.mu = {n: self._zeros(n) for n in self.params}
        self.nu = {n: self._zeros(n) for n in self.params}
        # the keys that train, and each one's slot in step_sizes
        self.slot = {k: i for i, k in enumerate(
            k for k in keys if self.lrs[k] != 0.0)}
        dev = next(iter(self.params.values())).device
        self.step_sizes = torch.zeros(len(self.slot), dtype=torch.float32,
                                      device=dev)

    def _zeros(self, name: str) -> torch.Tensor:
        p = self.params[name]
        if name in self.split:
            return p.new_zeros(self.split[name], dtype=torch.float32)
        return torch.zeros_like(p, dtype=torch.float32)

    def _own(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's range of the flattened ``x`` (zero padded)."""
        c = self.split[name]
        flat = x.reshape(-1)
        lo = self.mesh.rank * c
        if lo + c > flat.numel():
            flat = torch.nn.functional.pad(flat, (0, lo + c - flat.numel()))
        return flat[lo:lo + c]

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

    def reduce(self, grads: Dict[str, Optional[torch.Tensor]]
               ) -> Dict[str, Optional[torch.Tensor]]:
        """The ranks' gradients summed in fp32 (``grads`` as it is without a
        mesh)."""
        if self.mesh is None:
            return grads
        return pmesh.all_reduce_grads(grads, self.mesh)

    @torch.no_grad()
    def apply(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """The update of the step ``advance`` counted; ``grads`` maps each
        parameter name to its gradient (None counts as zero), summed over
        the ranks under a mesh (``reduce``)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        owned = []
        for name, p in self.params.items():
            key = name.split(".")[0]
            if key not in self.slot:
                continue
            step_size = self.step_sizes[self.slot[key]]
            g = grads.get(name)
            g = torch.zeros_like(p, dtype=torch.float32) if g is None \
                else g.float()
            p32 = p.float()
            if name in self.split:
                g, p32 = self._own(name, g), self._own(name, p32)
            m_old, v_old = self.mu[name], self.nu[name]
            m = b1 * m_old + (1 - b1) * g
            v = b2 * v_old + (1 - b2) * g * g
            delta = step_size * m / (torch.sqrt(v) + eps)
            if key in self.skip_fields:
                keep = g == 0.0
                m = torch.where(keep, m_old, m)
                v = torch.where(keep, v_old, v)
                p_new = torch.where(keep, p32, p32 - delta)
            else:
                p_new = p32 - delta
            if name in self.split:
                # rounded to the parameter's type before the all-gather,
                # as p.copy_ rounds it without a mesh
                owned.append((name, p_new.to(p.dtype).float()))
            else:
                p.copy_(p_new)
            m_old.copy_(m)
            v_old.copy_(v)
        if owned:
            self._gather_params(owned)

    def _gather_params(self, owned) -> None:
        """Every rank's updated ranges (fp32 on the way, each value already
        in its parameter's type) into the whole parameters, in one
        all-gather."""
        world = self.mesh.world
        mine = torch.cat([x for _, x in owned])
        every = pmesh.all_gather_flat(mine, self.mesh).view(world, -1)
        off = 0
        for name, x in owned:
            c = x.numel()
            p = self.params[name]
            p.copy_(every[:, off:off + c].reshape(-1)[:p.numel()]
                    .view(p.shape))
            off += c

    def _whole(self, name: str, m: torch.Tensor) -> torch.Tensor:
        """A moment as the whole parameter's shape (all-gathered where it
        is split)."""
        if name not in self.split:
            return m
        p = self.params[name]
        return pmesh.all_gather_flat(m, self.mesh)[:p.numel()].view(p.shape)

    def update(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One step: ``advance`` then ``apply``."""
        self.advance()
        self.apply(grads)

    def state_to_jax(self) -> Dict:
        """``{"count", "mu", "nu"}`` as the JAX package's
        ``MaskedAdamState`` pytrees (numpy leaves)."""
        return {"count": np.asarray(self.count, np.int32),
                **{attr: params_to_jax({n: self._whole(n, m) for n, m in
                                        getattr(self, attr).items()})
                   for attr in ("mu", "nu")}}

    def load_state_from_jax(self, saved: Dict) -> None:
        """Inverse of ``state_to_jax``: the moments are copied into this
        optimizer's own tensors, which a captured step reads."""
        self.count = int(np.asarray(saved["count"]))
        for attr in ("mu", "nu"):
            sd = params_from_jax(saved[attr])
            for n, m in getattr(self, attr).items():
                v = sd[n].to(m.device)
                m.copy_(self._own(n, v) if n in self.split else v)
