"""Checkpoints in the JAX package's pickle format, read and written
without jax (``apnerf/utils/checkpoint.py``, ``apnerf/cli.py``
``save_temporalpoints`` / ``load_temporalpoints`` and the stage-1
``fine_last.pkl`` / ``fine_progress.pkl``).

A checkpoint is a pickle of ``{"global_step", "model_kwargs", "params",
...extra}``; ``params`` is the JAX parameter pytree as numpy arrays, where
a dense layer is ``{"w": [din, dout], "b": [dout]}`` and an MLP is
``{"layers": [...]}``. ``params_from_jax`` / ``params_to_jax`` map that
tree to and from the port's ``state_dict`` (``weight`` is ``w``
transposed). Only load checkpoints you trust: unpickling runs code.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device


def save_checkpoint(path: str, model_kwargs: Dict[str, Any], params,
                    extra: Optional[Dict[str, Any]] = None,
                    global_step: int = 0) -> None:
    payload = {"global_step": global_step, "model_kwargs": model_kwargs,
               "params": params}
    if extra:
        payload.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return pickle.load(f)


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy leaves) -> ``state_dict`` of float32
    CPU tensors: ``a/b/layers/0/w`` -> ``a.b.layers.0.weight`` (transposed),
    ``b`` -> ``bias``, other leaves keep their name and layout."""
    out: Dict[str, torch.Tensor] = {}

    def leaf(x):
        return torch.tensor(np.asarray(x, dtype=np.float32))

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            is_layer = "w" in node
            for k, v in node.items():
                if is_layer and k == "w":
                    out[prefix + "weight"] = leaf(v).t().contiguous()
                elif is_layer and k == "b":
                    out[prefix + "bias"] = leaf(v)
                else:
                    walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = leaf(node)

    walk("", tree)
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``params_from_jax``: numpy pytree in the JAX layout."""
    root: Dict[str, Any] = {}
    for name, value in state_dict.items():
        parts = name.split(".")
        arr = value.detach().cpu().float().numpy()
        if parts[-1] == "weight":
            parts[-1], arr = "w", np.ascontiguousarray(arr.T)
        elif parts[-1] == "bias":
            parts[-1] = "b"
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def mlp_dims(state_dict: Dict[str, torch.Tensor], prefix: str) -> List[int]:
    """Layer widths of the MLP stored under ``prefix.layers.*``."""
    dims = []
    i = 0
    while f"{prefix}.layers.{i}.weight" in state_dict:
        dout, din = state_dict[f"{prefix}.layers.{i}.weight"].shape
        dims = (dims or [din]) + [dout]
        i += 1
    return dims


def model_from_jax(cfg, tree, device=None):
    """A ``TemporalPoints`` holding the JAX parameter pytree ``tree``, on
    ``device`` (``None``: the CUDA device; raises without one)."""
    from ..models.temporal_points import TemporalPoints
    device = resolve_device(device)
    sd = params_from_jax(tree)
    model = TemporalPoints(cfg, timenet_dims=mlp_dims(sd, "timenet"))
    model.load_state_dict(sd)
    return model.to(device)


def save_temporalpoints(path: str, model, state,
                        tineuvox_kwargs: Optional[Dict[str, Any]] = None,
                        global_step: int = 0) -> None:
    """Write a ``temporalpoints_last.pkl`` the JAX package can load."""
    def np_(x):
        if x is None or isinstance(x, np.ndarray):
            return x
        return x.detach().cpu().numpy()

    keys = ("canonical_pcd", "skeleton_pcd", "bones", "xyz_min", "xyz_max",
            "frozen_view_dir", "original_joints")
    extra = {"state_arrays": {k: np_(state[k]) for k in keys},
             "tineuvox_kwargs": tineuvox_kwargs or {}}
    save_checkpoint(path, dataclasses.asdict(model.cfg),
                    params_to_jax(model.state_dict()), extra=extra,
                    global_step=global_step)


def load_temporalpoints(path: str, device=None):
    """(model, state) from a ``temporalpoints_last.pkl`` on ``device``
    (``None``: the CUDA device; raises without one); ``state`` is rebuilt
    by ``init_state`` (kernel K1 runs here)."""
    from ..models import temporal_points as tp
    device = resolve_device(device)
    payload = load_checkpoint(path)
    cfg = tp.TemporalPointsConfig(**payload["model_kwargs"])
    model = model_from_jax(cfg, payload["params"], device)
    sa = payload["state_arrays"]
    state = tp.init_state(cfg, sa["canonical_pcd"], sa["original_joints"],
                          sa["bones"], sa["skeleton_pcd"], sa["xyz_min"],
                          sa["xyz_max"],
                          frozen_view_dir=sa["frozen_view_dir"],
                          device=device)
    return model, state


def tineuvox_from_jax(model_kwargs: Dict[str, Any], tree, device=None):
    """A ``TiNeuVox`` of the config ``model_kwargs`` holding the JAX
    parameter pytree ``tree``, on ``device`` (``None``: the CUDA device;
    raises without one)."""
    from ..models.tineuvox import TiNeuVox, TiNeuVoxConfig
    device = resolve_device(device)
    model = TiNeuVox(TiNeuVoxConfig(**model_kwargs))
    model.load_state_dict(params_from_jax(tree))
    return model.to(device)


def save_tineuvox(path: str, model, optimizer=None,
                  global_step: int = 0, write: bool = True) -> None:
    """Write a stage-1 checkpoint the JAX package can load:
    ``fine_last.pkl`` (the model alone) or, with ``optimizer`` (a
    ``train.masked_adam.MaskedAdam``), ``fine_progress.pkl`` with the Adam
    ``count`` / ``mu`` / ``nu`` for a mid-stage resume. Under a mesh every
    rank calls it (the ZeRO-1 moments are gathered) and only the rank with
    ``write`` writes."""
    extra = None if optimizer is None else {
        "opt_state": optimizer.state_to_jax()}
    if not write:
        return
    save_checkpoint(path, model.cfg.get_kwargs(),
                    params_to_jax(model.state_dict()), extra=extra,
                    global_step=global_step)


def load_tineuvox(path: str, device=None):
    """The ``TiNeuVox`` of a stage-1 checkpoint of either package, on
    ``device`` (``None``: the CUDA device; raises without one)."""
    payload = load_checkpoint(path)
    return tineuvox_from_jax(payload["model_kwargs"], payload["params"],
                             device)
