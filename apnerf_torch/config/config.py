"""Python-file configs with ``_base_`` inheritance (port of
``apnerf/config/config.py``).

A config file is plain Python; a ``_base_`` string (or list) names parent
file(s), relative to the file, whose dicts are merged recursively with the
child's values taking precedence (``configs/nerf/jumpingjacks.py`` over
``configs/nerf/default.py``). The reference loads mmengine configs of the
same shape (run.py:1246).
"""
from __future__ import annotations

import copy
import os
import types
from typing import Any, Dict


class ConfigDict(dict):
    """A dict whose keys read and write as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def get(self, key, default=None):
        return dict.get(self, key, default)

    def copy(self):
        return ConfigDict({k: (v.copy() if isinstance(v, ConfigDict) else
                               copy.deepcopy(v)) for k, v in self.items()})


def _to_config(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config(v) for v in obj)
    return obj


def _merge(base: Dict[str, Any], child: Dict[str, Any]):
    out = dict(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _exec_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = f.read()
    mod: Dict[str, Any] = {"__file__": path}
    exec(compile(src, path, "exec"), mod)
    return {k: v for k, v in mod.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)
            and not callable(v)}


def load_config(path: str) -> ConfigDict:
    """Load a config file, resolving ``_base_`` inheritance."""
    path = os.path.abspath(path)
    ns = _exec_file(path)
    bases = ns.pop("_base_", None)
    if bases is not None:
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            bcfg = load_config(os.path.join(os.path.dirname(path), b))
            merged = _merge(merged, bcfg)
        ns = _merge(merged, ns)
    return _to_config(ns)


def dump_config(cfg: ConfigDict, path: str):
    """Write a config back out as a Python file (reference run.py:1021)."""
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {_fmt(v)}\n")


def _fmt(v, indent=0):
    pad = " " * indent
    if isinstance(v, dict):
        items = ",\n".join(f"{pad}    {k!r}: {_fmt(x, indent + 4)}"
                           for k, x in v.items())
        return "{\n" + items + f"\n{pad}}}"
    return repr(v)


def builtin_config_dir() -> str:
    """The directory of the shipped config files (``nerf``, ``wim``,
    ``zju``)."""
    return os.path.join(os.path.dirname(__file__), "configs")
