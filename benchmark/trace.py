"""From a ``torch.profiler`` window to what the per-layer readers read.

The arithmetic is the program's profilers' (``train/profile_stage1.py``:
the device operations' intervals and their union; ``render/
profile_render.py``: kernels grouped by name), copied here so that a later
change to the program cannot move the yardstick. A group is told apart by
the name marks of ``kernels.json``.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(name: str):
    with open(os.path.join(HERE, name)) as f:
        return json.load(f)


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def group_of(name: str, marks=None) -> str:
    """``own:<kernel>``, ``gemm`` or ``glue`` by the marks of
    ``kernels.json``."""
    marks = marks or load_json("kernels.json")
    for kernel, ms in marks["own"].items():
        if any(m in name for m in ms):
            return "own:" + kernel
    if any(m in name for m in marks["gemm"]):
        return "gemm"
    return "glue"


def events(prof):
    """(device ops [(name, start_us, end_us)], host ops [(name, start_us,
    end_us)]) of a finished profile."""
    import torch
    dev, host = [], []
    for e in prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(rng)
        elif e.time_range.end > e.time_range.start:
            host.append(rng)
    return dev, host


def reduce(dev, host, window_s: float, units: int) -> Dict:
    """What a traced window holds, for ``units`` steps or frames:
    ``window_s``, ``busy_s`` (the union of the device operations),
    ``device_us_by_name`` (each operation's device time a unit),
    ``device_us_by_group`` (``own:<kernel>``, ``gemm``, ``glue``, a unit)
    and the ``breakdown`` of the result line: the ten operations that took
    most device time and the ten longest idle gaps, each named by the
    innermost host operation running at its middle."""
    marks = load_json("kernels.json")
    busy = union_us([(s, e) for _, s, e in dev])
    by_name: Dict[str, float] = defaultdict(float)
    by_group: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += (e - s) / units
        by_group[group_of(name, marks)] += (e - s) / units
    spans = merged([(s, e) for _, s, e in dev])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(spans, spans[1:])
                   if b[0] > a[1]), reverse=True)[:10]
    named = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        around = [(he - hs, hn) for hn, hs, he in host if hs <= mid <= he]
        named.append([min(around)[1] if around else "host idle",
                      length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy * 1e-6, "units": units,
            "device_us_by_name": dict(by_name),
            "device_us_by_group": dict(by_group),
            "breakdown": {"device_ops": [[n, t * units * 1e-6]
                                         for n, t in top],
                          "idle_gaps": named}}


def kernel_us(reading: Dict, kernel: str) -> Optional[float]:
    """Device us a unit of the hand-written kernel ``kernel`` (a key of
    ``kernels.json``'s ``own``), None when none of its marks ran."""
    t = reading["device_us_by_group"].get("own:" + kernel)
    return t if t else None
