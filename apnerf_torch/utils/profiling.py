"""The port's span and counter recorder.

A *span* is a named interval of host time: its start and end in ns on
``time.time_ns`` (CLOCK_REALTIME, the clock of a ``torch.profiler``
trace's own timestamps: an event there starts at ``trace_start_ns`` plus
its offset), the span that was open around it (its parent), the unit it
belongs to (a training step or a frame) and at most one small attribute
(a graph's key). A *counter* is a named sum kept beside the spans.

The recorder is on while a ``torch.profiler`` records and between
``enable()`` and ``disable()`` (an operator's use without a profiler). A
span is recorded only if the recorder was on at both its start and its
end. Off, a span site costs one flag test: ``scope`` and ``span`` hand
back one shared object that does nothing, with no allocation, no device
work and no host sync. The record is in memory and bounded (``CAP``
spans, the oldest dropped); ``record()`` reads it.

While a profiler records, a span opened with ``mirror`` is also a
``record_function`` range of the same name (and, on a CUDA build, an
NVTX range), so that it names the host time round it in the trace. Only
spans that launch nothing on the device are mirrored: the profiler may
give a range that encloses launches a device-side annotation, which a
reader of device operations would count as device work. A span opened
with ``device`` (on CUDA only) also records a pair of timing events in
stream order; ``record()`` resolves them to the device ms between them.

No span may lie inside a body that a CUDA graph captures: it would fire
once, at the capture. The span round the replay covers what the graph
runs.
"""
from __future__ import annotations

import collections
import itertools
import time
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

CAP = 1 << 16          # spans kept; the oldest are dropped beyond

_enabled = False
_spans: collections.deque = collections.deque(maxlen=CAP)
_dropped = 0
_ids = itertools.count()
_open: list = []                       # spans entered as parents
_unit = None                           # the loop's current unit
_units: Dict[str, int] = {}            # units made by ``span``, by kind
_counts: Dict[tuple, torch.Tensor] = {}   # counters, by their names


def on() -> bool:
    """Whether the recorder is on."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def enable() -> None:
    """Turn the recorder on without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Empty the record: spans, counters and the units' counts."""
    global _dropped
    _spans.clear()
    _dropped = 0
    _units.clear()
    _counts.clear()


def set_unit(unit) -> None:
    """The unit (e.g. ``("stage2", global_step)``) of the spans opened
    outside any other span from here on."""
    global _unit
    _unit = unit


class _Off:
    """What a span site gets while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return False

    def close(self) -> None:
        pass


_OFF = _Off()


class Span:
    """An open span. ``with`` it: it is the parent of the spans opened
    inside (and, from ``scope``, closed at the end of the block)."""
    __slots__ = ("name", "attr", "unit", "id", "parent", "start", "rf",
                 "nvtx", "events", "block")

    def __init__(self, name: str, attr, unit, mirror: bool, device: bool,
                 block: bool):
        parent = _open[-1] if _open else None
        self.name, self.attr, self.block = name, attr, block
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.unit = unit if unit is not None else (
            _unit if parent is None else parent.unit)
        self.events = None
        self.rf, self.nvtx = None, False
        self.start = time.time_ns()
        if mirror and _autograd_profiler._is_profiler_enabled:
            self.rf = torch.autograd.profiler.record_function(name)
            self.rf.__enter__()
            self.nvtx = torch.cuda.is_available()
            if self.nvtx:
                torch.cuda.nvtx.range_push(name)
        if device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()

    def __enter__(self):
        _open.append(self)
        return self

    def __exit__(self, *exc):
        _open.pop()
        if self.block:
            self.close()
        return False

    def close(self) -> None:
        global _dropped
        if self.events is not None:
            self.events[1].record()
        if self.rf is not None:
            if self.nvtx:
                torch.cuda.nvtx.range_pop()
            self.rf.__exit__(None, None, None)
        end = time.time_ns()
        if not (_enabled or _autograd_profiler._is_profiler_enabled):
            return
        if len(_spans) == CAP:
            _dropped += 1
        _spans.append((self.name, self.start, end, self.id, self.parent,
                       self.unit, self.attr, self.events))


def scope(name: str, attr=None, mirror: bool = False, device: bool = False):
    """``with scope(name):`` records the block as a span (see the module
    docstring for ``attr``, ``mirror`` and ``device``)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, attr, None, mirror, device, True)


def span(name: str, kind: str):
    """A span opened now, the first of a new unit ``(kind, n)`` (n counts
    the units of ``kind`` since the last ``reset``), and ended by its
    ``close()``, which may come in another call (a frame read back later);
    ``with`` it makes it the parent of the spans opened inside."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    n = _units.get(kind, 0)
    _units[kind] = n + 1
    return Span(name, None, (kind, n), False, False, False)


def count(names: tuple, values: torch.Tensor) -> None:
    """While on, add ``values`` ([len(names)]) into the counters ``names``,
    where the tensor lies: on a device, one add queued with no host sync
    (the first call copies, so that ``values`` may be a graph's output)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return
    acc = _counts.get(names)
    if acc is None:
        _counts[names] = values.detach().clone()
    else:
        acc.add_(values)


def record() -> Dict:
    """The record: ``spans``, oldest first, each a dict of ``name``,
    ``start_ns``, ``end_ns``, ``id``, ``parent`` (the id of the span open
    round it, or None), ``unit``, ``attr`` and, for a span with device
    events, ``device_ms``; ``counters`` by name; ``dropped``, the spans
    that fell off the cap. Device events and device counters are read
    here, after waiting for them: read the record after the device work
    it covers, not on a hot path."""
    spans = []
    for name, start, end, sid, parent, unit, attr, events in list(_spans):
        s = {"name": name, "start_ns": start, "end_ns": end, "id": sid,
             "parent": parent, "unit": unit, "attr": attr}
        if events is not None:
            events[1].synchronize()
            s["device_ms"] = events[0].elapsed_time(events[1])
        spans.append(s)
    counters = {}
    for names, acc in _counts.items():
        for name, v in zip(names, acc.tolist()):
            counters[name] = counters.get(name, 0) + v
    return {"spans": spans, "counters": counters, "dropped": _dropped}
