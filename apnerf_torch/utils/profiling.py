"""Trace annotations and timing (port of ``apnerf/utils/profiling.py``).

``scope(name)`` marks a region in a ``torch.profiler`` trace (a
``record_function`` range) and, on a CUDA build, in an NVTX-reading
profiler; it costs little when no profiler runs. ``trace(logdir)``
records a ``torch.profiler`` trace of a block into ``logdir``.
``StepTimer`` times intervals on the host clock, each ending in a
device synchronize when it times CUDA work.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def scope(name: str):
    """A named range in profiler traces (``record_function`` and NVTX)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: str = "./logs/trace"):
    """Record a ``torch.profiler`` trace (CPU, and CUDA where there is a
    device) of a block; the Chrome trace is written to ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


class StepTimer:
    """Wall-clock per-interval timing (reference run.py:725-728 style).
    With a CUDA ``device`` every reading first waits for the device's
    queued work (``torch.cuda.synchronize``)."""

    def __init__(self, device=None):
        self.cuda = torch.device(device or "cpu").type == "cuda"
        self.t0 = time.time()
        self.marks = {}

    def _now(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return time.time()

    def elapsed(self) -> float:
        return self._now() - self.t0

    def elapsed_str(self) -> str:
        t = self.elapsed()
        return f"{t // 3600:02.0f}:{t // 60 % 60:02.0f}:{t % 60:02.0f}"

    def lap(self, key: str) -> float:
        now = self._now()
        prev = self.marks.get(key, self.t0)
        self.marks[key] = now
        return now - prev
