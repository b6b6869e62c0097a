"""What the generators share: the program's config from a configuration file,
the measured window, the traced window, and the comparisons."""
from __future__ import annotations

import gc
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..reference.stage2 import AttrDict
from ..trace import events, load_json, reduce


class WindowClosed(Exception):
    """Raised from inside the program's loop to end it once the window has
    closed."""


def program_config(cfg: Dict) -> AttrDict:
    """The sections of a configuration file the program reads."""
    keys = ("data", "train_config", "model_and_render", "pcd_train_config",
            "pcd_model_and_render")
    return AttrDict.of({k: cfg[k] for k in keys})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Window:
    """The measured window over units (steps or frames) counted by
    ``tick``: it opens after ``warmup`` units (set-up ends there) and
    closes at the first unit after ``seconds``, or, when traced, after
    ``trace_units`` units under ``torch.profiler``. Both ends wait for the
    device."""

    def __init__(self, ctx, warmup: int, trace_units: int):
        self.ctx = ctx
        self.warmup = warmup
        self.trace_units = trace_units
        self.count = 0
        self.t_open = self.t_close = None
        self.setup_s = None
        self.prof = None

    @property
    def units(self) -> int:
        return self.count - self.warmup

    def tick(self) -> None:
        """After a unit's work was queued."""
        self.count += 1
        if self.count == self.warmup:
            sync(self.ctx.device)
            self.t_open = time.perf_counter()
            self.setup_s = self.t_open - self.ctx.t0
            if self.ctx.trace:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
                self.t_open = time.perf_counter()
            return
        if self.count < self.warmup:
            return
        if self.ctx.trace:
            done = self.units >= self.trace_units
        else:
            done = time.perf_counter() - self.t_open >= self.ctx.seconds
        if done:
            sync(self.ctx.device)
            self.t_close = time.perf_counter()
            if self.prof is not None:
                self.prof.stop()
            raise WindowClosed

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def reading(self) -> Dict:
        dev, host = events(self.prof)
        return reduce(dev, host, self.seconds, self.units)


def free_device() -> int:
    """The peak device memory of the run so far, then the caches freed."""
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else 0)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return peak


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap of norms: | |prog| - |ref| | over the larger of
    |ref| and the median leaf's |ref| (some leaves are all but zero)."""
    names = keep if keep is not None else list(ref)

    def norm(t):
        return 0.0 if t is None else float(torch.linalg.vector_norm(
            t.double()))

    rn = {n: norm(ref[n]) for n in names}
    med = statistics.median(rn.values()) if rn else 0.0
    worst = 0.0
    for n in names:
        den = max(rn[n], med)
        if den > 0:
            worst = max(worst, abs(norm(prog.get(n)) - rn[n]) / den)
    return worst


def moving_leaves(grads: Dict[str, Optional[torch.Tensor]],
                  rel: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: norm
    at least ``rel`` of the median leaf's."""
    norms = {n: (0.0 if g is None else float(torch.linalg.vector_norm(
        g.double()))) for n, g in grads.items()}
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= rel * med and v > 0]


def peaks() -> Dict:
    return load_json("peaks.json")


def keep(kept: List, i: int, n_keep: int, pick: np.random.Generator,
         item: Callable[[], Any]) -> None:
    """Reservoir sampling: the window's unit ``i`` (from 0) joins ``kept``,
    a uniform sample of ``n_keep`` of the units drawn with ``pick``, as it
    comes, so that the host holds no more than the sample; ``item()``
    makes what is kept, only when it is."""
    j = i if i < n_keep else int(pick.integers(0, i + 1))
    if j < n_keep:
        if j == len(kept):
            kept.append(None)
        kept[j] = item()


def percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))
