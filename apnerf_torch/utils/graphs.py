"""CUDA graphs of the port's hot bodies: the render's frame and chunk loop
(``render/renderers.py``) and the training steps (``train/stage1.py``,
``train/stage2.py``), the counterparts of the JAX package's jitted
programs.

A body reads every value that changes from call to call from *static
inputs*, tensors that the caller refills in stream order before each call
(``load_static``); on a CUDA device its first call runs it eagerly on a
side stream (the build at first use, the caches that fill then), captures
it as one graph into a memory pool, and later calls replay the graph. On
the CPU every call runs the body. A capture that fails raises: there is no
eager fallback on the card. Code on a body's path may make no host tensor
and read nothing back (``torch.tensor``, ``.item()``, ``.cpu()``, a
Python number stored into a CUDA tensor): a capture refuses both.

Under a mesh (``parallel.mesh``) a body holds its collectives, which the
graph captures on the capture stream; the eager first call forms NCCL's
communicator before the capture, which would refuse that. Such a body is
captured with ``thread_local`` set: a capture then refuses only this
thread's unsafe calls, not those of the process group's watchdog thread.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import kernels
from . import profiling

_NUMPY = {torch.float32: np.float32, torch.int64: np.int64,
          torch.int32: np.int32, torch.bool: np.bool_}


def load_static(buf: torch.Tensor, value) -> None:
    """Copy ``value`` (an array, a number, a tensor) into the static input
    ``buf`` in stream order: from the host through pinned memory, so that
    the copy waits neither for the device nor on it (PyTorch's
    pinned-memory cache keeps the block until the copy has run). A host
    value is converted to ``buf``'s type by numpy."""
    src = value if torch.is_tensor(value) else torch.from_numpy(
        np.ascontiguousarray(value, _NUMPY[buf.dtype]))
    src = src.reshape(buf.shape).to(buf.dtype)
    if buf.is_cuda and not src.is_cuda:
        src = src.pin_memory()
    buf.copy_(src, non_blocking=True)


class GraphedCall:
    """``body(*args)`` over ``inputs``, static tensors that the caller
    refills before each call. On a CUDA device the first call runs ``body``
    once eagerly on a side stream, then captures it as one CUDA graph in
    ``pool``; later calls replay the graph and return the graph's outputs,
    which the next replay overwrites (``args`` must then be what they were
    at the capture). Without ``step`` the first call replays too and
    returns the graph's outputs (a render: the eager run only warms up).
    With ``step`` the body changes state that it reads (a training step's
    optimizer update): the eager run is the first call's step and its
    outputs are returned; the replays start at the next call. On the CPU
    (``pool`` None) every call runs ``body``. ``capture_ms`` is the
    capture's host time. ``thread_local``: the capture's error mode is
    ``"thread_local"`` (a body with collectives), else the default.
    ``key``: the call's key in its ``Graphs``, the attribute of its spans
    (``graph.capture``; ``graph.replay``, the call of the graph, or of the
    body on the CPU, with the replay's device time on a CUDA device)."""

    def __init__(self, body: Callable, inputs: tuple, pool=None,
                 step: bool = False, thread_local: bool = False, key=None):
        self.body = body
        self.key = key
        self.inputs = inputs
        self.pool = pool
        self.step = step
        self.thread_local = thread_local
        self.replay: Optional[kernels.GraphReplay] = None
        self.out = None
        self.capture_ms: Optional[float] = None

    def __call__(self, *args):
        if self.pool is None:
            with profiling.scope("graph.replay", self.key):
                return self.body(*args)
        if self.replay is None:
            with profiling.scope("graph.capture", self.key):
                first = self._capture(args)
            if self.step:
                return first
        with profiling.scope("graph.replay", self.key, device=True):
            self.replay.replay()
        return self.out

    def _capture(self, args):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            first = self.body(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no garbage collection while capturing: it may free a dead graph
        # (a renderer is a reference cycle), and destroying a graph during
        # a capture invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        mode = ({"capture_error_mode": "thread_local"} if self.thread_local
                else {})
        try:
            with kernels.counted_capture() as launches, \
                    torch.cuda.graph(graph, pool=self.pool, **mode):
                self.out = self.body(*args)
        finally:
            if collecting:
                gc.enable()
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.replay = kernels.GraphReplay(graph, launches)
        return first


class Graphs:
    """Graphed calls by key and their memory pool on a CUDA device (freed
    with the owner, as the JAX jit cache is); no pool on the CPU. The
    calls share the pool, which is sound while they run one at a time on
    one stream and each call's outputs are read before the next call
    (a frame graph feeds the chunk graph replayed right after it; a
    training step's metrics are read before the next step). ``step``: the
    calls are training steps; ``thread_local``: their bodies hold
    collectives (``GraphedCall``)."""

    def __init__(self, device: torch.device, step: bool = False,
                 thread_local: bool = False):
        self.device = torch.device(device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.step = step
        self.thread_local = thread_local
        self.calls: Dict[tuple, GraphedCall] = {}

    def call(self, key: tuple, make: Callable) -> GraphedCall:
        """The call of ``key``; ``make() -> (body, inputs)`` the first
        time."""
        if key not in self.calls:
            self.calls[key] = GraphedCall(*make(), pool=self.pool,
                                          step=self.step,
                                          thread_local=self.thread_local,
                                          key=key)
        return self.calls[key]


class GraphedStep:
    """A training step as a graph replay: ``body(*key)() -> out`` reads the
    static tensors ``inputs`` (a dict); a call ``step(batch, key)`` loads
    ``batch`` (host arrays or numbers by input name) into them, runs
    ``prepare()`` on the host (the optimizer's count and step sizes, which
    it loads into static inputs of its own), then runs the graph of ``key``
    (one a setting of the host flags that pick a branch of the body). The
    first call of a key is that step run eagerly, captured after. One
    ``GraphedStep`` is a segment: what changes the step's shapes, its
    parameters' storage or its optimizer starts a new one.
    ``thread_local``: the body holds collectives (``GraphedCall``). Spans:
    ``step.load`` (the batch into the static inputs), ``step.prepare``."""

    def __init__(self, body: Callable, inputs: Dict[str, torch.Tensor],
                 device, prepare: Optional[Callable] = None,
                 thread_local: bool = False):
        self.graphs = Graphs(device, step=True, thread_local=thread_local)
        self.inputs = inputs
        self.body = body
        self.prepare = prepare

    def __call__(self, batch: Dict, key: tuple = ()):
        with profiling.scope("step.load"):
            for name, value in batch.items():
                load_static(self.inputs[name], value)
        if self.prepare is not None:
            with profiling.scope("step.prepare"):
                self.prepare()
        return self.graphs.call(key, lambda: (self.body(*key), ()))()

    @property
    def capture_ms(self) -> Dict[tuple, float]:
        """The capture's host ms of each key's graph (none on the CPU)."""
        return {k: c.capture_ms for k, c in self.graphs.calls.items()
                if c.capture_ms is not None}
