"""Python wrappers of the hand-written Hopper kernels in ``../csrc``.

Every wrapper picks by the device of the tensors it is given: a CPU tensor
takes the kernel's plain PyTorch version (same module), a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches per
kernel, so a run can show that its main path went through the kernels.
The wrappers count in Python, so a CUDA graph counts through
``counted_capture`` and ``GraphReplay``: what a capture counted is taken
back (nothing ran) and added at every replay.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"knn_brute": 0, "knn_count": 0, "knn_radius": 0,
                            "featmlp": 0, "featmlp_gather": 0,
                            "scatter": 0, "agg": 0,
                            "procrustes": 0, "procrustes_grad": 0,
                            "trilerp": 0, "trilerp_grad": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextmanager
def counted_capture():
    """Around a graph capture: yields a dict that receives, per kernel, the
    launches the wrappers counted inside, and takes them back out of
    ``LAUNCHES``, since a capture launches nothing."""
    before = dict(LAUNCHES)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        for name in LAUNCHES:
            delta[name] = LAUNCHES[name] - before[name]
            LAUNCHES[name] = before[name]


class GraphReplay:
    """A captured graph (``torch.cuda.CUDAGraph`` or anything with
    ``replay()``) with the launches its capture counted: every ``replay``
    adds them to ``LAUNCHES``, once per kernel launch in the graph."""

    def __init__(self, graph, launches: Dict[str, int]):
        self.graph = graph
        self.launches = {k: n for k, n in launches.items() if n}

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCHES[name] += n


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version), False when
    every tensor lies on one CUDA device (kernel); anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {dev}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of dtype and shape
    (``None`` in ``shape`` matches any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def sq_dist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[M, 3] x [P, 3] -> [M, P] squared distances as the kernels form
    them: ``(dx*dx + dy*dy) + dz*dz``, each op rounded (no FMA)."""
    dx = q[:, None, 0] - p[None, :, 0]
    dy = q[:, None, 1] - p[None, :, 1]
    dz = q[:, None, 2] - p[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def query_chunks(M: int, P: int, budget: int = 1 << 24):
    """Query ranges whose [rows, P] distance block stays under ``budget``
    elements (bounds the plain versions' memory)."""
    step = max(1, budget // max(P, 1))
    return [(s, min(M, s + step)) for s in range(0, M, step)]
