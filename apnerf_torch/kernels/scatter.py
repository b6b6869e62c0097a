"""K5: sorted window accumulation (``csrc/scatter.cu``).

Port of ``apnerf/kernels/scatter_pallas.py``: ``out[v] = sum of upd[r]``
over the rows with ``idx[r] == v``, ``idx`` sorted ascending, exact fp32,
each cell's sum taken in row order. The stage-1 grid gradient
(``ops/grid.py``) calls it three times a training step.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, check, on_cpu, raise_on_error, stream_handle

WIN = 64       # output cells per block (csrc/scatter.cu kWin)
MAX_C = 512    # channels: one thread each


def sorted_window_accumulate_plain(idx_sorted: torch.Tensor,
                                   upd_sorted: torch.Tensor, n_rows: int,
                                   transposed: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into zeros (sequential in row
    order on the CPU; atomics in no fixed order on a CUDA tensor), with
    out-of-range rows sent to a discarded extra row."""
    idx = idx_sorted.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < n_rows), idx,
                      torch.full_like(idx, n_rows))
    out = torch.zeros((n_rows + 1, upd_sorted.shape[1]), dtype=torch.float32,
                      device=upd_sorted.device)
    out.index_add_(0, idx, upd_sorted.float())
    out = out[:n_rows]
    return out.t().contiguous() if transposed else out


def sorted_window_accumulate_cuda(idx_sorted: torch.Tensor,
                                  upd_sorted: torch.Tensor, n_rows: int,
                                  transposed: bool = False) -> torch.Tensor:
    """Launch K5 on the tensors' CUDA device. ``idx_sorted`` must be
    ascending (not checked: that would synchronise)."""
    M, C = upd_sorted.shape
    if not 1 <= C <= MAX_C:
        raise ValueError(f"sorted_window_accumulate: need 1 <= C <= {MAX_C}, "
                         f"got C={C}")
    if n_rows >= 2 ** 31 - WIN or M >= 2 ** 31:
        raise ValueError("sorted_window_accumulate: sizes exceed int32")
    check(idx_sorted, "idx_sorted", torch.int32, (M,))
    check(upd_sorted, "upd_sorted", torch.float32, (M, C))
    from .build import load_library
    lib = load_library()
    dev = upd_sorted.device
    shape = (C, n_rows) if transposed else (n_rows, C)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    offs = torch.empty((n_rows + WIN - 1) // WIN + 1, dtype=torch.int32,
                       device=dev)
    LAUNCHES["scatter"] += 1
    raise_on_error(lib.scatter_launch(
        idx_sorted.data_ptr(), upd_sorted.data_ptr(), M, C, n_rows,
        int(transposed), offs.data_ptr(), out.data_ptr(),
        stream_handle(upd_sorted)), "scatter")
    return out


def sorted_window_accumulate(idx_sorted: torch.Tensor,
                             upd_sorted: torch.Tensor, n_rows: int,
                             transposed: bool = False) -> torch.Tensor:
    """Accumulate ``upd_sorted [M, C]`` into ``out [n_rows, C]`` (``[C,
    n_rows]`` when ``transposed``) at the ascending row indices
    ``idx_sorted [M]``; rows whose index lies outside [0, n_rows) are
    dropped (the JAX kernel requires every index in range). The kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if on_cpu(idx_sorted, upd_sorted):
        return sorted_window_accumulate_plain(idx_sorted, upd_sorted, n_rows,
                                              transposed)
    return sorted_window_accumulate_cuda(
        idx_sorted.to(torch.int32).contiguous(),
        upd_sorted.float().contiguous(), n_rows, transposed)


def scatter_add_rows(idx: torch.Tensor, upd: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """Unsorted scatter-add of rows, ``zeros[n_rows, C].index_add_(0, idx,
    upd)``: a stable argsort, then the sorted window accumulation."""
    order = torch.argsort(idx, stable=True)
    return sorted_window_accumulate(idx[order], upd[order], n_rows)
