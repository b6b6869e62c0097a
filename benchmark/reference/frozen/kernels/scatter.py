"""K5: sorted window accumulation (``csrc/scatter.cu``).

Port of ``apnerf/kernels/scatter_pallas.py``: ``out[v] = sum of upd[r]``
over the rows with ``idx[r] == v``, ``idx`` sorted ascending, exact fp32,
in a sum order that the data alone fixes. The stage-1 grid gradient
(``ops/grid.py``) calls it three times a training step.

The order: a cell's rows are added one by one in row order,
``((0 + u_1) + u_2) + ...``, as a sequential ``index_add_`` adds them.
Only a cell with more than ``HOT_ROWS`` rows is summed otherwise: in chunks
of ``HOT_ROWS`` rows counted from the cell's first row, each chunk in row
order from zero, the chunks' sums then added in ascending chunk order. The
kernel and the plain version both take that order, so the kernel is
bit-equal to the plain version on a CPU copy of its inputs.

The kernel balances its blocks by rows: a window of ``WIN`` cells with more
than ``ITEM_ROWS`` rows is cut at cell boundaries into work items of about
``ITEM_ROWS`` rows, and a hot cell into its chunks. ``item_plan`` is that
cut as a pure function, the model of the kernel's plan pass.
"""
from __future__ import annotations

from itertools import accumulate

import numpy as np
import torch

from . import LAUNCHES, check, on_cpu, raise_on_error, stream_handle

WIN = 64           # output cells per window (csrc/scatter.cu kWin)
ITEM_ROWS = 1024   # rows a work item holds, about (kItemRows)
HOT_ROWS = 4096    # a cell with more rows is summed in chunks (kHotRows)
PLAN_WARPS = 8     # candidates per block of the plan pass (kPlanWarps)
MAX_C = 512        # channels: one thread each


def item_plan(idx_sorted, n_rows: int):
    """The work items K5 cuts the windows over ``ITEM_ROWS`` rows into, as
    its plan pass writes them -> (items int32 [n, 4], pinfo int32 [p, 2]).

    Windows in ascending order, a window's items in ascending cell order.
    A run of whole cells is ``(first cell, cells, first row, end row)``; a
    new run starts at the window's first cell, after a hot cell, and where a
    cell's first row, counted from the window's first row, enters another
    multiple of ``ITEM_ROWS``. Chunk ``c`` of a hot cell (more than
    ``HOT_ROWS`` rows) is ``(cell, -1 - p, first row, end row)`` with ``p``
    its partial row; ``pinfo[p]`` is ``(cell, chunks of the cell)`` at a
    cell's first chunk and ``(cell, 0)`` at the others. Windows with at
    most ``ITEM_ROWS`` rows are one block's work and have no item."""
    idx = np.asarray(torch.as_tensor(idx_sorted).cpu()).astype(np.int64)
    n_win = -(-n_rows // WIN)
    offs = np.searchsorted(idx, np.minimum(np.arange(n_win + 1) * WIN,
                                           n_rows), side="left")
    items, pinfo = [], []
    cells = np.arange(WIN)
    for w in np.nonzero(np.diff(offs) > ITEM_ROWS)[0]:
        base, lo, hi = int(w) * WIN, int(offs[w]), int(offs[w + 1])
        nc = min(WIN, n_rows - base)
        start = np.full(WIN + 1, hi, np.int64)
        start[:nc] = lo + np.searchsorted(idx[lo:hi], base + cells[:nc],
                                          side="left")
        n = np.diff(start)
        hot = n > HOT_ROWS
        bucket = (start[:WIN] - lo) // ITEM_ROWS
        begins = ~hot & (cells < nc)
        begins[1:] &= hot[:-1] | (bucket[1:] != bucket[:-1])
        bounds = np.nonzero(hot | begins)[0].tolist() + [WIN]
        for j, j_end in zip(bounds[:-1], bounds[1:]):
            if hot[j]:
                chunks = -(-int(n[j]) // HOT_ROWS)
                for c in range(chunks):
                    s = int(start[j]) + c * HOT_ROWS
                    items.append((base + j, -1 - len(pinfo), s,
                                  min(s + HOT_ROWS, int(start[j + 1]))))
                    pinfo.append((base + j, chunks if c == 0 else 0))
            else:
                items.append((base + j, min(j_end, nc) - j, int(start[j]),
                              int(start[j_end])))
    return (np.asarray(items, np.int32).reshape(-1, 4),
            np.asarray(pinfo, np.int32).reshape(-1, 2))


def scratch_sizes(M: int, n_rows: int):
    """Elements of K5's scratch for M rows (the bounds are derived at
    ``scatter_launch`` in csrc/scatter.cu) -> (window offsets; counts: the
    candidates, the plan's blocks and the totals; items; partial rows)."""
    n_cand = -(-M // ITEM_ROWS)
    return (-(-n_rows // WIN) + 1, n_cand + -(-n_cand // PLAN_WARPS) + 1,
            3 * n_cand + 1, 2 * -(-M // HOT_ROWS) + 1)


def sorted_window_accumulate_plain(idx_sorted: torch.Tensor,
                                   upd_sorted: torch.Tensor, n_rows: int,
                                   transposed: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into zeros (sequential in row
    order on the CPU; atomics in no fixed order on a CUDA tensor), with
    out-of-range rows sent to a discarded extra row. The rows of a cell
    beyond its first ``HOT_ROWS`` go through a second ``index_add_``: into
    one partial row per chunk, the partial rows then into the cells in
    ascending chunk order."""
    M, C = upd_sorted.shape
    dev = upd_sorted.device
    idx = idx_sorted.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < n_rows), idx,
                      torch.full_like(idx, n_rows))
    upd = upd_sorted.float()
    out = torch.zeros((n_rows + 1, C), dtype=torch.float32, device=dev)
    if M <= HOT_ROWS:                       # no cell can be hot
        out.index_add_(0, idx, upd)
    else:
        rows = torch.arange(M, device=dev)
        first = torch.ones(M, dtype=torch.bool, device=dev)
        first[1:] = idx[1:] != idx[:-1]
        pos = rows - torch.cummax(torch.where(first, rows, 0), 0).values
        later = (pos >= HOT_ROWS) & (idx < n_rows)    # chunks 1, 2, ...
        out.index_add_(0, torch.where(later, n_rows, idx), upd)
        # a chunk beyond a cell's first follows HOT_ROWS rows of its cell
        n_seg = M // HOT_ROWS
        opens = later & (pos % HOT_ROWS == 0)
        seg = torch.where(later, torch.cumsum(opens, 0) - 1, n_seg)
        partial = torch.zeros((n_seg + 1, C), dtype=torch.float32,
                              device=dev)
        partial.index_add_(0, seg, upd)
        seg_cell = torch.full((n_seg + 1,), n_rows, dtype=torch.int64,
                              device=dev)
        seg_cell.scatter_(0, torch.where(opens, seg, n_seg),
                          torch.where(opens, idx, n_rows))
        out.index_add_(0, seg_cell, partial)
    out = out[:n_rows]
    return out.t().contiguous() if transposed else out


def sorted_window_accumulate_cuda(idx_sorted: torch.Tensor,
                                  upd_sorted: torch.Tensor, n_rows: int,
                                  transposed: bool = False,
                                  plan_out=None) -> torch.Tensor:
    """Launch K5 on the tensors' CUDA device. ``idx_sorted`` must be
    ascending (not checked: that would synchronise). ``plan_out``, a dict,
    receives the scratch tensors the plan pass wrote (``cnt`` int32
    [candidates + 1, 2] with the totals last, ``items`` int32 [., 4],
    ``pinfo`` int32 [., 2]) for a check against ``item_plan``."""
    M, C = upd_sorted.shape
    if not 1 <= C <= MAX_C:
        raise ValueError(f"sorted_window_accumulate: need 1 <= C <= {MAX_C}, "
                         f"got C={C}")
    if n_rows >= 2 ** 31 - WIN or M >= 2 ** 31 - HOT_ROWS:
        raise ValueError("sorted_window_accumulate: sizes exceed int32")
    check(idx_sorted, "idx_sorted", torch.int32, (M,))
    check(upd_sorted, "upd_sorted", torch.float32, (M, C))
    from .build import load_library
    lib = load_library()
    dev = upd_sorted.device
    shape = (C, n_rows) if transposed else (n_rows, C)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    n_offs, n_cnt, n_items, n_part = scratch_sizes(M, n_rows)
    # one allocation of 4-byte words: items (int4) | cnt (int2) | pinfo
    # (int2) | offs | partial (fp32)
    at = list(accumulate([0, 4 * n_items, 2 * n_cnt, 2 * n_part, n_offs,
                          n_part * C]))
    scratch = torch.empty(at[-1], dtype=torch.int32, device=dev)
    items, cnt, pinfo, offs, partial = (scratch.data_ptr() + 4 * a
                                        for a in at[:-1])
    LAUNCHES["scatter"] += 1
    raise_on_error(lib.scatter_launch(
        idx_sorted.data_ptr(), upd_sorted.data_ptr(), M, C, n_rows,
        int(transposed), offs, cnt, items, pinfo, partial, out.data_ptr(),
        stream_handle(upd_sorted)), "scatter")
    if plan_out is not None:
        plan_out.update(items=scratch[at[0]:at[1]].view(-1, 4),
                        cnt=scratch[at[1]:at[2]].view(-1, 2),
                        pinfo=scratch[at[2]:at[3]].view(-1, 2))
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
