"""K2 (``knn_count``) and K3 (``knn_radius``) over Morton-sorted point
tiles (``csrc/knn_cells.cu``).

Port of ``apnerf/kernels/knn_cells_pallas.py``: ``build_point_tables``
sorts and tiles the warped cloud once per frame, with each tile's bounding
box. A kernel's block takes consecutive (Morton-ordered) queries, ``QB``
of them in K3 and ``count_block(M)`` in K2, and walks only the tiles whose
box lies within the radius of its queries' box, in ascending tile order. The
kernels list those tiles themselves (``csrc/knn_tiles.cuh``), so a call on
a CUDA tensor is a check, an allocation and one launch;
``candidate_tiles`` is the plain version of that listing, for the CPU
tests and for counting the pairs a kernel must look at. The TPU kernel's
[NG, 4, 8, 128] metadata packing and its tile-count limit are not ported.

K3's contract differs from the TPU kernel's on purpose: d2 are exact fp32
(not 11-bit packed keys) and only points with d2 <= radius2 are returned,
ties to the lower sorted index, empty slots (+inf, 0). Every consumer
thresholds or recomputes d2, so the render is unaffected beyond the TPU
kernel's own key quantisation.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import LAUNCHES, check, on_cpu, query_chunks, raise_on_error, \
    sq_dist, stream_handle

QB = 256             # K3: queries per block (csrc/knn_cells.cu kQB)
QB_COUNT = 64        # K2: queries per block, four lanes a query (kLanesMany),
QB_COUNT_FEW = 16    # and with sixteen lanes a query (kLanesFew) in a call
FEW_QUERIES = 32768  # of fewer than this many queries (kFewQueries)
PTS = 128            # points per tile
MAX_PTS = 512


def build_point_tables(points: torch.Tensor,
                       pts_per_tile: int = PTS) -> Dict[str, torch.Tensor]:
    """Morton-sort and tile the point cloud; pad rows sit at 1e9.

    Returns ``pts_t`` [T, 3, pts], ``pts_sorted`` [T * pts, 3], ``t_lo`` /
    ``t_hi`` [T, 3] tile bboxes, ``perm`` (sorted row -> original row),
    ``p_lo`` / ``p_hi``."""
    from ..ops.knn import morton_codes
    if not (0 < pts_per_tile <= MAX_PTS
            and pts_per_tile & (pts_per_tile - 1) == 0):
        raise ValueError(f"pts_per_tile must be a power of two <= {MAX_PTS},"
                         f" got {pts_per_tile}")
    pf = points.float()
    P = pf.shape[0]
    p_lo = pf.amin(0)
    p_hi = pf.amax(0)
    perm = torch.argsort(morton_codes(pf, p_lo, p_hi), stable=True)
    pts = pf[perm]
    ppad = (-P) % pts_per_tile
    if ppad:
        pts = torch.cat([pts, torch.full((ppad, 3), 1e9, dtype=torch.float32,
                                         device=pf.device)])
    T = (P + ppad) // pts_per_tile
    tiles = pts.reshape(T, pts_per_tile, 3)
    return {
        "pts_t": tiles.transpose(1, 2).contiguous(),
        "pts_sorted": pts,
        "t_lo": tiles.amin(1),
        "t_hi": tiles.amax(1),
        "perm": perm,
        "p_lo": p_lo,
        "p_hi": p_hi,
    }


def count_block(M: int) -> int:
    """K2's queries per block in a call of M queries."""
    return QB_COUNT_FEW if M < FEW_QUERIES else QB_COUNT


def candidate_tiles(queries: torch.Tensor, tables: Dict[str, torch.Tensor],
                    radius2: float, qb: int = QB):
    """Per block of ``qb`` queries: tiles whose bbox gap^2 to the block
    bbox is <= radius2, listed first and ascending -> (list [NB, T], count
    [NB]). The plain version of the kernels' own listing; a ragged last
    block's box is that of the queries it has.

    The compare is ``<=`` (the TPU code has ``<``): a point at exactly
    d2 == radius2 counts, and gap^2 <= d2 holds in fp32, so no tile holding
    an in-radius point is dropped."""
    M = queries.shape[0]
    NB = -(-M // qb)
    pad = NB * qb - M
    q = queries
    if pad:
        q = torch.cat([q, q[-1:].expand(pad, 3)])   # no bbox growth
    blk = q.reshape(NB, qb, 3)
    q_lo, q_hi = blk.amin(1), blk.amax(1)
    t_lo, t_hi = tables["t_lo"], tables["t_hi"]
    gap = torch.clamp(torch.maximum(q_lo[:, None] - t_hi[None],
                                    t_lo[None] - q_hi[:, None]), min=0.0)
    g2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) \
        + gap[..., 2] * gap[..., 2]
    cand = g2 <= radius2
    order = torch.argsort((~cand).to(torch.int8), dim=1, stable=True)
    return order.to(torch.int32).contiguous(), \
        cand.sum(1).to(torch.int32).contiguous()


def knn_count_plain(queries: torch.Tensor, pts_sorted: torch.Tensor,
                    radius2: float) -> torch.Tensor:
    """Plain PyTorch K2: brute-force count over all (padded) points."""
    q = queries.float()
    out = [(sq_dist(q[s:e], pts_sorted) <= radius2).sum(1).to(torch.int32)
           for s, e in query_chunks(q.shape[0], pts_sorted.shape[0])]
    return torch.cat(out)


def knn_radius_plain(queries: torch.Tensor, pts_sorted: torch.Tensor, k: int,
                     radius2: float):
    """Plain PyTorch K3: d2 beyond radius2 -> +inf, stable sort over the
    index-ordered points, first k; empty slots (+inf, 0)."""
    q = queries.float()
    d_out, i_out = [], []
    for s, e in query_chunks(q.shape[0], pts_sorted.shape[0]):
        d2 = sq_dist(q[s:e], pts_sorted)
        d2 = torch.where(d2 <= radius2, d2, torch.full_like(d2, float("inf")))
        d, i = torch.sort(d2, dim=1, stable=True)
        d, i = d[:, :k], i[:, :k]
        d_out.append(d)
        i_out.append(torch.where(torch.isinf(d), torch.zeros_like(i),
                                 i).to(torch.int32))
    return torch.cat(d_out), torch.cat(i_out)


def _check_tables(queries, tables):
    pts_t = tables["pts_t"]
    T, _, pts = pts_t.shape
    check(queries, "queries", torch.float32, (queries.shape[0], 3))
    check(pts_t, "pts_t", torch.float32, (T, 3, pts))
    check(tables["t_lo"], "t_lo", torch.float32, (T, 3))
    check(tables["t_hi"], "t_hi", torch.float32, (T, 3))
    if pts > MAX_PTS:
        raise ValueError(f"pts_per_tile {pts} > {MAX_PTS}")
    return pts_t, T, pts


def knn_count_cuda(queries: torch.Tensor, tables: Dict[str, torch.Tensor],
                   radius2: float, lanes: int = 0) -> torch.Tensor:
    """Launch K2 on the queries' CUDA device. ``lanes``: 0, or the lanes a
    query (4 or 16) to take whatever ``count_block`` says (for timing one
    against the other)."""
    pts_t, T, pts = _check_tables(queries, tables)
    from .build import load_library
    lib = load_library()
    M = queries.shape[0]
    out = torch.empty(M, dtype=torch.int32, device=queries.device)
    LAUNCHES["knn_count"] += 1
    raise_on_error(lib.knn_count_launch(
        queries.data_ptr(), M, pts_t.data_ptr(), tables["t_lo"].data_ptr(),
        tables["t_hi"].data_ptr(), T, pts, float(radius2), lanes,
        out.data_ptr(), stream_handle(queries)), "knn_count")
    return out


def knn_radius_cuda(queries: torch.Tensor, tables: Dict[str, torch.Tensor],
                    k: int, radius2: float):
    """Launch K3 on the queries' CUDA device."""
    if not 1 <= k <= 16:
        raise ValueError(f"knn_radius: need 1 <= k <= 16, got {k}")
    pts_t, T, pts = _check_tables(queries, tables)
    from .build import load_library
    lib = load_library()
    M = queries.shape[0]
    d2 = torch.empty((M, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((M, k), dtype=torch.int32, device=queries.device)
    LAUNCHES["knn_radius"] += 1
    raise_on_error(lib.knn_radius_launch(
        queries.data_ptr(), M, pts_t.data_ptr(), tables["t_lo"].data_ptr(),
        tables["t_hi"].data_ptr(), T, pts, float(radius2), k,
        d2.data_ptr(), idx.data_ptr(), stream_handle(queries)),
        "knn_radius")
    return d2, idx


def knn_count(queries: torch.Tensor, tables: Dict[str, torch.Tensor],
              radius2: float) -> torch.Tensor:
    """Count of points with d2 <= radius2 per query -> int32 [M]."""
    if on_cpu(queries, tables["pts_t"]):
        return knn_count_plain(queries, tables["pts_sorted"], radius2)
    return knn_count_cuda(queries.float().contiguous(), tables, radius2)


def knn_radius(queries: torch.Tensor, tables: Dict[str, torch.Tensor],
               k: int, radius2: float):
    """Radius-bounded k-NN in the Morton-sorted point space ->
    (d2 [M, k] ascending, idx [M, k] int32)."""
    if on_cpu(queries, tables["pts_t"]):
        return knn_radius_plain(queries, tables["pts_sorted"], k, radius2)
    return knn_radius_cuda(queries.float().contiguous(), tables, k, radius2)
