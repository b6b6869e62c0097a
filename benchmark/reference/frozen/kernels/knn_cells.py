"""K2 (``knn_count``) and K3 (``knn_radius``) over Morton-sorted point
tiles (``csrc/knn_cells.cu``, ``csrc/knn_scan.cuh``).

Port of ``apnerf/kernels/knn_cells_pallas.py``: ``build_point_tables``
sorts and tiles the warped cloud once per frame, with each tile's bounding
box. A kernel's block takes consecutive (Morton-ordered) queries,
``radius_block(M)`` of them in K3 and ``count_block(M)`` in K2, and walks
only the tiles whose box lies within the radius of its queries' box (K2 in
ascending tile order). The kernels list those tiles themselves
(``csrc/knn_tiles.cuh``), so a call on a CUDA tensor is a check, an
allocation and one launch; ``candidate_tiles`` is the plain version of that
listing, for the CPU tests and for counting the pairs a kernel must look
at. The TPU kernel's [NG, 4, 8, 128] metadata packing and its tile-count
limit are not ported.

K3 (and K1, ``kernels/knn_brute.py``) split a query's points over several
lanes, each keeping its own top-k, merge the lanes by (d2, index), and let
a warp skip a tile that lies beyond its queries' kth distances;
``topk_scan_model`` is that work split in PyTorch, the plain model the
kernels' results and scanned-tile counts are held against.

K3's contract differs from the TPU kernel's on purpose: d2 are exact fp32
(not 11-bit packed keys) and only points with d2 <= radius2 are returned,
ties to the lower sorted index, empty slots (+inf, 0). Every consumer
thresholds or recomputes d2, so the render is unaffected beyond the TPU
kernel's own key quantisation.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import LAUNCHES, check, on_cpu, query_chunks, raise_on_error, \
    sq_dist, stream_handle

QB = 64              # K1 / K3: queries per block, four lanes a query
QB_FEW = 32          # (csrc/knn_scan.cuh kTopLanesMany), and with eight
                     # lanes a query (kTopLanesFew) in a call of fewer than
                     # FEW_QUERIES queries
QB_COUNT = 64        # K2: queries per block, four lanes a query (kLanesMany),
QB_COUNT_FEW = 16    # and with sixteen lanes a query (kLanesFew) in a call
FEW_QUERIES = 32768  # of fewer than this many queries (kFewQueries)
PTS = 128            # points per tile
MAX_PTS = 512
THREADS = 256        # a block's threads, all three kernels
ROUND_PTS = 1024     # points staged a round (kRoundPts)
LIST_CAP = 1024      # tiles listed at a time (knn_tiles.cuh kListCap)


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


def topk_lanes(M: int) -> int:
    """K3's (and K1's) lanes a query in a call of M queries."""
    return THREADS // radius_block(M)


def radius_block(M: int) -> int:
    """K3's (and K1's) queries per block in a call of M queries."""
    return QB_FEW if M < FEW_QUERIES else QB


def _gap2(lo, hi, t_lo, t_hi):
    """Squared gap of boxes [..., 3] to the tiles' boxes [T, 3] ->
    [..., T], formed as the kernels form it (each op rounded, no FMA)."""
    gap = torch.clamp(torch.maximum(lo[..., None, :] - t_hi,
                                    t_lo - hi[..., None, :]), min=0.0)
    return (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) \
        + gap[..., 2] * gap[..., 2]


def candidate_tiles(queries: torch.Tensor, tables: Dict[str, torch.Tensor],
                    radius2, qb: int = QB):
    """Per block of ``qb`` queries: tiles whose bbox gap^2 to the block
    bbox is <= radius2 (a float, or a tensor [NB] of one radius a block),
    listed first and ascending -> (list [NB, T], count [NB]). The plain
    version of the kernels' own listing; a ragged last block's box is that
    of the queries it has.

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
    g2 = _gap2(blk.amin(1), blk.amax(1), tables["t_lo"], tables["t_hi"])
    if torch.is_tensor(radius2):
        radius2 = radius2[:, None]
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


def _lex_topk(d: torch.Tensor, i: torch.Tensor, k: int):
    """The k smallest (d, i) pairs along the last dim, by d, then by i."""
    o = torch.argsort(i, dim=-1, stable=True)
    d, i = d.gather(-1, o), i.gather(-1, o)
    o = torch.argsort(d, dim=-1, stable=True)[..., :k]
    return d.gather(-1, o), i.gather(-1, o)


def query_bound(rq: torch.Tensor, ld: torch.Tensor, c: int) -> torch.Tensor:
    """A query's bound on its kth distance from its lanes' lists ld [n,
    lanes, k]: the least of its radius rq [n], the smallest kth distance of
    its lanes and the largest c-th (lanes * c >= k points lie that near)."""
    return torch.minimum(torch.minimum(rq, ld[:, :, -1].amin(1)),
                         ld[:, :, c - 1].amax(1))


def topk_scan_model(queries: torch.Tensor, tables: Dict[str, torch.Tensor],
                    k: int, radius2: float = 0.0,
                    lanes: Optional[int] = None,
                    seed: Optional[torch.Tensor] = None,
                    perm: Optional[torch.Tensor] = None, P: int = 0):
    """The top-k scan of ``csrc/knn_scan.cuh`` in PyTorch, with its work
    split (``lanes``: the kernel's, ``topk_lanes(M)``, unless given):
    blocks of ``256 / lanes`` queries list the tiles within their
    radius (K3: ``radius2``; K1: the largest ``seed`` of the block),
    ``LIST_CAP`` at a time, start at the listed tile nearest the block's
    middle query (the first at the least gap^2; wrapping round) and take
    them in rounds of ``ROUND_PTS`` points; at the head of a round a warp
    (``32 / lanes`` queries) keeps the round's tiles with gap^2 to its box
    <= its bound, the largest of its queries' (``query_bound``), and walks
    them in list order; lane l of a query takes the groups of four points
    f with f % lanes == l (single points when the tile size is not a
    multiple of 4) and keeps the k smallest (d2, index) of those with d2 <=
    the query's bound as it stands before the tile (no farther point can be
    among the query's k); the lanes are merged by (d2, index).

    K3: indices are the sorted ones. K1 (``seed`` [M], ``perm`` [P], ``P``):
    a query's radius is its seed, indices are ``perm``'s, pad rows (sorted
    index >= P) never enter. ``queries`` [M, 3] in the kernel's order ->
    (d2 [M, k], idx [M, k] int32, the tiles each warp scanned [NB * 8]
    int32)."""
    q = queries.float()
    M = q.shape[0]
    lanes = lanes or topk_lanes(M)
    T, _, pts = tables["pts_t"].shape
    ps = tables["pts_sorted"]
    t_lo, t_hi = tables["t_lo"], tables["t_hi"]
    per_warp = 32 // lanes
    qb = THREADS // lanes
    n_warps = THREADS // 32
    brute = seed is not None
    rq_all = seed.float() if brute else torch.full((M,), float(radius2))
    o = torch.arange(pts)
    lane_of = (o // 4) % lanes if pts % 4 == 0 else o % lanes
    in_lane = lane_of[None, None, :] == torch.arange(lanes)[None, :, None]
    per_round = min(32, max(1, ROUND_PTS // pts))
    c = -(-k // lanes)
    inf = float("inf")
    NB = -(-M // qb)
    d_out = torch.empty((M, k))
    i_out = torch.empty((M, k), dtype=torch.int64)
    tiles = torch.zeros(NB * n_warps, dtype=torch.int32)
    for b in range(NB):
        qs, rq = q[b * qb:(b + 1) * qb], rq_all[b * qb:(b + 1) * qb]
        n = qs.shape[0]
        warps = [slice(w, min(w + per_warp, n)) for w in range(0, n, per_warp)]
        r_blk = rq.max() if brute else torch.tensor(float(radius2))
        listed = torch.nonzero(_gap2(qs.amin(0), qs.amax(0), t_lo, t_hi)
                               <= r_blk)[:, 0]
        ld = torch.full((n, lanes, k), inf)
        li = torch.zeros((n, lanes, k), dtype=torch.int64)
        for t0 in range(0, T, LIST_CAP):
            chunk = listed[(listed >= t0) & (listed < t0 + LIST_CAP)]
            if len(chunk):
                at = q[min(b * qb + qb // 2, M - 1)]
                start = int(torch.argmin(_gap2(at, at, t_lo[chunk],
                                               t_hi[chunk])))
                chunk = torch.cat([chunk[start:], chunk[:start]])
            for c0 in range(0, len(chunk), per_round):
                rnd = chunk[c0:c0 + per_round]
                for w, sl in enumerate(warps):
                    bound = query_bound(rq[sl], ld[sl], c).max()
                    near = rnd[_gap2(qs[sl].amin(0), qs[sl].amax(0),
                                     t_lo[rnd], t_hi[rnd]) <= bound]
                    tiles[b * n_warps + w] += len(near)
                    for t in near.tolist():
                        j = t * pts + o
                        d = sq_dist(qs[sl], ps[j])              # [nq, pts]
                        ok = d <= query_bound(rq[sl], ld[sl], c)[:, None]
                        idx = j
                        if brute:
                            ok &= j < P
                            idx = perm[j.clamp(max=P - 1)]
                        cd = torch.where(ok, d, torch.full_like(d, inf))
                        ci = torch.where(ok, idx, torch.zeros_like(idx))
                        cd = torch.where(in_lane, cd[:, None], inf)
                        ci = torch.where(in_lane, ci[:, None], 0)
                        ld[sl], li[sl] = _lex_topk(
                            torch.cat([ld[sl], cd], -1),
                            torch.cat([li[sl], ci], -1), k)
        d_out[b * qb:b * qb + n], i_out[b * qb:b * qb + n] = _lex_topk(
            ld.reshape(n, -1), li.reshape(n, -1), k)
    return d_out, i_out.to(torch.int32), tiles


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
                   radius2: float) -> torch.Tensor:
    """Launch K2 on the queries' CUDA device."""
    pts_t, T, pts = _check_tables(queries, tables)
    from .build import load_library
    lib = load_library()
    M = queries.shape[0]
    out = torch.empty(M, dtype=torch.int32, device=queries.device)
    LAUNCHES["knn_count"] += 1
    raise_on_error(lib.knn_count_launch(
        queries.data_ptr(), M, pts_t.data_ptr(), tables["t_lo"].data_ptr(),
        tables["t_hi"].data_ptr(), T, pts, float(radius2), out.data_ptr(),
        stream_handle(queries)), "knn_count")
    return out


def tiles_buffer(M: int, device) -> torch.Tensor:
    """Room for the tiles each warp of a K1 / K3 launch of M queries
    scans."""
    return torch.zeros(-(-M // radius_block(M)) * (THREADS // 32),
                       dtype=torch.int32, device=device)


def knn_radius_cuda(queries: torch.Tensor, tables: Dict[str, torch.Tensor],
                    k: int, radius2: float, scan_out: Optional[dict] = None):
    """Launch K3 on the queries' CUDA device. ``scan_out``: a dict that
    receives ``tiles``, the tiles each warp scanned (for holding the kernel
    against ``topk_scan_model`` and counting the pairs it scanned)."""
    if not 1 <= k <= 16:
        raise ValueError(f"knn_radius: need 1 <= k <= 16, got {k}")
    pts_t, T, pts = _check_tables(queries, tables)
    from .build import load_library
    lib = load_library()
    M = queries.shape[0]
    d2 = torch.empty((M, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((M, k), dtype=torch.int32, device=queries.device)
    tiles = None
    if scan_out is not None:
        tiles = scan_out["tiles"] = tiles_buffer(M, queries.device)
    LAUNCHES["knn_radius"] += 1
    raise_on_error(lib.knn_radius_launch(
        queries.data_ptr(), M, pts_t.data_ptr(), tables["t_lo"].data_ptr(),
        tables["t_hi"].data_ptr(), T, pts, float(radius2), k, d2.data_ptr(),
        idx.data_ptr(),
        None if tiles is None else tiles.data_ptr(), stream_handle(queries)),
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
