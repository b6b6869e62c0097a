"""K1: exact k-NN of every query over all points (``csrc/knn_brute.cu``).

Port of ``apnerf/kernels/knn_pallas.py:knn_pallas_sorted``: returns the k
nearest points of each query, d2 ascending, indices in the original point
order, ties to the lower index. Used once per model load
(``init_state``'s canonical-cloud neighbours).

Like the TPU kernel, K1 prunes over Morton-sorted tiles: ``brute_plan``
sorts the points into the tiles of ``knn_cells.build_point_tables`` (the
tables K2 and K3 scan) and the queries along the same curve; the kernel,
K3's top-k scan with a radius a query, seeds each query with the largest
d2 over the k sorted points around its own position (``brute_seeds``: its
kth distance is no larger). ``knn_brute_model`` is the whole work in
PyTorch (``knn_cells.topk_scan_model``), ``knn_brute_plain`` the
contract.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES, check, on_cpu, query_chunks, raise_on_error, \
    sq_dist, stream_handle
from .knn_cells import build_point_tables, tiles_buffer, topk_scan_model


def knn_brute_plain(queries: torch.Tensor, points: torch.Tensor, k: int):
    """Plain PyTorch version: full distance rows, stable sort."""
    q = queries.float()
    p = points.float()
    d_out, i_out = [], []
    for s, e in query_chunks(q.shape[0], p.shape[0]):
        d2 = sq_dist(q[s:e], p)
        d, i = torch.sort(d2, dim=1, stable=True)
        d_out.append(d[:, :k])
        i_out.append(i[:, :k].to(torch.int32))
    return torch.cat(d_out), torch.cat(i_out)


def _self_query(queries: torch.Tensor, points: torch.Tensor) -> bool:
    return (queries.data_ptr() == points.data_ptr()
            and queries.shape == points.shape)


def brute_plan(queries: torch.Tensor, points: torch.Tensor):
    """The point tables, the queries' Morton order (sorted query m is row
    ``order[m]``) and each sorted query's position among the sorted points
    (``None`` for a self-query, whose sorted query m is sorted point m) ->
    (tables, order, pos)."""
    from ..ops.knn import morton_codes
    tables = build_point_tables(points)
    if _self_query(queries, points):
        return tables, tables["perm"], None
    lo, hi = tables["p_lo"], tables["p_hi"]
    codes = morton_codes(queries, lo, hi)
    order = torch.argsort(codes, stable=True)
    P = points.shape[0]
    pos = torch.searchsorted(morton_codes(tables["pts_sorted"][:P], lo, hi),
                             codes[order])
    return tables, order, pos


def brute_seeds(q_sorted: torch.Tensor, pts_sorted: torch.Tensor,
                pos: Optional[torch.Tensor], k: int, P: int) -> torch.Tensor:
    """Each sorted query's seed: the largest d2 over the k sorted points
    from clamp(pos - k // 2, 0, P - k) on, as the kernel forms it."""
    M = q_sorted.shape[0]
    if pos is None:
        pos = torch.arange(M, device=q_sorted.device)
    s0 = torch.clamp(pos - k // 2, 0, P - k)
    p = pts_sorted[s0[:, None] + torch.arange(k, device=q_sorted.device)]
    d = q_sorted[:, None, :] - p
    return ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
            + d[..., 2] * d[..., 2]).amax(1)


def knn_brute_model(queries: torch.Tensor, points: torch.Tensor, k: int):
    """K1's work in PyTorch (``topk_scan_model`` on ``brute_plan``'s order
    and ``brute_seeds``) -> (d2 [M, k], idx [M, k] int32, the tiles each
    warp scanned): equal to ``knn_brute_plain``."""
    q, p = queries.float(), points.float()
    tables, order, pos = brute_plan(q, p)
    P = p.shape[0]
    qs = q[order]
    seed = brute_seeds(qs, tables["pts_sorted"], pos, k, P)
    d, i, tiles = topk_scan_model(qs, tables, k, seed=seed,
                                  perm=tables["perm"], P=P)
    d_out, i_out = torch.empty_like(d), torch.empty_like(i)
    d_out[order], i_out[order] = d, i
    return d_out, i_out, tiles


def launch_scan(queries: torch.Tensor, plan, k: int,
                tiles: Optional[torch.Tensor] = None):
    """Launch K1's kernel on ``brute_plan(queries, points)``'s plan ->
    (d2 [M, k], idx [M, k] int32); ``tiles``: None, or
    ``knn_cells.tiles_buffer(M)`` to receive the tiles each warp scanned."""
    tables, order, pos = plan
    M, (T, _, pts), P = queries.shape[0], tables["pts_t"].shape, \
        tables["perm"].shape[0]
    from .build import load_library
    dev = queries.device
    d2 = torch.empty((M, k), dtype=torch.float32, device=dev)
    idx = torch.empty((M, k), dtype=torch.int32, device=dev)
    LAUNCHES["knn_brute"] += 1
    raise_on_error(load_library().knn_brute_launch(
        queries.data_ptr(), order.data_ptr(),
        None if pos is None else pos.data_ptr(), M,
        tables["pts_t"].data_ptr(), tables["t_lo"].data_ptr(),
        tables["t_hi"].data_ptr(), T, pts, P, tables["perm"].data_ptr(), k,
        d2.data_ptr(), idx.data_ptr(),
        None if tiles is None else tiles.data_ptr(),
        stream_handle(queries)), "knn_brute")
    return d2, idx


def knn_brute_cuda(queries: torch.Tensor, points: torch.Tensor, k: int,
                   scan_out: Optional[dict] = None):
    """K1 on the queries' CUDA device: ``brute_plan`` (PyTorch on the
    card), then the kernel. ``scan_out``: as
    ``knn_cells.knn_radius_cuda``'s."""
    if not 1 <= k <= 16 or k > points.shape[0]:
        raise ValueError(f"knn_brute: need 1 <= k <= min(16, P), got k={k}")
    M, P = queries.shape[0], points.shape[0]
    check(queries, "queries", torch.float32, (M, 3))
    check(points, "points", torch.float32, (P, 3))
    tiles = None
    if scan_out is not None:
        tiles = scan_out["tiles"] = tiles_buffer(M, queries.device)
    return launch_scan(queries, brute_plan(queries, points), k, tiles)


def knn_brute(queries: torch.Tensor, points: torch.Tensor, k: int):
    """(d2 [M, k] ascending, idx [M, k] int32): the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if on_cpu(queries, points):
        return knn_brute_plain(queries, points, k)
    return knn_brute_cuda(queries.float().contiguous(),
                          points.float().contiguous(), k)
