"""K1: exact brute-force k-NN (``csrc/knn_brute.cu``).

Port of ``apnerf/kernels/knn_pallas.py:knn_pallas_sorted``: returns the k
nearest points of each query, d2 ascending, indices in the original point
order, ties to the lower index. Used once per model load
(``init_state``'s canonical-cloud neighbours).
"""
from __future__ import annotations

import torch

from . import LAUNCHES, check, on_cpu, query_chunks, raise_on_error, \
    sq_dist, stream_handle


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


def knn_brute_cuda(queries: torch.Tensor, points: torch.Tensor, k: int):
    """Launch K1 on the queries' CUDA device."""
    if not 1 <= k <= 16 or k > points.shape[0]:
        raise ValueError(f"knn_brute: need 1 <= k <= min(16, P), got k={k}")
    M, P = queries.shape[0], points.shape[0]
    check(queries, "queries", torch.float32, (M, 3))
    check(points, "points", torch.float32, (P, 3))
    from .build import load_library
    lib = load_library()
    d2 = torch.empty((M, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((M, k), dtype=torch.int32, device=queries.device)
    LAUNCHES["knn_brute"] += 1
    raise_on_error(lib.knn_brute_launch(
        queries.data_ptr(), points.data_ptr(), M, P, k, d2.data_ptr(),
        idx.data_ptr(), stream_handle(queries)), "knn_brute")
    return d2, idx


def knn_brute(queries: torch.Tensor, points: torch.Tensor, k: int):
    """(d2 [M, k] ascending, idx [M, k] int32): the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if on_cpu(queries, points):
        return knn_brute_plain(queries, points, k)
    return knn_brute_cuda(queries.float().contiguous(),
                          points.float().contiguous(), k)
