"""The work a step or a frame needs, counted from the cell's shapes.

Counts are the benchmark's own: they never read the program's counters or
a kernel's report, so a later change to a kernel is read against the same
work. The samples come from the reference's run on the same inputs: its
budget audit row per forward, ``[active demand, active budget, passing
demand, passing budget]``. A sample in occupied space is an active one; a
passing one has a neighbour within the query radius and goes through
``feat_net`` with its K neighbours. What a row needs is the smaller of its
demand and its budget.

- ``feat_net`` (bf16 under ``agg_bf16``): ``[F + pts_ch + pose_dim] + [F] *
  feat_depth`` for each of the K neighbours of each passing sample.
- the heads (fp32): ``densitynet`` ``[F, 1]``, ``rgbnet``'s ``[F, F]`` and
  ``[F + views_ch, F / 2, 3]``, each passing sample.
- the warp's ``transform_net`` (``[t_dim] + [256] * 4 + [(J + 1) * 4]``,
  one row, when the frame is at a time) and ``pose_embedding_net`` (one
  row), fp32.
- the k-NN: 8 fp32 operations a distance (three differences, three
  products, two sums), K distances an active sample in the exact mode and
  ``knn_cand`` a passing one in the shared mode.
- training: three times the forward (the backward twice it), nothing
  recomputed counted.

The kernels' least work (``k5_bound``, ``k6_bound``, ``knn_bound``,
``g1_bound``) counts what their result needs, whatever kernel computes it:
each input byte read once, each output byte written once.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

WARP_HIDDEN, WARP_LAYERS, WARP_OUT = 256, 5, 4


def mlp_flops(dims: Sequence[int], rows: float) -> float:
    """Multiply-adds of a dense MLP ``dims[0] -> ... -> dims[-1]`` over
    ``rows`` rows, two operations each."""
    return 2.0 * rows * sum(a * b for a, b in zip(dims, dims[1:]))


def samples(audits: Iterable[Sequence[int]]) -> Dict[str, float]:
    """Active and passing samples summed over budget audit rows."""
    n_act = n_pass = 0
    for a in audits:
        n_act += min(a[0], a[1])
        n_pass += min(a[2], a[3])
    return {"active": float(n_act), "passing": float(n_pass)}


def point_model(shape: Dict, counts: Dict[str, float], train: bool,
                at_time: bool) -> Dict[str, float]:
    """Operations of one stage-2 step or frame by type (``bf16``,
    ``fp32``). ``shape``: F, K, pts_ch, views_ch, pose_dim, feat_depth, J,
    t_dim, knn_share, knn_cand, agg_bf16; ``counts``: ``samples``'s."""
    F, K = shape["F"], shape["K"]
    n_pass, n_act = counts["passing"], counts["active"]
    feat = mlp_flops([F + shape["pts_ch"] + shape["pose_dim"]]
                     + [F] * shape["feat_depth"], n_pass * K)
    heads = (mlp_flops([F, 1], n_pass) + mlp_flops([F, F], n_pass)
             + mlp_flops([F + shape["views_ch"], F // 2, 3], n_pass))
    per_frame = 0.0
    if at_time:
        per_frame += mlp_flops([shape["t_dim"]] + [WARP_HIDDEN]
                               * (WARP_LAYERS - 1)
                               + [(shape["J"] + 1) * WARP_OUT], 1)
    if shape["pose_dim"] > 0:
        pin = shape["J"] * shape["pts_ch"]
        per_frame += mlp_flops([pin, pin // 2] + [pin // 2]
                               * (shape["feat_depth"] - 2)
                               + [shape["pose_dim"]], 1)
    if shape["knn_share"] > 1:
        knn = 8.0 * n_pass * shape["knn_cand"]
    else:
        knn = 8.0 * n_act * K
    bf16 = feat if shape["agg_bf16"] else 0.0
    fp32 = heads + per_frame + knn + (0.0 if shape["agg_bf16"] else feat)
    mult = 3.0 if train else 1.0
    return {"bf16": mult * bf16, "fp32": mult * fp32}


def least_seconds(ops: Dict[str, float], peaks: Dict) -> float:
    """The least time of ``ops`` at the chip's peaks (TF32 off: fp32 on the
    vector units)."""
    return ops["bf16"] / peaks["bf16_flops"] + ops["fp32"] / peaks["fp32_flops"]


def k6_bound(shape: Dict, counts: Dict[str, float], chunks: int,
             peaks: Dict) -> Dict[str, float]:
    """K6 (``fused_subgroup_agg``) of one frame: each passing sample's K
    neighbours through the bf16 chain and its ``knn_cand`` distances; read
    once: the members' positions, each subgroup's candidates (position,
    rotation, bf16 features) and, per call, the bf16 layers; written once:
    ``h`` and ``kd2``. -> ``ops_s``, ``bytes_s``, ``seconds`` (the larger)."""
    F, K, kc, share = (shape["F"], shape["K"], shape["knn_cand"],
                       shape["knn_share"])
    n = counts["passing"]
    groups = n / share
    chain = mlp_flops([F + shape["pts_ch"]] + [F] * shape["feat_depth"],
                      n * K)
    ops_s = chain / peaks["bf16_flops"] + 8.0 * n * kc / peaks["fp32_flops"]
    layers = (F + shape["pts_ch"]) * F + (shape["feat_depth"] - 1) * F * F
    nbytes = (n * 3 * 4 + groups * kc * (3 * 4 + 9 * 4 + F * 2)
              + chunks * (layers * 2 + shape["feat_depth"] * F * 4)
              + n * (F * 4 + 4))
    bytes_s = nbytes / peaks["hbm_bytes_per_s"]
    return {"ops_s": ops_s, "bytes_s": bytes_s,
            "seconds": max(ops_s, bytes_s)}


def mean_counts(per_unit: List[Dict[str, float]]) -> Dict[str, float]:
    keys = per_unit[0].keys()
    return {k: sum(c[k] for c in per_unit) / len(per_unit) for k in keys}


def tineuvox_step(cfg, filled: float, n_rays: int, train: bool
                  ) -> Dict[str, float]:
    """Operations of one stage-1 step of the backbone ``cfg`` (a
    ``TiNeuVoxConfig``): ``deformation_net`` and ``featurenet`` (bf16
    under ``mlp_bf16``) and the heads (fp32) over the ``filled`` active
    samples, ``timenet`` over the rays; three times that in training."""
    W = cfg.net_width
    mlp = (mlp_flops([cfg.pts_ch + cfg.timenet_output] + [W]
                     * (cfg.defor_depth - 1) + [3], filled)
           + mlp_flops([cfg.featurenet_input, W], filled))
    heads = (mlp_flops([W, 1], filled) + mlp_flops([W, W], filled)
             + mlp_flops([W + cfg.rgb_views_ch, W // 2, 3], filled)
             + mlp_flops([cfg.times_ch, W, cfg.timenet_output], n_rays))
    mult = 3.0 if train else 1.0
    bf16 = mlp if cfg.mlp_bf16 else 0.0
    fp32 = heads + (0.0 if cfg.mlp_bf16 else mlp)
    return {"bf16": mult * bf16, "fp32": mult * fp32}


def k5_bound(world_size: Sequence[int], voxel_dim: int, filled: float,
             peaks: Dict) -> Dict[str, float]:
    """K5 (``sorted_window_accumulate``) of one stage-1 step: one call a
    scale of the multi-scale grid (strides 1, 2, 4 of the grid padded to
    4k + 1), each reading once the rows the step needs (a sorted int32 key
    and 8 corners x ``voxel_dim`` fp32 a filled sample) and writing once
    its gradient grid (8 x ``voxel_dim`` fp32 a cell of the extended
    grid). -> ``bytes``, ``seconds`` at the HBM rate."""
    C8 = 8 * voxel_dim
    padded = [-(-(n - 1) // 4) * 4 + 1 for n in world_size]
    nbytes = 0.0
    for s in (1, 2, 4):
        cells = 1
        for p in padded:
            cells *= (p - 1) // s + 1 + 1
        nbytes += filled * (4 + 4 * C8) + 4 * C8 * cells
    return {"bytes": nbytes, "seconds": nbytes / peaks["hbm_bytes_per_s"]}


def knn_bound(K: int, counts: Dict[str, float], chunks: int, n_points: int,
              peaks: Dict, tile: int = 128) -> Dict[str, float]:
    """The exact k-NN (K2 + K3) of one frame: 8 fp32 operations for each
    of the ``K`` distances of each active sample; read once: the active
    samples' positions, and each chunk the point tables (the ``n_points``
    warped points and a box of two corners a ``tile`` points); written
    once: K (d2, index) pairs an active sample. -> ``ops_s``, ``bytes_s``,
    ``seconds`` (the larger)."""
    n = counts["active"]
    ops_s = 8.0 * n * K / peaks["fp32_flops"]
    tables = n_points * 3 * 4 + -(-n_points // tile) * 2 * 3 * 4
    nbytes = n * 3 * 4 + n * K * (4 + 4) + chunks * tables
    bytes_s = nbytes / peaks["hbm_bytes_per_s"]
    return {"ops_s": ops_s, "bytes_s": bytes_s,
            "seconds": max(ops_s, bytes_s)}


def g1_bound(calls: List[Dict[str, float]], steps: int, peaks: Dict
             ) -> Dict[str, float]:
    """G1 (the multi-scale grid sample, forward and backward) of one
    stage-1 step, from the ``calls`` of ``steps`` steps, each with its
    ``rows`` (the samples' positions, [rows, 3] fp32), ``live`` (rows whose
    cotangent is not all zero), ``touched`` / ``touched_live`` (the grid
    points that the rows / the live rows read, over the three scales) and
    the ``cells`` and ``channels`` of its grid (fp32). A call moves at
    least: forward, the touched points read, the positions read and the
    three scales' features written ([rows, 3 x channels]); backward, the
    live rows' positions and cotangents and the points they touch read,
    the grid's gradient written whole (it is a dense tensor) and d/dxyz
    written. -> ``bytes``, ``seconds`` at the HBM rate."""
    nbytes = 0.0
    for c in calls:
        point = c["channels"] * 4
        feats = 3 * point
        nbytes += (c["touched"] * point + c["rows"] * (12 + feats)
                   + c["live"] * (12 + feats) + c["touched_live"] * point
                   + c["cells"] * point + c["rows"] * 12)
    nbytes /= steps
    return {"bytes": nbytes, "seconds": nbytes / peaks["hbm_bytes_per_s"]}
