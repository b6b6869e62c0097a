"""The work counters, the trace reduction and the metric readers at toy
shapes, against counts worked out by hand."""
import pytest

from benchmark import run as bench
from benchmark import trace, work

PEAKS = {"bf16_flops": 1e12, "fp32_flops": 1e11, "hbm_bytes_per_s": 1e9}
SHAPE = dict(F=4, K=2, pts_ch=3, views_ch=1, pose_dim=0, feat_depth=2, J=2,
             t_dim=1, knn_share=1, knn_cand=3, agg_bf16=True)


def test_mlp_flops():
    # 2 x rows x (3*4 + 4*5)
    assert work.mlp_flops([3, 4, 5], 10) == 2 * 10 * (12 + 20)


def test_samples_take_the_smaller_of_demand_and_budget():
    rows = [[10, 8, 3, 5], [2, 8, 7, 5]]
    assert work.samples(rows) == {"active": 8 + 2, "passing": 3 + 5}


def test_point_model_by_hand():
    counts = {"active": 5.0, "passing": 3.0}
    ops = work.point_model(SHAPE, counts, train=False, at_time=True)
    # feat_net [4+3, 4, 4] over 3 x 2 rows, bf16
    feat = 2 * 6 * (7 * 4 + 4 * 4)
    # heads over 3 rows: [4, 1], [4, 4], [4+1, 2, 3]
    heads = 2 * 3 * (4 + 16 + (5 * 2 + 2 * 3))
    # transform_net [1, 256, 256, 256, 256, 12], one row
    warp = 2 * (256 + 3 * 256 * 256 + 256 * 12)
    knn = 8 * 5 * 2
    assert ops == {"bf16": feat, "fp32": heads + warp + knn}
    trained = work.point_model(SHAPE, counts, train=True, at_time=False)
    assert trained == {"bf16": 3 * feat, "fp32": 3 * (heads + knn)}
    assert work.least_seconds(ops, PEAKS) == pytest.approx(
        feat / 1e12 + (heads + warp + knn) / 1e11)


def test_pose_embedding_and_shared_knn_by_hand():
    shape = dict(SHAPE, pose_dim=2, knn_share=4)
    counts = {"active": 5.0, "passing": 3.0}
    ops = work.point_model(shape, counts, train=False, at_time=False)
    feat = 2 * 6 * (9 * 4 + 4 * 4)
    heads = 2 * 3 * (4 + 16 + (5 * 2 + 2 * 3))
    # pose net [2 * 3, 3, 2] (feat_depth 2: no middle layer), one row
    pose = 2 * (6 * 3 + 3 * 2)
    knn = 8 * 3 * 3          # knn_cand distances a passing sample
    assert ops == {"bf16": feat, "fp32": heads + pose + knn}


def test_k6_bound_by_hand():
    shape = dict(SHAPE, knn_share=2, knn_cand=3)
    b = work.k6_bound(shape, {"active": 9.0, "passing": 4.0}, 1, PEAKS)
    chain = 2 * 4 * 2 * (7 * 4 + 4 * 4)
    assert b["ops_s"] == pytest.approx(chain / 1e12 + 8 * 4 * 3 / 1e11)
    nbytes = (4 * 12 + 2 * 3 * (12 + 36 + 8) + (28 + 16) * 2 + 2 * 4 * 4
              + 4 * (16 + 4))
    assert b["bytes_s"] == pytest.approx(nbytes / 1e9)
    assert b["seconds"] == max(b["ops_s"], b["bytes_s"])


def test_union_and_groups():
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.group_of("void knn_topk_kernel<8>") == "own:K1_K3_scan"
    assert trace.group_of("chain_kernel<128, SubgroupFront>") == "own:K6_agg"
    assert trace.group_of("sm80_xmma_gemm_f32f32") == "gemm"
    assert trace.group_of("at::native::elementwise_kernel") == "glue"


def test_reduce_by_hand():
    dev = [("sm90_gemm", 0.0, 4.0), ("elementwise", 6.0, 8.0),
           ("chain_kernel<SubgroupFront>", 9.0, 10.0)]
    host = [("cudaGraphLaunch", 3.5, 6.5), ("aten::add", 8.0, 9.0)]
    r = trace.reduce(dev, host, 20e-6, units=2)
    assert r["busy_s"] == pytest.approx(7e-6)
    assert r["device_us_by_group"] == {"gemm": 2.0, "glue": 1.0,
                                       "own:K6_agg": 0.5}
    assert r["breakdown"]["idle_gaps"] == [["cudaGraphLaunch", 2e-6],
                                           ["aten::add", 1e-6]]
    assert r["breakdown"]["device_ops"][0] == ["sm90_gemm", 4e-6]


def reading(groups, busy=8.0, window=10.0):
    return {"trace": {"busy_s": busy, "window_s": window,
                      "device_us_by_group": groups},
            "unit_s": 0.5, "peaks": PEAKS,
            "work": {"ops": {"bf16": 1e11, "fp32": 1e10},
                     "k6": {"seconds": 0.001}}}


def test_readers():
    r = reading({"gemm": 10.0, "glue": 3000.0, "own:K6_agg": 4000.0})
    assert bench.reader("idle_share.train")(r) == pytest.approx(20.0)
    assert bench.reader("glue_ms.render")(r) == pytest.approx(3.0)
    assert bench.reader("mfu.train")(r) == pytest.approx(
        100 * (0.1 + 0.1) / 0.5)
    assert bench.reader("k6_roofline.render")(r) == pytest.approx(25.0)


def test_readers_read_nothing_where_their_group_is_missing():
    r = reading({"glue": 3000.0})
    assert bench.reader("glue_ms.train")(r) is None
    assert bench.reader("k6_roofline.render")(r) is None
    r["work"] = {}
    assert bench.reader("mfu.render")(r) is None


def test_knn_bound_by_hand():
    counts = {"active": 10.0, "passing": 4.0}
    b = work.knn_bound(3, counts, chunks=2, n_points=130, peaks=PEAKS,
                       tile=128)
    assert b["ops_s"] == pytest.approx(8 * 3 * 10 / 1e11)
    # queries 10 x 12; 3 (d2, index) pairs of 8 bytes each; a chunk reads
    # 130 points of 12 bytes and 2 tiles' boxes of 24
    nbytes = 10 * 12 + 10 * 3 * 8 + 2 * (130 * 12 + 2 * 24)
    assert b["bytes_s"] == pytest.approx(nbytes / 1e9)
    assert b["seconds"] == max(b["ops_s"], b["bytes_s"])


def test_g1_bound_by_hand():
    """Two steps of two calls each: each call's touched points read in the
    forward, the live rows' in the backward, its grid's gradient written
    whole; summed over a step's calls."""
    call = {"rows": 5, "live": 2, "touched": 6, "touched_live": 3,
            "cells": 7, "channels": 2}
    calls = [call, dict(call, live=5, touched_live=6),
             dict(call, rows=3, live=1, touched=4, touched_live=2), call]
    b = work.g1_bound(calls, 2, PEAKS)
    point, feats = 2 * 4, 3 * 2 * 4
    total = 0
    for rows, live, t, tl in ((5, 2, 6, 3), (5, 5, 6, 6), (3, 1, 4, 2),
                              (5, 2, 6, 3)):
        fwd = t * point + rows * 12 + rows * feats
        # live rows' positions, cotangents and the points they read; the
        # gradient of all 7 cells written, d/dxyz of every row
        bwd = live * (12 + feats) + tl * point + 7 * point + rows * 12
        total += fwd + bwd
    assert b["bytes"] == pytest.approx(total / 2)
    assert b["seconds"] == pytest.approx(b["bytes"] / 1e9)


def test_g1_bound_at_the_smoke_shape():
    """At M = 2^20 rows, all live, every point of a 160^3 x 12 grid read:
    360 MB forward and 569 MB backward, as ``chip_smoke.py`` phase 3 counts
    them."""
    M = 1 << 20
    cells = 160 ** 3
    call = {"rows": M, "live": M, "touched": cells, "touched_live": cells,
            "cells": cells, "channels": 12}
    fwd = work.g1_bound([dict(call, live=0, touched_live=0)], 1,
                        PEAKS)["bytes"] - (cells * 12 * 4 + M * 12)
    total = work.g1_bound([call], 1, PEAKS)["bytes"]
    assert round(fwd / 1e6) == 360
    assert round((total - fwd) / 1e6) == 569


def test_touched_points_by_hand():
    """A 5^3 grid (4k+1 already, so unpadded) sampled at its centre: stride
    1 reads the points 2 and 3 on each axis, stride 2 (index 1.0) the points
    2 and 4, stride 4 (index 0.5) 0 and 4: 3 x 8 points, of which (2, 2, 2)
    and (4, 4, 4) are read by two scales, counted once."""
    import torch
    from benchmark.reference.stage1 import touched
    lo, hi = torch.zeros(3), torch.ones(3)
    xyz = torch.full((1, 3), 0.5)
    assert touched((5, 5, 5, 2), xyz, lo, hi) == 22
    assert touched((5, 5, 5, 2), xyz.repeat(3, 1), lo, hi) == 22
    # at the grid's far corner only the corners inside it are read: one a
    # scale, the same point
    assert touched((5, 5, 5, 2), torch.ones(1, 3), lo, hi) == 1


def test_new_readers():
    r = reading({"own:K2_count": 300.0, "own:K1_K3_scan": 700.0,
                 "own:G1_trilerp": 2000.0})
    r["work"].update(knn={"seconds": 1e-4}, g1={"seconds": 5e-4})
    assert bench.reader("knn_roofline.render")(r) == pytest.approx(10.0)
    assert bench.reader("g1_roofline.train")(r) == pytest.approx(25.0)
    r = reading({"glue": 1.0})
    r["work"].update(knn={"seconds": 1e-4}, g1={"seconds": 5e-4})
    assert bench.reader("knn_roofline.render")(r) is None
    assert bench.reader("g1_roofline.train")(r) is None
