"""The test-view render cell (``generators/render_test.py``) on the CPU at
a tiny size, the look for a card skipped: ``correct`` true for the sound
program, false with a view rendered at its neighbour's time, with half of
a view's chunks left out, and with the PSNR or the SSIM that it reports
worked out by a shortcut (all planted in the program). Beside it, the
scenes of the other cells kept bit for bit, and G1's marks in
``kernels.json``."""
import json
import os
import subprocess
import sys
from unittest import mock

import pytest
import torch

from benchmark import run as bench
from benchmark import trace
from benchmark.tests.tiny import tiny_context

N_VIEWS = 3


def run_cell(trace_on=False):
    spec, ctx = tiny_context("dnerf-render-test", trace=trace_on,
                             n_views=N_VIEWS, sample_views=2)
    return bench.execute(ctx, spec)


@pytest.mark.parametrize("trace_on", [False, True])
def test_sound_program_is_correct(trace_on):
    line = run_cell(trace_on)
    assert line["correct"], line["checks"]
    assert line["attempted"] == N_VIEWS and line["failed"] == 0
    assert list(line["checks"]) == ["rgb_rmse", "weights_rmse", "psnr_gap",
                                    "ssim_gap"]
    if trace_on:
        assert 0 < line["metrics"]["budget_fill.render"]["value"] <= 100
    else:
        assert set(line["metrics"]) == {"render_rays_per_s", "frame_ms_p95",
                                        "setup_s"}


def test_view_at_its_neighbours_time():
    """Each view's frame made at the next view's time (the last at the one
    before)."""
    from apnerf_torch.models import temporal_points as tp
    real = tp.prepare_frame

    def neighbour(model, state, t=None, **kw):
        if t is not None:
            k = round(float(t.reshape(-1)[0] if torch.is_tensor(t) else t)
                      * (N_VIEWS - 1))
            k = k + 1 if k < N_VIEWS - 1 else k - 1
            t = k / (N_VIEWS - 1)
        return real(model, state, t=t, **kw)
    with mock.patch.object(tp, "prepare_frame", neighbour):
        line = run_cell()
    assert not line["correct"], line["checks"]


def test_half_of_a_views_chunks_left_out():
    """The image function renders the first half of a view's chunks; the
    rest of its outputs stay zero."""
    from apnerf_torch.render import renderers
    real = renderers.make_image_scan

    def half(body, keys, graphs, mesh=None):
        image_fn = real(body, keys, graphs, mesh)

        def first_half(*args, **kw):
            out = dict(image_fn(*args, **kw))
            for k in keys:
                v = out.get(k)
                if torch.is_tensor(v):
                    v = v.clone()
                    v[(v.shape[0] + 1) // 2:] = 0
                    out[k] = v
            return out
        return first_half
    with mock.patch.object(renderers, "make_image_scan", half):
        line = run_cell()
    assert not line["correct"], line["checks"]
    assert all(c["value"] > c["limit"] for c in line["checks"].values())


def ssim_box(img0, img1, max_val=1.0, **kw):
    """SSIM over an 11 x 11 box window, a common shortcut."""
    import numpy as np
    from scipy.ndimage import uniform_filter

    def blur(z):
        return uniform_filter(z, size=(11, 11, 1))[5:-5, 5:-5]
    a, b = np.asarray(img0, np.float64), np.asarray(img1, np.float64)
    mu_a, mu_b = blur(a), blur(b)
    va, vb = blur(a * a) - mu_a ** 2, blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    return float(np.mean((2 * mu_a * mu_b + c1) * (2 * cov + c2)
                         / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))))


def psnr_half(img, ref):
    """PSNR from every other row, a shortcut."""
    import numpy as np
    d = np.asarray(img)[::2] - np.asarray(ref)[::2]
    return float(-10.0 * np.log10(np.mean(np.square(d))))


@pytest.mark.parametrize("name,approx", [("rgb_ssim", ssim_box),
                                         ("psnr", psnr_half)])
def test_scores_worked_out_by_a_shortcut(name, approx):
    """The program's score replaced by a shortcut: its images stay right,
    the score it reports does not."""
    from apnerf_torch.render import metrics
    with mock.patch.object(metrics, name, approx):
        line = run_cell()
    assert not line["correct"], line["checks"]
    checks = line["checks"]
    assert checks["rgb_rmse"]["value"] <= checks["rgb_rmse"]["limit"]
    gap = "ssim_gap" if name == "rgb_ssim" else "psnr_gap"
    assert checks[gap]["value"] > checks[gap]["limit"], checks


# sha256 of the tiny scenes (``tiny_config``, seed 4100000007, on the CPU
# in one thread with MKL's reproducible mode): the arrays the four cells
# that came before the test views are handed
SCENES = {"dnerf": "dbef03e9467240300281d50baef78721244bdf90595dd4a72b798eaf"
                   "7d7fbfd6",
          "zju": "7e91902b336ffacc69a9821c2b3004affa50fed18e2f6363beccfa6d62"
                 "64a469"}

DIGEST = """
import hashlib, json
import numpy as np
from benchmark import run as bench
from benchmark.scene import make_scene
from benchmark.tests.tiny import tiny_config
out = {}
for name in ("dnerf", "zju"):
    scene = make_scene(tiny_config(bench.load(f"configs/{name}.json")),
                       4100000007, "cpu")
    h = hashlib.sha256()
    for part in ("data", "canonical", "skeleton", "heads"):
        d = getattr(scene, part)
        for k in sorted(d):
            a = np.ascontiguousarray(np.asarray(d[k]))
            if a.dtype != object:
                h.update(k.encode())
                h.update(str(a.dtype).encode())
                h.update(a.tobytes())
    out[name] = h.hexdigest()
print(json.dumps(out))
"""


def test_scenes_unchanged():
    env = dict(os.environ, MKL_CBWR="COMPATIBLE", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", DIGEST], cwd=bench.ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == SCENES


G1 = ("trilerp_kernel", "trilerp_grad_kernel", "trilerp_rows_kernel",
      "trilerp_fold_kernel")
OTHERS = ("knn_topk_kernel", "knn_count_kernel", "chain_kernel<RowFront>",
          "chain_kernel<SubgroupFront>", "plan_kernel", "accumulate_kernel",
          "combine_kernel", "procrustes_kernel", "procrustes_grad_kernel",
          "upsample_trilinear3d_out_frame", "sm90_xmma_gemm_bf16",
          "at::native::vectorized_elementwise_kernel")


def test_g1_marks():
    """G1's four kernels (``chip_smoke.G1_KERNELS``), with their template
    arguments, are own kernels of G1; no other kernel is."""
    for name in G1:
        assert trace.group_of(f"void {name}<3>(float const*, int)") == \
            "own:G1_trilerp", name
    for name in OTHERS:
        assert trace.group_of(name) != "own:G1_trilerp", name
