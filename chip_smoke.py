#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``apnerf_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises; the exit code is then non-zero
and no result line is printed):

1. device  -- needs CUDA; prints the card and its nvidia-smi name and
   power limit; TF32 off for the fp32 plain versions.
2. build   -- compiles ``apnerf_torch/csrc/*.cu`` for sm_90a, one nvcc per
   source in parallel; K4's and K6's kernels must hold wgmma instructions
   (HGMMA in the library's SASS, read with the toolkit's ``cuobjdump``).
3. kernel  -- each kernel against its plain PyTorch version at its main
   path's shapes (K1-K3 exactly equal, K4's max abs error, beyond one
   bf16 step of each neighbour's last-layer output times its weight, under
   ``K4_REL_MAX_ERR`` of max |h| and its mean under ``K4_MEAN_ABS_ERR`` and
   ``K4_REL_MEAN_ERR`` of max |h|, printed beside a control
   reading), with the median of CUDA-event timed runs of each side; K4
   through ``featmlp_agg``, the entry the render calls. K4's gathering
   front (``featmlp_gather``, the exact render's aggregation in
   ``featnet_plain``'s rounding) at the ``dnerf-render-test`` cell's chunk
   (``GATHER_SLOTS`` slots, K = 8, F = 128, 4 layers), with and without a
   64-wide pose embedding, against the gathers and ``featnet_plain`` on
   the card: max and mean |dh| under K4's gates beside the control in K4's
   own rounding, kth bit-equal, the weights under
   ``GATHER_W_MAX_ABS_ERR``, a live prefix of ``GATHER_LIVE`` of the slots
   equal to the full call and the rest cleared; graphed and queued ms and
   the roofline share, over all slots and over the prefix. K5 (scatter) at
   the three stage-1 grid-gradient shapes: two runs bit-equal, and
   bit-equal to the plain version on a CPU copy of the inputs (the
   row-order sum is sequential in both), else under ``K5_MAX_ABS_ERR``,
   printed beside the bf16-row control, and beside the one library call
   that computes the same (``index_add_``), which K5 must beat at 42^3;
   then a cell of 300,000 rows (summed in chunks, in the plain version's
   order), rows all out of range, one cell holding every row, C = 8 in the
   other layout, and the kernel's work items against ``item_plan``. K1,
   K2 and K3 also on a ragged M, a block of sentinel queries only, clouds
   of 10^5 and of 130 points, tiles of 32 and 512 points, points at
   exactly d2 == r2 and duplicate points (K3 at k = 12 too, K1 as
   self-queries on the lattice and the duplicates at k = 1 to 16), each
   also at 32,768 queries or more, where the kernels take fewer lanes a
   query; on the small clouds the tiles each warp of K1 / K3 scanned
   against ``topk_scan_model``. K1's, K2's, K3's and K5's times beside
   those of the kernels they replace and with 20 launches queued; K1's and
   K3's beside the library yardstick (``cdist`` + ``topk``). K1's, K2's
   and K3's bounds count the pairs their warps scan, beside the pairs of
   the tiles their blocks list (K1: within each block's final kth
   distance) and, K1, the 10^8 pairs of a brute-force walk. K6 (agg) at
   the bench shape
   (4480 subgroups of 16 members, 8 candidates) and with 12 candidates,
   ~10% of the slots invalid: ``kd2`` bit-equal, ``h`` finite and under
   ``K6_MAX_ABS_ERR`` / ``K6_MEAN_ABS_ERR``, beside the same control as
   K4's. K4 and K6 also at the shapes a persistent, tiled kernel gets
   wrong first (ragged row counts, fewer rows than a tile, F = 64 and 32,
   1 to 7 layers, a pose embedding, members of 1 to 128 rows, share 8,
   1 / 12 / 16 / 100 candidates), under the same gates, and the wrapper's
   shared-memory rule against the kernel's. Every kernel's time stands
   beside its bound: the larger of its bytes over the card's memory rate
   and its operations over the card's peak for their type; K4's and K6's
   also beside the time of the WMMA kernels they replace. K1 also as
   ``ops.knn.nn1`` (k = 1, queries that are not the points, both lane
   counts), bit-equal. P1 (special Procrustes, forward and backward) at
   10^4 matrices of five kinds (rotations, two- and three-rotation blends,
   random, reflections): R and dM against float64 beside the plain
   version's (``torch.linalg.svd``) errors, its time queued, inside a CUDA
   graph (as the frame and step graphs run it) beside the earlier kernels'
   (``P1_EARLIER_GRAPHED_MS``) and beside ``torch.linalg.svd`` + ``det``,
   whether ``torch.linalg.svd`` and P1 capture into a CUDA graph, and
   ptxas' registers and spills of both kernels beside the earlier ones';
   then at 2^20 matrices, where bytes bind, the same times against the
   bound, every ``P1_BIG_STRIDE``-th matrix against float64 by the same
   gate, all finite. G1 (stage 1's multi-scale grid sample) at the step's
   shape: the forward and the grid gradient bit-equal to the plain path,
   d/dxyz no further from float64 than the plain path's, a forward and
   backward's launches, both captured in a CUDA graph; each kernel's time
   against its bytes bound, beside the plain path and ``F.grid_sample``.
4. train   -- stage 1 of the nerf family at full width (160^3 x 12 grid,
   defor_depth 5, net_width 128, 4096 rays a step) on a 6-view 400 x 400
   arm scene, ``scene_rep_reconstruction`` for ``TRAIN_STEPS`` steps, each
   a CUDA-graph replay after its segment's first, with one grid rebuild
   (pg_scale), the occupancy switch and a refresh (``TRAIN_REFRESH``)
   inside the run: three segments, each captured once; finite and falling
   losses, K5 launched, one step's feature-grid gradient through K5
   against the same through the plain version (under ``GRAD_REL_ERR``,
   beside the bf16-row control); then both ways (``both_ways``): the
   graphed step against the eager one (``make_train_step``) from one
   state, the loss equal, each gradient leaf under ``GRAD_REL_ERR`` of its
   max |grad| beside two eager runs' difference, ``TRAJ_STEPS``-step
   trajectories within ``TRAJ_GAP_MULT`` times two eager ones' gap,
   launches a step equal, ``BOTH_WAYS_STEPS`` steps timed each way, the
   capture's ms, peak memory and host launch calls a step each way (a
   replayed step launches one graph and no kernel); ``fine_last.pkl``
   written, reloaded and giving the same alpha; ``fine_progress.pkl``
   (model and Adam state) written for phase 7. Then a microbatched step
   both ways the same way: ``MICRO_N_RAND`` rays, which the JAX package's
   auto rule cuts in two, each half under its own active budget, both in
   the one graph (peak memory each way).
5. render  -- the bench scene of ``bench.py:build_model`` (10^4 points,
   24 joints, F = 128, K = 8, random weights from a seed) is saved and
   loaded as a checkpoint (K1 runs at load) and a 400 x 400 view is
   rendered in 8192-ray chunks through ``render_view`` (the image
   function: a frame graph and a chunk graph, captured in it), in exact
   k-NN mode (K4), in exact mode with ``featmlp_kernel`` off (the
   configurations' own formulation: K4's gathering front) and in shared
   mode (K4). Each mode must launch K1-K3 and its feat_net kernel, give a
   finite
   image with foreground, and agree with the same render through the
   plain versions on the foreground pixels (PSNR >= ``PSNR_MIN_DB``,
   printed beside a control render's). Then both ways (``graph_vs_eager``):
   one renderer's frames through its image function and through its
   chunk loop at two poses from the same graphs, equal within
   ``GRAPH_MAX_ABS_DIFF``, the launches of a graphed frame equal to an
   eager frame's, ``FRAMES`` frames timed each way, the capture's ms, the
   peak memory each way and the host's launch calls of a frame each way
   (under the profiler; a graphed frame launches its graphs and no more
   than one kernel). Then the same model with ``avg_procrustes`` (P1 in
   the frame graph), shared mode: a view through ``render_view``, both
   ways, and against the render with the float64 polar factor in P1's
   place (every other kernel's plain version) on the foreground (PSNR >=
   ``PROCRUSTES_PSNR_MIN_DB``), beside the control render of the blended
   frames; the plain-version render (``torch.linalg.svd``) against the
   same is printed.
6. render views -- the same checkpoint through ``load_temporalpoints``
   (no device given: the card), ``points_render_config`` with
   ``fused_agg`` and ``make_points_renderer(render_weights=False)``, then
   ``render_viewpoints`` over ``N_VIEWS`` views of 400 x 400 with the
   plain-version renders as gt images: K6 must launch and K4 must not, the
   images must be finite with foreground and agree with the plain-version
   renders on the foreground (PSNR >= ``FUSED_PSNR_MIN_DB``, beside a
   control render's). Fused, shared and exact both ways, as in phase 5,
   at the ``N_VIEWS`` times from one graph, and ``render_viewpoints`` (its
   readback overlapped with the next view) graphed against eager: equal
   images, ms a frame each way. At a smaller depth: one
   ``render_pcd_direct`` view, ``simplify_skeleton`` and a ``repose``
   with LBS-weight images, and a ``make_backbone_renderer`` view of the
   stage-1 model of phase 4, its frames both ways at two times (at 100 x
   100).
7. stage 2 -- the stage-2 half at the nerf family's width: phase 4's
   model trained ``EXPORT_STEPS`` more steps (a resume from its progress
   checkpoint), ``export_point_cloud`` at the model's world size (the
   search must bracket canonical_pcd_num; a count inside ``PCD_BAND``, a
   bone at least, the joints inside the cloud's bbox), ``train_pcd`` for
   ``STAGE2_STEPS`` steps of 8192 rays with every loss term at the
   family's sample budget of 192 (``STAGE2_MAX_STEPS``: the fused group
   sampler; every step a graph replay after the first; K1 launched once,
   K2 and K3 on every step, K4-K6 never; finite losses whose last third
   averages below the first), one step's
   gradients through K2 / K3 against their plain versions, on the fused
   group sampler and on the non-fused sampler pair, grouped and per
   sample (the loss equal, every
   leaf under ``STAGE2_GRAD_REL_ERR`` of its max |grad|, beside two
   kernel runs' own difference), the graphed step both ways as in phase 4
   (the gradients under ``STAGE2_GRAD_REL_ERR``), the same with
   ``featmlp_train`` (K4 in the forward and the recompute backward inside
   the graph; K4 against its plain version on
   the step's inputs under phase 3's relative gates, beside the control
   without its per-layer bf16 round; the step's gradients against the XLA
   formulation's under ``K4_TRAIN_MEAN_REL_ERR``), the same with
   ``avg_procrustes`` (P1's forward and backward in the graph; one step's
   blended frames through P1 against float64 as in phase 3, the step's
   gradients against the plain versions' printed), then
   ``save_temporalpoints`` / ``load_temporalpoints`` and a 400 x 400
   ``render_view`` of the trained model with foreground (opacity over
   ``STAGE2_FG_ACC`` on at least half the training mask's share of the
   view).
8. cli -- ``apnerf_torch.cli.main`` (``python -m apnerf_torch.cli``) on
   a D-NeRF dataset that ``generate_scene`` writes to disk (``CLI_SIZE``
   PNGs read with ``half_res``), in a temporary working directory: (1)
   train both stages with the nerf family's jumpingjacks config at full
   width, cut in steps (``CLI_STAGE1_STEPS`` / ``CLI_STAGE2_STEPS``):
   the checkpoints and exports written, finite and falling losses, the
   export inside ``PCD_BAND``, K5 in stage 1, K1 once, K2 and K3 every
   stage-2 step, K4 (``featmlp_train``, so that the render takes it); (2) ``--render_only --load_test_val --render_test
   --render_pcd --eval_psnr --eval_ssim`` (exact k-NN, K1-K4): PNGs read
   back with ``utils.png`` equal to the rendered images, ``results.txt``,
   the render against the same invocation through the plain versions
   (foreground PSNR >= ``CLI_PSNR_MIN_DB``, beside the control's); (3)
   ``--repose_pcd --degree_threshold 30`` with the shared k-NN and
   ``fused_agg``: K6 and not K4, 60 frames and the video (or its
   animated-PNG stand-in); (4) the backbone's ``--render_test``. Times:
   the scene, a PNG decode, stage-1 and stage-2 ms/step (graph replays),
   the export, each invocation.
9. mesh (run after phase 7, before phase 8) -- the mesh paths of
   ``apnerf_torch.parallel`` on a world-size-1 NCCL group (the card is
   one; a group of two needs two cards), each
   against the same call without the mesh and the launch counts at 0
   just before it: phase 4's ``scene_rep_reconstruction`` (10 graphed
   steps, three segments, K5) and ``MESH_STAGE2_STEPS`` steps of phase 7's
   ``train_pcd`` (K1, K2, K3; the moments ZeRO-1 split) with
   ``mesh=make_mesh(1)``, each run twice without the mesh as the control:
   the first loss equal and the mesh run's largest loss gap within
   ``TRAJ_GAP_MULT`` times the two plain runs' (or both zero), the
   parameters' gap after the last step, ms a step, the NCCL kernels,
   device copies and host calls of one replay of the last segment's
   graph, peak memory;
   then one 400 x 400 view of phase 5's checkpoint, fused (K2, K3, K6)
   and exact (K2, K3, K4), through ``make_points_renderer(mesh=)`` and
   ``render_viewpoints``: bit-equal to the view without the mesh, ms a
   frame graphed, NCCL kernels, device copies and host calls a frame,
   peak memory.
10. wim -- the WIM loader on the card's host: the benchmark's ``wim``
   scene (``benchmark/configs/wim.json``, the spot quadruped, 18 ring
   cameras) written as a WIM dataset of ``WIM_FRAMES`` frames at 512 x
   512 (``write_wim_fixture``: RGBA frames with straight colour and
   alpha, cameras 0-19, ``cam_%03d.json``), read back with
   ``data.load_data``: the images within one uint8 level of the scene's
   or two below (the loader truncates), the masks equal but at alpha
   127-128, the other arrays equal, the poses within float32 rounding
   (``check_wim_load``); then ``WIM_STEPS`` steps of
   ``train_pcd`` on what the loader read (finite losses, K3 every step).
11. a JSON line of the kernels (each kernel's launches summed over the
   paths of phases 4-10, and by path: P1's on the avg_procrustes view and
   steps), the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
H = W = 400
FOCAL = 555.0
CHUNK = 8192
RADIUS = 0.01
# Gates between the sound reading and a control (the plain K4 without its
# per-layer bf16 round), both taken on an NVIDIA H100 80GB HBM3, 700 W:
# K4 max abs error 3.0e-4 against the control's 4.2e-4; K4 mean abs error
# 8.4e-8 (the wgmma chain; 1.17e-7 for the WMMA kernel before it) against
# the control's 2.02e-5 (the gate is near their geometric mean); foreground
# render PSNR 160.3 / 161.0 dB (exact / shared) against the control
# render's 143.9 / 144.7 dB. The kernel and the plain version sum the same
# bf16 products in fp32 in another order, so now and then a bf16 round
# falls the other way: a last-layer output then moves by one bf16 step of
# itself, which is 2^-8 to 2^-7 of it, and an output may exceed max |h|
# (at the stage-2 step, max |h| 3.39: one element 0.00435 of max |h|, over
# 2^-8). So the max gate allows each element of h one bf16 step of each
# neighbour's last-layer output (the plain version's), times the
# neighbour's weight (``last_round_allowance``), and holds what is left
# over -- flips in earlier layers carried forward, the fp32 order -- to
# 2^-8 of max |h|, a ceiling as K6's; the mean is what tells a kernel that
# skips a round from a sound one, held both absolutely and, as K6's,
# relative to max |h|.
K4_REL_MAX_ERR = 2.0 ** -8
K4_MEAN_ABS_ERR = 1.5e-6
K4_REL_MEAN_ERR = 1e-5
PSNR_MIN_DB = 152.0
KERNELS = [  # name, source, TPU kernel it replaces (pl.pallas_call line)
    ("knn_brute", "apnerf_torch/csrc/knn_brute.cu",
     "apnerf/kernels/knn_pallas.py:110"),
    ("knn_count", "apnerf_torch/csrc/knn_cells.cu",
     "apnerf/kernels/knn_cells_pallas.py:261"),
    ("knn_radius", "apnerf_torch/csrc/knn_cells.cu",
     "apnerf/kernels/knn_cells_pallas.py:340"),
    ("featmlp", "apnerf_torch/csrc/featmlp.cu",
     "apnerf/kernels/featmlp_pallas.py:203"),
    # K4's gathering front replaces no TPU kernel: the XLA formulation of
    # the exact path's aggregation, which the JAX package renders with
    ("featmlp_gather", "apnerf_torch/csrc/featmlp.cu",
     "apnerf/train/stage2.py:99 (no pl.pallas_call: the XLA feat_net with "
     "featmlp_kernel off)"),
    ("scatter", "apnerf_torch/csrc/scatter.cu",
     "apnerf/kernels/scatter_pallas.py:213"),
    ("agg", "apnerf_torch/csrc/agg.cu", "apnerf/kernels/agg_pallas.py:230"),
    # P1 replaces no TPU kernel: the XLA SVD of special_procrustes
    ("procrustes", "apnerf_torch/csrc/procrustes.cu",
     "apnerf/ops/rotations.py:47 (no pl.pallas_call: the XLA SVD)"),
    ("procrustes_grad", "apnerf_torch/csrc/procrustes.cu",
     "apnerf/ops/rotations.py:47 (no pl.pallas_call: the SVD's "
     "derivative)"),
    # G1 replaces no TPU kernel: XLA's gathers of mult_dist_interp
    ("trilerp", "apnerf_torch/csrc/trilerp.cu",
     "apnerf/ops/grid.py:298 (no pl.pallas_call: XLA's corner gathers)"),
    ("trilerp_grad", "apnerf_torch/csrc/trilerp.cu",
     "apnerf/ops/grid.py:298 (no pl.pallas_call: the _corner_gather VJP)"),
]
RENDER_KERNELS = ("knn_brute", "knn_count", "knn_radius", "featmlp")
# K6's gates, from readings on an NVIDIA H100 80GB HBM3, 700 W. The control
# is the plain K6 without its per-layer bf16 round. The mean abs error
# tells the two apart: 2.34e-7 / 2.32e-7 (8 / 12 candidates) against the
# control's 1.45e-5 / 1.35e-5; the gate is near their geometric mean. The
# max abs error does not (2.48e-4 / 2.37e-4 against 2.48e-4 / 2.82e-4: a
# rare flip of one bf16 step of a sine, as in K4), so its gate is only a
# ceiling at twice the reading. The fused render against the plain-version
# render on the foreground: 164.11 dB against the control render's
# 146.63 dB; the gate is their midpoint.
K6_MAX_ABS_ERR = 5e-4
K6_MEAN_ABS_ERR = 1.8e-6
FUSED_PSNR_MIN_DB = 155.0
# The two absolute gates above belong to inputs whose |h| stays under 0.18.
# With one candidate a member at weight 1 and the features 30 times larger
# (max |h| 0.55), K6's error is held relative to max |h|: the max read
# 1.9e-3 to 2.1e-3 of it, half of one bf16 step (the control 3.4e-3, so
# again only a ceiling: one step, 2^-8), the mean 0.8e-6 to 1.1e-6 of it
# against the control's 2.1e-4 to 2.3e-4 (the gate is near their geometric
# mean).
K6_REL_MAX_ERR = 2.0 ** -8
K6_REL_MEAN_ERR = 1e-5
# What the WMMA kernels that K4 / K6 replaced read at the bench shapes (K6
# also with 12 candidates) on an NVIDIA H100 80GB HBM3, 700 W: printed
# beside the wgmma chain's times.
K4_EARLIER_MS = 4.461
K6_EARLIER_MS = 4.077
K6_EARLIER_KC12_MS = 6.483
# What the kernels that K1 / K2 / K3 / K5 replace read at the main paths'
# shapes on an NVIDIA H100 80GB HBM3, 700 W (K2 and K5 before their
# redesign, K3 with one thread a query, K1 walking every point): printed
# beside the new times.
K2_EARLIER_MS = {7392: 0.755, 131072: 0.796}
K3_EARLIER_MS = {8192: 0.573, 71680: 0.629}
K1_EARLIER_MS = 0.448
K5_EARLIER_MS = {161: 0.881, 81: 0.349, 41: 1.132}
# Phase 5's avg_procrustes view against the render with the float64 polar
# factor (rounded to fp32) in P1's place, on the foreground. P1's R and
# the exact one differ by fp32 rounding, which the 2^9-frequency position
# encoding of the neighbours' offsets carries into the image; a sample
# that crosses the k-NN radius or the budget's cut changes a pixel by up
# to 4e-3. torch.linalg.svd's R is further from the exact one (2.9e-6 on
# this view's frames, P1's 4.2e-7) and crosses such boundaries where the
# exact factor does not: the plain-version render is printed, not gated.
# Read on an NVIDIA H100 80GB HBM3, 700 W, against the plain-version
# render: P1 115.55 dB with the first kernels, 84.93 with these, the exact
# factor 84.94 (the same 8 pixels beyond 1e-3 as P1); the control, the
# render of the blended frames, 65.26 dB.
PROCRUSTES_PSNR_MIN_DB = 90.0
# Phase 7 holds P1 on the avg_procrustes step's own blended frames as
# phase 3 holds it. One step's gradients through P1 against the plain
# versions' are printed only: the step's loss is discontinuous in the
# warped positions (the pass budget's truncation, the kth radius), and the
# two SVDs' fp32 rounding of R moved it by 1e-6 in one run and 0.35% in
# the next, as much as dropping avg_procrustes does (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md).
N_VIEWS = 3
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): device
# memory bytes/s, bf16 tensor-core and fp32 non-tensor-core FLOP/s. A
# kernel's bound is the larger of its bytes (each input read once, each
# output written once) over the first and its operations over the peak of
# their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
# K5's gates, each between the sound reading and the control (the plain
# K5 on bf16-rounded update rows), both taken on an NVIDIA H100 80GB HBM3,
# 700 W. Phase 3: K5 is bit-equal to the CPU plain version; were it not,
# an fp32 reordering is what the atomics of the plain version on the card
# show, max abs error 2.9e-6 to 8.4e-5, against the control's 0.031 to
# 0.138 (the gate is near their geometric mean). Phase 4: one step's
# feature-grid gradient, K5 vs the plain version, max abs error 1.37e-7 of
# max |grad|, against the control's 2.52e-4 (gate near the geometric
# mean).
K5_MAX_ABS_ERR = 1.5e-3
GRAD_REL_ERR = 6e-6
TRAIN_VIEWS = 6
TRAIN_STEPS = 10
# Phase 4's run refreshes the occupancy grid at step TRAIN_REFRESH, so its
# three segments (before the occupancy switch at 2, before the rebuild at
# 4, after it) each capture a graph and one takes a refresh in place.
TRAIN_REFRESH = 8
# Phases 4 and 7 hold the graphed training step against the eager one
# (``make_train_step``) from one state: the loss equal, each gradient leaf
# under the phase's ceiling of its max |grad| (GRAD_REL_ERR,
# STAGE2_GRAD_REL_ERR), beside two eager runs' own difference; over
# TRAJ_STEPS steps the graphed losses within TRAJ_GAP_MULT times the gap
# of two eager trajectories (0 when those agree bit for bit: both run the
# same kernels in the same order, and only the atomics of the gathers'
# backward reorder fp32 sums); BOTH_WAYS_STEPS steps timed each way.
TRAJ_STEPS = 10
TRAJ_GAP_MULT = 10.0
BOTH_WAYS_STEPS = 20
# Phase 4 also holds a microbatched step both ways: at this many rays the
# JAX package's auto rule (stage1.microbatches) cuts a batch in two.
MICRO_N_RAND = 8192
# Phase 7 (stage 2), from readings on an NVIDIA H100 80GB HBM3, 700 W.
# EXPORT_STEPS: the stage-1 steps after phase 4's at which the export
# brackets canonical_pcd_num at the nerf family's 0.05 thresholds: the
# fewest of the counts tried (100, 200, 300, 400, 600, 800 all bracketed,
# 9,928-10,056 points); the count must lie inside PCD_BAND (10^4 +-25%).
# STAGE2_STEPS: train_pcd steps at full width. STAGE2_MAX_STEPS: the arm's
# cloud is crossed in 99 steps, which would cap the nerf family's
# sample_budget of 192 at 99, a budget that coarse_stride 16 does not
# divide; the family's scenes are crossed in more than 192 steps, so
# train_pcd gets max_steps 192: the budget of 192 and the fused group
# sampler (with K2's group prefilter) that the family's step runs.
EXPORT_STEPS = 100
PCD_BAND = (7500, 12500)
STAGE2_STEPS = 30
MESH_STAGE2_STEPS = 10   # phase 9's train_pcd runs
STAGE2_MAX_STEPS = 192
# One step's gradients through K2 / K3 against the same step through their
# plain versions: the selection is bit-equal, so the loss must be equal
# (the check that separates); only the order of the backward's fp32
# atomics (the neighbour gathers' index_add_) differs, so the gradients'
# gate is a ceiling above that noise: two kernel runs differ by 7.7e-6 to
# 1.05e-5 of the worst leaf's max |grad| at sample_budget 99 (a gate of
# 1e-6 failed at a reading of 4.65e-6 there), by 2.8e-6 to 2.1e-5 at 192
# (kernel vs plain 1.6e-6 to 2.3e-5), hence 1e-4.
STAGE2_GRAD_REL_ERR = 1e-4
# featmlp_train: the step's gradients with K4 in the forward (and the
# recompute backward) against those of the XLA formulation, mean abs
# difference over max |grad|: read 1.69e-5 to 2.09e-5, a ceiling only,
# since neither control separates at the step's gradient (K4's plain
# version without its per-layer bf16 round 1.60e-5 to 1.86e-5, the
# recompute in fp32 1.96e-5 to 2.43e-5: a sample crossing
# fast_color_thres or the kth radius moves the gradient more than
# either). What separates is K4's output against its plain version on
# the step's own inputs (the frame's pose embedding folded into the
# layer-1 bias), under phase 3's K4_REL_MAX_ERR / K4_REL_MEAN_ERR, the
# mean taken over the rows with a neighbour weight.
K4_TRAIN_MEAN_REL_ERR = 1e-4
# A wiring test of FeatMLPTrain's backward: at the step's inputs and one
# cotangent, against the backward of featnet_plain in bf16, which is the
# recompute it runs (reads 0), so a ceiling at 1e-5 of each leaf's max
# |grad|; the recompute in fp32 must lie above it (read 0.0438).
K4_BACKWARD_REL_ERR = 1e-5
# The trained model's render shows foreground: pixels of opacity above
# STAGE2_FG_ACC cover at least half the share of the training view's
# mask (read: 0.0426 against the mask's 0.0295).
STAGE2_FG_ACC = 0.1
# Phase 8 (cli). The scene is written as PNGs of CLI_SIZE and read with the
# nerf family's half_res, as a D-NeRF scene is. CLI_STAGE1_STEPS: phase
# 7's stage-1 count at its export (which bracketed). CLI_SAMPLE_BUDGET: the
# arm is crossed in 99 steps, so the family's budget of 192 would be
# capped at 99, which no coarse_stride that is a multiple of 16 divides;
# 96, the bench scene's budget, is divided by 16 and 32, so stage 2 trains
# on the fused group sampler and the fused repose takes K6.
CLI_SIZE = 800
CLI_TRAIN_VIEWS, CLI_TEST_VIEWS = 6, 2
CLI_STAGE1_STEPS = TRAIN_STEPS + EXPORT_STEPS
CLI_STAGE2_STEPS = 20
CLI_SAMPLE_BUDGET = 96
# CLI_PSNR_MIN_DB: the CLI's render of its trained model (exact k-NN, K4)
# against the same invocation through the plain versions, on the
# foreground, read 112.71 / 113.00 dB, the control render (the plain K4
# without its per-layer bf16 round) 87.39 dB (NVIDIA H100 80GB HBM3,
# 700 W); the gate sits between them. PSNR_MIN_DB's readings belong to
# phase 5's random weights: the trained heads turn one bf16 step of h
# into a larger change of density and colour.
CLI_PSNR_MIN_DB = 100.0
# Phase 10 (wim). WIM_FRAMES frames of the benchmark's ``wim`` scene written
# as a WIM dataset; WIM_STEPS steps of train_pcd on what the loader read.
# The WIM training cameras 1-9 and 11-19 are the scene's ring cameras 0-17;
# the test cameras 0 and 10 sit half-way between ring cameras 17 and 0, 8
# and 9.
WIM_FRAMES = 30
WIM_STEPS = 20
WIM_SEED = 4100000003
WIM_TRAIN_CAMS = list(range(1, 10)) + list(range(11, 20))
WIM_TEST_CAMS = {0: -0.5, 10: 8.5}   # camera id: place on the ring


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def count_wgmma(so) -> str:
    """How many warpgroup matrix products (HGMMA in SASS) the built library
    holds, by kernel family: K4's (both fronts, each under K4's mark
    ``RowFront``) and K6's chain must be made of them."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if not tool.exists():
        raise RuntimeError(f"{tool} not found: cannot show that K4 and K6 "
                           "issue wgmma")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = ("K4 (GatherRowFront)" if "GatherRowFront" in m.group(1)
                  else "K4 (RowFront)" if "RowFront" in m.group(1) else
                  "K6 (SubgroupFront)" if "SubgroupFront" in m.group(1)
                  else "other kernels")
        elif fn and "HGMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
    if not (counts.get("K4 (RowFront)") and counts.get("K4 (GatherRowFront)")
            and counts.get("K6 (SubgroupFront)")):
        raise AssertionError(f"build: no wgmma in K4 / K6: {counts}")
    return "HGMMA (wgmma) instructions in the library's SASS: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items()))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Report:
    """What the kernels JSON line says of each kernel: times and bounds
    add up over the shapes a kernel is recorded at (the calls one chunk or
    one training step makes), the error is the worst."""

    def __init__(self):
        self.rows = {}

    def add(self, name, shape, ms, plain_ms, err, moved_bytes, ops, ops_type,
            library_ms=None):
        t_bytes = 1e3 * moved_bytes / HBM_BYTES_PER_S
        t_ops = 1e3 * ops / PEAK_FLOPS[ops_type]
        bound = max(t_bytes, t_ops)
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        print(f"kernel {name} {shape}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms{lib}, bound {bound:.5f} ms "
              f"({moved_bytes / 1e6:.3f} MB -> {t_bytes:.5f} ms, "
              f"{ops / 1e9:.3f} G{ops_type} op -> {t_ops:.5f} ms), "
              f"max_abs_err {err:g}", flush=True)
        row = self.rows.setdefault(name, dict(
            ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
            library_ms=None, _bytes=0.0, _ops=0.0))
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += bound
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["_bytes"] += t_bytes
        row["_ops"] += t_ops
        if library_ms is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + library_ms

    def json_rows(self, by_path):
        """``by_path``: each main path's launch counts, taken with the
        counts at 0 just before it; a kernel's ``launches`` is their sum,
        ``launches_by_path`` its count on each path that launched it."""
        out = []
        for name, src, rep in KERNELS:
            row = dict(self.rows[name])
            by = "operations" if row.pop("_ops") >= row.pop("_bytes") \
                else "bytes"
            paths = {p: c[name] for p, c in by_path.items()
                     if c.get(name)}
            out.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=sum(paths.values()),
                            launches_by_path=paths, bound_by=by, **row))
        return out


def cuda_ms(fn, reps=7):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event runs, after
    one warm-up; returns (median_ms, last result)."""
    import torch
    out = fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def featmlp_fp32_layers(rel, feat, w, wts):
    """Control for K4's gate: its plain version with the activations kept
    in fp32 between layers (no bf16 round after each layer) -- what a K4
    that skipped the rounding would give."""
    import torch
    from apnerf_torch.ops.encoding import poc_fre, poc_freqs
    from apnerf_torch.ops.nn import leaky_relu
    w1, b1, wl, bl, n_pe, P_pad = wts[:6]
    M, K, _ = rel.shape
    F = feat.shape[-1]
    e = poc_fre(rel.reshape(M * K, 3).float(), poc_freqs(n_pe, rel.device))
    e = torch.nn.functional.pad(e, (0, P_pad - e.shape[1]))
    a = torch.cat([e.to(torch.bfloat16), feat.reshape(M * K, F)], dim=-1)
    h = leaky_relu(a.float() @ w1.float() + b1)
    for i in range(wl.shape[0]):
        h = leaky_relu(h @ wl[i].float() + bl[i])
    return (h.reshape(M, K, F) * w.reshape(M, K, 1).float()).sum(1)


def bf16_step(torch, x):
    """The spacing of bf16 numbers at |x| (0 where x is 0)."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))


def last_layer_rows(rel, feat, wts):
    """The plain version's last-layer outputs (bf16-rounded, in fp32), one
    row a neighbour: [M, K, F]."""
    import torch
    from apnerf_torch.kernels import featmlp as fm
    M, K, _ = rel.shape
    F = feat.shape[-1]
    ones = torch.ones(M * K, 1, device=rel.device)
    return fm.featmlp_plain(rel.reshape(M * K, 1, 3),
                            feat.reshape(M * K, 1, F), ones,
                            wts).reshape(M, K, F)


def beyond_last_round(torch, d, f, w):
    """Largest amount by which |h - plain h| (``d``, [M, F]) exceeds what
    flipped last-layer rounds may move it by: one bf16 step of each
    neighbour's output ``f`` [M, K, F], times the neighbour's |w|."""
    allow = (bf16_step(torch, f) * w.abs().float()[..., None]).sum(1)
    return float((d - allow).clamp_min(0).max())


def scatter_bf16_rows(idx, upd, n_rows, transposed=False):
    """Control for K5's gates: its plain version with every update row
    rounded to bf16 first (the JAX package's lossy APNERF_SCATTER_BF16
    mode)."""
    import torch
    from apnerf_torch.kernels import scatter as sc
    return sc.sorted_window_accumulate_plain(
        idx, upd.to(torch.bfloat16).float(), n_rows, transposed)


def agg_fp32_layers(q_sub, nbr, rot, feat, wts, K, eps):
    """Control for K6's gates: its plain version with the activations kept
    in fp32 between layers."""
    from apnerf_torch.kernels import agg
    rc, w, kd2 = agg.subgroup_geometry(q_sub, nbr, rot, K, eps)
    S, share, kc = w.shape
    F = feat.shape[-1]
    h = featmlp_fp32_layers(
        rc.reshape(S * share, kc, 3),
        feat[:, None].expand(S, share, kc, F).reshape(S * share, kc, F),
        w.reshape(S * share, kc), wts)
    return h.reshape(S, share, F), kd2


def gather_k4_rounding(q, idx, tabs, eps, live=None, want_w=False):
    """Control for K4's gathering front: its plain version in K4's own
    rounding (the bias added in fp32 before the round, the pose term folded
    into it) -- what switching K4 on in the exact render would give."""
    from apnerf_torch.kernels import featmlp as fm
    geo, feat, wts = tabs
    n, K = idx.shape
    rel, w, kth = fm.gather_rows_plain(q, idx, geo, eps)
    fk = feat.index_select(0, idx.reshape(-1).long()).reshape(n, K, -1)
    b1 = wts.b1 if wts.pose is None else wts.b1 + wts.pose
    k4 = fm.FeatMLPWeights(wts.w1, b1, wts.wl, wts.bl, wts.n_pe, wts.P_pad,
                           wts.image)
    return fm.featmlp_plain(rel, fk, w, k4), kth, w if want_w else None


@contextmanager
def plain_kernels(featmlp=None, scatter=None, agg=None, gather=None):
    """Route every kernel wrapper to its plain PyTorch version (on the
    card) -- for the comparison runs of this script only. ``featmlp`` /
    ``scatter`` / ``agg`` / ``gather`` replace K4's / K5's / K6's / K4's
    gathering front's plain version (the controls)."""
    from apnerf_torch.kernels import agg as ag, featmlp as fm, \
        knn_brute as kb, knn_cells as kc, procrustes as pk, \
        scatter as sc, trilerp as tl
    from apnerf_torch.ops import grid as gridops
    with mock.patch.object(kb, "knn_brute_cuda", kb.knn_brute_plain), \
            mock.patch.object(tl, "mult_dist_interp_cuda",
                              gridops.mult_dist_interp_plain), \
            mock.patch.object(pk, "procrustes_cuda", pk.procrustes_plain), \
            mock.patch.object(pk, "procrustes_grad_cuda",
                              pk.procrustes_grad_plain), \
            mock.patch.object(ag, "fused_subgroup_agg_cuda",
                              agg or ag.fused_subgroup_agg_plain), \
            mock.patch.object(kc, "knn_count_cuda",
                              lambda q, t, r2: kc.knn_count_plain(
                                  q, t["pts_sorted"], r2)), \
            mock.patch.object(kc, "knn_radius_cuda",
                              lambda q, t, k, r2: kc.knn_radius_plain(
                                  q, t["pts_sorted"], k, r2)), \
            mock.patch.object(fm, "featmlp_cuda",
                              featmlp or fm.featmlp_plain), \
            mock.patch.object(fm, "featmlp_gather_cuda",
                              gather or fm.featmlp_gather_plain), \
            mock.patch.object(sc, "sorted_window_accumulate_cuda",
                              scatter or sc.sorted_window_accumulate_plain):
        yield


def psnr(a, b, mask=None) -> float:
    """PSNR of ``a`` against ``b`` (images in [0, 1]) over the pixels of
    ``mask`` (all pixels without one)."""
    d2 = ((a - b) ** 2).sum(-1) / a.shape[-1]
    mse = float(d2.mean() if mask is None else d2[mask].mean())
    return float("inf") if mse == 0 else -10.0 * float(np.log10(mse))


def phase_kernels(torch, pcd, report):
    """Phase 3: each kernel vs its plain version at main-path shapes."""
    from apnerf_torch.kernels import featmlp as fm, knn_brute as kb, \
        knn_cells as kc
    from apnerf_torch.ops.knn import morton_codes
    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(0)
    p = torch.tensor(pcd, device=dev)
    tabs = kc.build_point_tables(p)

    def queries(n, spread, g=g):
        i = torch.randint(0, p.shape[0], (n,), generator=g).to(dev)
        q = p[i] + spread * torch.randn(n, 3, generator=g).to(dev)
        order = torch.argsort(morton_codes(q, tabs["p_lo"], tabs["p_hi"]),
                              stable=True)
        return q[order].contiguous()

    # a squared distance is 3 subtractions, 3 products, 2 additions
    PAIR_FLOP = 8

    def pairs_examined(q, r2, qb, tables=tabs):
        """Query-point pairs of the tiles within the radius of each block
        of qb queries (K2's warps scan those of their own box: qb = the
        warp's queries)."""
        _, cnt = kc.candidate_tiles(q, tables, r2, qb=qb)
        return int(cnt.sum()) * qb * tables["pts_t"].shape[2]

    from apnerf_torch.kernels import build
    lib = build.load_library()
    for n in (1, kc.FEW_QUERIES - 1, kc.FEW_QUERIES, 1 << 20):
        if not (lib.knn_count_block(n) == kc.count_block(n)
                and lib.knn_radius_lanes(n) == kc.topk_lanes(n)):
            raise AssertionError("knn_cells.count_block / topk_lanes are not "
                                 "the kernels'")

    phase_knn_brute(torch, p, tabs, report, PAIR_FLOP)
    # group midpoints (7,392, prefilter radius) and samples (131,072)
    stepdist = 0.5 * 0.012
    thr = float((np.sqrt(RADIUS) + 31 / 2 * stepdist) ** 2)
    for n, r2 in ((7392, thr), (131072, RADIUS)):
        q = queries(n, 0.06)
        ms, c = cuda_ms(lambda: kc.knn_count(q, tabs, r2))
        pms, pc = cuda_ms(lambda: kc.knn_count_plain(q, tabs["pts_sorted"],
                                                     r2))
        if not torch.equal(c, pc):
            raise AssertionError(f"knn_count differs at M={n}")
        qb = kc.count_block(n)
        per_warp = 32 * qb // kc.THREADS
        pairs = pairs_examined(q, r2, per_warp)
        report.add("knn_count", f"M={n}, {qb} queries a block", ms, pms, 0.0,
                   nbytes(q, tabs["pts_t"], tabs["t_lo"], tabs["t_hi"], c),
                   PAIR_FLOP * pairs, "fp32")
        print_front_end("knn_count", f"M={n}", ms, K2_EARLIER_MS[n],
                        lambda: kc.knn_count(q, tabs, r2), pairs,
                        [(f"its {qb}-query blocks' listing",
                          pairs_examined(q, r2, qb)),
                         ("256 queries a block", pairs_examined(q, r2, 256))],
                        PAIR_FLOP, basis=f"of the tiles within the radius "
                        f"of each warp's {per_warp} queries, which its warps "
                        f"scan")

    r2_sel = float((np.sqrt(RADIUS) + 15 * stepdist / 2) ** 2)
    for n, r2 in ((8192, r2_sel), (71680, RADIUS)):
        q = queries(n, 0.03)
        ms, (d, i) = cuda_ms(lambda: kc.knn_radius(q, tabs, 8, r2))
        pms, (pd, pi) = cuda_ms(lambda: kc.knn_radius_plain(
            q, tabs["pts_sorted"], 8, r2))
        if not (torch.equal(d, pd) and torch.equal(i, pi)):
            raise AssertionError(f"knn_radius differs at M={n}")
        lms, _ = cuda_ms(lambda: cdist_topk(torch, q, tabs["pts_sorted"], 8,
                                            r2))
        qb = kc.radius_block(n)
        scan = {}
        kc.knn_radius_cuda(q, tabs, 8, r2, scan_out=scan)
        pairs = scanned_pairs(scan, n, tabs)
        report.add("knn_radius", f"M={n} k=8, {qb} queries a block", ms, pms,
                   0.0, nbytes(q, tabs["pts_t"], tabs["t_lo"], tabs["t_hi"],
                               d, i),
                   PAIR_FLOP * pairs, "fp32", library_ms=lms)
        print_front_end("knn_radius", f"M={n} k=8", ms, K3_EARLIER_MS[n],
                        lambda: kc.knn_radius(q, tabs, 8, r2), pairs,
                        [(f"its {qb}-query blocks' listing",
                          pairs_examined(q, r2, qb)),
                         ("256 queries a block", pairs_examined(q, r2, 256))],
                        PAIR_FLOP, library_ms=lms,
                        earlier="the one-thread-a-query kernel it replaces "
                                "read")
        print(f"kernel knn_radius M={n}: with k = 12, queued: "
              f"{queued_ms(lambda: kc.knn_radius(q, tabs, 12, r2)):.3f} ms",
              flush=True)
    # a generator of its own: the phases below keep their draws
    phase_knn_shapes(torch, p, tabs, queries,
                     torch.Generator(device="cpu").manual_seed(5))

    layers = phase_featmlp(torch, report, g)
    phase_gather(torch, report, p, tabs, queries,
                 torch.Generator(device="cpu").manual_seed(11))
    phase_agg(torch, report, layers, g)
    phase_chain_shapes(torch, g)
    phase_scatter(torch, report)
    phase_procrustes(torch, report)
    phase_trilerp(torch, report)


# P1 (special Procrustes). Its inputs: 10^4 matrices, 2,000 each of exact
# rotations (singular values 1, 1, 1), blends of two rotations (1, c, c),
# of three, random matrices and reflections (det < 0). R is held where
# s2 + d s3 >= P1_MIN_COND (nearer a rank-deficient reflection R is
# ill-conditioned by 1 / (s2 + d s3) in any fp32 SVD), against the polar
# factor in float64, the kernel's error beside the plain version's
# (torch.linalg.svd); the gradient against the closed form in float64 on
# the float64 factors, each matrix's error relative to max(1, its max
# |dM|). The gates are ceilings over the plain version's own errors,
# which the kernel must not exceed by more than P1_ERR_MULT.
P1_COUNT = 10000
P1_MIN_COND = 1e-3
P1_ERR_MULT = 4.0
# Phase 3 also times P1 at P1_BIG matrices, where bytes bind, and holds
# every P1_BIG_STRIDE-th of them (all blocks and lanes) to float64 by
# procrustes_ok's rule. The first kernels' readings (128 threads a block,
# six fixed sweeps with IEEE sqrtf and division, strided scalar accesses),
# printed beside these kernels': ptxas' usage from build.log, and a launch
# inside a CUDA graph of 20, forward / backward, ms; this phase's own
# lines, run on a tree that holds their source, on an NVIDIA H100 80GB
# HBM3, 700 W.
P1_BIG = 1 << 20
P1_BIG_STRIDE = 97
P1_EARLIER_PTXAS = {
    "procrustes_kernel": "40 registers, 0 bytes stack frame, 0 / 0 bytes "
                         "spill stores / loads",
    "procrustes_grad_kernel": "46 registers, 0 bytes stack frame, 0 / 0 "
                              "bytes spill stores / loads"}
P1_EARLIER_GRAPHED_MS = {P1_COUNT: (0.0083, 0.0031),
                         P1_BIG: (0.3259, 0.0807)}
# the operations of one matrix, at most (a Jacobi rotation skipped where
# two columns are already orthogonal does fewer): 18 rotations of ~64
# flops, the sort, 3 Givens rotations of ~42 and R's 27 FMAs; the
# backward's four 3 x 3 products and K
P1_FWD_FLOP = 1350
P1_BWD_FLOP = 240


def procrustes_inputs(n=P1_COUNT, seed=3):
    """``n`` float32 3 x 3 matrices in five kinds, a fifth each (exact
    rotations, two- and three-rotation blends, random, reflections), and a
    cotangent; numpy."""
    rng = np.random.default_rng(seed)
    k = -(-n // 5)

    def rotations():
        axis = rng.normal(size=(k, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        th = rng.uniform(0.0, np.pi, k)[:, None, None]
        s = np.zeros((k, 3, 3))
        s[:, 0, 1], s[:, 0, 2], s[:, 1, 2] = -axis[:, 2], axis[:, 1], \
            -axis[:, 0]
        s = s - s.transpose(0, 2, 1)
        return np.eye(3) + np.sin(th) * s + (1 - np.cos(th)) * (s @ s)

    r0, r1, r2 = rotations(), rotations(), rotations()
    w = rng.dirichlet([1.0, 1.0, 1.0], k)[:, :, None, None]
    m = np.concatenate([r0, 0.5 * r0 + 0.5 * r1,
                        w[:, 0] * r0 + w[:, 1] * r1 + w[:, 2] * r2,
                        rng.normal(size=(k, 3, 3)),
                        -r1 + 0.3 * rng.normal(size=(k, 3, 3))])[:n]
    return m.astype(np.float32), rng.normal(size=m.shape).astype(np.float32)


def polar64(m):
    """The JAX function's R, in float64, and its s2 + d s3; numpy."""
    u, s, vt = np.linalg.svd(m.astype(np.float64))
    d = np.linalg.det(u @ vt)
    ones = np.ones_like(d)
    return (u * np.stack([ones, ones, d], -1)[:, None, :]) @ vt, \
        s[:, 1] + d * s[:, 2]


def grad64(m, g):
    """The closed-form gradient of <R, G> in float64 on the float64
    factors; numpy."""
    u, s, vt = np.linalg.svd(m.astype(np.float64))
    d = np.linalg.det(u @ vt)
    u[:, :, 2] *= d[:, None]
    s = s * np.stack([np.ones_like(d), np.ones_like(d), d], -1)
    v = vt.transpose(0, 2, 1)
    a = u.transpose(0, 2, 1) @ g.astype(np.float64) @ v
    with np.errstate(divide="ignore", invalid="ignore"):
        kk = (a - a.transpose(0, 2, 1)) / (s[:, :, None] + s[:, None, :])
    kk[:, [0, 1, 2], [0, 1, 2]] = 0.0
    return u @ kk @ v.transpose(0, 2, 1)


def ptxas_usage(text: str,
                pattern: str = r"(procrustes(?:_grad)?_kernel)") -> dict:
    """Kernel -> "N registers, N bytes stack frame, N / N bytes spill
    stores / loads" for the kernels whose mangled name ``pattern`` matches
    (P1's two by default), from ``-Xptxas -v`` output."""
    out, fn = {}, None
    for line in text.splitlines():
        if "Function properties for" in line:
            m = re.search(pattern, line)
            fn = m.group(1) if m else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if fn and m:
            out[fn] = (f"{m.group(1)} bytes stack frame, {m.group(2)} / "
                       f"{m.group(3)} bytes spill stores / loads")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if fn and m and fn in out:
            out[fn] = f"{m.group(1)} registers, " + out[fn]
            fn = None
    return out


def capture_ok(torch, fn):
    """Whether ``fn`` captures into a CUDA graph (after a warm-up on a side
    stream): (True, "") or (False, the error's first line)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        return True, ""
    except RuntimeError as e:
        torch.cuda.synchronize()
        return False, f"{type(e).__name__}: {str(e).splitlines()[0]}"


def procrustes_errors(torch, m, g):
    """P1 and its plain version on the matrices ``m`` with the cotangent
    ``g`` (numpy [n, 3, 3]), against float64 (``procrustes_summary``)."""
    from apnerf_torch.kernels import procrustes as pk
    M = torch.tensor(m, device=DEVICE)
    G = torch.tensor(g, device=DEVICE)
    R, U, s, V = pk.procrustes_cuda(M)
    Rp, Up, sp, Vp = pk.procrustes_plain(M)
    dM = pk.procrustes_grad_cuda(G, U, s, V)
    dMp = pk.procrustes_grad_plain(G, Up, sp, Vp)
    return procrustes_summary(m, g, *(x.cpu().numpy()
                                      for x in (R, Rp, dM, dMp)))


def procrustes_summary(m, g, rk, rp, gk, gp):
    """The kernel's R and dM (``rk``, ``gk``) and the plain version's
    (``rp``, ``gp``) on ``m`` and ``g`` against float64: R's max abs error
    where s2 + d s3 >= P1_MIN_COND, each way, and dM's relative to max(1,
    max |dM|) a matrix; kernel vs plain; det R and R R^T; finiteness."""
    R64, cond = polar64(m)
    keep = cond >= P1_MIN_COND
    g64 = grad64(m, g)
    scale = np.maximum(1.0, np.abs(g64).max((1, 2)))[:, None, None]
    with np.errstate(invalid="ignore"):
        gerr_k = float((np.abs(gk - g64) / scale)[keep].max())
        gerr_p = float((np.abs(gp - g64) / scale)[keep].max())
    det = np.linalg.det(rk.astype(np.float64))
    return dict(
        n=len(m), left=int((~keep).sum()),
        err_k=float(np.abs(rk - R64)[keep].max()),
        err_p=float(np.abs(rp - R64)[keep].max()),
        kp=float(np.abs(rk - rp)[keep].max()), gerr_k=gerr_k, gerr_p=gerr_p,
        gkp=float(np.abs(gk - gp)[keep].max()),
        det=(float(det.min()), float(det.max())),
        orth=float(np.abs(rk @ rk.transpose(0, 2, 1) - np.eye(3)).max()),
        finite=bool(np.isfinite(rk).all() and np.isfinite(gk).all()))


def procrustes_ok(e) -> bool:
    """P1 within P1_ERR_MULT of the plain version's errors (plus 1e-6),
    det R within 1e-5 of 1, and finite."""
    return (e["finite"] and e["err_k"] <= P1_ERR_MULT * e["err_p"] + 1e-6
            and e["gerr_k"] <= P1_ERR_MULT * e["gerr_p"] + 1e-6
            and max(abs(d - 1.0) for d in e["det"]) < 1e-5)


def procrustes_text(e) -> str:
    return (f"{e['left']} of {e['n']} matrices with s2 + d s3 < "
            f"{P1_MIN_COND:g} left out of the errors; R vs float64: kernel "
            f"{e['err_k']:.3g}, plain (torch.linalg.svd) {e['err_p']:.3g} "
            f"(gate {P1_ERR_MULT:g} x plain + 1e-6); kernel vs plain "
            f"{e['kp']:.3g}; det R {e['det'][0]:.7f}-{e['det'][1]:.7f}, max "
            f"|R R^T - I| {e['orth']:.3g}; dM vs the float64 closed form, "
            f"relative to max(1, max |dM|) a matrix: kernel "
            f"{e['gerr_k']:.3g}, plain {e['gerr_p']:.3g} (gate "
            f"{P1_ERR_MULT:g} x plain + 1e-6), finite {e['finite']}")


def phase_procrustes(torch, report):
    """P1 at the main path's shape (10^4 frames, the bench cloud's count):
    the forward and the backward against their plain versions and against
    float64, both timed beside their bounds (bytes) and, for the forward,
    beside ``torch.linalg.svd`` + ``det``; inside a CUDA graph as the
    frame and step graphs run them, beside the earlier kernels; whether
    ``torch.linalg.svd`` and P1 capture into a CUDA graph; ptxas' reading
    of both kernels. Then the same times at 2^20 matrices, where bytes
    bind, and every P1_BIG_STRIDE-th matrix against float64."""
    from apnerf_torch.kernels import build, procrustes as pk
    log = build.BUILD_DIR / "build.log"
    usage = ptxas_usage(log.read_text() if log.exists() else "")
    for kernel, earlier in P1_EARLIER_PTXAS.items():
        print(f"build: ptxas {kernel}: {usage.get(kernel, 'not found')}; "
              f"the earlier kernel's: {earlier}", flush=True)
    m, g = procrustes_inputs(P1_COUNT)
    e = procrustes_errors(torch, m, g)
    M = torch.tensor(m, device=DEVICE)
    G = torch.tensor(g, device=DEVICE)
    ms, (R, U, s, V) = cuda_ms(lambda: pk.procrustes_cuda(M))
    pms, (_, Up, sp, Vp) = cuda_ms(lambda: pk.procrustes_plain(M))
    lms, _ = cuda_ms(lambda: torch.linalg.det(torch.linalg.svd(M)[0]))
    bms, dM = cuda_ms(lambda: pk.procrustes_grad_cuda(G, U, s, V))
    bpms, _ = cuda_ms(lambda: pk.procrustes_grad_plain(G, Up, sp, Vp))
    q_f = queued_ms(lambda: pk.procrustes_cuda(M))
    q_b = queued_ms(lambda: pk.procrustes_grad_cuda(G, U, s, V))
    g_f = graphed_ms(lambda: pk.procrustes_cuda(M))
    g_b = graphed_ms(lambda: pk.procrustes_grad_cuda(G, U, s, V))
    p1_cap, p1_why = capture_ok(torch, lambda: pk.procrustes_grad_cuda(
        G, *pk.procrustes_cuda(M)[1:]))
    svd_cap, svd_why = capture_ok(torch, lambda: torch.linalg.svd(M))
    n = m.shape[0]
    report.add("procrustes", f"P={n}", ms, pms, e["kp"],
               nbytes(M, R, U, s, V), P1_FWD_FLOP * n, "fp32", library_ms=lms)
    report.add("procrustes_grad", f"P={n}", bms, bpms, e["gkp"],
               nbytes(G, U, s, V, dM), P1_BWD_FLOP * n, "fp32")
    e_f, e_b = P1_EARLIER_GRAPHED_MS[n]
    print(f"kernel procrustes P={n}: queued {q_f:.4f} ms a call (20 back to "
          f"back), backward queued {q_b:.4f} ms; in a CUDA graph of 20 "
          f"launches {g_f:.4f} / {g_b:.4f} ms a launch forward / backward "
          f"(the earlier kernels {e_f:.4f} / {e_b:.4f}); max_abs_err over the "
          f"matrices kept; {procrustes_text(e)}; torch.linalg.svd captures "
          f"into a CUDA graph: {svd_cap} {svd_why}; P1 forward + backward "
          f"capture: {p1_cap} {p1_why}", flush=True)
    if not (procrustes_ok(e) and p1_cap):
        raise AssertionError(f"procrustes: {e}, capture {p1_cap}")
    del M, G, R, U, s, V, dM, Up, sp, Vp

    # 2^20 matrices: timed; every P1_BIG_STRIDE-th held to float64 beside
    # the plain version, as at 10^4; all outputs finite
    n = P1_BIG
    m, g = procrustes_inputs(n)
    M = torch.tensor(m, device=DEVICE)
    G = torch.tensor(g, device=DEVICE)
    ms, (R, U, s, V) = cuda_ms(lambda: pk.procrustes_cuda(M))
    pms, (Rp, Up, sp, Vp) = cuda_ms(lambda: pk.procrustes_plain(M))
    lms, _ = cuda_ms(lambda: torch.linalg.det(torch.linalg.svd(M)[0]))
    bms, dM = cuda_ms(lambda: pk.procrustes_grad_cuda(G, U, s, V))
    bpms, dMp = cuda_ms(lambda: pk.procrustes_grad_plain(G, Up, sp, Vp))
    q_f = queued_ms(lambda: pk.procrustes_cuda(M))
    q_b = queued_ms(lambda: pk.procrustes_grad_cuda(G, U, s, V))
    g_f = graphed_ms(lambda: pk.procrustes_cuda(M))
    g_b = graphed_ms(lambda: pk.procrustes_grad_cuda(G, U, s, V))
    pick = slice(0, n, P1_BIG_STRIDE)
    e = procrustes_summary(m[pick], g[pick], *(x[pick].cpu().numpy()
                                               for x in (R, Rp, dM, dMp)))
    e["finite"] = bool(torch.isfinite(R).all() and torch.isfinite(dM).all())
    del m, g
    e_f, e_b = P1_EARLIER_GRAPHED_MS[n]
    for name, t, q, gr, plain, lib, moved, early in (
            ("procrustes", ms, q_f, g_f, pms, lms, nbytes(M, R, U, s, V),
             e_f),
            ("procrustes_grad", bms, q_b, g_b, bpms, None,
             nbytes(G, U, s, V, dM), e_b)):
        bound = 1e3 * moved / HBM_BYTES_PER_S
        lib_text = ("" if lib is None else
                    f", torch.linalg.svd + det {lib:.3f} ms")
        print(f"kernel {name} P={n}: {t:.4f} ms a call, queued {q:.4f}, in "
              f"a CUDA graph of 20 {gr:.4f} (the earlier kernel {early:.4f}); "
              f"bound {bound:.4f} ms ({moved / 1e6:.1f} MB, bytes): "
              f"{100 * bound / t:.1f}% of a call, {100 * bound / gr:.1f}% "
              f"graphed; plain {plain:.3f} ms{lib_text}", flush=True)
    print(f"kernel procrustes P={n}, every {P1_BIG_STRIDE}th matrix: "
          f"{procrustes_text(e)} (finite: all {n})", flush=True)
    if not procrustes_ok(e):
        raise AssertionError(f"procrustes at P={n}: {e}")


# G1 (the stage-1 multi-scale trilinear sample) at the stage-1 step's
# shape: G1_M samples on a G1_SHAPE x G1_C grid, G1_LIVE of them along rays
# (some leaving the bbox), the rest at one point with a zero cotangent (an
# active-sample budget's unfilled slots). G1_LIVE is the share of rows with
# a nonzero cotangent in the benchmark's zju-stage1-train steps, counted
# inside the graphed step over its measured window: 7.3% and 8.4% on two
# seeds (NVIDIA H100 80GB HBM3, 700 W). A step launches G1's forward, its
# backward's three kernels and K5 three times (C <= 12: one channel chunk).
G1_M = 1 << 20
G1_SHAPE = (160, 160, 160)
G1_C = 12
G1_LIVE = 0.08
G1_STEP_LAUNCHES = {"trilerp": 1, "trilerp_grad": 3, "scatter": 3}
G1_KERNELS = ("trilerp_kernel", "trilerp_grad_kernel", "trilerp_rows_kernel",
              "trilerp_fold_kernel")


def trilerp_inputs(torch, seed=21):
    """G1's inputs at the step's shape: (grid, xyz, lo, hi, cotangent)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    grid = 0.1 * torch.randn(*G1_SHAPE, G1_C, generator=g)
    n_live = int(G1_LIVE * G1_M)
    n_rays = 4096
    per_ray = -(-n_live // n_rays)
    start = torch.rand(n_rays, 3, generator=g) * 1.1 - 0.05
    d = torch.randn(n_rays, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.arange(per_ray) / per_ray
    unit = (start[:, None] + d[:, None] * t[None, :, None]).reshape(-1, 3)
    unit = torch.cat([unit[:n_live], unit[:1].expand(G1_M - n_live, 3)])
    lo, hi = torch.tensor([-1.0, -1.2, -0.8]), torch.tensor([1.0, 0.9, 1.3])
    xyz = lo + unit * (hi - lo)
    cot = torch.randn(G1_M, 3 * G1_C, generator=g)
    cot[n_live:] = 0.0
    return tuple(x.to(DEVICE) for x in (grid, xyz, lo, hi, cot))


def trilerp_dunit64(torch, grid, unit, g):
    """d/dunit of ``sum(out * g)`` for G1's sample, in float64 at the
    float32 cell coordinates that G1 and the plain path both take (``u =
    unit * last``, ``frac = u - floor(u)``, in float32): the yardstick of
    their d/dunit, free of the float32 coordinates, which neither can
    improve on."""
    from apnerf_torch.kernels.trilerp import STRIDES
    from apnerf_torch.ops.grid import _corner_tables, pad_to_mult4
    gp = pad_to_mult4(grid.detach().double())
    C = grid.shape[3]
    unit = unit.detach()
    out = torch.zeros(unit.shape, dtype=torch.float64, device=unit.device)
    for si, s in enumerate(STRIDES):
        gs = gp[::s, ::s, ::s]
        dims = gs.shape[:3]
        last = torch.tensor([n - 1.0 for n in dims], device=unit.device)
        u = unit * last
        i0f = torch.floor(u)
        i0 = i0f.to(torch.int64)
        frac = (u - i0f).double()
        lins, _ = _corner_tables(dims, i0, frac)
        gsc = g[:, si * C:(si + 1) * C].double()
        dw = (gs.reshape(-1, C)[lins] * gsc[:, None, :]).sum(-1)   # [M, 8]
        for k in range(8):
            d = (k >> 2 & 1, k >> 1 & 1, k & 1)
            w = [frac[:, a] if d[a] else 1.0 - frac[:, a] for a in range(3)]
            ok = torch.ones_like(dw[:, k], dtype=torch.bool)
            for a in range(3):
                ok &= (i0[:, a] + d[a] >= 0) & (i0[:, a] + d[a] < dims[a])
            term = torch.where(ok, dw[:, k], torch.zeros_like(dw[:, k]))
            for a in range(3):
                b, c = (x for x in range(3) if x != a)
                sign = 1.0 if d[a] else -1.0
                out[:, a] += sign * term * w[b] * w[c] * (dims[a] - 1)
    return out


def phase_trilerp(torch, report):
    """G1 at the stage-1 step's shape against the plain path on the card:
    the forward and the grid gradient bit-equal (the zero pattern too,
    which the masked Adam reads), d/dxyz no further from float64 (at the
    float32 cell coordinates both take, ``trilerp_dunit64``) than the
    plain path's own; the launches of a forward and backward; whether both
    capture into a CUDA graph. Times: the forward a call, queued, in a CUDA
    graph; the whole backward; each kernel's device time from the
    profiler; the bytes bound of the forward and of the backward's three
    kernels; beside the plain path and ``F.grid_sample`` on the padded,
    strided grids (the yardstick, which the port never calls)."""
    import torch.nn.functional as F
    from apnerf_torch import kernels
    from apnerf_torch.kernels import build, trilerp as tl
    from apnerf_torch.ops import grid as gridops
    log = build.BUILD_DIR / "build.log"
    usage = ptxas_usage(log.read_text() if log.exists() else "",
                        r"(trilerp_(?:grad_|rows_|fold_)?kernel(?:ILi\dEE)?)")
    for name, text in sorted(usage.items()) or [("trilerp", "not found")]:
        print(f"build: ptxas {name}: {text}", flush=True)
    grid, xyz, lo, hi, cot = trilerp_inputs(torch)
    M, C = xyz.shape[0], grid.shape[3]

    def fwd(fn):
        with torch.no_grad():
            return fn(grid, xyz, lo, hi)

    gr = grid.clone().requires_grad_(True)
    xr = xyz.clone().requires_grad_(True)

    def fwd_bwd(fn):
        # the output detached: no graph outlives a call (a leaf's gradient
        # node made on one stream would sync a capture on another with it)
        out = fn(gr, xr, lo, hi)
        dg, dx = torch.autograd.grad(out, (gr, xr), cot)
        return out.detach(), dg, dx

    kernels.reset_launches()
    out_k, dg_k, dx_k = fwd_bwd(tl.mult_dist_interp_cuda)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    out_p, dg_p, dx_p = fwd_bwd(gridops.mult_dist_interp_plain)
    dx64 = trilerp_dunit64(torch, grid, (xyz - lo) / (hi - lo), cot) / \
        (hi - lo).double()
    err_k = float((dx_k.double() - dx64).abs().max())
    err_p = float((dx_p.double() - dx64).abs().max())
    fwd_equal = torch.equal(out_k, out_p)
    grad_equal = torch.equal(dg_k, dg_p)
    zeros_equal = torch.equal(dg_k == 0, dg_p == 0)
    n_diff = int((dg_k != dg_p).sum())
    # the rows' errors, measured: the forward and the grid gradient against
    # the plain path (0 where bit-equal), d/dxyz against it too
    out_gap = float((out_k - out_p).abs().max())
    dg_gap = float((dg_k - dg_p).abs().max())
    dx_gap = float((dx_k - dx_p).abs().max())
    del out_p, dg_p, dx_p, dx64
    cap, why = capture_ok(torch, lambda: fwd_bwd(tl.mult_dist_interp_cuda))

    ms, _ = cuda_ms(lambda: fwd(tl.mult_dist_interp_cuda))
    q_f = queued_ms(lambda: fwd(tl.mult_dist_interp_cuda))
    g_f = graphed_ms(lambda: fwd(tl.mult_dist_interp_cuda), launches=5)
    fb_ms, _ = cuda_ms(lambda: fwd_bwd(tl.mult_dist_interp_cuda))
    pms, _ = cuda_ms(lambda: fwd(gridops.mult_dist_interp_plain))
    pfb_ms, _ = cuda_ms(lambda: fwd_bwd(gridops.mult_dist_interp_plain), 3)
    gp = gridops.pad_to_mult4(grid)
    views = [gp[::s, ::s, ::s].permute(3, 0, 1, 2)[None].contiguous()
             .requires_grad_(True) for s in tl.STRIDES]
    unit = ((xyz - lo) / (hi - lo)).requires_grad_(True)

    def library(backward):
        coords = (2.0 * unit - 1.0).flip(-1).reshape(1, -1, 1, 1, 3)
        outs = [F.grid_sample(v, coords, align_corners=True) for v in views]
        if backward:
            torch.autograd.grad(outs, [*views, unit],
                                [torch.ones_like(o) for o in outs])
        return outs
    lms, _ = cuda_ms(lambda: [x.detach() for x in library(False)])
    lfb_ms, _ = cuda_ms(lambda: library(True))
    del views, gp
    # each kernel's device time in one forward and backward
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fwd_bwd(tl.mult_dist_interp_cuda)
        torch.cuda.synchronize()
    dev_ms = {}
    for e in prof.key_averages():
        name = next((k for k in G1_KERNELS if k in e.key), None)
        if name is None:
            name = "K5" if any(m in e.key for m in (
                "plan_kernel", "accumulate_kernel", "combine_kernel")) \
                else "other"
        dev_ms[name] = dev_ms.get(name, 0.0) + e.device_time_total / 1e3
    n_live = int((cot != 0).any(-1).sum())
    geo = tl.geometry(grid.shape)
    cells = sum(n for _, n, _ in geo)
    # what the function has to move: forward, read the coordinates and the
    # grid, write the output; backward, read the coordinates, the cotangent
    # and the grid, write the grid gradient and d/dunit
    f_bytes = M * 12 + nbytes(grid) + M * 3 * C * 4
    b_bytes = M * 12 + nbytes(cot) + nbytes(grid) + nbytes(grid) + M * 12
    # what this design moves besides, each written once and read once: the
    # keys and their sort, K5's sorted rows (live ones) and index, and
    # K5's [8C, n_cells] accumulators that the fold reads
    keys_bytes = 2 * 3 * M * (4 + 4 + 8)    # keys, sorted keys, order
    rows_bytes = 2 * 3 * n_live * (8 * C + 1) * 4
    acc_bytes = 2 * 8 * C * cells * 4
    ops = 3 * M * (8 * C * 2 + 40)
    b_ms = sum(dev_ms.get(k, 0.0) for k in G1_KERNELS[1:])
    bwd_ms = fb_ms - ms
    report.add("trilerp", f"M={M} grid={G1_SHAPE}x{C}", ms, pms, out_gap,
               f_bytes, ops, "fp32", library_ms=lms)
    report.add("trilerp_grad", f"M={M} grid={G1_SHAPE}x{C}", bwd_ms,
               pfb_ms - pms, max(dg_gap, dx_gap), b_bytes, 2 * ops, "fp32",
               library_ms=lfb_ms - lms)
    bf = 1e3 * f_bytes / HBM_BYTES_PER_S
    bb = 1e3 * b_bytes / HBM_BYTES_PER_S
    print(f"kernel trilerp M={M} grid={G1_SHAPE}x{C} ({nvidia_smi_line()}): "
          f"forward {ms:.3f} ms a call, queued {q_f:.3f}, in a CUDA graph "
          f"{g_f:.3f}; bound {bf:.4f} ms ({f_bytes / 1e6:.1f} MB at 3.35 "
          f"TB/s, bytes): {100 * bf / q_f:.1f}% queued; plain path "
          f"{pms:.3f} ms, F.grid_sample x3 {lms:.3f} ms. Forward and "
          f"backward {fb_ms:.3f} ms (plain path {pfb_ms:.3f}, F.grid_sample "
          f"x3 {lfb_ms:.3f}); device ms by kernel "
          f"{ {k: round(v, 4) for k, v in sorted(dev_ms.items())} }; the "
          f"backward's bound {bb:.4f} ms ({b_bytes / 1e6:.1f} MB, what the "
          f"function reads and writes): {100 * bb / bwd_ms:.1f}% of the "
          f"whole backward ({bwd_ms:.3f} ms, sort and K5 in it), "
          f"{100 * bb / b_ms:.1f}% of its three kernels ({b_ms:.3f} ms); "
          f"the design's intermediates besides, written and read back: keys "
          f"and sort {keys_bytes / 1e6:.1f} MB, sorted rows "
          f"{rows_bytes / 1e6:.1f} MB, K5's accumulators "
          f"{acc_bytes / 1e6:.1f} MB ({n_live} live rows of {M}); launches "
          f"{launches}", flush=True)
    print(f"kernel trilerp: forward bit-equal to the plain path {fwd_equal}, "
          f"grid gradient bit-equal {grad_equal} ({n_diff} cells differ), "
          f"zero pattern equal {zeros_equal}; max abs gap to the plain "
          f"path: forward {out_gap:.3g}, grid gradient {dg_gap:.3g}, d/dxyz "
          f"{dx_gap:.3g}; d/dxyz max abs err against "
          f"float64 G1 {err_k:.3g}, plain path {err_p:.3g}; forward and "
          f"backward capture into a CUDA graph: {cap} {why}", flush=True)
    if not (fwd_equal and grad_equal and zeros_equal and err_k <= err_p
            and cap and launches == G1_STEP_LAUNCHES):
        raise AssertionError(f"trilerp: forward {fwd_equal}, gradient "
                             f"{grad_equal} / {zeros_equal}, d/dxyz {err_k:g}"
                             f" vs {err_p:g}, capture {cap}, {launches}")


def print_front_end(name, shape, ms, earlier_ms, fn, pairs, other_pairs,
                    pair_flop, library_ms=None,
                    earlier="behind the PyTorch tile listing it read",
                    basis="its warps scanned"):
    """K1's / K2's / K3's time beside the earlier kernel's, the time of a
    launch with 20 queued, the bound (on the pairs its warps scan) beside
    the pairs of other bases (the earlier rows counted the tiles listed for
    256 queries a block) and the library yardstick."""
    queued = queued_ms(fn)
    bound = 1e3 * pair_flop * pairs / PEAK_FLOPS["fp32"]
    others = "".join(
        f"; on {what}: {n / 1e6:.1f} M pairs -> "
        f"{1e3 * pair_flop * n / PEAK_FLOPS['fp32']:.5f} ms"
        for what, n in other_pairs)
    extra = ""
    if library_ms is not None:
        extra += (f"; library yardstick (cdist + topk, two calls, not the "
                  f"same bits) {library_ms:.3f} ms, {library_ms / ms:.1f}x "
                  f"the kernel's time, {library_ms / queued:.1f}x queued")
    print(f"kernel {name} {shape}: {ms:.3f} ms ({queued:.3f} ms a call when "
          f"20 calls are queued back to back); bound {bound:.5f} ms "
          f"({pairs / 1e6:.1f} M pairs {basis}): "
          f"{100 * bound / ms:.1f}% reached, {100 * bound / queued:.1f}% "
          f"queued{others}{extra}; {earlier} "
          f"{earlier_ms:.3f} ms ({earlier_ms / ms:.1f}x)", flush=True)


def cdist_topk(torch, q, p, k, r2=None):
    """The library yardstick of K1 and K3: one ``cdist`` (no matrix-product
    shortcut) and one ``topk``, K3's beyond-radius distances masked to +inf
    in between; the distances, not their squares, so not the same bits."""
    d = torch.cdist(q, p, compute_mode="donot_use_mm_for_euclid_dist")
    if r2 is not None:
        d.masked_fill_(d > float(np.sqrt(r2)), float("inf"))
    return d.topk(k, dim=1, largest=False)


def scanned_pairs(scan, M, tables):
    """The query-point pairs K1's / K3's warps scanned: tiles a warp times
    its queries times the points a tile."""
    from apnerf_torch.kernels import knn_cells as kc
    per_warp = 32 // kc.topk_lanes(M)
    return int(scan["tiles"].sum()) * per_warp * tables["pts_t"].shape[2]


def brute_scan_alone(torch, p, k):
    """K1's kernel timed alone, its plan (``brute_plan``) made beforehand:
    (ms, queued ms)."""
    from apnerf_torch.kernels import knn_brute as kb
    plan = kb.brute_plan(p, p)
    launch = lambda: kb.launch_scan(p, plan, k)  # noqa: E731
    ms, _ = cuda_ms(launch)
    return ms, queued_ms(launch)


def phase_knn_brute(torch, p, tabs, report, pair_flop):
    """K1 at the load's shape: the canonical cloud's self-query (P = 10^4,
    k = 8), bit-equal to its plain version; the whole wrapper timed (the
    plan's Morton sort and tables included, as a load pays them) and the
    kernel alone (the plan made beforehand). Its bound counts the pairs its
    warps scanned; beside it the pairs of the tiles within each block's
    final kth distance, through the plain listing, and the 10^8 pairs of a
    brute-force walk."""
    from apnerf_torch.kernels import knn_brute as kb, knn_cells as kc
    P, k = p.shape[0], 8
    ms, (d, i) = cuda_ms(lambda: kb.knn_brute(p, p, k))
    pms, (pd, pi) = cuda_ms(lambda: kb.knn_brute_plain(p, p, k))
    if not (torch.equal(d, pd) and torch.equal(i, pi)):
        raise AssertionError("knn_brute differs from its plain version")
    lms, _ = cuda_ms(lambda: cdist_topk(torch, p, p, k))
    qb = kc.radius_block(P)
    NB = -(-P // qb)
    perm = tabs["perm"]
    kth = torch.full((NB * qb,), float("-inf"), device=p.device)
    kth[:P] = d[perm, k - 1]
    _, cnt = kc.candidate_tiles(p[perm], tabs, kth.reshape(NB, qb).amax(1),
                                qb=qb)
    listed = int(cnt.sum()) * qb * tabs["pts_t"].shape[2]
    scan = {}
    kb.knn_brute_cuda(p, p, k, scan_out=scan)
    pairs = scanned_pairs(scan, P, tabs)
    report.add("knn_brute", f"P={P} k={k}, {qb} queries a block", ms, pms,
               0.0, nbytes(p, d, i), pair_flop * pairs, "fp32",
               library_ms=lms)
    alone_ms, alone_q = brute_scan_alone(torch, p, k)
    print_front_end("knn_brute", f"P={P} k={k}", ms, K1_EARLIER_MS,
                    lambda: kb.knn_brute(p, p, k), pairs,
                    [(f"the tiles within each {qb}-query block's final kth "
                      f"distance", listed),
                     ("the brute-force walk", P * P)], pair_flop,
                    library_ms=lms,
                    earlier="the brute-force kernel it replaces read")
    print(f"kernel knn_brute P={P} k={k}: the kernel alone (brute_plan made "
          f"beforehand) {alone_ms:.3f} ms, {alone_q:.3f} ms queued; the "
          f"plan (build_point_tables, the frames' tables) the rest",
          flush=True)
    # nn1 (the chamfer helpers): K1 at k = 1 with queries that are not the
    # points, at both lane counts, bit-equal to the plain version
    from apnerf_torch.ops import knn as ops_knn
    g1 = torch.Generator(device="cpu").manual_seed(21)
    for M in (P, 40000):
        src = torch.randint(0, P, (M,), generator=g1).to(p.device)
        q = (p[src] + 0.02 * torch.randn(M, 3, generator=g1).to(p.device)
             ).contiguous()
        n_ms, (d1, i1) = cuda_ms(lambda: ops_knn.nn1(q, p))
        pd1, pi1 = kb.knn_brute_plain(q, p, 1)
        same = torch.equal(d1, pd1[:, 0]) and torch.equal(i1, pi1[:, 0])
        print(f"kernel knn_brute nn1 M={M} P={P}: {n_ms:.3f} ms (plan "
              f"included), bit-equal to the plain version {same}, "
              f"{kc.topk_lanes(M)} lanes a query", flush=True)
        if not same:
            raise AssertionError(f"knn_brute nn1 differs at M={M}")


def lattice_case(torch, step=2.0 ** -4, side=24, n_q=8000, seed=13):
    """Points and queries on a lattice scaled by a power of two, so that
    every squared distance is exact in fp32, with r2 = 9 steps^2: the
    offsets (3, 0, 0) and (2, 2, 1) put points at exactly d2 == r2."""
    from apnerf_torch.kernels import knn_cells as kc
    from apnerf_torch.ops.knn import morton_codes
    rng = np.random.default_rng(seed)
    pi = np.unique(rng.integers(0, side, size=(5000, 3)), axis=0)
    qi = rng.integers(0, side, size=(n_q, 3))
    tabs = kc.build_point_tables(torch.tensor(pi * step, dtype=torch.float32,
                                              device=DEVICE))
    q = torch.tensor(qi * step, dtype=torch.float32, device=DEVICE)
    order = torch.argsort(morton_codes(q, tabs["p_lo"], tabs["p_hi"]),
                          stable=True)
    qi = torch.tensor(qi, device=DEVICE)[order]
    d2 = ((qi[:, None, :] - torch.tensor(pi, device=DEVICE)[None]) ** 2
          ).sum(-1)
    return (q[order].contiguous(), tabs, 9 * step * step,
            (d2 <= 9).sum(1).to(torch.int32), int((d2 == 9).sum()))


def phase_knn_shapes(torch, p, tabs, queries, g):
    """K1, K2 and K3 at the shapes a block-listed, split scan gets wrong
    first (not timed into the table), every one bit-equal to the plain
    version: a ragged M, a block of sentinel queries only, a cloud whose
    tiles outnumber one round of tile tests and one of two tiles, tiles of
    32 and of 512 points, points at exactly d2 == r2, duplicate points; K3
    also at k = 12 everywhere; K1 as a lattice self-query (many equal
    distances), on duplicate points, on P = 130 and on P = 10^5, at k = 1,
    8 and 16. The kernels take fewer lanes a query from 32,768 queries on
    (``kc.FEW_QUERIES``): K2 and K3 run each case also with sentinel
    queries added up to 32,805, K1 on cases of 33,000 and 10^5 queries, so
    that both instantiations of each meet every shape. On the smaller
    clouds the tiles each warp scanned are held against
    ``topk_scan_model`` (K3) and ``knn_brute_model`` (K1) on a CPU copy,
    and so are the results."""
    from apnerf_torch.kernels import knn_brute as kb, knn_cells as kc
    from apnerf_torch.ops.knn import morton_codes
    dev = p.device
    many = kc.FEW_QUERIES + 37      # a ragged last block of the wide shape
    MODEL_NOTE = ", the warps scanned the tiles of the model"

    def both(name, q, tables, r2, k=8, want_count=None, model=False):
        n = q.shape[0]
        calls = [q]
        if n < many:
            calls.append(torch.cat([q, torch.full((many - n, 3), 1e9,
                                                  device=dev)]))
        for qq in calls:
            M = qq.shape[0]
            c = kc.knn_count(qq, tables, r2)
            if not torch.equal(c, kc.knn_count_plain(qq, tables["pts_sorted"],
                                                     r2)):
                raise AssertionError(f"knn_count differs: {name}, M={M}")
            if want_count is not None and not torch.equal(c[:n], want_count):
                raise AssertionError(f"knn_count is not the integer count: "
                                     f"{name}")
            for kk in sorted({k, 12}):
                pd, pi = kc.knn_radius_plain(qq, tables["pts_sorted"], kk, r2)
                scan = {}
                d, i = kc.knn_radius_cuda(qq, tables, kk, r2, scan)
                if not (torch.equal(d, pd) and torch.equal(i, pi)):
                    raise AssertionError(f"knn_radius differs: {name}, "
                                         f"M={M}, k={kk}")
                if model:
                    md, mi, mt = kc.topk_scan_model(
                        qq.cpu(), {key: v.cpu() for key, v in tables.items()},
                        kk, r2)
                    if not (torch.equal(md, pd.cpu())
                            and torch.equal(mi, pi.cpu())
                            and torch.equal(mt, scan["tiles"].cpu())):
                        raise AssertionError(
                            f"knn_radius: topk_scan_model's tiles "
                            f"{int(mt.sum())}, the kernel's "
                            f"{int(scan['tiles'].sum())}: {name}, M={M}, "
                            f"k={kk}")
        T, _, pts = tables["pts_t"].shape
        return (f"{name} (M={n} and {many}, T={T} x {pts}, count up to "
                f"{int(c[:n].max())}, {float((c[:n] >= k).float().mean()):.2f}"
                f" of the queries with {k} in radius"
                f"{MODEL_NOTE if model else ''})")

    def brute(name, q, pts, ks, model=False):
        # the plain version's first k of its stable sort, for every k
        want_d, want_i = kb.knn_brute_plain(q, pts, max(ks))
        for k in ks:
            pd, pi = want_d[:, :k], want_i[:, :k]
            scan = {}
            d, i = kb.knn_brute_cuda(q, pts, k, scan)
            if not (torch.equal(d, pd) and torch.equal(i, pi)):
                raise AssertionError(f"knn_brute differs: {name}, k={k}")
            if model:
                pc = pts.cpu()
                md, mi, mt = kb.knn_brute_model(pc if q is pts else q.cpu(),
                                                pc, k)
                if not (torch.equal(md, pd.cpu())
                        and torch.equal(mi, pi.cpu())
                        and torch.equal(mt, scan["tiles"].cpu())):
                    raise AssertionError(
                        f"knn_brute: knn_brute_model's tiles "
                        f"{int(mt.sum())}, the kernel's "
                        f"{int(scan['tiles'].sum())}: {name}, k={k}")
        return (f"{name} (M={q.shape[0]}, P={pts.shape[0]}, k={list(ks)}, "
                f"{kc.topk_lanes(q.shape[0])} lanes a query"
                f"{MODEL_NOTE if model else ''})")

    def cloud(P, n_q, spread, pts_per_tile=kc.PTS):
        pc = (0.3 * torch.randn(P, 3, generator=g)).to(dev)
        t = kc.build_point_tables(pc, pts_per_tile)
        i = torch.randint(0, P, (n_q,), generator=g).to(dev)
        q = pc[i] + spread * torch.randn(n_q, 3, generator=g).to(dev)
        order = torch.argsort(morton_codes(q, t["p_lo"], t["p_hi"]),
                              stable=True)
        return q[order].contiguous(), t, pc

    lines = []
    sentinel = torch.full((300, 3), 1e9, device=dev)
    q = torch.cat([queries(4703, 0.05, g), sentinel])   # 5,003 queries
    lines.append(both("ragged M, the last blocks sentinels only", q, tabs,
                      RADIUS))
    if not bool((kc.knn_count(sentinel, tabs, RADIUS)
                 == (-p.shape[0]) % kc.PTS).all()):
        raise AssertionError("sentinel queries do not count the pad rows")
    q, t, big = cloud(100000, 20011, 0.01)
    lines.append(both("P=100000", q, t, 0.0004, k=12))
    lines.append(brute("K1, P=100000, other queries", q, big, (8,)))
    lines.append(brute("K1, P=100000 self-query", big, big, (1, 16)))
    q, t, small = cloud(130, 999, 0.1)
    lines.append(both("P=130", q, t, 0.02, k=3, model=True))
    lines.append(brute("K1, P=130 self-query", small, small, (1, 16),
                       model=True))
    q = small[torch.randint(0, 130, (33000,), generator=g).to(dev)] + \
        0.1 * torch.randn(33000, 3, generator=g).to(dev)
    lines.append(brute("K1, P=130, other queries", q.contiguous(), small,
                       (1, 16), model=True))
    q, t, _ = cloud(20000, 10007, 0.02, pts_per_tile=32)
    lines.append(both("tiles of 32", q, t, 0.002))
    q, t, _ = cloud(20000, 10007, 0.02, pts_per_tile=512)
    lines.append(both("tiles of 512", q, t, 0.002, k=16))
    q, t, r2, want, on_edge = lattice_case(torch)
    if on_edge < q.shape[0]:
        raise AssertionError("the lattice case has no points at d2 == r2")
    lines.append(both(f"lattice, {on_edge} pairs at exactly d2 == r2", q, t,
                      r2, want_count=want))
    real = t["pts_sorted"][:int((t["pts_sorted"][:, 0] < 1e8).sum())]
    lines.append(brute("K1, lattice self-query", real, real, (1, 8, 16)))
    q, _, _, _, _ = lattice_case(torch, n_q=40000)
    lines.append(brute("K1, lattice points, lattice queries", q, real,
                       (1, 8, 16)))
    base = (0.3 * torch.randn(1000, 3, generator=g)).to(dev)
    dup = torch.cat([base, base[::2], base[::3]])
    dup = dup[torch.randperm(dup.shape[0], generator=g).to(dev)].contiguous()
    t = kc.build_point_tables(dup)
    i = torch.randint(0, dup.shape[0], (1500,), generator=g).to(dev)
    q = dup[i] + 0.02 * torch.randn(1500, 3, generator=g).to(dev)
    q = q[torch.argsort(morton_codes(q, t["p_lo"], t["p_hi"]),
                        stable=True)].contiguous()
    lines.append(both("duplicate points", q, t, 0.01, model=True))
    lines.append(brute("K1, duplicate points self-query", dup, dup, (8,),
                       model=True))
    print("kernel knn_brute / knn_count / knn_radius, other shapes, "
          "bit-equal to the plain versions: " + "; ".join(lines), flush=True)


def random_layers(torch, g, F, n_pe, depth, pose_dim=0):
    """``depth`` bf16 layers [(weight [dout, din], bias)] of a feat_net on
    the card, uniform in +-1/sqrt(din) like ``torch.nn.Linear``."""
    dims = [3 * (1 + 2 * n_pe) + F + pose_dim] + [F] * depth
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(din)
        layers.append((
            ((torch.rand(dout, din, generator=g) * 2 - 1) * bound).to(
                DEVICE, torch.bfloat16),
            ((torch.rand(dout, generator=g) * 2 - 1) * bound).to(
                DEVICE, torch.bfloat16)))
    return layers


def featmlp_inputs(torch, g, M, K, F):
    dev = torch.device(DEVICE)
    rel = (0.05 * torch.randn(M, K, 3, generator=g)).to(dev)
    feat = (0.1 * torch.randn(M, K, F, generator=g)).to(dev, torch.bfloat16)
    w = torch.rand(M, K, generator=g).to(dev)
    return rel, feat, w / w.sum(-1, keepdim=True)


def phase_featmlp(torch, report, g, M=71680, K=8, F=128, n_pe=10):
    """K4 at the bench shape; returns the feat_net layers (K6 reuses
    them)."""
    from apnerf_torch.kernels import featmlp as fm
    rel, feat, w = featmlp_inputs(torch, g, M, K, F)
    layers = random_layers(torch, g, F, n_pe, 4)
    wts = fm.pack_weights(layers, F, n_pe, None)
    ms, h = cuda_ms(lambda: fm.featmlp_agg(rel, feat, w, wts))
    pms, ph = cuda_ms(lambda: fm.featmlp_plain(rel, feat, w, wts))
    d, dc = (h - ph).abs(), (featmlp_fp32_layers(rel, feat, w, wts)
                              - ph).abs()
    err, mean = d.max().item(), d.mean().item()
    over = beyond_last_round(torch, d, last_layer_rows(rel, feat, wts), w)
    top = ph.abs().max().item()
    print(f"kernel featmlp: max_abs_err {err:g} ({err / top:.3g} of max |h| "
          f"{top:.3g}; beyond one bf16 step of the last layer's outputs "
          f"{over / top:.3g}, gate {K4_REL_MAX_ERR:.3g}), mean_abs_err "
          f"{mean:g} "
          f"(gates {K4_MEAN_ABS_ERR:g}, {mean / top:.3g} of max |h| against "
          f"{K4_REL_MEAN_ERR:g}); control without the per-layer bf16 round: "
          f"max {dc.max().item():g}, mean {dc.mean().item():g}", flush=True)
    if not featmlp_within_gates(torch, h, over, mean, top):
        raise AssertionError(f"featmlp differs: max err {err:g} ({over:g} "
                             f"beyond the last round), mean {mean:g}, max "
                             f"|h| {top:g}")
    mlp_flop = 2 * ((3 * (1 + 2 * n_pe) + F) * F + 3 * F * F)  # per MLP row
    report.add("featmlp", f"M={M} K={K} F={F} depth 4", ms, pms, err,
               nbytes(rel, feat, w, wts.w1, wts.b1, wts.wl, wts.bl, h),
               M * K * mlp_flop, "bf16")
    print_redesign(report, "featmlp", ms, K4_EARLIER_MS,
                   lambda: fm.featmlp_agg(rel, feat, w, wts))
    return layers


def featmlp_within_gates(torch, h, over, mean, top) -> bool:
    """K4's gates: ``over`` (``beyond_last_round``) within K4_REL_MAX_ERR
    of max |h|, the mean abs error within K4_MEAN_ABS_ERR and
    K4_REL_MEAN_ERR of max |h|."""
    return (bool(torch.isfinite(h).all()) and over <= K4_REL_MAX_ERR * top
            and mean <= K4_MEAN_ABS_ERR and mean <= K4_REL_MEAN_ERR * top)


# K4's gathering front at the chunk of the dnerf-render-test cell: 8,192
# rays at budget 192 give a pass budget of 141,824 slots (K = 8, F = 128,
# 4 layers), of which the cell's passing slots fill ~35% (its
# budget_fill.render reads 34.7%): the kernel reads that count and skips the
# rest. Held against the model's plain path on the card
# (temporal_points.exact_front_plain and featnet_plain in bf16, cuBLAS's
# GEMMs): kth bit-equal (the kernel sums d2 and the weights in the order of
# PyTorch's CUDA reductions, read from torch 2.11.0+cu128: this gate is
# the check to rerun after an upgrade of torch), the weights within
# GATHER_W_MAX_ABS_ERR, a ceiling at ~4x the reading of 2.4e-7 (NVIDIA H100
# 80GB HBM3, 700 W: a few float32 steps where the plain path's sum of a
# row's weights is not taken in the kernel's order), h under K4's gates
# (the same rounding in another fp32 order: a flipped bf16 round now and
# then), beside the control in K4's own rounding (gather_k4_rounding).
GATHER_SLOTS = 141824
GATHER_LIVE = 0.35
GATHER_W_MAX_ABS_ERR = 1e-6


def phase_gather(torch, report, p, tabs, queries, g, F=128, K=8, n_pe=10,
                 eps=1e-6):
    """K4's gathering front at the render cell's chunk, with and without a
    64-wide pose embedding, against the plain path on the card."""
    from apnerf_torch.kernels import featmlp as fm, knn_cells as kc
    from apnerf_torch.models import temporal_points as tp
    dev = torch.device(DEVICE)
    n = GATHER_SLOTS
    q = queries(n, 0.03, g=g)
    _, idx = kc.knn_radius(q, tabs, K, RADIUS)
    Pp = tabs["pts_sorted"].shape[0]
    rot = (torch.eye(3).reshape(1, 9)
           + 0.3 * torch.randn(Pp, 9, generator=g)).to(dev)
    geo = torch.cat([tabs["pts_sorted"], rot], -1).contiguous()
    feat = (0.3 * torch.randn(Pp, F, generator=g)).to(dev)
    n_live = int(GATHER_LIVE * n)
    live = torch.arange(n, device=dev) < n_live
    mlp_flop = 2 * ((3 * (1 + 2 * n_pe) + F) * F + 3 * F * F)
    for pose_dim in (0, 64):
        layers = random_layers(torch, g, F, n_pe, 4, pose_dim)
        pose = (torch.randn(1, pose_dim, generator=g).to(dev) if pose_dim
                else None)
        tabs_g = fm.GatherTables(geo, feat.to(torch.bfloat16),
                                 fm.pack_plain_weights(layers, F, n_pe, pose))

        def kernel(lv=None):
            return fm.featmlp_gather(q, idx, tabs_g, eps, live=lv,
                                     want_w=True)
        ms, (h, kth, w) = cuda_ms(kernel)

        def plain():
            rc, fk, to_nn, w = tp.exact_front_plain(
                geo, feat, torch.bfloat16, q, idx.long(), eps)
            return (tp.featnet_plain(layers, rc, fk, w, pose, n_pe,
                                     torch.bfloat16),
                    to_nn.amax(-1), w, (rc, fk))
        pms, (ph, pkth, pw, (rc, fk)) = cuda_ms(plain)
        d = (h - ph).abs()
        err, mean, top = d.max().item(), d.mean().item(), ph.abs().max().item()
        # the plain path's last-layer outputs, one neighbour a row
        ones = torch.ones(n * K, 1, device=dev)
        f_last = tp.featnet_plain(layers, rc.reshape(n * K, 1, 3),
                                  fk.reshape(n * K, 1, F), ones, pose, n_pe,
                                  torch.bfloat16).reshape(n, K, F)
        over = beyond_last_round(torch, d, f_last, w)
        dc = (gather_k4_rounding(q, idx, tabs_g, eps)[0] - ph).abs()
        kth_equal = torch.equal(kth, pkth)
        w_err = (w - pw).abs().max().item()
        # the live prefix: the rows before it as the full call's, the rest
        # cleared
        hl, kl, wl = kernel(live)
        prefix_ok = (torch.equal(hl[:n_live], h[:n_live])
                     and torch.equal(kl[:n_live], kth[:n_live])
                     and torch.equal(wl[:n_live], w[:n_live])
                     and not bool(hl[n_live:].any())
                     and not bool(wl[n_live:].any())
                     and bool(torch.isinf(kl[n_live:]).all()))
        shape = (f"n={n} K={K} F={F} depth 4"
                 + (f" pose {pose_dim}" if pose_dim else ""))
        print(f"kernel featmlp_gather {shape}: max |dh| {err:g} "
              f"({err / top:.3g} of max |h| {top:.3g}; beyond one bf16 step "
              f"of the last layer's outputs {over / top:.3g}, gate "
              f"{K4_REL_MAX_ERR:.3g}), mean |dh| {mean:g} (gates "
              f"{K4_MEAN_ABS_ERR:g}, {mean / top:.3g} of max |h| against "
              f"{K4_REL_MEAN_ERR:g}); control in K4's rounding: max "
              f"{dc.max().item():g}, mean {dc.mean().item():g}; kth "
              f"bit-equal {kth_equal}; max |dw| {w_err:g} (gate "
              f"{GATHER_W_MAX_ABS_ERR:g}); live prefix of {n_live} "
              f"{'as the full call, the rest cleared' if prefix_ok else 'WRONG'}"
              f"; against the gathers + featnet_plain", flush=True)
        if not (featmlp_within_gates(torch, h, over, mean, top) and kth_equal
                and w_err <= GATHER_W_MAX_ABS_ERR and prefix_ok):
            raise AssertionError(f"featmlp_gather differs ({shape}): max "
                                 f"{err:g} ({over:g} beyond the last round), "
                                 f"mean {mean:g}, kth equal {kth_equal}, w "
                                 f"{w_err:g}, live prefix {prefix_ok}")
        moved = nbytes(q, idx, geo, tabs_g.feat, tabs_g.wts.w1, tabs_g.wts.wl,
                       h, kth, w)
        if pose_dim == 0:
            report.add("featmlp_gather", shape, ms, pms, err, moved,
                       n * K * mlp_flop, "bf16")
        for label, lv, rows in (("all slots", None, n),
                                (f"live prefix {n_live}", live, n_live)):
            t_b = moved / HBM_BYTES_PER_S * 1e3
            t_o = rows * K * mlp_flop / PEAK_FLOPS["bf16"] * 1e3
            bound = max(t_b, t_o)
            qd = queued_ms(lambda: kernel(lv))
            gr = graphed_ms(lambda: kernel(lv))
            print(f"kernel featmlp_gather {shape}, {label}: graphed {gr:.4f} "
                  f"ms, queued {qd:.4f} ms, bound {bound:.4f} ms "
                  f"({'operations' if t_o >= t_b else 'bytes'}): "
                  f"{100 * bound / gr:.1f}% of its roofline graphed, "
                  f"{100 * bound / qd:.1f}% queued; the plain path "
                  f"{pms:.3f} ms ({nvidia_smi_line()})", flush=True)


def queued_ms(fn, launches=20, rounds=5):
    """Median over ``rounds`` of the milliseconds a call of ``fn`` takes
    when ``launches`` calls are queued back to back between two CUDA
    events: the device's time, without the wrapper's host work that
    ``cuda_ms`` includes when a kernel is as short as that work."""
    import torch
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def graphed_ms(fn, launches=20, rounds=5):
    """Milliseconds a launch of ``fn`` takes inside a CUDA graph of
    ``launches`` launches (as P1 runs inside the frame and step graphs):
    the replay's median over ``rounds``, divided by ``launches``. No host
    work between the launches, unlike ``queued_ms``, which at small sizes
    times the wrapper's host work."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    return queued_ms(graph.replay, 1, rounds) / launches


def print_redesign(report, name, ms, earlier_ms, fn):
    bound = report.rows[name]["bound_ms"]
    queued = queued_ms(fn)
    print(f"kernel {name}: {ms:.3f} ms beside its bound {bound:.4f} ms "
          f"({100 * bound / ms:.1f}% reached; {queued:.3f} ms a call when 20 "
          f"calls are queued back to back, {100 * bound / queued:.1f}%); the "
          f"WMMA kernel it replaces read {earlier_ms:.3f} ms at this shape "
          f"({earlier_ms / ms:.1f}x)", flush=True)


def phase_agg(torch, report, layers, g, S=4480, share=16, K=8, F=128,
              n_pe=10):
    """K6 at the bench shape (one 8192-ray chunk's pass budget: 4480
    subgroups of 16 members, 8 candidates) and with 12 candidates; ~10% of
    the candidate slots invalid (at the sentinel position)."""
    from apnerf_torch.kernels import agg as ag, featmlp as fm
    wts = fm.pack_weights(layers, F, n_pe, None)
    mlp_flop = 2 * ((3 * (1 + 2 * n_pe) + F) * F + 3 * F * F)
    for kc in (8, 12):
        q, nbr, rot, feat = agg_inputs(torch, g, S, share, kc, F)
        args = (q, nbr, rot, feat, wts, K, 1e-6)
        ms, (h, kd2) = cuda_ms(lambda: ag.fused_subgroup_agg(*args))
        pms, (ph, pkd2) = cuda_ms(lambda: ag.fused_subgroup_agg_plain(*args))
        ch, _ = agg_fp32_layers(*args)
        d, dc = (h - ph).abs(), (ch - ph).abs()
        err, mean = d.max().item(), d.mean().item()
        rejected = float((pkd2 > 1e17).float().mean())
        print(f"kernel agg kc={kc}: kd2 bit-equal {torch.equal(kd2, pkd2)} "
              f"({rejected:.3f} of the samples reach an invalid slot), h "
              f"max_abs_err {err:g} (gate {K6_MAX_ABS_ERR:g}), mean_abs_err "
              f"{mean:g} (gate {K6_MEAN_ABS_ERR:g}), max |h| "
              f"{ph.abs().max().item():g}; control without the per-layer "
              f"bf16 round: max {dc.max().item():g}, mean "
              f"{dc.mean().item():g}; kernel {ms:.3f} ms, plain {pms:.3f} ms",
              flush=True)
        if not (torch.equal(kd2, pkd2) and bool(torch.isfinite(h).all())
                and err <= K6_MAX_ABS_ERR and mean <= K6_MEAN_ABS_ERR):
            raise AssertionError(f"agg differs at kc={kc}: kd2 equal "
                                 f"{torch.equal(kd2, pkd2)}, max err {err:g},"
                                 f" mean {mean:g}")
        if kc == 8:     # the main path's shape
            report.add("agg", f"S={S} share={share} kc={kc} K={K} F={F}", ms,
                       pms, err, nbytes(q, nbr, rot, feat, wts.w1, wts.b1,
                                        wts.wl, wts.bl, h, kd2),
                       S * share * kc * mlp_flop, "bf16")
            print_redesign(report, "agg", ms, K6_EARLIER_MS,
                           lambda: ag.fused_subgroup_agg(*args))
        else:
            print(f"kernel agg kc={kc}: {ms:.3f} ms; the WMMA kernel it "
                  f"replaces read {K6_EARLIER_KC12_MS:.3f} ms", flush=True)


def agg_inputs(torch, g, S, share, kc, F):
    """K6's operands with ~10% of the candidate slots invalid (at the
    sentinel position)."""
    dev = torch.device(DEVICE)
    q = (0.05 * torch.randn(S, share, 3, generator=g)).to(dev)
    nbr = q[:, :1] + (0.05 * torch.randn(S, kc, 3, generator=g)).to(dev)
    invalid = (torch.rand(S, kc, generator=g) < 0.1).to(dev)
    nbr = torch.where(invalid[..., None], torch.full_like(nbr, 2e9), nbr)
    rot = torch.randn(S, kc, 9, generator=g).to(dev)
    feat = (0.1 * torch.randn(S, kc, F, generator=g)).to(dev, torch.bfloat16)
    return q, nbr.contiguous(), rot, feat


def agg_scaled_features(torch, args, kept, scale=30.0):
    """K6 on ``args`` with the features ``scale`` times larger, so that
    |h| leaves the range the absolute gates were set for: a bf16 step is
    relative, so the error must follow max |h| (``K6_REL_MAX_ERR``,
    ``K6_REL_MEAN_ERR``), as the control's does."""
    from apnerf_torch.kernels import agg as ag
    q, nbr, rot, feat, wts, K, eps = args
    args = (q, nbr, rot, (feat.float() * scale).to(torch.bfloat16), wts, K,
            eps)
    h, kd2 = ag.fused_subgroup_agg(*args)
    ph, pkd2 = ag.fused_subgroup_agg_plain(*args)
    d = (h - ph).abs()[kept]
    dc = (agg_fp32_layers(*args)[0] - ph).abs()[kept]
    top = ph[kept].abs().max().item()
    err, mean = d.max().item(), d.mean().item()
    line = (f"the same with features x {scale:g}: max |h| {top:.3g}, max "
            f"{err:.3g} ({err / top:.3g} of max |h|, gate "
            f"{K6_REL_MAX_ERR:.3g}), mean {mean:.3g} ({mean / top:.3g}, gate "
            f"{K6_REL_MEAN_ERR:g}); control without the per-layer bf16 "
            f"round: max {dc.max().item() / top:.3g}, mean "
            f"{dc.mean().item() / top:.3g} of max |h|")
    if not (torch.equal(kd2, pkd2) and bool(torch.isfinite(h).all())
            and err <= K6_REL_MAX_ERR * top
            and mean <= K6_REL_MEAN_ERR * top):
        raise AssertionError(f"agg differs: {line}")
    return line


def phase_chain_shapes(torch, g):
    """The shapes a persistent, tiled chain gets wrong first, K4 and K6
    against their plain versions under the gates of the bench shape (not
    timed into the table): ragged row counts, fewer rows than one tile,
    narrow and deep nets (5 or more layers at F = 128 are streamed), a pose
    embedding, members of other sizes than 8 rows (the shared-tile
    reduction; more than 64 rows take two passes). And the wrapper's
    shared-memory rule against the kernel's own."""
    import ctypes
    from apnerf_torch.kernels import agg as ag, build, featmlp as fm
    lib = build.load_library()
    for F, P_pad, L in ((128, 64, 4), (128, 64, 5), (128, 64, 9),
                        (64, 64, 2), (32, 32, 1), (32, 64, 4), (128, 80, 4),
                        (128, 448, 2), (64, 1024, 2)):
        res, smem = ctypes.c_int(0), ctypes.c_int(0)
        ok = lib.featmlp_plan(F, P_pad, L, ctypes.byref(res),
                              ctypes.byref(smem))
        want = fm.chain_plan(F, P_pad, L)
        got = dict(mode="refused" if not ok else
                   "resident" if res.value == L else "streamed",
                   resident=res.value, smem_bytes=smem.value)
        if got != want:
            raise AssertionError(f"chain_plan({F}, {P_pad}, {L}): {want}, "
                                 f"the kernel's plan_chain: {got}")
    lines = []
    # M, K, F, n_pe, depth, pose_dim
    for M, K, F, n_pe, depth, pd in (
            (1003, 8, 128, 10, 4, 0),      # ragged: M K not a tile multiple
            (5, 8, 128, 10, 4, 0),         # fewer rows than one tile
            (3001, 8, 64, 10, 2, 0),       # narrow, 2 layers
            (2000, 8, 128, 10, 5, 0),      # 5 layers: the last two streamed
            (2000, 8, 128, 10, 7, 0),      # 7 layers: the last four streamed
            (1500, 8, 128, 10, 4, 32),     # a pose embedding
            (777, 4, 32, 4, 1, 0),         # one layer, F = 32, K = 4
            (900, 8, 128, 12, 4, 0),       # two chunks of PE columns
            (300, 16, 128, 10, 4, 0),      # two tile rows a member
            (41, 128, 64, 6, 3, 0)):       # two passes a member
        rel, feat, w = featmlp_inputs(torch, g, M, K, F)
        layers = random_layers(torch, g, F, n_pe, depth, pd)
        pose = None if not pd else (0.1 * torch.randn(pd, generator=g)).to(
            DEVICE)
        wts = fm.pack_weights(layers, F, n_pe, pose)
        h = fm.featmlp_agg(rel, feat, w, wts)
        ph = fm.featmlp_plain(rel, feat, w, wts)
        d = (h - ph).abs()
        err, mean = d.max().item(), d.mean().item()
        over = beyond_last_round(torch, d, last_layer_rows(rel, feat, wts),
                                 w)
        top = ph.abs().max().item()
        lines.append(f"M={M} K={K} F={F} pe={n_pe} depth={depth} pose={pd} "
                     f"({fm.chain_plan(F, wts.P_pad, depth)['mode']}): max "
                     f"{err:.3g} ({err / top:.3g} of max |h|, "
                     f"{over / top:.3g} beyond the last round), mean "
                     f"{mean:.3g} ({mean / top:.3g})")
        if not featmlp_within_gates(torch, h, over, mean, top):
            raise AssertionError(f"featmlp differs: {lines[-1]}")
    print("kernel featmlp, other shapes (gates: max beyond one bf16 step "
          f"of the last layer's outputs {K4_REL_MAX_ERR:.3g} of max |h|, "
          f"mean {K4_MEAN_ABS_ERR:g} and "
          f"{K4_REL_MEAN_ERR:g} of max |h|): " + "; ".join(lines),
          flush=True)
    lines = []
    # S, share, kc, K, F, depth
    for S, share, kc, K, F, depth in (
            (1001, 16, 8, 8, 128, 4),      # ragged S
            (3, 16, 8, 8, 128, 4),         # fewer rows than one block's tiles
            (999, 8, 8, 8, 128, 4),        # share 8
            (501, 16, 16, 8, 128, 4),      # kc 16
            (333, 4, 12, 8, 64, 4),        # narrow, members across subgroups
            (200, 16, 12, 8, 128, 6),      # 6 layers: the last three streamed
            (37, 4, 100, 8, 32, 4),        # two passes a member
            (2000, 4, 1, 1, 128, 4)):      # one row a member, at weight 1
        layers = random_layers(torch, g, F, 10, depth)
        wts = fm.pack_weights(layers, F, 10, None)
        args = (*agg_inputs(torch, g, S, share, kc, F), wts, K, 1e-6)
        h, kd2 = ag.fused_subgroup_agg(*args)
        ph, pkd2 = ag.fused_subgroup_agg_plain(*args)
        d = (h - ph).abs()
        note = ""
        if kc == 1:
            # a member whose only candidate is invalid carries the sentinel
            # row (|h| ~ 1e8) at weight 1; the render drops it by its kd2
            kept = pkd2 < 1e17
            d = d[kept]
            note = (f" over the {kept.float().mean().item():.3f} of the "
                    f"members with a valid candidate, max |h| "
                    f"{ph[kept].abs().max().item():.3g}")
        err, mean = d.max().item(), d.mean().item()
        lines.append(f"S={S} share={share} kc={kc} K={K} F={F} depth={depth}"
                     f": kd2 bit-equal {torch.equal(kd2, pkd2)}, max "
                     f"{err:.3g}, mean {mean:.3g}{note}")
        if not (torch.equal(kd2, pkd2) and bool(torch.isfinite(h).all())
                and err <= K6_MAX_ABS_ERR and mean <= K6_MEAN_ABS_ERR):
            raise AssertionError(f"agg differs: {lines[-1]}")
        if kc == 1:
            lines.append(agg_scaled_features(torch, args, kept))
    print("kernel agg, other shapes (gates "
          f"{K6_MAX_ABS_ERR:g} / {K6_MEAN_ABS_ERR:g}): " + "; ".join(lines),
          flush=True)


def scatter_inputs(torch, n_pad, M=1 << 20, C=96, seed=0):
    """K5's operands as the stage-1 grid gradient gives them at the scale
    whose padded grid is ``n_pad``^3: the extended base cells of M samples
    (a Gaussian blob of points around the grid centre, sigma 1/8 of the
    bbox, so that windows range from empty to hot), sorted, and [M, C]
    fp32 corner contributions."""
    rng = np.random.default_rng(seed)
    u = np.clip(rng.normal(0.5, 0.125, size=(M, 3)), 0.0, 1.0)
    b = np.clip(np.floor(u * (n_pad - 1)).astype(np.int64) + 1, 0, n_pad)
    e = n_pad + 1
    idx = np.sort((b[:, 0] * e + b[:, 1]) * e + b[:, 2]).astype(np.int32)
    upd = rng.normal(size=(M, C)).astype(np.float32)
    return (torch.tensor(idx, device=DEVICE), torch.tensor(upd, device=DEVICE),
            e ** 3)


def check_item_plan(torch, sc, idx, n_rows, plan):
    """The work items the kernel's plan pass wrote against the pure
    function ``item_plan`` on a CPU copy of idx; returns (items, chunks)."""
    torch.cuda.synchronize()
    n_items, n_parts = plan["cnt"][-1].tolist()
    want_items, want_pinfo = sc.item_plan(idx.cpu(), n_rows)
    got_items = plan["items"][:n_items].cpu().numpy()
    got_pinfo = plan["pinfo"][:n_parts].cpu().numpy()
    if not (np.array_equal(got_items, want_items)
            and np.array_equal(got_pinfo, want_pinfo)):
        raise AssertionError(
            f"scatter n_rows={n_rows}: the kernel planned {n_items} items "
            f"and {n_parts} chunks, item_plan {len(want_items)} and "
            f"{len(want_pinfo)}, or they differ")
    return n_items, n_parts


def scatter_case(torch, sc, name, idx, upd, n_rows, transposed, timed=False):
    """K5 on one more input: two runs bit-equal, bit-equal to the plain
    version on a CPU copy, the item plan as ``item_plan`` gives it."""
    plan = {}
    out = sc.sorted_window_accumulate_cuda(idx, upd, n_rows, transposed,
                                           plan_out=plan)
    items, chunks = check_item_plan(torch, sc, idx, n_rows, plan)
    again = sc.sorted_window_accumulate(idx, upd, n_rows, transposed)
    ref = sc.sorted_window_accumulate_plain(idx.cpu(), upd.cpu(), n_rows,
                                            transposed)
    if not (torch.equal(out, again) and torch.equal(out.cpu(), ref)):
        raise AssertionError(
            f"scatter {name}: two runs equal {torch.equal(out, again)}, "
            f"max abs err vs the plain version on the CPU "
            f"{(out.cpu() - ref).abs().max().item():g}")
    line = (f"{name} (M={idx.shape[0]} C={upd.shape[1]} n_rows={n_rows}"
            f"{' transposed' if transposed else ''}: {items} items, "
            f"{chunks} chunks")
    if timed:
        ms, _ = cuda_ms(lambda: sc.sorted_window_accumulate(
            idx, upd, n_rows, transposed))
        idx64 = idx.long().clamp(0, n_rows - 1)
        lms, _ = cuda_ms(lambda: torch.zeros(
            (n_rows, upd.shape[1]), device=upd.device).index_add_(
                0, idx64, upd))
        line += f"; kernel {ms:.3f} ms, index_add_ {lms:.3f} ms"
    return line + ")"


def phase_scatter(torch, report):
    """K5 at the three stage-1 shapes (padded grids 161^3, 81^3, 41^3 of
    the 160^3 nerf grid; M = 2^20, C = 96, transposed), then on the inputs
    that a row-balanced, chunked sum gets wrong first."""
    from apnerf_torch.kernels import build, scatter as sc
    lib = build.load_library()
    if (lib.scatter_item_rows(), lib.scatter_hot_rows()) != (sc.ITEM_ROWS,
                                                             sc.HOT_ROWS):
        raise AssertionError("scatter.ITEM_ROWS / HOT_ROWS are not the "
                             "kernel's")
    for n_pad in (161, 81, 41):
        idx, upd, n_rows = scatter_inputs(torch, n_pad)
        ms, out = cuda_ms(lambda: sc.sorted_window_accumulate(
            idx, upd, n_rows, transposed=True))
        queued = queued_ms(lambda: sc.sorted_window_accumulate(
            idx, upd, n_rows, transposed=True), launches=10)
        plan = {}
        again = sc.sorted_window_accumulate_cuda(idx, upd, n_rows, True,
                                                 plan_out=plan)
        items, chunks = check_item_plan(torch, sc, idx, n_rows, plan)
        pms, pout = cuda_ms(lambda: sc.sorted_window_accumulate_plain(
            idx, upd, n_rows, transposed=True))
        idx64 = idx.long()
        lms, _ = cuda_ms(lambda: torch.zeros(
            (n_rows, upd.shape[1]), device=upd.device).index_add_(
                0, idx64, upd))
        if not torch.equal(out, again):
            raise AssertionError(f"scatter n_rows={n_rows}: two runs differ")
        ref = sc.sorted_window_accumulate_plain(idx.cpu(), upd.cpu(), n_rows,
                                                transposed=True)
        out_c = out.cpu()
        bit_equal = torch.equal(out_c, ref)
        err = (out_c - ref).abs().max().item()
        ctl = (scatter_bf16_rows(idx, upd, n_rows, transposed=True).cpu()
               - ref).abs().max().item()
        gpu_plain = (pout.cpu() - ref).abs().max().item()
        del out, again, pout, ref, out_c
        hottest = int(torch.bincount(idx.long()).max())
        print(f"kernel scatter M={idx.shape[0]} C={upd.shape[1]} "
              f"n_rows={n_rows} transposed: deterministic (two runs "
              f"bit-equal); "
              f"bit-equal to the plain version on the CPU: {bit_equal} "
              f"(max_abs_err {err:g}, gate {K5_MAX_ABS_ERR:g} if not); "
              f"bf16-row control {ctl:g}; plain version on the card "
              f"(atomics) {gpu_plain:g}; {items} work items and {chunks} "
              f"chunks as item_plan gives them, the fullest cell holds "
              f"{hottest} rows; {ms:.3f} ms ({queued:.3f} ms a call when 10 "
              f"calls are queued back to back), the kernel it replaces read "
              f"{K5_EARLIER_MS[n_pad]:.3f} ms", flush=True)
        if not (bit_equal or err <= K5_MAX_ABS_ERR):
            raise AssertionError(f"scatter differs at n_rows={n_rows}: "
                                 f"{err:g}")
        if n_pad == 41 and not ms < lms:
            raise AssertionError(f"scatter at n_rows={n_rows}: {ms:.3f} ms, "
                                 f"not under index_add_'s {lms:.3f} ms")
        M, C = upd.shape
        report.add("scatter", f"M={M} C={C} n_rows={n_rows}", ms, pms, err,
                   nbytes(idx, upd) + 4 * n_rows * C, M * C, "fp32",
                   library_ms=lms)
    row = report.rows["scatter"]
    print(f"kernel scatter: the three calls of a training step take "
          f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, index_add_ "
          f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
          f"({100 * row['bound_ms'] / row['ms']:.1f}% reached); the kernel "
          f"it replaces read {sum(K5_EARLIER_MS.values()):.3f} ms",
          flush=True)

    # idx and upd are the 41^3 inputs from here on
    lines = []
    hot = idx.clone()
    hot[:300000] = n_rows // 2 + 5            # one cell with 300,000 rows
    hot = torch.sort(hot).values
    lines.append(scatter_case(torch, sc, "a cell of 300,000 rows", hot, upd,
                              n_rows, True, timed=True))
    small = slice(0, 1 << 18)
    one = torch.full_like(idx[small], 4242)
    lines.append(scatter_case(torch, sc, "every row on one cell", one,
                              upd[small], n_rows, True))
    out_of_range = torch.cat([torch.full_like(idx[:1 << 17], -5),
                              torch.full_like(idx[:1 << 17], n_rows)])
    lines.append(scatter_case(torch, sc, "every row out of range",
                              out_of_range, upd[small], n_rows, False))
    mixed = torch.sort(torch.cat([out_of_range[::2], idx[:1 << 17]])).values
    lines.append(scatter_case(torch, sc, "half the rows out of range", mixed,
                              upd[small], n_rows, True))
    rng = np.random.default_rng(3)
    idx8 = torch.tensor(np.sort(rng.integers(0, 3000, 200001)).astype(
        np.int32), device=DEVICE)
    upd8 = torch.tensor(rng.normal(size=(200001, 8)).astype(np.float32),
                        device=DEVICE)
    lines.append(scatter_case(torch, sc, "C = 8", idx8, upd8, 3000, False))
    lines.append(scatter_case(torch, sc, "no rows", idx8[:0], upd8[:0], 100,
                              True))
    print("kernel scatter, other inputs, each bit-equal to the plain version "
          "on the CPU and from run to run: " + "; ".join(lines), flush=True)


def nerf_config(n_steps, refresh_every=500):
    """The nerf family's defaults at full width, cut to ``n_steps`` steps
    with pg_scale [4] (one rebuild, from 160^3 / 2 to 160^3 voxels),
    occupancy_start 2 and the occupancy refreshed every ``refresh_every``
    steps (the family's 500 by default)."""
    from apnerf_torch.config import nerf_default
    return nerf_default(N_iters=n_steps, pg_scale=[4], occupancy_start=2,
                        occupancy_update_every=refresh_every)


def train_state(model, opt):
    """What a training step changes: the parameters, the Adam moments and
    count (copies)."""
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            {n: m.clone() for n, m in opt.mu.items()},
            {n: m.clone() for n, m in opt.nu.items()}, opt.count)


def put_state(torch, model, opt, saved):
    """``train_state``'s copy put back in place (the graphs read these
    tensors)."""
    params, mu, nu, count = saved
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    for n in mu:
        opt.mu[n].copy_(mu[n])
        opt.nu[n].copy_(nu[n])
    opt.count = count


def all_grads(torch, model, grads):
    """Every parameter's gradient from ``grads`` (by name; None is zero),
    copied."""
    return {n: torch.zeros_like(p) if grads.get(n) is None
            else grads[n].detach().float().clone()
            for n, p in model.named_parameters()}


def both_ways(torch, label, step, graphed, eager, batches, model, opt,
              gate):
    """One segment's graphed step ``step`` against the eager step from one
    state (the model's as it is, restored after): ``graphed(batch)`` /
    ``eager(batch)`` -> (loss, gradients by name) of one step on a host
    batch. The eager step first, its peak memory read before a graph
    exists; then the graphed step's first call (the step run eagerly and
    the capture: its ms, its peak memory), one replay against two eager
    steps (loss equal, each gradient leaf under ``gate`` of its max
    |grad|), the launches of a step each way (equal), ``TRAJ_STEPS``-step
    trajectories (graphed vs eager within ``TRAJ_GAP_MULT`` times the gap
    of two eager ones), ``BOTH_WAYS_STEPS`` steps timed each way (each
    synchronized; and graphed ones queued back to back), and the host's
    launch calls of a step each way under the profiler. Returns the line's
    readings."""
    from apnerf_torch import kernels
    from apnerf_torch.train.profile_stage1 import host_calls
    s0 = train_state(model, opt)

    def run(fn, batch):
        loss, grads = fn(batch)
        torch.cuda.synchronize()
        return loss.detach().clone(), all_grads(torch, model, grads)

    put_state(torch, model, opt, s0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    le, ge = run(eager, batches[0])
    e_peak = torch.cuda.max_memory_allocated()
    put_state(torch, model, opt, s0)
    le2, ge2 = run(eager, batches[0])
    put_state(torch, model, opt, s0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(graphed, batches[0])
    first_ms = 1e3 * (time.perf_counter() - t0)
    g_peak = torch.cuda.max_memory_allocated()
    put_state(torch, model, opt, s0)
    lg, gg = run(graphed, batches[0])
    worst, mean = grad_gap(gg, ge)
    worst2, mean2 = grad_gap(ge2, ge)
    counts = {}
    for way, fn in (("graphed", graphed), ("eager", eager)):
        put_state(torch, model, opt, s0)
        kernels.reset_launches()
        fn(batches[0])
        torch.cuda.synchronize()
        counts[way] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    traj = {}
    for way, fn in (("graphed", graphed), ("eager", eager),
                    ("eager2", eager)):
        put_state(torch, model, opt, s0)
        traj[way] = np.array([float(fn(b)[0])
                              for b in batches[:TRAJ_STEPS]])
    t_gap = float(np.abs(traj["graphed"] - traj["eager"]).max())
    e_gap = float(np.abs(traj["eager2"] - traj["eager"]).max())
    timed = batches[TRAJ_STEPS:TRAJ_STEPS + BOTH_WAYS_STEPS]
    ms = {}
    for way, fn in (("graphed", graphed), ("eager", eager)):
        put_state(torch, model, opt, s0)
        ms[way] = []
        for b in timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(b)
            torch.cuda.synchronize()
            ms[way].append(1e3 * (time.perf_counter() - t0))
    put_state(torch, model, opt, s0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in timed:
        out = graphed(b)
    float(out[0])
    queued_ms = 1e3 * (time.perf_counter() - t0) / len(timed)
    host = {}
    for way, fn in (("graphed", graphed), ("eager", eager)):
        put_state(torch, model, opt, s0)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn(batches[0])
            torch.cuda.synchronize()
        host[way] = host_calls(prof)
    put_state(torch, model, opt, s0)
    capture = {k: round(v, 1) for k, v in step.capture_ms.items()}
    print(f"{label} both ways ({nvidia_smi_line()}): a step graphed "
          f"{ms_text(ms['graphed'])}, eager {ms_text(ms['eager'])}, "
          f"graphed queued back to back {queued_ms:.2f} ms a step; the "
          f"first graphed step {first_ms:.1f} ms with the capture "
          f"{capture} ms; peak memory {g_peak / 2 ** 30:.3f} GiB graphed "
          f"(first step, capture included), {e_peak / 2 ** 30:.3f} GiB "
          f"eager; host launch calls a step graphed {host['graphed']}, "
          f"eager {host['eager']}; launches a step graphed "
          f"{counts['graphed']}, eager {counts['eager']}; one step: loss "
          f"equal {torch.equal(lg, le)} ({float(lg):.6f}), worst leaf max "
          f"abs err / max |grad| graphed vs eager {worst:.3g} (gate "
          f"{gate:g}), mean {mean:.3g}, two eager steps {worst2:.3g}, mean "
          f"{mean2:.3g}; {TRAJ_STEPS} steps: losses graphed vs eager max "
          f"abs diff {t_gap:.3g} (gate {TRAJ_GAP_MULT:g} x two eager "
          f"trajectories' {e_gap:.3g}); losses graphed "
          f"{[round(float(x), 6) for x in traj['graphed']]}", flush=True)
    if not (torch.equal(lg, le) and worst <= gate):
        raise AssertionError(f"{label}: graphed vs eager loss {float(lg)} /"
                             f" {float(le)}, gradients {worst:.3g}")
    if counts["graphed"] != counts["eager"]:
        raise AssertionError(f"{label}: launches graphed "
                             f"{counts['graphed']}, eager {counts['eager']}")
    if not t_gap <= TRAJ_GAP_MULT * e_gap:
        raise AssertionError(f"{label}: trajectories {t_gap:.3g} apart, "
                             f"two eager ones {e_gap:.3g}")
    # a replayed step launches its graph and no kernel from the host
    if host["graphed"]["graph"] != 1 or host["graphed"]["kernel"]:
        raise AssertionError(f"{label}: a graphed step made the launch "
                             f"calls {host['graphed']}")
    return dict(graphed_ms=statistics.median(ms["graphed"]),
                eager_ms=statistics.median(ms["eager"]),
                queued_ms=queued_ms, launches=counts["graphed"])


def feature_grad(torch, model, loss_fn, batch, occ):
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(batch, occ)
    loss.backward()
    torch.cuda.synchronize()
    return model.feature.grad.detach().clone()


def phase_train(torch, ckpt_dir):
    """Phase 4: stage-1 training at the nerf family's width."""
    from apnerf_torch import kernels
    from apnerf_torch.data import rays as raydata
    from apnerf_torch.data.synthetic import make_scene
    from apnerf_torch.models import tineuvox
    from apnerf_torch.train import stage1
    from apnerf_torch.utils.checkpoint import load_tineuvox, save_tineuvox
    t0 = time.perf_counter()
    data = make_scene(TRAIN_VIEWS, H, W, seed=0)
    scene_s = time.perf_counter() - t0
    cfg = nerf_config(TRAIN_STEPS, refresh_every=TRAIN_REFRESH)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    made = {}
    with record(stage1, "make_graphed_step", made):
        model, mcfg, stats = stage1.scene_rep_reconstruction(
            cfg, data, seed=0, log_every=1, device=DEVICE,
            ckpt_path=os.path.join(ckpt_dir, "fine_progress.pkl"),
            ckpt_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k]
                for k in ("scatter", "trilerp", "trilerp_grad")}
    # one graph a segment: before the occupancy switch, before the
    # rebuild, after it (the refresh at TRAIN_REFRESH copied in place)
    segments = [[round(v, 1) for v in st.capture_ms.values()]
                for st in made.pop("make_graphed_step")]
    if len(segments) != 3 or any(len(c) != 1 for c in segments):
        raise AssertionError(f"train: segment captures {segments}")
    losses = stats["loss"]
    secs = [0.0] + stats["seconds"]
    step_ms = [1e3 * (b - a) for a, b in zip(secs[:-1], secs[1:])]
    rebuild = cfg.train_config.pg_scale[-1]
    after = step_ms[rebuild:]              # steps rebuild + 1 ...
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    if launches["scatter"] == 0:
        raise AssertionError("train: K5 (scatter) was never launched")

    # one step's feature-grid gradient: K5 vs the plain version (atomics)
    # vs the bf16-row control, at the final model on a fresh batch
    stepsize = float(cfg.model_and_render.stepsize)
    ct = dict(cfg.train_config, _stepsize=stepsize)
    budget, _ = stage1.active_budget(ct["N_rand"], mcfg.max_steps(stepsize),
                                     0.25)
    occ = stage1.refresh_occupancy(model, stepsize)
    Ks = torch.tensor(data["Ks"], device=DEVICE)
    poses = torch.tensor(data["poses"], device=DEVICE)
    loss_fn = stage1.make_loss_fn(model, ct, Ks, poses, H, W, data["near"],
                                  data["far"], 1.0, active_budget=budget)
    index = raydata.build_ray_index(
        list(data["images"]), list(data["masks"]), data["times"],
        data["img_to_cam"], data["poses"], data["Ks"], H, W,
        np.asarray(mcfg.xyz_min), np.asarray(mcfg.xyz_max), data["near"],
        data["far"], device=DEVICE)
    sel = next(raydata.batch_index_generator(index.n, ct["N_rand"], seed=9))
    rgb, mval, tval, cam, pix = index.gather(sel)
    batch = {"rgb": torch.tensor(rgb, device=DEVICE),
             "mask": torch.tensor(mval, device=DEVICE),
             "time": torch.tensor(tval, device=DEVICE),
             "cam": torch.tensor(cam, device=DEVICE).long(),
             "pix": torch.tensor(pix, device=DEVICE).long()}
    g_k = feature_grad(torch, model, loss_fn, batch, occ)
    g_k2 = feature_grad(torch, model, loss_fn, batch, occ)
    with plain_kernels():
        g_p = feature_grad(torch, model, loss_fn, batch, occ)
    with plain_kernels(scatter=scatter_bf16_rows):
        g_c = feature_grad(torch, model, loss_fn, batch, occ)
    scale = g_p.abs().max().item()
    rel = (g_k - g_p).abs().max().item() / scale
    rel_c = (g_c - g_p).abs().max().item() / scale
    print(f"train stage1 grad: feature-grid gradient of one step, K5 vs the "
          f"plain version: max abs err / max |grad| = {rel:g} (gate "
          f"{GRAD_REL_ERR:g}; max |grad| {scale:g}); bf16-row control "
          f"{rel_c:g}; two K5 steps bit-equal: {torch.equal(g_k, g_k2)}",
          flush=True)
    if not (np.isfinite(scale) and scale > 0 and rel <= GRAD_REL_ERR):
        raise AssertionError(f"train: grid gradient differs ({rel:g})")
    del g_k, g_k2, g_p, g_c

    # the graphed step against the eager one, on the occupancy path at
    # the final grid (one segment of the run's kind)
    from apnerf_torch.train.masked_adam import MaskedAdam
    opt = MaskedAdam(model, ct)
    n_rand = int(ct["N_rand"])
    gstep = stage1.make_graphed_step(
        model, ct, opt, Ks, poses, H, W, data["near"], data["far"], 1.0,
        n_rand, active_budget=budget, occ_shape=mcfg.world_size)
    gstep.inputs["occ"].copy_(occ)
    estep = stage1.make_train_step(model, ct, opt, Ks, poses, H, W,
                                   data["near"], data["far"], 1.0,
                                   active_budget=budget)
    gen = raydata.batch_index_generator(index.n, n_rand, seed=11)
    host = []
    for _ in range(TRAJ_STEPS + BOTH_WAYS_STEPS):
        rgb, mval, tval, cam, pix = index.gather(next(gen))
        host.append({"rgb": rgb, "mask": mval, "time": tval, "cam": cam,
                     "pix": pix})

    def graphed(b):
        loss, _, grads = gstep(b, (False, True))
        return loss, grads

    def eager(b):
        loss, _ = estep(on_card(torch, b), False, occ, True)
        return loss, {n: p.grad for n, p in model.named_parameters()}

    bw = both_ways(torch, "train stage1", gstep, graphed, eager, host,
                   model, opt, GRAD_REL_ERR)
    step_launches = {k: bw["launches"].get(k, 0)
                     for k in ("trilerp", "trilerp_grad", "scatter")}
    if step_launches != G1_STEP_LAUNCHES:
        raise AssertionError(f"train stage1: G1 / K5 launches a step "
                             f"{step_launches}, not {G1_STEP_LAUNCHES}")
    del gstep, estep, opt

    # ray microbatching: at MICRO_N_RAND rays the JAX package's auto rule
    # cuts a batch in two, each half under its own active budget; both
    # halves' forwards and backwards in the step's one graph
    n_micro = stage1.microbatches(MICRO_N_RAND)
    mb_budget, _ = stage1.active_budget(MICRO_N_RAND // n_micro,
                                        mcfg.max_steps(stepsize), 0.25)
    ct_mb = dict(ct, N_rand=MICRO_N_RAND)
    opt = MaskedAdam(model, ct_mb)
    mb_step = stage1.make_graphed_step(
        model, ct_mb, opt, Ks, poses, H, W, data["near"], data["far"], 1.0,
        MICRO_N_RAND, active_budget=mb_budget, occ_shape=mcfg.world_size,
        n_micro=n_micro)
    mb_step.inputs["occ"].copy_(occ)
    mb_body = stage1.make_step_body(
        model, ct_mb, opt, Ks, poses, H, W, data["near"], data["far"], 1.0,
        active_budget=mb_budget, n_micro=n_micro)
    gen = raydata.batch_index_generator(index.n, MICRO_N_RAND, seed=12)
    mb_host = []
    for _ in range(TRAJ_STEPS + BOTH_WAYS_STEPS):
        rgb, mval, tval, cam, pix = index.gather(next(gen))
        mb_host.append({"rgb": rgb, "mask": mval, "time": tval, "cam": cam,
                        "pix": pix})

    def mb_graphed(b):
        loss, _, grads = mb_step(b, (False, True))
        return loss, grads

    def mb_eager(b):
        # make_train_step's step, with the gradients it took
        opt.advance()
        loss, _, grads = mb_body(on_card(torch, b), occ, False, True)
        return loss, grads

    mb = both_ways(torch, f"train stage1 microbatched ({MICRO_N_RAND} rays "
                   f"a step, {n_micro} microbatches of active budget "
                   f"{mb_budget})", mb_step, mb_graphed, mb_eager, mb_host,
                   model, opt, GRAD_REL_ERR)
    if n_micro != 2 or not mb["launches"].get("scatter"):
        raise AssertionError(f"train stage1 microbatched: {n_micro} "
                             f"microbatches, launches {mb['launches']}")
    del mb_step, mb_body, opt

    path = os.path.join(ckpt_dir, "fine_last.pkl")
    save_tineuvox(path, model)
    back = load_tineuvox(path, device=DEVICE)
    rng = np.random.default_rng(2)
    lo, hi = np.asarray(mcfg.xyz_min), np.asarray(mcfg.xyz_max)
    probe = (lo + (hi - lo) * rng.random((4096, 3))).astype(np.float32)
    a0 = tineuvox.eval_alpha_volume(model, probe, 0.5, stepsize)
    a1 = tineuvox.eval_alpha_volume(back, probe, 0.5, stepsize)
    if back.cfg != mcfg or not np.array_equal(a0, a1):
        raise AssertionError("train: fine_last.pkl does not reload the same "
                             "model")
    med = statistics.median(after)
    print(f"train stage1: nerf width, world size {mcfg.world_size} x "
          f"{mcfg.voxel_dim}, {TRAIN_STEPS} graphed steps of {ct['N_rand']} "
          f"rays (a refresh at step {TRAIN_REFRESH}) on "
          f"{TRAIN_VIEWS} views of {H}x{W} (scene made in {scene_s:.1f} s); "
          f"losses {[round(x, 6) for x in losses]}; "
          f"{med:.1f} ms/step (median of steps {rebuild + 1}-{TRAIN_STEPS}, "
          f"after the rebuild: {[round(x, 1) for x in after]}; "
          f"{nvidia_smi_line()}); whole run {train_s:.1f} s, step times "
          f"{[round(x, 1) for x in step_ms]} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches {launches}; segments' captures {segments} ms; "
          f"fine_last.pkl reloads with equal alpha", flush=True)
    return ({"stage1 train": launches, "stage1 microbatched step":
             mb["launches"]}, model, data, stepsize)


# Phases 5 and 6 render every mode two ways: through the renderer's image
# function (two CUDA-graph replays a view) and through its chunk loop (the
# image function removed), FRAMES frames each after a warm-up. The graphed
# images must equal the eager ones bit for bit: both run the same kernels
# on the same inputs in the same order.
FRAMES = 20
GRAPH_MAX_ABS_DIFF = 0.0


def host_ms(torch, fn, n=FRAMES):
    """Host-clock ms of ``n`` calls of ``fn(j)`` (j the call's number;
    each call reads its result back), after one call."""
    fn(0)
    out = []
    for j in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(j)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def ms_text(times):
    return (f"{statistics.median(times):.2f} ms (median of {len(times)}, "
            f"{min(times):.2f}-{max(times):.2f})")


def graph_vs_eager(torch, label, make_view, cases, K, c2w, h, w,
                   extra_keys=()):
    """One renderer's frames both ways. ``make_view()`` gives a fresh
    renderer; ``cases`` are (t, rot_params) pairs that its graphs all
    serve. The first graphed view (the capture in it) is timed and its
    peak memory read; then every case both ways, whose images must agree
    within ``GRAPH_MAX_ABS_DIFF``; the launches of a graphed frame must
    equal an eager frame's; ``FRAMES`` frames each way over the cases, the
    eager frame's peak memory and, under the profiler, the host's launch
    calls of a frame each way. Returns the medians, the launch counts."""
    from apnerf_torch import kernels
    from apnerf_torch.render.profile_render import host_launch_calls
    from apnerf_torch.render.render import render_image
    from apnerf_torch.render.renderers import chunk_loop

    def frame(view, case, graphed=True):
        t, rot = case
        fn = view(0, t) if rot is None else view(0, t, rot_params=rot)
        return render_image(fn if graphed else chunk_loop(fn), K, c2w, h, w,
                            chunk=CHUNK, extra_keys=extra_keys)

    view = make_view()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame(view, cases[0])
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    g_peak = torch.cuda.max_memory_allocated()
    calls = view.graphs.calls
    capture_ms = {k[0]: round(c.capture_ms, 1) for k, c in calls.items()}
    diff, equal = 0.0, True
    for case in cases:
        g, e = frame(view, case), frame(view, case, graphed=False)
        if sorted(g) != sorted(e):
            raise AssertionError(f"{label}: graphed {sorted(g)}, eager "
                                 f"{sorted(e)}")
        for k in e:
            equal &= bool(np.array_equal(g[k], e[k]))
            diff = max(diff, float(np.abs(np.asarray(g[k], np.float64)
                                          - e[k]).max()))
    counts = {}
    for way in (True, False):
        kernels.reset_launches()
        frame(view, cases[0], graphed=way)
        torch.cuda.synchronize()
        counts[way] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    g_ms = host_ms(torch, lambda j: frame(view, cases[j % len(cases)]))
    e_ms = host_ms(torch, lambda j: frame(view, cases[j % len(cases)],
                                          graphed=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame(view, cases[0], graphed=False)
    torch.cuda.synchronize()
    e_peak = torch.cuda.max_memory_allocated()
    host = {}
    for way in (True, False):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            frame(view, cases[0], graphed=way)
            torch.cuda.synchronize()
        host[way] = host_launch_calls(prof)
    print(f"{label} both ways ({nvidia_smi_line()}): a frame graphed "
          f"{ms_text(g_ms)}, eager {ms_text(e_ms)}; the first graphed view "
          f"{first_ms:.1f} ms with the captures {capture_ms} ms; peak "
          f"memory {g_peak / 2 ** 30:.3f} GiB graphed (first view, capture "
          f"included), {e_peak / 2 ** 30:.3f} GiB eager; host launch calls "
          f"a frame graphed {host[True]}, eager {host[False]}; launches a "
          f"frame graphed {counts[True]}, eager {counts[False]}; graphed vs "
          f"eager over {len(cases)} cases: max abs diff {diff:g} (gate "
          f"{GRAPH_MAX_ABS_DIFF:g}; bit-equal {equal})", flush=True)
    if counts[True] != counts[False]:
        raise AssertionError(f"{label}: launches graphed {counts[True]}, "
                             f"eager {counts[False]}")
    if not diff <= GRAPH_MAX_ABS_DIFF:
        raise AssertionError(f"{label}: graphed vs eager {diff:g}")
    # a graphed frame launches its graphs, and a kernel at most: the fill
    # of a static time
    if host[True]["graph"] != len(calls) or host[True]["kernel"] > 1:
        raise AssertionError(f"{label}: a graphed frame made the launch "
                             f"calls {host[True]}")
    return dict(graphed_ms=statistics.median(g_ms),
                eager_ms=statistics.median(e_ms), launches=counts[True])


def phase_render(torch, pcd, joints, bones, feat, ckpt_dir):
    """Phase 5: save/load the bench model, render exact and shared, each
    graphed and eager."""
    from apnerf_torch import kernels
    from apnerf_torch.data.bench_scene import bench_config, bench_heads
    from apnerf_torch.models import temporal_points as tp
    from apnerf_torch.render.render import render_image
    from apnerf_torch.render.renderers import (chunk_loop,
                                               make_points_renderer,
                                               render_view)
    from apnerf_torch.utils.checkpoint import (load_temporalpoints,
                                               save_temporalpoints)
    P, J, F = pcd.shape[0], joints.shape[0], feat.shape[1]
    gen = torch.Generator().manual_seed(1)
    cfg0 = bench_config(P, J, F)
    model = tp.init_params(cfg0, pcd, joints, bones, feat,
                           np.full(P, 0.5, np.float32),
                           np.full((P, 3), 0.5, np.float32),
                           bench_heads(cfg0, gen), generator=gen)
    # the bench's explicit pose (bench.py measure_mode), and a second pose
    # that the same graphs render
    rng = np.random.default_rng(1)
    rot = torch.tensor(np.concatenate(
        [rng.normal(size=(J, 3)), 0.2 * np.ones((J, 1))], -1).astype(
            np.float32), device=DEVICE)
    rot2 = rot.clone()
    rot2[:, 3] = -0.3
    Kmat = [[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]]
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.0
    # each mode's k-NN path and the kernel that runs its feat_net: K4, or,
    # with featmlp_kernel off (featnet_plain's formulation), K4's gathering
    # front
    modes = {"exact": (dict(knn_share=1), "exact", "featmlp"),
             "exact featnet_plain": (dict(knn_share=1, featmlp_kernel=False),
                                     "exact", "featmlp_gather"),
             "shared": (dict(knn_share=16, knn_cand=8, coarse_stride=32,
                             sample_budget=96, max_steps=512), "shared",
                        "featmlp")}
    images, launches = {}, {}
    for mode, (over, knn_path, feat_kernel) in modes.items():
        model.cfg = bench_config(P, J, F, **over)
        path = os.path.join(ckpt_dir,
                            f"temporalpoints_{mode.replace(' ', '_')}.pkl")
        save_temporalpoints(path, model, {
            "canonical_pcd": pcd, "skeleton_pcd": pcd[::40], "bones":
            np.asarray(bones), "xyz_min": pcd.min(0) - 0.1,
            "xyz_max": pcd.max(0) + 0.1, "frozen_view_dir": None,
            "original_joints": joints})

        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, state = load_temporalpoints(path, device=DEVICE)
        out = render_view(m, state, H, W, Kmat, c2w, rot_params=rot,
                          chunk=CHUNK)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        # K1 at the load; the image function's warm-up and its replay
        launches[mode] = dict(kernels.LAUNCHES)
        if out["knn_path"] != knn_path:
            raise AssertionError(f"{mode} render ran the {out['knn_path']} "
                                 "aggregation")
        idle = [k for k in (*RENDER_KERNELS[:3], feat_kernel)
                if launches[mode][k] == 0]
        if idle:
            raise AssertionError(f"{mode} render launched no {idle}")
        rgb = out["rgb"]
        if rgb.shape != (H, W, 3) or not bool(torch.isfinite(rgb).all()) \
                or not bool(torch.isfinite(out["depth"]).all()):
            raise AssertionError(f"{mode}: bad image {tuple(rgb.shape)}")
        fg = float((out["acc"] > 1e-3).float().mean())
        if fg < 0.01:
            raise AssertionError(f"{mode}: background-only image "
                                 f"(foreground {fg:.4f})")
        audit = out["budget_audit"].max(0).values.tolist()
        both = graph_vs_eager(
            torch, f"render {mode}",
            lambda: make_points_renderer(m, state, 0.5, 6.0, 1.0),
            [(None, rot), (None, rot2)], Kmat, c2w, H, W,
            extra_keys=("acc", "weights"))
        loads = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            load_temporalpoints(path, device=DEVICE)
            torch.cuda.synchronize()
            loads.append(1e3 * (time.perf_counter() - t0))

        def eager():
            fn = make_points_renderer(m, state, 0.5, 6.0, 1.0)(
                0, None, rot_params=rot)
            return render_image(chunk_loop(fn), Kmat, c2w, H, W, chunk=CHUNK,
                                extra_keys=("acc",))
        with plain_kernels():
            ref = eager()
        with plain_kernels(featmlp_fp32_layers, gather=gather_k4_rounding):
            ctl = eager()
        # over the foreground only: the background is bg whatever K4 gives
        fg_mask = (out["acc"] > 1e-3).cpu().numpy() | (ref["acc"] > 1e-3)
        ref_rgb = ref["rgb_marched"]
        p_db = psnr(rgb.cpu().numpy(), ref_rgb, fg_mask)
        c_db = psnr(ctl["rgb_marched"], ref_rgb, fg_mask)
        if not p_db >= PSNR_MIN_DB:
            raise AssertionError(f"{mode}: kernel vs plain {p_db:.2f} dB")
        images[mode] = rgb.cpu().numpy()
        dt = both["graphed_ms"] / 1e3
        print(f"render {mode}: {H}x{W} in {CHUNK}-ray chunks, graphed "
              f"{both['graphed_ms']:.1f} ms/frame, {H * W / dt:.0f} rays/s "
              f"(eager {both['eager_ms']:.1f} ms/frame), "
              f"first load+frame {first_s:.1f} s, load_temporalpoints "
              f"{statistics.median(loads):.1f} ms (median of "
              f"{[round(t, 1) for t in loads]}; K1 runs once in it), "
              f"foreground {fg:.3f}, "
              f"kernel vs plain {p_db:.2f} dB on the foreground (gate "
              f"{PSNR_MIN_DB:g}; control render {c_db:.2f} dB), "
              f"launches of the load and the first view {launches[mode]}, "
              f"of a frame {both['launches']}, "
              f"worst-chunk budget audit {audit}", flush=True)
    print("render shared vs exact: "
          f"{psnr(images['shared'], images['exact']):.2f} dB (bench.py gates "
          "its headline at 50 dB; information only, these weights are not "
          "the JAX bench's)", flush=True)
    return {k: sum(c[k] for c in launches.values())
            for k in (*RENDER_KERNELS, "featmlp_gather")}


def phase_procrustes_render(torch, pcd, joints, bones, feat, ckpt_dir):
    """Phase 5, avg_procrustes: phase 5's bench model in shared mode with
    the blended frames replaced by their nearest rotations (P1 in the
    frame graph): a view through ``render_view``, both ways, against the
    render with the float64 polar factor in P1's place (the reference) and
    the render of the blends (the control) against the same; the render
    through the plain versions is printed against it. Returns the view's
    launches."""
    import dataclasses
    from apnerf_torch import kernels
    from apnerf_torch.data.bench_scene import bench_config, bench_heads
    from apnerf_torch.kernels import procrustes as pk
    from apnerf_torch.models import temporal_points as tp
    from apnerf_torch.render.render import render_image
    from apnerf_torch.render.renderers import (chunk_loop,
                                               make_points_renderer,
                                               render_view)
    from apnerf_torch.utils.checkpoint import (load_temporalpoints,
                                               save_temporalpoints)
    P, J, F = pcd.shape[0], joints.shape[0], feat.shape[1]
    gen = torch.Generator().manual_seed(1)
    cfg = bench_config(P, J, F, avg_procrustes=True)
    model = tp.init_params(cfg, pcd, joints, bones, feat,
                           np.full(P, 0.5, np.float32),
                           np.full((P, 3), 0.5, np.float32),
                           bench_heads(cfg, gen), generator=gen)
    rng = np.random.default_rng(1)
    rot = torch.tensor(np.concatenate(
        [rng.normal(size=(J, 3)), 0.2 * np.ones((J, 1))], -1).astype(
            np.float32), device=DEVICE)
    rot2 = rot.clone()
    rot2[:, 3] = -0.3
    Kmat = [[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]]
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.0
    path = os.path.join(ckpt_dir, "temporalpoints_procrustes.pkl")
    save_temporalpoints(path, model, {
        "canonical_pcd": pcd, "skeleton_pcd": pcd[::40], "bones":
        np.asarray(bones), "xyz_min": pcd.min(0) - 0.1,
        "xyz_max": pcd.max(0) + 0.1, "frozen_view_dir": None,
        "original_joints": joints})
    m, state = load_temporalpoints(path, device=DEVICE)
    if not m.cfg.avg_procrustes:
        raise AssertionError("avg_procrustes did not survive the checkpoint")
    kernels.reset_launches()
    out = render_view(m, state, H, W, Kmat, c2w, rot_params=rot,
                      chunk=CHUNK)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    idle = [k for k in ("knn_count", "knn_radius", "featmlp", "procrustes")
            if not launches[k]]
    if idle:
        raise AssertionError(f"avg_procrustes render launched no {idle}")
    rgb = out["rgb"].cpu().numpy()
    acc = out["acc"].cpu().numpy()
    fg = float((acc > 1e-3).mean())
    if not (np.isfinite(rgb).all() and fg >= 0.01):
        raise AssertionError(f"avg_procrustes render: foreground {fg:.4f}")
    both = graph_vs_eager(
        torch, "render avg_procrustes",
        lambda: make_points_renderer(m, state, 0.5, 6.0, 1.0),
        [(None, rot), (None, rot2)], Kmat, c2w, H, W, extra_keys=("acc",))

    def eager():
        fn = make_points_renderer(m, state, 0.5, 6.0, 1.0)(
            0, None, rot_params=rot)
        return render_image(chunk_loop(fn), Kmat, c2w, H, W, chunk=CHUNK,
                            extra_keys=("acc",))
    def exact_polar(M):
        """The plain factors, R replaced by the float64 polar factor."""
        R, U, s, V = pk.procrustes_plain(M)
        R64 = polar64(M.cpu().numpy())[0].astype(np.float32)
        return torch.tensor(R64, device=M.device), U, s, V
    with plain_kernels(), mock.patch.object(pk, "procrustes_cuda",
                                            exact_polar):
        exact = eager()
    with plain_kernels():
        plain = eager()
    m.cfg = dataclasses.replace(m.cfg, avg_procrustes=False)
    blend = eager()
    m.cfg = dataclasses.replace(m.cfg, avg_procrustes=True)
    fg_mask = (acc > 1e-3) | (exact["acc"] > 1e-3)
    p_db = psnr(rgb, exact["rgb_marched"], fg_mask)
    c_db = psnr(blend["rgb_marched"], exact["rgb_marched"], fg_mask)
    s_db = psnr(plain["rgb_marched"], exact["rgb_marched"], fg_mask)
    k_db = psnr(rgb, plain["rgb_marched"], fg_mask)
    print(f"render avg_procrustes: shared k-NN, {H}x{W}, graphed "
          f"{both['graphed_ms']:.1f} ms/frame (eager {both['eager_ms']:.1f}"
          f"), foreground {fg:.3f}; launches of the view (its frame graph's "
          f"capture and replay) {launches}, of a frame {both['launches']}; "
          f"kernels vs the render with the float64 polar factor in P1's "
          f"place {p_db:.2f} dB on the foreground (gate "
          f"{PROCRUSTES_PSNR_MIN_DB:g}); control, the blended frames (no "
          f"avg_procrustes) vs the same: {c_db:.2f} dB; not gated: the "
          f"plain versions (torch.linalg.svd) vs the same {s_db:.2f} dB, "
          f"the kernels vs the plain versions {k_db:.2f} dB", flush=True)
    if not c_db < PROCRUSTES_PSNR_MIN_DB <= p_db:
        raise AssertionError(f"avg_procrustes render: {p_db:.2f} dB, control"
                             f" {c_db:.2f} dB")
    return launches


def phase_views(torch, ckpt_dir, stage1_model, stage1_data, stepsize):
    """Phase 6: ``render_viewpoints`` and ``repose`` at full width."""
    from apnerf_torch import cli, kernels
    from apnerf_torch.models import temporal_points as tp
    from apnerf_torch.render.render import render_viewpoints
    from apnerf_torch.render.renderers import (chunk_loop,
                                               make_backbone_renderer,
                                               make_points_renderer)
    from apnerf_torch.utils.checkpoint import load_temporalpoints
    near, far, bg = 0.5, 6.0, 1.0
    n = N_VIEWS
    # no device given: the entry points take the card
    model, state = load_temporalpoints(
        os.path.join(ckpt_dir, "temporalpoints_shared.pkl"))
    if state["canonical_pcd"].device.type != "cuda":
        raise AssertionError("load_temporalpoints did not take the card")
    base = model.cfg
    shared = dict(knn_share=16, knn_cand=8, coarse_stride=32)
    modes = {mode: cli.points_render_config(
        base, {"pcd_model_and_render": over}) for mode, over in (
            ("fused", dict(shared, fused_agg=True)),
            ("shared", dict(shared, fused_agg=False)),
            ("exact", dict(render_exact=True)))}
    # cameras on an arc about the cloud, times over the whole motion
    poses = np.repeat(np.eye(4, dtype=np.float32)[None], n, 0)
    for i, a in enumerate(np.linspace(-0.3, 0.3, n)):
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [3.0 * np.sin(a), 0.0, 3.0 * np.cos(a)]
    Ks = np.repeat(np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2],
                             [0, 0, 1]], np.float32)[None], n, 0)
    HW = np.array([[H, W]] * n)
    times = np.linspace(0.0, 1.0, n).astype(np.float32)
    data = dict(poses=poses, Ks=Ks, HW=HW)

    def renderer(mode):
        model.cfg = modes[mode]
        return make_points_renderer(model, state, near, far, bg,
                                    render_weights=False)

    def render(mode, graphed=True, view=None, **kw):
        view = view or renderer(mode)
        if not graphed:
            view = (lambda v: lambda i, t: chunk_loop(v(i, t)))(view)
        return render_viewpoints(view, poses, HW, Ks, times, chunk=CHUNK,
                                 verbose=False, **kw)

    with plain_kernels():
        ref = render("fused", graphed=False)
    with plain_kernels(agg=agg_fp32_layers):
        ctl = render("fused", graphed=False)
    kernels.reset_launches()
    out = render("fused", gt_imgs=ref["rgbs"], eval_psnr=True, eval_ssim=True,
                 eval_lpips_alex=True)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["agg"] == 0 or launches["featmlp"] != 0:
        raise AssertionError(f"render views: the fused render launched "
                             f"{launches}")
    rgbs = out["rgbs"]
    if rgbs.shape != (n, H, W, 3) or not np.isfinite(rgbs).all() \
            or not np.isfinite(out["depths"]).all():
        raise AssertionError(f"render views: bad images {rgbs.shape}")
    # over the foreground only: the background is bg whatever K6 gives
    fg_mask = foreground(rgbs, ref["rgbs"])
    fg = float(fg_mask.mean())
    if fg < 0.01:
        raise AssertionError(f"render views: background-only images "
                             f"(foreground {fg:.4f})")
    p_db = psnr(rgbs, ref["rgbs"], fg_mask)
    c_db = psnr(ctl["rgbs"], ref["rgbs"], fg_mask)
    if not p_db >= FUSED_PSNR_MIN_DB:
        raise AssertionError(f"render views: kernel vs plain {p_db:.2f} dB")

    # each mode both ways: frames one at a time (graph_vs_eager, the three
    # times from one graph), then render_viewpoints' overlapped passes,
    # whose images must agree as the frames'
    frame_ms, images = {}, {"fused": rgbs}
    for mode in modes:
        graph_vs_eager(torch, f"render views {mode}",
                       lambda: renderer(mode), [(t, None) for t in times],
                       Ks[0], poses[0], H, W)
        view = renderer(mode)
        res = {way: render(mode, way, view) for way in (True, False)}
        diff = max(float(np.abs(res[True][k] - res[False][k]).max())
                   for k in ("rgbs", "depths"))
        if not diff <= GRAPH_MAX_ABS_DIFF:
            raise AssertionError(f"render views {mode}: render_viewpoints "
                                 f"graphed vs eager {diff:g}")
        for way in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(mode, way, view)
            torch.cuda.synchronize()
            frame_ms[f"{mode} {'graphed' if way else 'eager'}"] = \
                1e3 * (time.perf_counter() - t0) / n
        images[mode] = res[True]["rgbs"]
    from apnerf_torch.render.metrics import lpips_metric_name
    print(f"render views: {n} views of {H}x{W} in {CHUNK}-ray chunks through "
          f"render_viewpoints, fused_agg: launches {launches}, foreground "
          f"{fg:.3f}, kernel vs plain {p_db:.2f} dB on the foreground (gate "
          f"{FUSED_PSNR_MIN_DB:g}; control render {c_db:.2f} dB); whole "
          f"images vs the plain render: psnr "
          f"{[round(x, 2) for x in out['psnrs']]}, ssim "
          f"{[round(x, 6) for x in out['ssims']]}, {lpips_metric_name('alex')}"
          f" {[float(f'{x:.3g}') for x in out['lpips_alex']]}; fused vs "
          f"shared {psnr(images['fused'], images['shared']):.2f} dB, shared "
          f"vs exact {psnr(images['shared'], images['exact']):.2f} dB; "
          f"ms/frame through render_viewpoints (readback included, mean "
          f"of {n} views after a pass that captured the graphs; "
          f"{nvidia_smi_line()}): "
          f"{ {k: round(v, 1) for k, v in frame_ms.items()} }", flush=True)

    # ---- at a smaller depth: the direct point-cloud render
    model.cfg = modes["shared"]
    kernels.reset_launches()
    direct = render_viewpoints(
        make_points_renderer(model, state, near, far, bg,
                             render_weights=False, render_pcd_direct=True),
        poses[:1], HW[:1], Ks[:1], times[:1], render_factor=2, chunk=CHUNK,
        verbose=False)["rgbs"]
    d_fg = float(((1.0 - direct.min(-1)) > 1e-3).mean())
    if direct.shape != (1, H // 2, W // 2, 3) \
            or not np.isfinite(direct).all() or d_fg < 0.01:
        raise AssertionError(f"render views: direct render {direct.shape}, "
                             f"foreground {d_fg:.4f}")
    print(f"render views direct: render_pcd_direct view of {H // 2}x"
          f"{W // 2}, foreground {d_fg:.3f}, launches "
          f"{dict(kernels.LAUNCHES)}", flush=True)

    # ---- simplify_skeleton, then a repose with LBS-weight images
    # (random weights move every joint a little: the threshold is the median
    # joint's largest angle, so that about half the joints count as static)
    from apnerf_torch.models import point_warper
    from apnerf_torch.ops import encoding
    train_times = np.linspace(0.0, 1.0, 20)
    with torch.no_grad():
        t_emb = encoding.poc_fre(
            torch.tensor(train_times, dtype=torch.float32,
                         device=DEVICE).reshape(-1, 1),
            encoding.poc_freqs(base.timebase_pe, DEVICE))
        angles = point_warper.transform_params(
            model.forward_warp, t_emb)[:, :base.n_joints, -1]
        thr = float(torch.rad2deg(angles.abs().amax(0)).median())
    new_state, info = tp.simplify_skeleton(
        model, state, train_times, deg_threshold=thr,
        five_percent_heuristic=True)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = cli.repose(model, new_state, data, near, far, bg, seed=0,
                     render_factor=4, chunk=CHUNK, verbose=False)
    torch.cuda.synchronize()
    rep_s = time.perf_counter() - t0
    if rep["rgbs"].shape != (60, H // 4, W // 4, 3) \
            or rep["weights"].shape != rep["rgbs"].shape \
            or not np.isfinite(rep["rgbs"]).all() \
            or not np.isfinite(rep["weights"]).all():
        raise AssertionError(f"render views: repose {rep['rgbs'].shape}, "
                             f"{rep['weights'].shape}")
    moved = float(np.abs(rep["depths"][29] - rep["depths"][0]).max())
    if not moved > 0:
        raise AssertionError("render views: the repose moved nothing")
    print(f"render views repose: simplify_skeleton at {thr:.2f} degrees "
          f"pruned "
          f"{int(info['prune_bones'].sum())} of "
          f"{len(info['prune_bones'])} joints, {len(info['new_bones'])} "
          f"bones left; repose 60 frames of {H // 4}x{W // 4} with "
          f"LBS-weight images in {rep_s:.1f} s, max depth change "
          f"{moved:.1f} steps, launches {dict(kernels.LAUNCHES)}",
          flush=True)

    # ---- the stage-1 backbone: its frames both ways at two times, at a
    # quarter of the view's side (a 400 x 400 frame takes ~3.3 s), then
    # one view at full size
    d = stage1_data
    bh, bw = int(d["HW"][0][0]) // 4, int(d["HW"][0][1]) // 4
    bK = np.array(d["Ks"][0], np.float32)
    bK[:2, :3] /= 4
    graph_vs_eager(torch, f"render views backbone {bh}x{bw}",
                   lambda: make_backbone_renderer(
                       stage1_model, stepsize, d["near"], d["far"], 1.0),
                   [(float(d["times"][0]), None),
                    (float(d["times"][-1]), None)],
                   bK, d["poses"][0], bh, bw)
    back = render_viewpoints(
        make_backbone_renderer(stage1_model, stepsize, d["near"], d["far"],
                               1.0),
        d["poses"][:1], d["HW"][:1], d["Ks"][:1], d["times"][:1],
        gt_imgs=d["images"][:1], render_factor=0, eval_psnr=True,
        chunk=CHUNK, verbose=False)
    if back["rgbs"].shape != (1, H, W, 3) \
            or not np.isfinite(back["rgbs"]).all() \
            or not np.isfinite(back["depths"]).all():
        raise AssertionError(f"render views: backbone {back['rgbs'].shape}")
    print(f"render views backbone: make_backbone_renderer view of {H}x{W} "
          f"of the stage-1 model after {TRAIN_STEPS} steps, psnr vs its "
          f"training image {back['psnrs'][0]:.2f} dB", flush=True)
    return {"agg": launches["agg"]}


# ---------------------------------------------------------------------------
# Phase 7: stage 2 -- the stage-1 model of phase 4 trained on, exported,
# then train_pcd at the nerf family's width
# ---------------------------------------------------------------------------

def continue_stage1(torch, cfg, data, ckpt_dir, n_more):
    """Phase 4's model trained ``n_more`` steps on through
    ``scene_rep_reconstruction`` (a resume from its progress checkpoint)
    -> (model, config, seconds)."""
    from apnerf_torch.train import stage1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, mcfg, stats = stage1.scene_rep_reconstruction(
        cfg, data, seed=0, log_every=n_more, device=DEVICE,
        ckpt_path=os.path.join(ckpt_dir, "fine_progress.pkl"))
    torch.cuda.synchronize()
    if not np.all(np.isfinite(stats["loss"])):
        raise AssertionError(f"stage2: stage-1 losses {stats['loss']}")
    return model, mcfg, time.perf_counter() - t0


def export_stage1(torch, cfg, model, out_dir):
    """``export_point_cloud`` of a stage-1 model at the configuration's
    thresholds, grid at the model's world size -> (artifacts, bracketed,
    seconds); ``bracketed``: the frequency search bracketed
    canonical_pcd_num within its guard."""
    import contextlib
    import io
    from apnerf_torch.train.export import export_point_cloud
    pm = cfg.pcd_model_and_render
    log = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        art = export_point_cloud(
            model, out_dir, float(cfg.data.canonical_t),
            float(cfg.model_and_render.stepsize),
            pcd_density_threshold=float(pm.pcd_density_threshold),
            skeleton_density_threshold=float(pm.skeleton_density_threshold),
            bone_length=float(pm.bone_length),
            canonical_pcd_num=float(pm.canonical_pcd_num), overwrite=True)
    secs = time.perf_counter() - t0
    return art, "did not bracket" not in log.getvalue(), secs


def check_export(art, bracketed, mcfg):
    can, sk = art["canonical"], art["skeleton"]
    n = len(can["pcd"])
    lo = can["pcd"].min(0) - 2 * mcfg.voxel_size
    hi = can["pcd"].max(0) + 2 * mcfg.voxel_size
    joints = np.asarray(sk["joints"])
    inside = bool(((joints >= lo) & (joints <= hi)).all())
    if not (bracketed and PCD_BAND[0] <= n <= PCD_BAND[1]
            and len(sk["bones"]) >= 1 and inside
            and np.isfinite(can["feat"]).all()):
        raise AssertionError(f"stage2: export bracketed {bracketed}, {n} "
                             f"points, {len(sk['bones'])} bones, joints "
                             f"inside {inside}")


def on_card(torch, batch):
    """A host batch as the eager steps take it: arrays on the card (index
    arrays as int64), numbers as they are."""
    out = {}
    for k, v in batch.items():
        if np.ndim(v) == 0:
            out[k] = v
        else:
            a = np.asarray(v)
            out[k] = torch.as_tensor(
                a.astype(np.int64 if a.dtype.kind in "iu" else np.float32),
                device=DEVICE)
    return out


def stage2_batch(torch, data, index, n_points, n_rand, seed):
    """One training batch as ``train_pcd`` draws it, on the host: ``n_rand``
    rays of the middle time, one chamfer view (its own camera)."""
    from apnerf_torch.train.stage2 import CH_M, CH_N
    rng = np.random.default_rng(seed)
    times = np.unique(data["times"])
    t_key = float(times[len(times) // 2])
    lo, hi = index.index_to_times[t_key]
    rgb, mval, _, cam, pix = index.gather(rng.integers(lo, hi, n_rand))
    row = int(np.nonzero(data["times"] == t_key)[0][0])
    ys, xs = np.nonzero(np.asarray(data["masks"][row]).reshape(H, W) > 0)
    mpix = np.stack([ys, xs], -1).astype(np.float32)
    c = int(data["img_to_cam"][row])
    return {
        "rgb": rgb, "mask": mval, "t": np.float32(t_key), "cam": cam,
        "pix": pix, "sparsity_on": 1.0,
        "chamfer_poses": np.asarray(data["poses"][c:c + 1], np.float32),
        "chamfer_Ks": np.asarray(data["Ks"][c:c + 1], np.float32),
        "chamfer_mask_pts": mpix[rng.integers(0, len(mpix), CH_M)][None],
        "chamfer_pcd_idx": rng.integers(0, n_points, CH_N)}


def stage2_grads(torch, model, loss_fn, batch):
    model.zero_grad(set_to_none=True)
    loss, _, _ = loss_fn(batch)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach().clone(), {
        n: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
        for n, p in model.named_parameters()}


def k4_step_inputs(torch, tp, loss_fn, batch):
    """The arguments of K4's training Function in one forward of
    ``loss_fn`` with ``featmlp_train``: (packed weights, n_pe, rel, feat,
    w, pose embedding, *layers)."""
    seen = {}
    real = tp.FeatMLPTrain.apply

    def capture(*args):
        seen["args"] = args
        return real(*args)

    with torch.no_grad(), mock.patch.object(tp.FeatMLPTrain, "apply",
                                            capture):
        loss_fn(batch)
    return seen["args"]


def k4_backward(torch, tp, args, formulation=False):
    """K4's training Function alone on ``args`` (``k4_step_inputs``),
    backward of one seeded cotangent -> the inputs' and layers' gradients;
    ``formulation``: the same through ``featnet_plain`` in bf16 instead."""
    wts, n_pe, *ts = args
    ts = [None if t is None else t.detach().clone().requires_grad_()
          for t in ts]
    rel, feat, w, pose, *layers = ts
    if formulation:
        h = tp.featnet_plain(list(zip(layers[::2], layers[1::2])), rel,
                             feat, w, pose, n_pe, torch.bfloat16)
    else:
        h = tp.FeatMLPTrain.apply(wts, n_pe, *ts)
    g = torch.randn(h.shape, generator=torch.Generator(
        device=h.device).manual_seed(0), device=h.device)
    h.backward(g)
    torch.cuda.synchronize()
    names = ["rel", "feat", "w", "pose"] + [f"layer{i}" for i in
                                            range(len(layers))]
    return {n: t.grad.float() for n, t in zip(names, ts)
            if t is not None and t.grad is not None}


def grad_gap(a, b):
    """(worst leaf's max |a - b| / max |b|, all leaves' mean |a - b| /
    max |b| weighted by size) over the leaves ``b`` reaches."""
    worst, num, den = 0.0, 0.0, 0
    for name, ref in b.items():
        scale = float(ref.abs().max())
        if scale == 0:
            continue
        d = (a[name] - ref).abs()
        worst = max(worst, float(d.max()) / scale)
        num += float(d.sum()) / scale
        den += d.numel()
    return worst, num / max(den, 1)


def check_k4_at_step(torch, args):
    """K4 against its plain version on the inputs the step gave it, under
    phase 3's gates, and the control (no per-layer bf16 round) outside the
    mean gate -> the line to print. Also reads K4's last-layer outputs one
    neighbour at a time (one-hot weights) against the plain version's: how
    many differ, by how many bf16 steps of the plain value, and how far
    their weighted sum is from h."""
    from apnerf_torch.kernels import featmlp as fm
    wts, _, rel, feat, w = args[:5]
    h = fm.featmlp_agg(rel, feat, w, wts)
    ph = fm.featmlp_plain(rel, feat, w, wts)
    pc = featmlp_fp32_layers(rel, feat, w, wts)
    f = last_layer_rows(rel, feat, wts)
    fk = torch.empty_like(f)
    for k in range(w.shape[1]):
        onehot = torch.zeros_like(w)
        onehot[:, k] = 1
        fk[:, k] = fm.featmlp_agg(rel, feat, onehot, wts)
    torch.cuda.synchronize()
    live = (w != 0).any(-1)
    top = float(ph.abs().max())
    d, dc = (h - ph).abs(), (pc - ph).abs()
    err, mean = float(d.max()) / top, float(d[live].mean()) / top
    over = beyond_last_round(torch, d, f, w) / top
    c_err, c_mean = float(dc.max()) / top, float(dc[live].mean()) / top
    df = (fk - f).abs()
    steps = torch.where(df == 0, 0.0, df / bf16_step(torch, f))
    resum = float((h - (fk * w.float()[..., None]).sum(1)).abs().max()) / top
    line = (f"K4 vs its plain version on the step's inputs ({rel.shape[0]} "
            f"rows, {int(live.sum())} with a neighbour weight, max |h| "
            f"{top:.3g}): max abs err / max |h| {err:.3g}, beyond one bf16 "
            f"step of the last layer's outputs {over:.3g} (gate "
            f"{K4_REL_MAX_ERR:.3g}), mean over the weighted rows {mean:.3g} "
            f"(gate {K4_REL_MEAN_ERR:g}); control without the per-layer "
            f"bf16 round: max {c_err:.3g}, mean {c_mean:.3g}; K4's "
            f"last-layer outputs, one neighbour at a time: "
            f"{int((df != 0).sum())} of {df.numel()} differ from the plain "
            f"version's, by at most {float(steps.max()):.3g} bf16 steps, max "
            f"|f| {float(f.abs().max()):.3g}, their weighted sum within "
            f"{resum:.3g} of h (over max |h|)")
    del f, fk, df, steps
    if not (bool(torch.isfinite(h).all()) and over <= K4_REL_MAX_ERR
            and mean <= K4_REL_MEAN_ERR < c_mean):
        raise AssertionError(f"stage2 featmlp_train: {line}")
    return line


def phase_stage2(torch, data, ckpt_dir, stage1_cfg):
    """Phase 7: stage-1 model on, export, train_pcd, kernel gradients,
    featmlp_train, save / load / render. Returns the launch counts of each
    path: the train_pcd run, the featmlp_train steps, the load and
    render."""
    import dataclasses
    from apnerf_torch import kernels
    from apnerf_torch.data import rays as raydata
    from apnerf_torch.models import temporal_points as tp
    from apnerf_torch.render.renderers import render_view
    from apnerf_torch.train import stage2
    from apnerf_torch.train.masked_adam import MaskedAdam
    from apnerf_torch.utils.checkpoint import (load_temporalpoints,
                                               params_to_jax,
                                               save_temporalpoints)
    cfg = stage1_cfg(TRAIN_STEPS + EXPORT_STEPS)
    s1, s1cfg, s1_s = continue_stage1(torch, cfg, data, ckpt_dir,
                                      EXPORT_STEPS)
    art, bracketed, export_s = export_stage1(torch, cfg, s1, ckpt_dir)
    check_export(art, bracketed, s1cfg)
    can, sk = art["canonical"], art["skeleton"]
    print(f"stage2 export: stage-1 model of phase 4 trained {EXPORT_STEPS} "
          f"steps on ({s1_s:.1f} s), export_point_cloud at world size "
          f"{s1cfg.world_size}: final sampling freq "
          f"{can['sampling_freq']:.4f}, {len(can['pcd'])} points (band "
          f"{PCD_BAND}), {len(sk['bones'])} bones, {len(sk['joints'])} "
          f"joints inside the cloud's bbox, {export_s:.1f} s", flush=True)

    heads = params_to_jax({k: v for k, v in s1.state_dict().items()
                           if k.split(".")[0] in tp.HEADS})
    bbox = (np.asarray(s1cfg.xyz_min), np.asarray(s1cfg.xyz_max))
    del s1
    clock = []

    def tick(step, model, mcfg, state, stats):
        torch.cuda.synchronize()
        clock.append(time.perf_counter())

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    made = {}
    with record(stage2, "make_graphed_step", made):
        model, mcfg, state, stats = stage2.train_pcd(
            cfg, data, can, sk, heads, s1cfg, bbox, seed=0,
            n_iters=STAGE2_STEPS, log_every=1, callback=tick,
            max_steps=STAGE2_MAX_STEPS, device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    capture = [round(v, 1) for st in made.pop("make_graphed_step")
               for v in st.capture_ms.values()]
    peak = torch.cuda.max_memory_allocated()
    losses = np.asarray(stats["loss"])
    terms = stats["terms"]
    third = max(1, STAGE2_STEPS // 3)
    if (len(losses) != STAGE2_STEPS or not all(
            np.isfinite(v) for t in terms for v in t.values())
            or not losses[-third:].mean() < losses[:third].mean()):
        raise AssertionError(f"stage2: losses {losses}, terms {terms}")
    if (launches["knn_brute"] != 1 or launches["knn_count"] < STAGE2_STEPS
            or launches["knn_radius"] < STAGE2_STEPS or launches["featmlp"]
            or launches["scatter"] or launches["agg"]):
        raise AssertionError(f"stage2: launches {launches}")
    step_ms = [1e3 * (b - a) for a, b in zip(clock[:-1], clock[1:])]
    B, c = mcfg.sample_budget, mcfg.coarse_stride
    n_rand = int(cfg.pcd_train_config.N_rand)
    M_full = n_rand * B
    M_act = tp.active_budget(mcfg, M_full)
    M_pass = min(max(1024, (int(M_act * mcfg.pass_fraction) + 1023)
                      // 1024 * 1024), M_act)
    if not (B == STAGE2_MAX_STEPS and B % c == 0 and M_act % c == 0):
        raise AssertionError(f"stage2: sample_budget {B}, coarse_stride {c}"
                             f", M_act {M_act}: not the fused group sampler")
    print(f"stage2 train: train_pcd, {STAGE2_STEPS} steps of {n_rand} rays "
          f"on {len(data['times'])} views of {H}x{W}, {mcfg.n_points} "
          f"points, {mcfg.n_joints} joints, F {mcfg.feat_dim}, "
          f"sample_budget {B} (max_steps {mcfg.max_steps}), fused group "
          f"sampler, "
          f"exact k-NN: M_full {M_full}, M_act {M_act}, pass budget "
          f"{M_pass}; median {statistics.median(step_ms):.1f} ms/step "
          f"(steps 2-{STAGE2_STEPS}, graph replays, synchronized; "
          f"{nvidia_smi_line()}); the capture {capture} ms; "
          f"step ms {[round(x, 1) for x in step_ms]}; whole call "
          f"{train_s:.1f} s; peak device memory {peak / 2 ** 30:.2f} GiB; "
          f"launches {launches}; losses "
          f"{[round(float(x), 4) for x in losses]}; "
          f"terms first {terms[0]}, last {terms[-1]}", flush=True)

    # ---- one step's gradients: K2 / K3 against their plain versions, on
    # the step's fused group sampler and on the non-fused sampler pair
    # (grouped, with K2's group prefilter, and per sample)
    dev_Ks = torch.tensor(data["Ks"], device=DEVICE)
    dev_poses = torch.tensor(data["poses"], device=DEVICE)
    index = raydata.build_ray_index(
        list(data["images"]), list(data["masks"]), data["times"],
        data["img_to_cam"], data["poses"], data["Ks"], H, W, bbox[0],
        bbox[1], data["near"], data["far"], device=DEVICE)
    batch = on_card(torch, stage2_batch(torch, data, index, mcfg.n_points,
                                        n_rand, 5))
    loss_fn = stage2.make_loss_fn(model, state, cfg.pcd_train_config,
                                  dev_Ks, dev_poses, H, W, data["near"],
                                  data["far"], 1.0, 1)
    pair = "sample_rays_compact + compact_active"
    for sampler, scfg, fused in (
            ("fused group sampler", mcfg, "1"),
            (f"{pair} on groups, APNERF_FUSED_SAMPLER=0", mcfg, "0"),
            (f"{pair} per sample, sample_budget {B - 1}",
             dataclasses.replace(mcfg, sample_budget=B - 1), "1")):
        model.cfg = scfg
        with mock.patch.dict(os.environ, {"APNERF_FUSED_SAMPLER": fused}):
            lk, gk = stage2_grads(torch, model, loss_fn, batch)
            lk2, gk2 = stage2_grads(torch, model, loss_fn, batch)
            with plain_kernels():
                lp, gp = stage2_grads(torch, model, loss_fn, batch)
        kp, kp_mean = grad_gap(gk, gp)
        kk, kk_mean = grad_gap(gk, gk2)
        print(f"stage2 grad ({sampler}): one step's gradients through K2 / "
              f"K3 vs their plain versions: loss equal {torch.equal(lk, lp)}"
              f" ({float(lk):.6f}); worst leaf max abs err / max |grad| "
              f"{kp:.3g} (gate {STAGE2_GRAD_REL_ERR:g}), mean {kp_mean:.3g};"
              f" two kernel steps: {kk:.3g}, mean {kk_mean:.3g}", flush=True)
        if not (torch.equal(lk, lp) and kp <= STAGE2_GRAD_REL_ERR):
            raise AssertionError(f"stage2 ({sampler}): gradients differ "
                                 f"({kp:.3g})")
        del gk, gk2, gp
    model.cfg = mcfg

    # ---- the graphed step against the eager one, from the trained state
    def stage2_both_ways(label):
        opt = MaskedAdam(model, cfg.pcd_train_config)
        gstep = stage2.make_graphed_step(
            model, state, cfg.pcd_train_config, opt, dev_Ks, dev_poses, H,
            W, data["near"], data["far"], 1.0, 1, n_rand)
        estep = stage2.make_train_step(
            model, state, cfg.pcd_train_config, opt, dev_Ks, dev_poses, H,
            W, data["near"], data["far"], 1.0, 1)
        host = [stage2_batch(torch, data, index, mcfg.n_points, n_rand,
                             20 + i)
                for i in range(TRAJ_STEPS + BOTH_WAYS_STEPS)]

        def graphed(b):
            metrics, grads, _ = gstep(b)
            return metrics["loss"], grads

        def eager(b):
            loss = estep(on_card(torch, b))["loss"]
            return loss, {n: p.grad for n, p in model.named_parameters()}

        return both_ways(torch, label, gstep, graphed, eager, host, model,
                         opt, STAGE2_GRAD_REL_ERR)

    stage2_both_ways("stage2 train")

    # ---- featmlp_train: K4 in the forward, the recompute backward, in
    # the graphed step
    model.cfg = dataclasses.replace(mcfg, featmlp_kernel=True)
    k4_both = stage2_both_ways("stage2 featmlp_train")
    k4_launches = k4_both["launches"]
    if k4_launches.get("featmlp", 0) < 1:
        raise AssertionError(f"stage2 featmlp_train: launches a step "
                             f"{k4_launches}")
    _, g4 = stage2_grads(torch, model, loss_fn, batch)
    with plain_kernels(featmlp=featmlp_fp32_layers):
        _, gc = stage2_grads(torch, model, loss_fn, batch)
    real_plain = tp.featnet_plain

    def recompute_fp32(layers, rel, feat, w, pose, n_pe, dtype):
        return real_plain([(a.float(), b.float()) for a, b in layers], rel,
                          feat.float(), w, pose, n_pe, torch.float32)

    args = k4_step_inputs(torch, tp, loss_fn, batch)
    k4_line = check_k4_at_step(torch, args)
    with mock.patch.object(tp, "featnet_plain", recompute_fp32):
        _, gb = stage2_grads(torch, model, loss_fn, batch)
        rb = k4_backward(torch, tp, args)
    rk = k4_backward(torch, tp, args)
    rf = k4_backward(torch, tp, args, formulation=True)
    del args
    model.cfg = mcfg
    _, gr = stage2_grads(torch, model, loss_fn, batch)
    k4_max, k4_mean = grad_gap(g4, gr)
    c_max, c_mean = grad_gap(gc, gr)
    b_max, b_mean = grad_gap(gb, gr)
    iso, iso_mean = grad_gap(rk, rf)
    iso_c, iso_c_mean = grad_gap(rb, rf)
    print(f"stage2 featmlp_train: K4 in the forward of the graphed step "
          f"(launches a step {k4_launches}); {k4_line}; the step's "
          f"gradients vs the XLA formulation's: "
          f"mean abs err / max |grad| {k4_mean:.3g} (ceiling "
          f"{K4_TRAIN_MEAN_REL_ERR:g}), worst leaf max {k4_max:.3g}; "
          f"controls: K4 without its per-layer bf16 round mean {c_mean:.3g}"
          f", max {c_max:.3g}; the recompute backward in fp32 mean "
          f"{b_mean:.3g}, max {b_max:.3g}. Wiring of FeatMLPTrain's "
          f"backward (the step's K4 inputs, one cotangent) vs featnet_plain"
          f"'s in bf16: worst leaf max abs err / max |grad| {iso:.3g} "
          f"(ceiling {K4_BACKWARD_REL_ERR:g}), mean {iso_mean:.3g}; the "
          f"recompute in fp32: {iso_c:.3g}, mean {iso_c_mean:.3g}",
          flush=True)
    if not (k4_mean <= K4_TRAIN_MEAN_REL_ERR
            and iso <= K4_BACKWARD_REL_ERR < iso_c):
        raise AssertionError(f"stage2 featmlp_train: gradients {k4_mean:.3g}"
                             f", K4's backward {iso:.3g} (fp32 {iso_c:.3g})")
    del g4, gc, gb, gr, rk, rf, rb

    # ---- avg_procrustes: P1's forward and backward in the graphed step
    model.cfg = dataclasses.replace(mcfg, avg_procrustes=True)
    ap_launches = stage2_both_ways("stage2 avg_procrustes")["launches"]
    if not (ap_launches.get("procrustes")
            and ap_launches.get("procrustes_grad")):
        raise AssertionError(f"stage2 avg_procrustes: launches a step "
                             f"{ap_launches}")
    la, ga = stage2_grads(torch, model, loss_fn, batch)
    with plain_kernels():
        lp, gp = stage2_grads(torch, model, loss_fn, batch)
    model.cfg = mcfg
    l_off, go = stage2_grads(torch, model, loss_fn, batch)
    a_max, a_mean = grad_gap(ga, gp)
    o_max, o_mean = grad_gap(go, gp)
    # P1 on the step's own input: the trained model's blended frames at
    # the batch's time
    with torch.no_grad():
        fr = tp.warp(model, state, t=batch["t"])["frames"][:, :3, :3]
    fr = fr.cpu().numpy()
    e = procrustes_errors(torch, fr, np.random.default_rng(31).normal(
        size=fr.shape).astype(np.float32))
    print(f"stage2 avg_procrustes ({nvidia_smi_line()}): P1 on the step's "
          f"blended frames: {procrustes_text(e)}. One step through P1 (and "
          f"K2 / K3) vs the plain versions (torch.linalg.svd and the closed "
          f"form), information only: loss {float(la):.6f} / {float(lp):.6f},"
          f" worst leaf max abs err / max |grad| {a_max:.3g}, mean "
          f"{a_mean:.3g}; the step without avg_procrustes (loss "
          f"{float(l_off):.6f}) vs the same plain one: {o_max:.3g}, mean "
          f"{o_mean:.3g}", flush=True)
    if not (procrustes_ok(e) and np.isfinite(float(la)) and all(
            bool(torch.isfinite(v).all()) for v in ga.values())):
        raise AssertionError(f"stage2 avg_procrustes: P1 on the step's "
                             f"frames {e}, loss {float(la)}")
    del ga, gp, go

    # ---- save, load (K1), render one view
    path = os.path.join(ckpt_dir, "temporalpoints_last.pkl")
    save_temporalpoints(path, model, state,
                        tineuvox_kwargs=s1cfg.get_kwargs(),
                        global_step=STAGE2_STEPS)
    kernels.reset_launches()
    m2, st2 = load_temporalpoints(path)
    view = render_view(m2, st2, H, W, data["Ks"][0], data["poses"][0],
                       t=float(data["times"][0]), near=data["near"],
                       far=data["far"], chunk=CHUNK)
    torch.cuda.synchronize()
    load_launches = dict(kernels.LAUNCHES)
    rgb = view["rgb"].cpu().numpy()
    acc = view["acc"].cpu().numpy()
    fg = float((acc > STAGE2_FG_ACC).mean())
    mask_fg = float((np.asarray(data["masks"][0]) > 0.5).mean())
    if not (np.isfinite(rgb).all() and fg >= 0.5 * mask_fg):
        raise AssertionError(f"stage2: render of the trained model, "
                             f"foreground {fg:.4f}")
    print(f"stage2 render: save_temporalpoints / load_temporalpoints "
          f"(launches {load_launches}) / render_view {H}x{W} of the "
          f"trained model: foreground (opacity > {STAGE2_FG_ACC:g}) {fg:.4f} "
          f"(gate: half the training mask's {mask_fg:.4f}), max opacity "
          f"{float(acc.max()):.3f}, psnr vs training view 0 "
          f"{psnr(rgb, data['images'][0]):.2f} dB", flush=True)
    ctx = dict(cfg=cfg, data=data, can=can, sk=sk, heads=heads,
               s1cfg=s1cfg, bbox=bbox)
    return {"stage2 train": launches, "stage2 featmlp_train": k4_launches,
            "stage2 avg_procrustes": ap_launches,
            "stage2 load and render": load_launches}, ctx


# ---------------------------------------------------------------------------
# Phase 9: the mesh paths (apnerf_torch.parallel) at world size 1 on NCCL
# ---------------------------------------------------------------------------
def nccl_profile(torch, fn):
    """``fn()`` (one graph replay) under the profiler -> (host launch
    calls, the device's NCCL kernels and device-to-device copies: a
    world-size-1 group's collectives are copies or nothing)."""
    from apnerf_torch.train.profile_stage1 import host_calls
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = {"nccl kernels": sum(e.count for e in device
                                if "nccl" in e.key.lower()),
            "DtoD copies": sum(e.count for e in device
                               if "memcpy" in e.key.lower()
                               and "dtod" in e.key.lower())}
    return host_calls(prof), nccl


def loss_gap(a, b):
    """Largest relative difference of two loss sequences."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def param_gap(a, b):
    """Largest absolute difference of two parameter dicts (CPU copies)."""
    return max(float((v - b[n]).abs().max()) for n, v in a.items())


def mesh_trainer_runs(torch, label, train, mesh, gate_launches, replay):
    """``train(mesh, made) -> (model, losses, step ms, the segments'
    steps)`` run twice without the mesh (the second the control: two runs
    of one program) and once with it, each with the launch counts at 0
    just before it -> the readings of each run, the mesh run's largest
    relative loss gap to the first run and the control's. After a run,
    ``replay(last segment's step)`` once under the profiler, then the
    run's model, graphs and optimizer are freed (three runs' graph pools
    do not fit the card together). The losses must agree step for step:
    the first step's equal, and the mesh run's gap within
    ``TRAJ_GAP_MULT`` times the control's (or both zero)."""
    import gc
    from apnerf_torch import kernels
    runs = {}
    for name, m in (("plain", None), ("control", None), ("mesh", mesh)):
        made = {}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        model, losses, step_ms, steps = train(m, made)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - held
        host, nccl = nccl_profile(torch, lambda: replay(steps[-1]))
        runs[name] = dict(
            losses=np.asarray(losses), step_ms=step_ms, whole_s=whole_s,
            launches=launches, peak=peak, host=host, nccl=nccl,
            captures=[round(v, 1) for st in steps
                      for v in st.capture_ms.values()],
            params={n: p.detach().float().cpu()
                    for n, p in model.named_parameters()},
            split=[len(o.split) for o in made.get("MaskedAdam", [])])
        del model, steps, made
    gate_launches(runs["mesh"]["launches"])
    plain, mesh_run = runs["plain"], runs["mesh"]
    gap = loss_gap(mesh_run["losses"], plain["losses"])
    control = loss_gap(runs["control"]["losses"], plain["losses"])
    first_equal = mesh_run["losses"][0] == plain["losses"][0]
    if not (first_equal and (gap <= TRAJ_GAP_MULT * control
                             or gap == control == 0.0)):
        raise AssertionError(f"{label}: losses with the mesh "
                             f"{mesh_run['losses']} vs without "
                             f"{plain['losses']} (gap {gap:.3g}, control "
                             f"{control:.3g})")
    return runs, gap, control


def phase_mesh(torch, ctx, s1_data, ckpt_dir):
    """Phase 9: ``scene_rep_reconstruction(mesh=)``, ``train_pcd(mesh=)``
    and ``make_points_renderer(mesh=)`` through ``render_viewpoints`` on a
    world-size-1 NCCL group (``apnerf_torch.parallel``), each against the
    same call without the mesh. Returns the launch counts of each mesh
    path."""
    import dataclasses
    import socket
    import torch.distributed as dist
    from apnerf_torch import cli, kernels, parallel
    from apnerf_torch.render.render import render_viewpoints
    from apnerf_torch.render.renderers import make_points_renderer
    from apnerf_torch.train import stage1, stage2
    from apnerf_torch.utils.checkpoint import load_temporalpoints
    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    parallel.initialize(1, 0, init_method=f"tcp://localhost:{port}",
                        device=DEVICE)
    by_path = {}
    try:
        mesh = parallel.make_mesh(1)
        if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
            raise AssertionError(f"mesh: backend {dist.get_backend()} on "
                                 f"{mesh.device}")
        print(f"mesh: a world-size-1 NCCL group on {mesh.device} formed in "
              f"{time.perf_counter() - t0:.1f} s (torch "
              f"{torch.__version__}, NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))})",
              flush=True)

        # ---- stage 1: phase 4's run, with and without the mesh
        cfg1 = nerf_config(TRAIN_STEPS, refresh_every=TRAIN_REFRESH)

        def train1(m, made):
            with record(stage1, "make_graphed_step", made), \
                    record(stage1, "MaskedAdam", made):
                model, _, stats = stage1.scene_rep_reconstruction(
                    cfg1, s1_data, seed=0, log_every=1, device=DEVICE,
                    mesh=m)
            secs = [0.0] + stats["seconds"]
            ms = [1e3 * (b - a) for a, b in zip(secs[:-1], secs[1:])]
            return (model, stats["loss"],
                    ms[cfg1.train_config.pg_scale[-1]:],
                    made["make_graphed_step"])

        def gate1(launches):
            if launches["scatter"] == 0:
                raise AssertionError(f"mesh stage1: launches {launches}")

        runs, gap, control = mesh_trainer_runs(
            torch, "mesh stage1", train1, mesh, gate1,
            lambda st: st({}, next(iter(st.graphs.calls))))
        by_path["mesh stage1"] = runs["mesh"]["launches"]
        mesh_summary("mesh stage1", runs, gap, control)
        del runs

        # ---- stage 2: phase 7's train_pcd, 10 steps, ZeRO-1 on
        def train2(m, made):
            clock = []

            def tick(step, *args):
                torch.cuda.synchronize()
                clock.append(time.perf_counter())
            with record(stage2, "make_graphed_step", made), \
                    record(stage2, "MaskedAdam", made):
                model, _, _, stats = stage2.train_pcd(
                    ctx["cfg"], ctx["data"], ctx["can"], ctx["sk"],
                    ctx["heads"], ctx["s1cfg"], ctx["bbox"], seed=0,
                    n_iters=MESH_STAGE2_STEPS, log_every=1, callback=tick,
                    max_steps=STAGE2_MAX_STEPS, device=DEVICE, mesh=m)
            ms = [1e3 * (b - a) for a, b in zip(clock[:-1], clock[1:])]
            return model, stats["loss"], ms, made["make_graphed_step"]

        def gate2(launches):
            if (launches["knn_brute"] != 1
                    or launches["knn_count"] < MESH_STAGE2_STEPS
                    or launches["knn_radius"] < MESH_STAGE2_STEPS):
                raise AssertionError(f"mesh stage2: launches {launches}")

        runs, gap, control = mesh_trainer_runs(
            torch, "mesh stage2", train2, mesh, gate2, lambda st: st({}))
        split = runs["mesh"]["split"]
        if not (split and split[-1]):
            raise AssertionError(f"mesh stage2: ZeRO-1 split {split}")
        by_path["mesh stage2"] = runs["mesh"]["launches"]
        mesh_summary("mesh stage2", runs, gap, control,
                     f"ZeRO-1 split the moments of {split[-1]} of "
                     f"{len(runs['mesh']['params'])} parameters; ")
        del runs

        # ---- views: phase 5's checkpoint, fused and exact, one 400x400
        # view each through render_viewpoints
        model, state = load_temporalpoints(
            os.path.join(ckpt_dir, "temporalpoints_shared.pkl"))
        base = model.cfg
        modes = {mode: cli.points_render_config(
            base, {"pcd_model_and_render": over}) for mode, over in (
                ("fused", dict(knn_share=16, knn_cand=8, coarse_stride=32,
                               fused_agg=True)),
                ("exact", dict(render_exact=True)))}
        pose = np.eye(4, dtype=np.float32)
        pose[2, 3] = 3.0
        K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                     np.float32)
        views = {}
        for mode, mcfg in modes.items():
            model.cfg = mcfg
            out = {}
            for name, m in (("plain", None), ("mesh", mesh)):
                view = make_points_renderer(model, state, 0.5, 6.0, 1.0,
                                            render_weights=False, mesh=m)

                def frame(view=view):
                    return render_viewpoints(
                        view, pose[None], np.array([[H, W]]), K[None],
                        [0.5], chunk=CHUNK, verbose=False)["rgbs"][0]
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                frame()                       # the capture
                torch.cuda.synchronize()
                kernels.reset_launches()
                img = frame()
                torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)
                peak = torch.cuda.max_memory_allocated() - held
                ms = cuda_ms(frame, reps=5)[0]
                host, nccl = nccl_profile(torch, frame)
                out[name] = dict(img=img, launches=launches, peak=peak,
                                 ms=ms, host=host, nccl=nccl)
            views[mode] = out
            if mode == "fused" and not (out["mesh"]["launches"]["agg"]
                                        and not out["mesh"]["launches"]
                                        ["featmlp"]):
                raise AssertionError(f"mesh views: fused launches "
                                     f"{out['mesh']['launches']}")
            if mode == "exact" and not all(
                    out["mesh"]["launches"][k]
                    for k in ("knn_count", "knn_radius", "featmlp")):
                raise AssertionError(f"mesh views: exact launches "
                                     f"{out['mesh']['launches']}")
            equal = np.array_equal(out["mesh"]["img"], out["plain"]["img"])
            fg = float((out["plain"]["img"] < 0.99).any(-1).mean())
            print(f"mesh views {mode} ({nvidia_smi_line()}): one 400x400 "
                  f"view through make_points_renderer(mesh=) / "
                  f"render_viewpoints (foreground {fg:.3f}): bit-equal to "
                  f"the view without the mesh {equal}; ms a frame graphed "
                  f"{out['mesh']['ms']:.2f} with the mesh, "
                  f"{out['plain']['ms']:.2f} without; a frame's host calls "
                  f"{out['mesh']['host']} with, {out['plain']['host']} "
                  f"without; on the device a frame {out['mesh']['nccl']} "
                  f"with, {out['plain']['nccl']} without; peak memory "
                  f"(the capture included, above what was held) "
                  f"{out['mesh']['peak'] / 2 ** 30:.3f} / "
                  f"{out['plain']['peak'] / 2 ** 30:.3f} GiB; launches "
                  f"{out['mesh']['launches']}", flush=True)
            if not (equal and fg > 0.01):
                raise AssertionError(f"mesh views {mode}: images differ "
                                     f"(foreground {fg:.4f})")
        by_path["mesh views"] = {
            k: sum(v["mesh"]["launches"][k] for v in views.values())
            for k in kernels.LAUNCHES}
        model.cfg = base
        del views, model, state
    finally:
        parallel.shutdown()
    print(f"mesh: phase 9 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_path


def mesh_summary(label, runs, gap, control, extra=""):
    """The line of one trainer's mesh runs: losses, parameters, ms a step,
    what a replay of the last segment's graph launches, peak memory."""
    plain, mesh_run = runs["plain"], runs["mesh"]
    p_gap = param_gap(mesh_run["params"], plain["params"])
    p_ctl = param_gap(runs["control"]["params"], plain["params"])
    ms_m, ms_p = mesh_run["step_ms"], plain["step_ms"]
    losses = [round(float(x), 6) for x in mesh_run["losses"]]
    print(f"{label} ({nvidia_smi_line()}): {len(losses)} graphed steps "
          f"with mesh=make_mesh(1) against the same without it: first loss "
          f"equal, largest relative loss gap {gap:.3g} (two runs without "
          f"the mesh: {control:.3g}; gate {TRAJ_GAP_MULT:g} x that, or "
          f"both 0), parameters' max abs difference after the last step "
          f"{p_gap:.3g} (control {p_ctl:.3g}); {extra}ms a step graphed "
          f"{statistics.median(ms_m):.2f} with the mesh, "
          f"{statistics.median(ms_p):.2f} without (medians; "
          f"{[round(x, 1) for x in ms_m]} / {[round(x, 1) for x in ms_p]}"
          f"); the mesh run's captures {mesh_run['captures']} ms; a "
          f"replay's host calls {mesh_run['host']} with, {plain['host']} "
          f"without; on the device a replay {mesh_run['nccl']} with, "
          f"{plain['nccl']} without; peak memory "
          f"{mesh_run['peak'] / 2 ** 30:.3f} / {plain['peak'] / 2 ** 30:.3f}"
          f" GiB; whole calls {mesh_run['whole_s']:.1f} / "
          f"{plain['whole_s']:.1f} s; launches {mesh_run['launches']}; "
          f"losses {losses}", flush=True)


# ---------------------------------------------------------------------------
# Phase 8: the command line -- python -m apnerf_torch.cli's main on a
# D-NeRF dataset written to disk
# ---------------------------------------------------------------------------
def cli_configs(scene_dir):
    """(train / render config, the repose config over it) as file texts:
    the nerf family's jumpingjacks config at full width, cut in steps
    (and pg_scale to one rebuild inside the run, occupancy from step 2, as
    phase 4), with ``CLI_SAMPLE_BUDGET`` and ``featmlp_train`` (a
    checkpoint's ``featmlp_kernel`` decides whether its render takes K4:
    as in the JAX package, a model trained without it renders through the
    XLA formulation); the repose config adds the subgroup-shared k-NN and
    fused_agg."""
    base = REPO / "apnerf_torch" / "config" / "configs" / "nerf" / \
        "jumpingjacks.py"
    train = (f"_base_ = {str(base)!r}\n"
             f"expname = 'arm'\nbasedir = './logs/'\n"
             f"data = dict(datadir={str(scene_dir)!r}, half_res=True)\n"
             f"train_config = dict(N_iters={CLI_STAGE1_STEPS}, "
             f"pg_scale=[4], occupancy_start=2)\n"
             f"pcd_train_config = dict(N_iters={CLI_STAGE2_STEPS})\n"
             f"pcd_model_and_render = dict("
             f"sample_budget={CLI_SAMPLE_BUDGET}, featmlp_train=True)\n")
    fused = ("_base_ = './cli_train.py'\n"
             "pcd_model_and_render = dict(knn_share=16, knn_cand=8, "
             "coarse_stride=32, fused_agg=True)\n")
    return train, fused


@contextmanager
def record(mod, name, store, timed=False):
    """``mod.name`` wrapped: each call's result (and, ``timed``, its
    synchronized seconds) appended to ``store[name]``."""
    import torch
    real = getattr(mod, name)

    def wrapper(*args, **kwargs):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        if timed:
            torch.cuda.synchronize()
        store.setdefault(name, []).append(
            (out, time.perf_counter() - t0) if timed else out)
        return out
    with mock.patch.object(mod, name, wrapper):
        yield


@contextmanager
def timed_steps(stage2, log):
    """Every stage-2 step of ``train_pcd`` (a graph replay after the
    first) timed (synchronized) and its loss logged: ``log`` gets
    (seconds, loss) a step."""
    import torch
    real = stage2.make_graphed_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            log.append((time.perf_counter() - t0, float(out[0]["loss"])))
            return out
        return timed
    with mock.patch.object(stage2, "make_graphed_step", make):
        yield


def cli_run(torch, argv, store=None):
    """``cli.main(argv)`` on the card (no device given) with the launch
    counts at 0 just before it -> (launch counts, seconds, what
    ``render_viewpoints`` returned, one entry a call)."""
    from apnerf_torch import cli, kernels
    from apnerf_torch.render import render as rmod
    store = {} if store is None else store
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with record(rmod, "render_viewpoints", store):
        cli.main(argv)
    torch.cuda.synchronize()
    return (dict(kernels.LAUNCHES), time.perf_counter() - t0,
            store.get("render_viewpoints", []))


def foreground(a, b):
    """Pixels off the white background in either of two image stacks."""
    return ((1.0 - a.min(-1)) > 1e-3) | ((1.0 - b.min(-1)) > 1e-3)


def phase_cli(torch):
    """Phase 8: the command line on a D-NeRF dataset on disk. Returns the
    launch counts of its four invocations, summed."""
    t_phase = time.perf_counter()
    try:
        import torch.utils.tensorboard  # noqa: F401
        writer = "found (torch.utils.tensorboard)"
    except ImportError:
        writer = "not found: no previews"
    with tempfile.TemporaryDirectory() as work, working_dir(work):
        return cli_invocations(torch, work, writer, t_phase)


@contextmanager
def working_dir(path):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def cli_invocations(torch, work, writer, t_phase):
    """Phase 8's body, in the working directory ``work``."""
    import glob
    from apnerf_torch.data.synthetic import generate_scene
    from apnerf_torch.render.metrics import to8b
    from apnerf_torch.train import export, stage1, stage2
    from apnerf_torch.utils import png
    t0 = time.perf_counter()
    scene = generate_scene(os.path.join(work, "scene", "arm"),
                           n_times=CLI_TRAIN_VIEWS, n_test=CLI_TEST_VIEWS,
                           H=CLI_SIZE, W=CLI_SIZE)
    scene_s = time.perf_counter() - t0
    # one decode of a written file (the writer's Sub rows) and of the same
    # image with Paeth rows (the anti-diagonal walk)
    first = os.path.join(scene, "train", "r_000.png")
    t0 = time.perf_counter()
    img = png.read_png(first)
    dec_sub = time.perf_counter() - t0
    paeth = os.path.join(work, "paeth.png")
    png.write_png(paeth, img, filter_type=4)
    t0 = time.perf_counter()
    same = np.array_equal(png.read_png(paeth), img)
    dec_paeth = time.perf_counter() - t0
    if img.shape != (CLI_SIZE, CLI_SIZE, 4) or not same:
        raise AssertionError(f"cli: png {img.shape}, Paeth round trip "
                             f"{same}")
    cfg_train, cfg_fused = cli_configs(scene)
    Path("cli_train.py").write_text(cfg_train)
    Path("cli_fused.py").write_text(cfg_fused)
    run = os.path.join("logs", "arm")
    print(f"cli scene: generate_scene wrote {CLI_TRAIN_VIEWS} train, "
          f"{CLI_TEST_VIEWS} test and 1 val RGBA PNGs of {CLI_SIZE}x"
          f"{CLI_SIZE} in {scene_s:.1f} s (numpy ray march on the host); "
          f"read_png of one: {1e3 * dec_sub:.1f} ms (Sub rows), "
          f"{1e3 * dec_paeth:.1f} ms (Paeth rows); tensorboard writer "
          f"{writer}", flush=True)

    # ---- 1. train both stages
    from apnerf_torch import cli
    store, steps2 = {}, []
    with record(cli, "load_everything", store, timed=True), \
            record(stage1, "scene_rep_reconstruction", store), \
            record(export, "export_point_cloud", store, timed=True), \
            timed_steps(stage2, steps2):
        launches, train_s, _ = cli_run(
            torch, ["--config", "cli_train.py", "--i_print", "5",
                    "--i_save", "10"])
    for f in ("fine_last.pkl", "pcds/canonical.pkl", "pcds/skeleton.pkl",
              "temporalpoints_last.pkl"):
        if not os.path.isfile(os.path.join(run, f)):
            raise AssertionError(f"cli train: {f} was not written")
    _, _, s1 = store["scene_rep_reconstruction"][0]
    art, export_s = store["export_point_cloud"][0]
    load_s = store["load_everything"][0][1]
    l1 = np.asarray(s1["loss"])
    l2 = np.asarray([loss for _, loss in steps2])
    third = max(1, len(l2) // 3)
    n_pts = len(art["canonical"]["pcd"])
    if (len(l1) != CLI_STAGE1_STEPS // 5 or not np.isfinite(l1).all()
            or not l1[-3:].mean() < l1[0]):
        raise AssertionError(f"cli train: stage-1 losses {l1}")
    if (len(l2) != CLI_STAGE2_STEPS or not np.isfinite(l2).all()
            or not l2[-third:].mean() < l2[:third].mean()):
        raise AssertionError(f"cli train: stage-2 losses {l2}")
    if not PCD_BAND[0] <= n_pts <= PCD_BAND[1]:
        raise AssertionError(f"cli train: {n_pts} points exported")
    if (launches["scatter"] == 0 or launches["knn_brute"] != 1
            or launches["knn_count"] < CLI_STAGE2_STEPS
            or launches["knn_radius"] < CLI_STAGE2_STEPS
            or launches["featmlp"] == 0 or launches["agg"]):
        raise AssertionError(f"cli train: launches {launches}")
    secs = [0.0] + s1["seconds"]
    s1_ms = [200.0 * (b - a) for a, b in zip(secs[1:-1], secs[2:])]
    s2_ms = [1e3 * s for s, _ in steps2[1:]]
    tb = sorted(os.listdir(os.path.join("logs", "tensorboard", "arm"))) \
        if os.path.isdir(os.path.join("logs", "tensorboard", "arm")) else []
    print(f"cli train: python -m apnerf_torch.cli --config <jumpingjacks, "
          f"N_iters {CLI_STAGE1_STEPS} / {CLI_STAGE2_STEPS}> --i_print 5 "
          f"--i_save 10 in {train_s:.1f} s ({nvidia_smi_line()}): the "
          f"dataset loaded (PNG decode, half_res) in {load_s:.2f} s; stage 1 "
          f"{statistics.median(s1_ms):.1f} ms/step (graph replays; median "
          f"over 5-step intervals after the first: "
          f"{[round(x, 1) for x in s1_ms]}), "
          f"losses {[round(float(x), 5) for x in l1]}; export "
          f"{export_s:.1f} s, {n_pts} points, "
          f"{len(art['skeleton']['bones'])} bones; stage 2 "
          f"{statistics.median(s2_ms):.1f} ms/step (median of steps "
          f"2-{CLI_STAGE2_STEPS}: graph replays, synchronized), losses "
          f"{[round(float(x), 4) for x in l2]}; launches {launches}; "
          f"tensorboard files {tb}", flush=True)
    total = dict(launches)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # ---- 2. evaluate the test views, exact k-NN (K1-K4), against the
    # same invocation through the plain versions and the control
    argv = ["--config", "cli_train.py", "--render_only", "--load_test_val",
            "--render_test", "--render_pcd", "--eval_psnr", "--eval_ssim"]
    with plain_kernels():
        _, _, (ref,) = cli_run(torch, argv)
    with plain_kernels(featmlp_fp32_layers):
        _, _, (ctl,) = cli_run(torch, argv)
    launches, eval_s, (out,) = cli_run(torch, argv)
    add(launches)
    outdir = os.path.join(run, "render_test_temporalpoints_last")
    rgbs = out["rgbs"]
    pngs = sorted(glob.glob(os.path.join(outdir, "img_*.png")))
    back = np.stack([png.read_png(p) for p in pngs])
    results = Path(outdir, "results.txt").read_text()
    psnr_txt = float(results.split("psnr:")[1].split()[0])
    half = CLI_SIZE // 2
    fg = foreground(rgbs, ref["rgbs"])
    p_db = psnr(rgbs, ref["rgbs"], fg)
    c_db = psnr(ctl["rgbs"], ref["rgbs"], fg)
    idle = [k for k in RENDER_KERNELS if launches[k] == 0]
    if (rgbs.shape != (CLI_TEST_VIEWS, half, half, 3)
            or not np.isfinite(rgbs).all() or idle or launches["agg"]
            or not np.array_equal(back, to8b(rgbs))
            or not np.isfinite(psnr_txt) or fg.mean() < 0.01):
        raise AssertionError(f"cli render test: {rgbs.shape}, launches "
                             f"{launches}, psnr {psnr_txt}, foreground "
                             f"{fg.mean():.4f}, {len(pngs)} PNGs")
    print(f"cli render test: --render_only --load_test_val --render_test "
          f"--render_pcd --eval_psnr --eval_ssim, {CLI_TEST_VIEWS} views of "
          f"{half}x{half}, exact k-NN, in {eval_s:.1f} s "
          f"({1e3 * eval_s / CLI_TEST_VIEWS:.1f} ms a view, the "
          f"checkpoint load and metrics included; {nvidia_smi_line()}): "
          f"results.txt psnr {psnr_txt:.3f} vs the test images, ssim "
          f"{np.mean(out['ssims']):.4f}; kernel vs plain {p_db:.2f} dB on "
          f"the foreground {fg.mean():.3f} (gate {CLI_PSNR_MIN_DB:g}; "
          f"control "
          f"render {c_db:.2f} dB); {len(pngs)} PNGs read back equal; "
          f"launches {launches}", flush=True)
    if not p_db >= CLI_PSNR_MIN_DB:
        raise AssertionError(f"cli render test: kernel vs plain "
                             f"{p_db:.2f} dB")

    # ---- 3. repose with pruned bones, shared k-NN with fused_agg (K6)
    launches, rep_s, (rep,) = cli_run(
        torch, ["--config", "cli_fused.py", "--render_only", "--render_pcd",
                "--repose_pcd", "--degree_threshold", "30"])
    add(launches)
    repdir = os.path.join(run, "render_video_repose_0")
    frames = sorted(glob.glob(os.path.join(repdir, "img_*.png")))
    video = [f for f in os.listdir(repdir)
             if f.startswith("train_video.rgb")]
    if (len(frames) != 60 or not video or launches["agg"] == 0
            or launches["featmlp"] or rep["rgbs"].shape != (60, half, half, 3)
            or not np.isfinite(rep["rgbs"]).all()):
        raise AssertionError(f"cli repose: {len(frames)} frames, video "
                             f"{video}, launches {launches}")
    moved = float(np.abs(rep["depths"][29] - rep["depths"][0]).max())
    print(f"cli repose: --render_only --render_pcd --repose_pcd "
          f"--degree_threshold 30 with knn_share 16, knn_cand 8, "
          f"coarse_stride 32, fused_agg: 60 frames of {half}x{half} in "
          f"{rep_s:.1f} s ({1e3 * rep_s / 60:.1f} ms a frame, the load and "
          f"simplify_skeleton included; {nvidia_smi_line()}), video "
          f"{video}, max depth change {moved:.1f}; launches {launches}",
          flush=True)

    # ---- 4. the backbone on fine_last.pkl
    launches, bb_s, (bb,) = cli_run(
        torch, ["--config", "cli_train.py", "--render_only",
                "--load_test_val", "--render_test", "--eval_psnr"])
    add(launches)
    bb_png = glob.glob(os.path.join(run, "render_test_fine_last",
                                    "img_*.png"))
    if (bb["rgbs"].shape != (CLI_TEST_VIEWS, half, half, 3)
            or not np.isfinite(bb["rgbs"]).all()
            or len(bb_png) != CLI_TEST_VIEWS):
        raise AssertionError(f"cli backbone: {bb['rgbs'].shape}, "
                             f"{len(bb_png)} PNGs")
    print(f"cli backbone: --render_only --load_test_val --render_test "
          f"--eval_psnr on fine_last.pkl: {CLI_TEST_VIEWS} views in "
          f"{bb_s:.1f} s, psnr {[round(x, 2) for x in bb['psnrs']]}; "
          f"launches {launches}; phase 8 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def wim_config():
    """The benchmark's ``wim`` configuration (``benchmark/configs/wim.json``:
    the scene, the cameras and the program's sections)."""
    return json.loads((REPO / "benchmark" / "configs" / "wim.json")
                      .read_text())


def wim_data_config(root, frames, size=512):
    """The ``data`` section that reads the WIM dataset at ``root`` (its
    frames at ``size``, ``wim_size``)."""
    from apnerf_torch.config.config import ConfigDict
    return ConfigDict(dataset_type="wim", datadir=str(root),
                      video_len=int(frames), wim_size=int(size))


def wim_rgba(rgb, acc):
    """uint8 RGBA [H, W, 4] of a volume render, as a WIM frame holds it:
    straight colour (the premultiplied ``rgb`` [H, W, 3] over the opacity
    ``acc`` [H, W]) and ``acc`` as alpha."""
    import torch
    a = acc.clamp(0.0, 1.0)[..., None]
    straight = torch.where(a > 0, rgb / a.clamp(min=1e-12),
                           torch.zeros_like(rgb)).clamp(0.0, 1.0)
    rgba = (torch.cat([straight, a], -1) * 255).round()
    return rgba.to(torch.uint8).cpu().numpy()


def wim_camera_json(path, c2w, K):
    """``cam_%03d.json`` of camera-to-world ``c2w``: its view matrix,
    transposed, and the intrinsics, as WIM's camera files hold them."""
    view = np.linalg.inv(np.asarray(c2w, np.float64))
    with open(path, "w") as f:
        json.dump({"camera_data": {
            "intrinsics": {"fx": float(K[0, 0]), "fy": float(K[1, 1]),
                           "cx": float(K[0, 2]), "cy": float(K[1, 2])},
            "camera_view_matrix": view.T.tolist()}}, f)


def wim_ring_pose(cam, poses, place):
    """Camera-to-world of a camera at ring index ``place`` (fractional) on
    the ring of the scene's cameras ``poses`` (``cam``: the configuration's
    ``cameras`` block)."""
    from benchmark.scene import look_at_opencv
    a = (np.arctan2(poses[0][1, 3], poses[0][0, 3])
         + 2 * np.pi * place / len(poses))
    return look_at_opencv(float(cam["radius"]) * np.array(
        [np.cos(a), np.sin(a), float(cam["height"])]))


def write_wim_fixture(root, cfg, seed, device):
    """The benchmark's scene of configuration ``cfg`` (a ring of 18
    cameras) written under ``root`` as a WIM dataset: RGBA
    ``frame_%05d_cam_%03d.png`` for each of the ``n_times`` frames and the
    cameras 0-19, and ``cam_%03d.json``. Returns the scene
    (``benchmark.scene.make_scene``), whose images the loader must give
    back."""
    from apnerf_torch.utils.png import write_png
    from benchmark.scene import make_scene, render_image
    scene = make_scene(cfg, seed, device)
    data, cam = scene.data, cfg["cameras"]
    poses, K = data["poses"], data["Ks"][0]
    if len(poses) != len(WIM_TRAIN_CAMS):
        raise ValueError(f"a WIM dataset has {len(WIM_TRAIN_CAMS)} training "
                         f"cameras, the scene {len(poses)}")
    by_id = dict(zip(WIM_TRAIN_CAMS, poses))
    by_id.update({c: wim_ring_pose(cam, poses, place).astype(np.float32)
                  for c, place in WIM_TEST_CAMS.items()})
    os.makedirs(root, exist_ok=True)
    for c, c2w in by_id.items():
        wim_camera_json(os.path.join(root, f"cam_{c:03d}.json"), c2w, K)
    size = int(cam["size"])
    for f in range(int(cam["n_times"])):
        joints = scene.figure.joints_at(float(data["times"][f * len(poses)]))
        for c, c2w in by_id.items():
            rgb, acc = render_image(scene.figure, joints, K, c2w, size, size,
                                    float(cam["near"]), float(cam["far"]),
                                    bool(cfg["data"]["inverse_y"]), device)
            write_png(os.path.join(root, f"frame_{f:05d}_cam_{c:03d}.png"),
                      wim_rgba(rgb, acc))
    return scene


def check_wim_load(data, want):
    """(lowest and highest image gap in uint8 levels, pixels two levels
    low, mask pixels that differ, largest pose gap) of the loader's
    ``data`` against the scene's ``want``. Raises unless each image pixel
    lies within one level of the scene's, or two below it (the file's
    alpha and straight colour are each rounded, together within one level
    of the composite, and the loader truncates its composite to uint8, as
    the WIM reference loader does, which lowers a pixel by less than one
    more), no mask pixel differs (alpha above one half against the scene's
    mask), the poses lie within 4 float32 ulp of their largest entry
    (float64 inverses on the way) and every other array is equal. A mask
    pixel may differ where the alpha is 127 or 128: the file's alpha
    rounds another render of the same opacity, which on the card differs
    from the scene's in its last bits, and the scene's mask is that
    opacity above one half."""
    gap = (data["images"].astype(np.int16)
           - want["images"].astype(np.int16))
    lo, hi = int(gap.min()), int(gap.max())
    two_low = int((gap == -2).sum())
    differ = (data["masks"] > 127) != (want["masks"] > 0)
    edge = np.abs(data["masks"].astype(np.int16) * 2 - 255) <= 1
    mask_diff = int((differ & ~edge).sum())
    mask_edge = int((differ & edge).sum())
    pose_gap = float(np.abs(data["poses"] - want["poses"]).max())
    pose_tol = 4 * float(np.spacing(np.abs(want["poses"]).max()))
    same = all(np.array_equal(np.asarray(data[k]), np.asarray(want[k]))
               for k in ("Ks", "times", "img_to_cam", "i_train", "HW"))
    same &= (data["near"], data["far"]) == (want["near"], want["far"])
    if lo < -2 or hi > 1 or mask_diff or pose_gap > pose_tol or not same:
        raise AssertionError(f"wim load: images {lo} to {hi} levels off the "
                             f"scene's, {mask_diff} mask pixels differ, "
                             f"poses within {pose_gap:.3g} (tolerance "
                             f"{pose_tol:.3g}), the other arrays equal: "
                             f"{same}")
    return lo, hi, two_low, mask_diff, mask_edge, pose_gap


def phase_wim(torch):
    """Phase 10: the WIM loader on the card's host. Returns the launch
    counts of its ``train_pcd`` run."""
    from apnerf_torch import kernels
    from apnerf_torch.data.load_data import load_data
    from apnerf_torch.models.tineuvox import TiNeuVoxConfig
    from apnerf_torch.train import stage2
    from apnerf_torch.utils.checkpoint import params_to_jax
    from benchmark.generators.common import program_config
    t_phase = time.perf_counter()
    cfg = wim_config()
    cfg["cameras"]["n_times"] = WIM_FRAMES
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "spot")
        t0 = time.perf_counter()
        scene = write_wim_fixture(root, cfg, WIM_SEED, DEVICE)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = load_data(wim_data_config(root, WIM_FRAMES), bg_col=1)
        load_s = time.perf_counter() - t0
        lo, hi, two_low, mask_diff, mask_edge, pose_gap = check_wim_load(
            data, scene.data)
        print(f"wim load: the wim scene (seed {WIM_SEED}) written as "
              f"{WIM_FRAMES} frames of cameras 0-19, RGBA 512x512, in "
              f"{write_s:.1f} s; load_data read {len(data['images'])} "
              f"training images in {load_s:.1f} s: images {lo} to {hi} "
              f"uint8 levels off the scene's ({two_low} of "
              f"{data['images'].size} values two below), {mask_diff} mask "
              f"pixels differ ({mask_edge} more at alpha 127-128), poses "
              f"within {pose_gap:.3g}", flush=True)

        kernels.reset_launches()
        t0 = time.perf_counter()
        *_, stats = stage2.train_pcd(
            program_config(cfg), data, scene.canonical, scene.skeleton,
            params_to_jax({k: torch.from_numpy(v)
                           for k, v in scene.heads.items()}),
            TiNeuVoxConfig(**scene.backbone), scene.bbox, seed=WIM_SEED,
            n_iters=WIM_STEPS, log_every=5, max_steps=cfg["max_steps"],
            device=DEVICE)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if not np.isfinite(stats["loss"]).all() or launches.get(
                "knn_radius", 0) < WIM_STEPS:
            raise AssertionError(f"wim train_pcd: losses {stats['loss']}, "
                                 f"launches {launches}")
        print(f"wim train_pcd: {WIM_STEPS} steps on the loaded dataset in "
              f"{time.perf_counter() - t0:.1f} s (set-up included), losses "
              f"{[round(x, 4) for x in stats['loss']]}, launches {launches}",
              flush=True)

    print(f"wim: phase 10 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "apnerf_torch" / "csrc").is_dir():
        print("chip_smoke: apnerf_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}, nvidia-smi: {smi}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    from apnerf_torch.kernels import build
    t0 = time.perf_counter()
    so = build.build()
    build.load_library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        text = log.read_text()
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", text))
        print(f"build: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, {spills} bytes of spills", flush=True)
    print(f"build: {count_wgmma(so)}", flush=True)

    from apnerf_torch.data.bench_scene import bench_scene
    pcd, joints, bones, feat = bench_scene()
    report = Report()
    phase_kernels(torch, pcd, report)
    with tempfile.TemporaryDirectory() as d:
        by_path, s1_model, s1_data, stepsize = phase_train(torch, d)
        by_path["render"] = phase_render(torch, pcd, joints, bones, feat, d)
        by_path["render avg_procrustes"] = phase_procrustes_render(
            torch, pcd, joints, bones, feat, d)
        by_path["render views"] = phase_views(torch, d, s1_model, s1_data,
                                              stepsize)
        del s1_model
        s2_paths, s2_ctx = phase_stage2(torch, s1_data, d, nerf_config)
        by_path.update(s2_paths)
        by_path.update(phase_mesh(torch, s2_ctx, s1_data, d))
        del s2_ctx
    by_path["cli"] = phase_cli(torch)
    by_path["wim"] = phase_wim(torch)

    print(json.dumps({"kernels": report.json_rows(by_path)}))
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
