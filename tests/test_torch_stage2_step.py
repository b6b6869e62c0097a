"""One stage-2 training step of the port against the JAX package on the
CPU: ``make_loss_fn``'s loss and the gradient of every parameter, from
the same parameters (the JAX ``build_model``'s, carried over with
``model_from_jax``) and the same batch (torch_stage2_scene: 2,000 points,
six joints, F = 32, 128 rays, every loss term on, one chamfer view).

Against the JAX kernel path (its Pallas k-NN kernels in interpret mode,
``featmlp_kernel`` off as stage 2 sets it: the XLA feat_net formulation,
and the same Morton-sorted index space as the port), in exact mode here
and in shared mode (``knn_share`` 8, ``knn_cand`` 12) in
test_torch_stage2_shared.py, through the fused group sampler (budget 32),
at ``agg_bf16`` False and True. JAX's CPU path and the non-fused sampler
pair are in test_torch_stage2_model.py.

The loss terms are held to 1e-5 relative (1e-4 under ``agg_bf16``); the
ARAP term also to 1e-7 of the summed canonical neighbour distances: it
sums |d_canonical - d_warped| over 16,000 neighbour pairs that the
near-rigid initial warp keeps within ~1e-5 of each other, so the fp32
rounding of the two packages' warps shows in full (measured 2.3e-5
relative; every other term 0 to 5e-7).

The gradient is discontinuous where a sample crosses the kth-neighbour
radius, an alpha or weight crosses ``fast_color_thres`` or an ARAP term
crosses 0: perturbing the parameters by 1e-7 (relative) moves the port's
own gradient by up to 0.12 of its max |.| in single elements (the
skinning weights), 2e-5 on average. So each gradient leaf is held by its
max and mean difference relative to its max |.|: fp32 1e-2 and 1e-4
(measured at most 2.9e-3 and 2.1e-5). Under bf16 a gradient is noisy in
itself (see test_torch_featnet.py), and the JAX package sums some of its
cotangents in bf16: its feat_net bias gradients depart from the fp32 ones
by 5-15% of their max on average in shared mode, the port's by 0.05%. So
a bf16 gradient is held by its mean departure from the port's fp32
gradient on the same parameters (itself held to the JAX package's above):
at most 1.5 times the JAX package's bf16 gradient's, and under 1e-2. A
leaf the JAX gradient does not reach (gammas, timenet, the direct-render
arrays) must stay zero.
"""
import dataclasses

import numpy as np
import pytest

from torch_stage2_scene import (batch_arrays, check_step, config,  # noqa
                                jax_step, port_step)

CASES = {
    "exact": dict(sample_budget=32),
    "shared": dict(sample_budget=32, knn_share=8, knn_cand=12),
}


def run_case(case, bf16, monkeypatch):
    cfg = config(**CASES[case])
    b = batch_arrays()
    mcfg, params, state, jm, jg = jax_step(cfg, bf16, b, monkeypatch)
    assert all(np.isfinite(v) for v in jm.values())
    tm, tg = port_step(cfg, mcfg, params, b)
    ref = None
    if bf16:
        _, ref = port_step(cfg, dataclasses.replace(mcfg, agg_bf16=False),
                           params, b)
    check_step(jm, jg, tm, tg,
               1e-7 * float(np.asarray(state["nn_distance"]).sum()), ref)


@pytest.mark.parametrize("bf16", [False, True])
def test_step_vs_jax_kernel_path(bf16, monkeypatch):
    run_case("exact", bf16, monkeypatch)
