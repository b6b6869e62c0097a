"""The render bench scene of ``bench.py:build_model`` in numpy, and its
model configuration: what ``chip_smoke.py`` and
``render/profile_render.py`` render."""
from __future__ import annotations

import numpy as np


def bench_scene(P=10_000, J=24, F=128):
    """bench.py:build_model's scene in numpy (points, joints, features)."""
    rng = np.random.default_rng(0)
    joints = np.zeros((J, 3), np.float32)
    joints[:, 1] = np.linspace(-0.8, 0.8, J)
    joints[:, 0] = 0.2 * np.sin(np.linspace(0, 3, J))
    bones = [[j, j + 1] for j in range(J - 1)]
    seg = rng.integers(0, J, P)
    pcd = (joints[seg] + rng.normal(size=(P, 3)) * 0.08).astype(np.float32)
    feat = rng.normal(size=(P, F)).astype(np.float32) * 0.1
    return pcd, joints, bones, feat


def bench_config(P, J, F, **mode):
    """bench.py:build_model's TemporalPointsConfig, k-NN mode overridden."""
    from ..models.temporal_points import TemporalPointsConfig
    base = dict(
        n_points=P, n_joints=J, feat_dim=F, neighbours=8, timebase_pe=8,
        posbase_pe=10, viewbase_pe=4, stepsize=0.5, voxel_size=0.012,
        voxel_size_ratio=1.0, act_shift=float(np.log(1 / (1 - 1e-3) - 1)),
        fast_color_thres=1e-4, sample_budget=96, max_steps=512,
        knn_share=16, knn_cand=8, coarse_stride=32, active_fraction=0.30,
        pass_fraction=0.30)
    base.update(mode)
    return TemporalPointsConfig(**base)


def bench_heads(cfg, generator):
    """The backbone heads that bench.py:build_model draws (``rgbnet``,
    ``densitynet``, a ``timenet`` of [t_dim, 128, 60]), drawn from
    ``generator``: the ``tineuvox_params`` of ``init_params``, a JAX
    pytree of numpy arrays."""
    from torch import nn

    from ..models.tineuvox import RGBNet
    from ..ops.nn import MLP
    from ..utils.checkpoint import params_to_jax
    F = cfg.feat_dim
    heads = nn.ModuleDict({"rgbnet": RGBNet(F, cfg.views_ch),
                           "densitynet": MLP([F, 1]),
                           "timenet": MLP([cfg.t_dim, 128, 60])})
    for net in heads.values():
        net.reset_parameters_(generator)
    return params_to_jax(heads.state_dict())


def bench_model(device=None, P=10_000, J=24, F=128):
    """The bench scene as a model with random weights from a seed and its
    render state, on ``device`` (``None``: the CUDA device): (model,
    state)."""
    import torch

    from ..models import temporal_points as tp
    pcd, joints, bones, feat = bench_scene(P, J, F)
    cfg = bench_config(P, J, F)
    gen = torch.Generator().manual_seed(1)
    model = tp.init_params(cfg, pcd, joints, bones, feat,
                           np.full(P, 0.5, np.float32),
                           np.full((P, 3), 0.5, np.float32),
                           bench_heads(cfg, gen), generator=gen,
                           device=device)
    state = tp.init_state(cfg, pcd, joints, bones, pcd[::40],
                          pcd.min(0) - 0.1, pcd.max(0) + 0.1, device=device)
    return model, state
