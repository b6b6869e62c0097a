"""The small stage-2 scene the ``test_torch_stage2_*`` files share (not a
test module): export-like artifacts of a 2,000-point cloud along a
six-joint chain (F = 32), backbone heads from the JAX initialisers, one
400 x 400 camera at z = 3 looking down -z, and one batch of 128 rays with
a 2D-chamfer view. Everything is made with numpy from seeds (the heads
with ``jax.random``) and handed to both packages as numpy arrays. Also
the one-step comparison both step test files run."""
import dataclasses
import importlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

from apnerf.models import tineuvox as jtv
from apnerf.ops import nn as jnn
from apnerf.train import stage2 as js2
from apnerf_torch.config import nerf_default
from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.models import tineuvox as ttv
from apnerf_torch.train import stage2 as ts2
from apnerf_torch.utils.checkpoint import model_from_jax, params_from_jax

P, J, F = 2000, 6, 32
H = W = 400
NEAR, FAR = 0.5, 6.0


def absorb_first_vml_call():
    """Run one multi-threaded ``torch.sqrt`` on the CPU and discard it.

    PyTorch's CPU build sends float ``sqrt``, ``exp`` and the like to
    MKL's vector math library, split over the OpenMP threads. In about one
    fresh process in ten, the first such call after a parallel region
    returns one thread's chunk at about 12 bits (relative errors up to
    3e-4, as a hardware reciprocal square root estimate), whatever the
    function; later calls are right, and with ``MKL_CBWR=COMPATIBLE`` or
    ``MKL_NUM_THREADS=1`` the first is right too. The fault is outside
    both packages, and once a process: after a parallel sort, a ``sqrt``
    of 2^20 floats over all 8 OpenMP threads (MKL 2024.2) had one
    thread's chunk wrong in 6 of 30 fresh processes, and in none of 30
    each when a discarded ``sqrt`` of 2,048 (one thread's), 2^16 or 2^19
    floats came first. A module whose results must not carry it calls
    this first, so that the faulty call is this one."""
    x = torch.rand(1 << 16, generator=torch.Generator().manual_seed(0))
    torch.sort(x.view(64, -1), dim=1)      # the threads' parallel region
    torch.sqrt(x + 0.5)


def artifacts():
    """(canonical, skeleton) in the export pickles' schema."""
    rng = np.random.default_rng(0)
    joints = np.zeros((J, 3), np.float32)
    joints[:, 1] = np.linspace(-0.2, 0.2, J)
    seg = rng.integers(0, J, P)
    pcd = (joints[seg] + rng.normal(size=(P, 3)) * 0.05).astype(np.float32)
    feat = (rng.normal(size=(P, F)) * 0.1).astype(np.float32)
    canonical = dict(pcd=pcd, feat=feat, raw_feat=feat,
                     alphas=np.full(P, 0.5, np.float32),
                     rgbs=np.full((P, 3), 0.5, np.float32), t=0.0,
                     xyz_min=pcd.min(0), xyz_max=pcd.max(0),
                     voxel_size=0.012)
    skeleton = dict(joints=joints, bones=[[j, j + 1] for j in range(J - 1)],
                    skeleton_pcd=pcd[::40].copy())
    return canonical, skeleton


def backbone():
    """(JAX TiNeuVoxConfig, port TiNeuVoxConfig, heads as numpy pytree)."""
    kw = dict(xyz_min=(-1.0, -1.0, -1.0), xyz_max=(1.0, 1.0, 1.0),
              num_voxels=10 ** 3, num_voxels_base=10 ** 3, net_width=F)
    jcfg = jtv.TiNeuVoxConfig(**kw)
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    heads = {"rgbnet": jtv.init_rgbnet(ks[0], F, jcfg.views_ch),
             "densitynet": jnn.init_mlp(ks[1], [F, 1]),
             "timenet": jnn.init_mlp(ks[2], [jcfg.times_ch, 32, 16])}
    return (jcfg, ttv.TiNeuVoxConfig(**kw),
            jax.tree_util.tree_map(np.asarray, heads))


def config(**pcd_model):
    """The nerf family's defaults, ``pcd_model_and_render`` overridden."""
    cfg = nerf_default()
    cfg.pcd_model_and_render.update(pcd_model)
    return cfg


def camera():
    K = np.array([[[555.0, 0, W / 2], [0, 555.0, H / 2], [0, 0, 1]]],
                 np.float32)
    pose = np.eye(4, dtype=np.float32)[None].copy()
    pose[0, 2, 3] = 3.0
    return K, pose


def batch_arrays(n_chamfer=300, n_pcd=500, seed=1):
    """One batch as numpy: 128 pixels around the image centre."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(8) * 3 + 188, np.arange(16) * 3 + 176,
                         indexing="ij")
    pix = (jj * W + ii).ravel().astype(np.int32)
    K, pose = camera()
    return dict(rgb=rng.random((pix.size, 3)).astype(np.float32),
                mask=np.ones(pix.size, np.float32), t=np.float32(0.3),
                cam=np.zeros(pix.size, np.int32), pix=pix,
                sparsity_on=np.float32(1.0), chamfer_poses=pose,
                chamfer_Ks=K,
                chamfer_mask_pts=(rng.random((1, n_chamfer, 2)) * 60
                                  + 170).astype(np.float32),
                chamfer_pcd_idx=rng.integers(0, P, n_pcd).astype(np.int32))


def torch_batch(b):
    out = {}
    for k, v in b.items():
        if k in ("t", "sparsity_on"):
            out[k] = v
        elif k in ("cam", "pix", "chamfer_pcd_idx"):
            out[k] = torch.as_tensor(v).long()
        else:
            out[k] = torch.as_tensor(v)
    return out


def force_jax_kernel_path(monkeypatch):
    """The JAX package on its TPU kernel path, Pallas in interpret mode."""
    monkeypatch.setattr(importlib.import_module("apnerf.ops.knn"),
                        "_tpu_default", lambda: True)
    for name in ("apnerf.kernels.knn_pallas",
                 "apnerf.kernels.knn_cells_pallas",
                 "apnerf.kernels.featmlp_pallas",
                 "apnerf.kernels.agg_pallas"):
        monkeypatch.setattr(importlib.import_module(name), "_interpret_mode",
                            lambda: True)
    jax.clear_caches()


class GradsOut:
    """An optimizer whose update returns the gradients as the parameters:
    the JAX train step then hands back its loss's gradients."""

    def update(self, grads, opt_state, params):
        return grads, opt_state


def jax_step(cfg, agg_bf16, b, monkeypatch=None):
    """(mcfg, params, state, loss, grads as a state_dict) of the JAX
    package: build_model (on its CPU path: the exact canonical k-NN), then
    one make_train_step step, on the kernel path with ``monkeypatch``.
    ``knn_rt`` 4 only shrinks the JAX kernels' unrolled rounds (faster
    interpret-mode compiles); the port has no such knob."""
    canonical, skeleton = artifacts()
    jtcfg, _, heads = backbone()
    mcfg, params, state = js2.build_model(cfg, canonical, skeleton, heads,
                                          jtcfg, seed=0)
    mcfg = dataclasses.replace(mcfg, agg_bf16=agg_bf16, knn_rt=4)
    if monkeypatch is not None:
        force_jax_kernel_path(monkeypatch)
    K, pose = camera()
    step = js2.make_train_step(mcfg, state, cfg.pcd_train_config,
                               GradsOut(), jnp.asarray(K), jnp.asarray(pose),
                               H, W, NEAR, FAR, 1.0, 1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    grads, _, metrics = step(params, None, jb)
    jax.clear_caches()
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), grads)
    return (mcfg, jax.tree_util.tree_map(np.asarray, params), state,
            {k: float(v) for k, v in metrics.items()}, params_from_jax(tree))


def port_step(cfg, mcfg, params, b):
    """(metrics, grads) of the port's loss_fn on the JAX parameters."""
    canonical, skeleton = artifacts()
    _, tcfg, heads = backbone()
    _, model, state = ts2.build_model(cfg, canonical, skeleton, heads, tcfg,
                                      device="cpu")
    model = model_from_jax(ttp.TemporalPointsConfig(
        **dict(dataclasses.asdict(mcfg), knn_rt=24)), params, device="cpu")
    K, pose = camera()
    loss_fn = ts2.make_loss_fn(model, state, cfg.pcd_train_config,
                               torch.tensor(K), torch.tensor(pose), H, W,
                               NEAR, FAR, 1.0, 1)
    loss, metrics, _ = loss_fn(torch_batch(b))
    loss.backward()
    metrics["loss"] = loss
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    return {k: float(v.detach()) for k, v in metrics.items()}, grads


def check_step(jm, jg, tm, tg, arap_atol, ref=None):
    """Loss terms: 1e-5 relative (1e-4 under bf16, when ``ref``, the
    port's fp32 gradients, is given), ARAP also ``arap_atol``. Gradients,
    each leaf relative to its max |.|: fp32, the port's against the JAX
    package's to 1e-2 at most and 1e-4 on average; bf16, each package's
    mean departure from ``ref``, the port's at most 1.5 times the JAX
    package's and under 1e-2. A leaf the JAX gradient does not reach
    stays zero."""
    bf16 = ref is not None
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(
            tm[key], jm[key], rtol=1e-4 if bf16 else 1e-5,
            atol=arap_atol if key == "arap" else 0, err_msg=key)
    assert set(tg) == set(jg)
    reached = 0
    for name, want in jg.items():
        got, want = tg[name].numpy(), want.numpy()
        scale = float(np.abs(want).max())
        assert np.isfinite(got).all(), name
        if scale == 0:
            assert not got.any(), name
            continue
        reached += 1
        if bf16:
            r = ref[name].numpy()
            scale = float(np.abs(r).max())
            port_err = np.abs(got - r).mean() / scale
            jax_err = np.abs(want - r).mean() / scale
            assert port_err <= min(1.5 * jax_err + 1e-6, 1e-2), (
                name, port_err, jax_err)
        else:
            diff = np.abs(got - want) / scale
            assert diff.max() <= 1e-2 and diff.mean() <= 1e-4, (
                name, diff.max(), diff.mean())
    # the warp, the skinning weights and joints, the features, feat_net
    # and both heads carry gradients
    assert reached >= 20, reached
