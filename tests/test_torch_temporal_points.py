"""The port's stage-2 render (apnerf_torch.models.temporal_points) against
the JAX package on a small scene: P = 2000 points, J = 6 joints, F = 32,
128 rays, sample_budget 32, max_steps 128, coarse_stride 16. Parameters are
made once in JAX and handed over through ``params_from_jax``.

The full forward is compared in exact mode and in shared mode (share 8
with knn_cand = K, share 16 with knn_cand > K):
  (a) against the JAX kernel path, its Pallas kernels in interpret mode --
      the same Morton-sorted index space as the port;
  (b) against the JAX CPU path, whose plain aggregation rounds each dot to
      bf16 where the kernels accumulate in fp32.
Measured on this scene (CPU): rgb (a) 136.8-137.2 dB, (b) 117.0-117.5 dB
across the three modes; the bounds below leave room for summation-order
differences only.

With ``fused_agg`` the shared modes run kernel K6 in both packages (the
port its plain version, the JAX package ``agg_pallas`` in interpret mode)
when ``render_weights`` is off, measured 143.8 dB rgb (122.2 dB against the
port's own K4 path, which rounds the last layer to bf16); with it on, both
fall back to the K4 path. ``render_pcd_direct`` passes through no network,
only the k-NN selection and fp32 sums: against the JAX CPU path the direct
image is held to 1e-5 absolute (measured 1.3e-6).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.models import temporal_points as jtp
from apnerf.models import tineuvox as jtv
from apnerf.ops import nn as jnn
from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.utils.checkpoint import model_from_jax, params_to_jax

P, J, F = 2000, 6, 32
# active_fraction 1.0 / pass_fraction 0.6: the pass compaction runs and
# truncates (demand ~3.9k of 3072 slots) yet every ray keeps foreground.
# knn_rt 4 only shrinks the JAX kernels' unrolled rounds (faster
# interpret-mode compiles); the port has no such knob.
BASE = dict(n_points=P, n_joints=J, feat_dim=F, neighbours=8, stepsize=0.5,
            voxel_size=0.012, act_shift=0.0, sample_budget=32, max_steps=128,
            coarse_stride=16, active_fraction=1.0, pass_fraction=0.6,
            knn_rt=4)
MODES = {
    "exact": dict(knn_share=1),
    "shared8_cand8": dict(knn_share=8, knn_cand=8),
    "shared16_cand12": dict(knn_share=16, knn_cand=12),
}
PSNR_KERNEL_PATH = {"exact": 50.0, "shared8_cand8": 45.0,
                    "shared16_cand12": 45.0}
PSNR_CPU_PATH = 40.0


def scene_arrays():
    rng = np.random.default_rng(0)
    joints = np.zeros((J, 3), np.float32)
    joints[:, 1] = np.linspace(-0.2, 0.2, J)
    bones = [[j, j + 1] for j in range(J - 1)]
    seg = rng.integers(0, J, P)
    pcd = (joints[seg] + rng.normal(size=(P, 3)) * 0.05).astype(np.float32)
    feat = rng.normal(size=(P, F)).astype(np.float32) * 0.1
    return pcd, joints, bones, feat


def jax_params(cfg, pcd, joints, bones, feat):
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    tnv = {"rgbnet": jtv.init_rgbnet(ks[0], F, cfg.views_ch),
           "densitynet": jnn.init_mlp(ks[1], [F, 1]),
           "timenet": jnn.init_mlp(ks[2], [cfg.t_dim, 32, 16])}
    return jtp.init_params(jax.random.PRNGKey(1), cfg, pcd, joints, bones,
                           feat, np.full(P, 0.5, np.float32),
                           np.full((P, 3), 0.5, np.float32), tnv)


def rays():
    """128 rays of a 400 x 400, focal 555 camera at z = 3 onto the cloud."""
    jj, ii = np.meshgrid(np.arange(8) * 3 + 188, np.arange(16) * 3 + 176,
                         indexing="ij")
    d = np.stack([(ii.ravel() + .5 - 200) / 555.0,
                  -(jj.ravel() + .5 - 200) / 555.0,
                  -np.ones(ii.size)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 3.0], np.float32), d.shape).copy()
    return o, d, d / np.linalg.norm(d, axis=-1, keepdims=True)


def rot_params():
    rng = np.random.default_rng(1)
    return np.concatenate([rng.normal(size=(J, 3)) * 0.3,
                           0.2 * np.ones((J, 1))], -1).astype(np.float32)


@pytest.fixture(autouse=True)
def no_grad():
    """The render tests hold no autograd graph, as the render callers
    hold ``torch.inference_mode()``: ``forward`` is differentiable."""
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def scene():
    pcd, joints, bones, feat = scene_arrays()
    cfg = jtp.TemporalPointsConfig(**BASE)
    params = jax_params(cfg, pcd, joints, bones, feat)
    return dict(pcd=pcd, joints=joints, bones=bones, params=params,
                tree=jax.tree_util.tree_map(np.asarray, params))


def jax_state(cfg, s):
    pcd = s["pcd"]
    return jtp.init_state(cfg, pcd, s["joints"], s["bones"], pcd[::40],
                          pcd.min(0) - .1, pcd.max(0) + .1)


def port_model(mode_kw, s):
    cfg = ttp.TemporalPointsConfig(**{**BASE, **mode_kw})
    pcd = s["pcd"]
    state = ttp.init_state(cfg, pcd, s["joints"], s["bones"], pcd[::40],
                           pcd.min(0) - .1, pcd.max(0) + .1, device="cpu")
    return model_from_jax(cfg, s["tree"], device="cpu"), state


def port_render(model, state):
    o, d, v = rays()
    return ttp.forward(model, state, torch.tensor(o), torch.tensor(d),
                       torch.tensor(v), rot_params=torch.tensor(rot_params()),
                       near=0.5, far=6.0, bg=1.0, render_depth=True,
                       render_weights=True)


def lbs_image(out):
    """Per-ray composite of the per-sample LBS weights -> [R, J]."""
    w = out["weights_for_render"]
    return (np.asarray(w)[..., None]
            * np.asarray(out["lbs_w_per_sample"])).sum(1)


def jax_forward_fn(mode_kw, s, keys, **flags):
    """The jitted JAX forward on this file's rays -> ``{key: array}``."""
    cfg = jtp.TemporalPointsConfig(**{**BASE, **mode_kw})
    state = jax_state(cfg, s)

    @jax.jit
    def run(params, o, d, v, rot):
        frame = jtp.prepare_frame(params, cfg, state, rot_params=rot)
        res = jtp.forward(params, cfg, state, o, d, v, near=0.5, far=6.0,
                          bg=1.0, render_depth=True, frame=frame, **flags)
        return {k: res[k] for k in keys}

    return lambda: run(s["params"], *map(jnp.asarray, rays()),
                       jnp.asarray(rot_params()))


def jax_forward(mode_kw, s, keys, **flags):
    return {k: np.asarray(v)
            for k, v in jax_forward_fn(mode_kw, s, keys, **flags)().items()}


def jax_render(mode_kw, s):
    out = jax_forward(mode_kw, s, ("rgb_marched", "depth",
                                   "weights_for_render", "lbs_w_per_sample"),
                      render_weights=True)
    return out["rgb_marched"], out["depth"], lbs_image(out)


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return np.inf if mse == 0 else -10 * np.log10(mse)


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """Force the JAX package onto its TPU kernel path with the Pallas
    kernels in interpret mode (nothing in apnerf changes)."""
    monkeypatch.setattr(importlib.import_module("apnerf.ops.knn"),
                        "_tpu_default", lambda: True)
    for name in ("apnerf.kernels.knn_pallas",
                 "apnerf.kernels.knn_cells_pallas",
                 "apnerf.kernels.featmlp_pallas",
                 "apnerf.kernels.agg_pallas"):
        monkeypatch.setattr(importlib.import_module(name), "_interpret_mode",
                            lambda: True)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _check_render(out, mode_kw):
    want = "shared" if mode_kw["knn_share"] > 1 else "exact"
    assert out["knn_path"] == want
    rgb = out["rgb_marched"].numpy()
    assert rgb.shape == (128, 3) and np.isfinite(rgb).all()
    # not an empty render: under 5% of the pixels are background
    assert (out["alphainv_last"].numpy() > 0.99).mean() < 0.05


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_vs_jax_kernel_path(mode, scene, jax_kernel_path):
    """(a): same index space as the JAX kernel path, PSNR >= 50 dB exact,
    >= 45 dB shared, for rgb, depth / max_steps and the LBS-weight image."""
    jrgb, jdep, jlbs = jax_render(MODES[mode], scene)
    out = port_render(*port_model(MODES[mode], scene))
    _check_render(out, MODES[mode])
    assert psnr(out["rgb_marched"], jrgb) >= PSNR_KERNEL_PATH[mode]
    assert psnr(out["depth"] / 128.0, jdep / 128.0) >= PSNR_KERNEL_PATH[mode]
    assert psnr(lbs_image(out), jlbs) >= PSNR_KERNEL_PATH[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_vs_jax_cpu_path(mode, scene):
    """(b): against the JAX CPU path, PSNR >= 40 dB."""
    jrgb, jdep, jlbs = jax_render(MODES[mode], scene)
    out = port_render(*port_model(MODES[mode], scene))
    _check_render(out, MODES[mode])
    assert psnr(out["rgb_marched"], jrgb) >= PSNR_CPU_PATH
    assert psnr(out["depth"] / 128.0, jdep / 128.0) >= PSNR_CPU_PATH
    assert psnr(lbs_image(out), jlbs) >= PSNR_CPU_PATH


FUSED = dict(MODES["shared16_cand12"], fused_agg=True)


def test_forward_fused_vs_jax_kernel_path(scene, jax_kernel_path):
    """``fused_agg`` without ``render_weights``: kernel K6's plain version
    against the JAX kernel path with ``agg_pallas`` in interpret mode (kc
    12 > K = 8: the MLP runs on all candidates), PSNR >= 45 dB for rgb and
    depth / max_steps."""
    want = jax_forward(FUSED, scene, ("rgb_marched", "depth"))
    model, state = port_model(FUSED, scene)
    o, d, v = map(torch.tensor, rays())
    out = ttp.forward(model, state, o, d, v,
                      rot_params=torch.tensor(rot_params()), near=0.5,
                      far=6.0, bg=1.0, render_depth=True)
    assert out["knn_path"] == "shared_fused"
    assert np.isfinite(out["rgb_marched"].numpy()).all()
    assert (out["alphainv_last"].numpy() > 0.99).mean() < 0.05
    assert psnr(out["rgb_marched"], want["rgb_marched"]) >= 45.0
    assert psnr(out["depth"] / 128.0, want["depth"] / 128.0) >= 45.0
    # and K6 agrees with the port's own K4 path on the same samples
    model.cfg = dataclasses.replace(model.cfg, fused_agg=False)
    k4 = ttp.forward(model, state, o, d, v,
                     rot_params=torch.tensor(rot_params()), near=0.5,
                     far=6.0, bg=1.0, render_depth=True)
    assert k4["knn_path"] == "shared"
    assert psnr(out["rgb_marched"], k4["rgb_marched"]) >= 60.0


def test_fused_conditions_match_jax(scene, jax_kernel_path, monkeypatch):
    """The reference's rule for K6, in both packages: ``fused_agg`` with
    ``render_weights`` (or ``render_pcd_direct``, or exact mode) takes the
    K4 path. The JAX forward is only traced, with its kernel counted."""
    agg_pallas = importlib.import_module("apnerf.kernels.agg_pallas")
    calls = []
    real = agg_pallas.fused_subgroup_agg
    monkeypatch.setattr(agg_pallas, "fused_subgroup_agg",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model, state = port_model(FUSED, scene)
    o, d, v = map(torch.tensor, rays())
    for flags, mode_kw, want in (
            (dict(), FUSED, "shared_fused"),
            (dict(render_weights=True), FUSED, "shared"),
            (dict(render_pcd_direct=True), FUSED, "shared"),
            (dict(), dict(FUSED, knn_share=1), "exact")):
        calls.clear()
        jax.eval_shape(jax_forward_fn(mode_kw, scene, ("rgb_marched",),
                                      **flags))
        assert bool(calls) == (want == "shared_fused"), (flags, mode_kw)
        model.cfg = ttp.TemporalPointsConfig(**{**BASE, **mode_kw})
        out = ttp.forward(model, state, o, d, v,
                          rot_params=torch.tensor(rot_params()), near=0.5,
                          far=6.0, bg=1.0, **flags)
        assert out["knn_path"] == want, (flags, mode_kw)


@pytest.mark.parametrize("mode", ["exact", "shared16_cand12"])
def test_render_pcd_direct_vs_jax(mode, scene):
    """The direct point-cloud composite (Gaussian weights on the squared
    distance, canonical alpha / rgb) against the JAX CPU path: no network
    in between, so 1e-5 absolute on the image and the leftover
    transmittance."""
    keys = ("rgb_marched_direct", "alphainv_last_direct", "rgb_marched")
    model, state = port_model(MODES[mode], scene)
    with torch.no_grad():
        model.direct_eps.copy_(torch.linspace(0.02, 0.08, P))
    tree = dict(scene["tree"], direct_eps=np.linspace(
        0.02, 0.08, P, dtype=np.float32))
    want = jax_forward(MODES[mode], dict(scene, params=tree), keys,
                       render_pcd_direct=True)
    o, d, v = map(torch.tensor, rays())
    out = ttp.forward(model, state, o, d, v,
                      rot_params=torch.tensor(rot_params()), near=0.5,
                      far=6.0, bg=1.0, render_pcd_direct=True)
    assert (want["alphainv_last_direct"] < 0.9).mean() > 0.5
    for key in ("rgb_marched_direct", "alphainv_last_direct"):
        np.testing.assert_allclose(out[key].numpy(), want[key], rtol=0,
                                   atol=1e-5, err_msg=key)
    assert psnr(out["rgb_marched"], want["rgb_marched"]) >= PSNR_CPU_PATH


def test_render_view_chunks(scene):
    """render_view over one view: a single chunk equals forward on the
    same rays; a ragged chunking (padded last chunk) gives the full image
    with finite rgb, depth, opacity and LBS colours."""
    from apnerf_torch.ops.rays import get_rays_of_a_view
    from apnerf_torch.render.renderers import render_view
    model, state = port_model(MODES["shared8_cand8"], scene)
    H, W = 12, 16
    K = [[140.0, 0, W / 2], [0, 140.0, H / 2], [0, 0, 1]]
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.0
    rot = torch.tensor(rot_params())
    one = render_view(model, state, H, W, K, c2w, rot_params=rot,
                      chunk=H * W)
    o, d, v = (x.reshape(-1, 3) for x in get_rays_of_a_view(H, W, K, c2w))
    ref = ttp.forward(model, state, o, d, v, rot_params=rot, near=0.5,
                      far=6.0, bg=1.0, render_depth=True)
    assert one["knn_path"] == "shared"
    assert torch.equal(one["rgb"].reshape(-1, 3), ref["rgb_marched"])
    assert torch.equal(one["depth"].reshape(-1), ref["depth"])
    assert (one["acc"] > 0.5).float().mean() > 0.5
    rag = render_view(model, state, H, W, K, c2w, rot_params=rot, chunk=80)
    assert rag["rgb"].shape == (H, W, 3) and rag["weights"].shape == (H, W, 3)
    assert rag["budget_audit"].shape == (3, 4)
    for key in ("rgb", "depth", "acc", "weights"):
        assert torch.isfinite(rag[key]).all(), key


@pytest.mark.parametrize("pose", ["rot_params", "time"])
def test_prepare_frame_vs_jax(pose, scene):
    """Warp, frames, inverse rotations and the occupancy grid, fp32 1e-5;
    explicit rotations or the time-conditioned transform_net."""
    cfg = jtp.TemporalPointsConfig(**BASE)
    kw = (dict(rot_params=rot_params()) if pose == "rot_params"
          else dict(t=0.3))
    jf = jtp.prepare_frame(scene["params"], cfg, jax_state(cfg, scene),
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    model, state = port_model({}, scene)
    tf = ttp.prepare_frame(model, state, **{k: torch.tensor(v)
                                            for k, v in kw.items()})
    for key in ("xyz", "frames", "inv_rot", "joints_warped", "lbs_weights"):
        np.testing.assert_allclose(tf[key].numpy(), np.asarray(jf[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("bb_min", "bb_max", "occ_cell"):
        np.testing.assert_allclose(tf["occ_info"][key].numpy(),
                                   np.asarray(jf["occ_info"][key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(tf["occ_info"]["occ"].numpy(),
                                  np.asarray(jf["occ_info"]["occ"]))


def test_init_state_neighbours(scene):
    """Canonical k-NN (kernel K1's plain version) vs the JAX CPU k-NN:
    equal neighbour sets wherever the kth and (k+1)th distances differ."""
    cfg = jtp.TemporalPointsConfig(**BASE)
    jn = np.sort(np.asarray(jax_state(cfg, scene)["nn_i"]), 1)
    _, state = port_model({}, scene)
    tn = np.sort(state["nn_i"].numpy(), 1)
    pcd = scene["pcd"]
    d2 = np.sort(((pcd[:, None] - pcd[None]) ** 2).sum(-1), 1)
    clear = d2[:, 8] > d2[:, 7] * (1 + 1e-4)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(tn[clear], jn[clear])
    np.testing.assert_allclose(state["nn_distance"].numpy()[clear],
                               np.sort(np.asarray(
                                   jax_state(cfg, scene)["nn_distance"]),
                                   1)[clear], rtol=1e-5, atol=1e-6)


def _port_init(cfg_kw, scene, seed):
    pcd, joints, bones, feat = scene_arrays()
    cfg = ttp.TemporalPointsConfig(**{**BASE, **cfg_kw})
    heads = {k: scene["tree"][k] for k in ttp.HEADS}
    return ttp.init_params(cfg, pcd, joints, bones, feat,
                           np.full(P, 0.5, np.float32),
                           np.full((P, 3), 0.5, np.float32), heads,
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu")


def test_init_params_vs_jax(scene):
    """The port's init_params: given the JAX init_params' tineuvox_params,
    rgbnet / densitynet / timenet are the JAX init_params' bit for bit
    (copied from the backbone); skinning weights, joints and per-point
    arrays equal the JAX ones (fp32, rtol 1e-6); the parameter tree has the
    JAX pytree's structure and shapes; the other networks are drawn from
    the torch.Generator alone."""
    model = _port_init({}, scene, 0)
    tree = scene["tree"]
    got = params_to_jax(model.state_dict())
    for name in ttp.HEADS:
        jax.tree_util.tree_map(np.testing.assert_array_equal, got[name],
                               tree[name])
    for key in ("weights", "joints", "theta_weight", "canonical_feat",
                "canonical_rgbs", "canonical_alpha", "direct_eps"):
        np.testing.assert_allclose(getattr(model, key).detach().numpy(),
                                   tree[key], rtol=1e-6, atol=0, err_msg=key)
    gam = model.gammas.detach().numpy()
    assert abs(gam.mean() - 1.0) < 2e-3 and 5e-3 < gam.std() < 2e-2
    assert (jax.tree_util.tree_map(np.shape, got)
            == jax.tree_util.tree_map(np.shape, tree))
    again, other = (_port_init({}, scene, 0).state_dict(),
                    _port_init({}, scene, 1).state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k
        if k.split(".")[0] in ttp.HEADS:
            assert torch.equal(other[k], v), k
    assert not torch.equal(other["feat_net.layers.0.weight"],
                           model.feat_net.layers[0].weight)


def test_init_params_re_init_mlps(scene):
    """Under re_init_mlps the three heads are drawn again, as the JAX
    init_params draws them: they differ from the backbone's, keep the JAX
    shapes (those of the JAX init_params with the flag), and repeat for
    one generator seed."""
    pcd, joints, bones, feat = scene_arrays()
    jcfg = jtp.TemporalPointsConfig(**{**BASE, "re_init_mlps": True})
    jre = jax.tree_util.tree_map(np.asarray, jtp.init_params(
        jax.random.PRNGKey(1), jcfg, pcd, joints, bones, feat,
        np.full(P, 0.5, np.float32), np.full((P, 3), 0.5, np.float32),
        {k: scene["tree"][k] for k in ttp.HEADS}))
    a = params_to_jax(_port_init({"re_init_mlps": True}, scene, 0)
                      .state_dict())
    b = params_to_jax(_port_init({"re_init_mlps": True}, scene, 0)
                      .state_dict())
    for name in ttp.HEADS:
        assert (jax.tree_util.tree_map(np.shape, a[name])
                == jax.tree_util.tree_map(np.shape, jre[name]))
        jax.tree_util.tree_map(np.testing.assert_array_equal, a[name],
                               b[name])
        for x, y in zip(jax.tree_util.tree_leaves(a[name]),
                        jax.tree_util.tree_leaves(scene["tree"][name])):
            assert not np.array_equal(x, y), name


def test_unported_options_raise(scene):
    """The options this test once showed raising are ported: budgets the
    coarse stride does not divide (the non-fused sampler pair), and
    ``agg_bf16=False`` / ``featmlp_kernel=False`` (the XLA feat_net
    formulation) give finite renders with foreground (their parity with
    the JAX package is in test_torch_featnet.py and
    test_torch_stage2_step.py). What stays refused raises: kernel K6
    (``fused_agg``) with gradients enabled, since it has no backward."""
    model, state = port_model({}, scene)
    o, d, v = map(torch.tensor, rays())
    rot = torch.tensor(rot_params())
    for over in (dict(sample_budget=40), dict(agg_bf16=False),
                 dict(featmlp_kernel=False)):
        model.cfg = ttp.TemporalPointsConfig(**{**BASE, **over})
        out = ttp.forward(model, state, o, d, v, rot_params=rot)
        assert np.isfinite(out["rgb_marched"].numpy()).all(), over
        assert (out["alphainv_last"].numpy() > 0.99).mean() < 0.05, over
    model.cfg = ttp.TemporalPointsConfig(**{**BASE, **FUSED})
    with torch.enable_grad(), pytest.raises(ValueError):
        ttp.forward(model, state, o, d, v, rot_params=rot)
