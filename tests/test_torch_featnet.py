"""The port's XLA feat_net formulation (``featnet_plain``, the aggregation
the JAX ``_featnet_h`` runs without its kernel), kernel K4's training
Function (``FeatMLPTrain``), the six stage-2 losses and the curriculum
samplers, against the JAX package on the CPU.

Inputs: 96 rows of K = 8 neighbours, F = 32, posbase_pe 10, a 4-layer
feat_net, with and without an 8-wide pose embedding, made with numpy from
a seed; feat_net from the JAX ``init_mlp``, handed over through
``params_from_jax``. Tolerances:

* fp32 (``agg_bf16`` False): h to 1e-5 relative, every gradient (of
  ``rel_canon``, ``feat_k``, ``w``, the pose embedding and every feat_net
  leaf, through ``jax.vjp`` with one cotangent) to 1e-4 relative + 1e-6
  of max(1, the gradient's max |.|) absolute: the rel_canon gradient
  passes through PE frequencies up to 2^9, which carry the two packages'
  fp32 summation orders into it (measured 1.2e-6 on a gradient whose max
  is 4.5);
* bf16: both packages round each product and bias add to bf16 but differ
  in where a dot's fp32 sum is rounded. h is held to 1e-2 of max |h|.
  A bf16 gradient is noisy in itself (a rounding flips a leaky-ReLU
  slope): on this input each package's rel / feat gradient departs from
  the fp32 gradient by up to 11-39% of its max |.| at single elements,
  0.2-0.4% on average. So each bf16 gradient is held by its mean
  deviation from the fp32 gradient, at most 1.5 times the JAX package's
  (measured 0.16-1.42 times over every leaf, 1.33 for the pose
  embedding, whose gradient sums bf16 cotangents over every row);
* K4's Function: its forward is K4's plain version (fp32 sums of exact
  bf16 products) and its backward the formulation's VJP, so its
  gradients equal the formulation's at the same cotangent to 1e-6; the JAX
  custom VJP (``featmlp_agg``, its Pallas kernel in interpret mode) takes
  the same formulation backward: h within 1e-3 of max |h| (the kernels
  round alike), gradients within the bf16 bound above;
* the losses: 1e-6 relative (fp32, same sums);
* the samplers: the same index sequence for the same seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.kernels.featmlp_pallas import featmlp_agg as jax_featmlp_agg
from apnerf.models import temporal_points as jtp
from apnerf.ops import nn as jnn
from apnerf.utils import samplers as jsamplers
from apnerf_torch.kernels.featmlp import pack_weights
from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.ops.nn import MLP
from apnerf_torch.utils import samplers as tsamplers
from apnerf_torch.utils.checkpoint import params_from_jax

M, K, F, N_PE, DEPTH, POSE = 96, 8, 32, 10, 4, 8
PTS_CH = 3 + 6 * N_PE


def inputs(pose: bool):
    rng = np.random.default_rng(3)
    rel = (rng.normal(size=(M, K, 3)) * 0.1).astype(np.float32)
    feat = (rng.normal(size=(M, K, F)) * 0.5).astype(np.float32)
    w = rng.random((M, K)).astype(np.float32) + 0.1
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    pe = (rng.normal(size=(1, POSE)) * 0.5).astype(np.float32) if pose \
        else None
    params = jnn.init_mlp(jax.random.PRNGKey(4), [PTS_CH + F
                                                   + (POSE if pose else 0)]
                          + [F] * DEPTH)
    g = rng.normal(size=(M, F)).astype(np.float32)
    return rel, feat, w, pe, jax.tree_util.tree_map(np.asarray, params), g


def torch_mlp(tree):
    dims = [tree["layers"][0]["w"].shape[0]] + [F] * DEPTH
    mlp = MLP(dims, "leaky_relu", "leaky_relu")
    mlp.load_state_dict(params_from_jax(tree))
    return mlp


def jax_featnet(bf16: bool, rel, feat, w, pe, tree, g):
    """h and the gradients of <h, g> through the JAX ``_featnet_h`` plain
    branch, its caller's bf16 cast of feat_net included."""
    cfg = jtp.TemporalPointsConfig(n_points=1, n_joints=1, feat_dim=F,
                                   posbase_pe=N_PE, agg_bf16=bf16,
                                   featmlp_kernel=False)

    def f(rel, feat, w, pe, params):
        if bf16:
            params = jax.tree_util.tree_map(
                lambda x: x.astype(jnp.bfloat16), params)
        return jtp._featnet_h(cfg, params, rel, feat, w, pe)

    args = [jnp.asarray(rel), jnp.asarray(feat), jnp.asarray(w),
            None if pe is None else jnp.asarray(pe),
            jax.tree_util.tree_map(jnp.asarray, tree)]
    h, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g))
    return np.asarray(h), grads


def port_featnet(bf16: bool, rel, feat, w, pe, tree, g):
    mlp = torch_mlp(tree)
    dt = torch.bfloat16 if bf16 else torch.float32
    ts = [torch.tensor(x, requires_grad=True) for x in (rel, feat, w)]
    tpe = None if pe is None else torch.tensor(pe, requires_grad=True)
    layers = [(l.weight.to(dt), l.bias.to(dt)) for l in mlp.layers]
    h = ttp.featnet_plain(layers, *ts, tpe, N_PE, dt)
    h.backward(torch.tensor(g))
    return h.detach().numpy(), ts, tpe, mlp


def grad_pairs(ts, tpe, mlp, jgrads):
    """[(name, port gradient, JAX gradient)] over rel, feat, w, the pose
    embedding and every feat_net leaf, as fp32 numpy."""
    pairs = [(n, t.grad.float().numpy(), np.asarray(j, np.float32))
             for t, j, n in zip(ts, jgrads[:3], ("rel", "feat", "w"))]
    if tpe is not None:
        pairs.append(("pose", tpe.grad.numpy(), np.asarray(jgrads[3])))
    want = params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), jgrads[4]))
    for name, p in mlp.named_parameters():
        pairs.append((name, p.grad.numpy(), want[name].numpy()))
    return pairs


def assert_grads(ts, tpe, mlp, jgrads, rel_tol, abs_tol):
    """Port gradients against the JAX ones elementwise: ``rel_tol``, and
    ``abs_tol`` of max(1, the gradient's max |.|)."""
    for name, got, ref in grad_pairs(ts, tpe, mlp, jgrads):
        np.testing.assert_allclose(
            got, ref, rtol=rel_tol,
            atol=abs_tol * max(1.0, float(np.abs(ref).max())), err_msg=name)


def assert_bf16_grads(pairs16, pairs32):
    """bf16 gradients (``pairs16``: port and JAX bf16, ``pairs32``: the
    JAX fp32 gradient third): each package's mean deviation from the fp32
    gradient, relative to its max |.|; the port's may be at most 1.5 times
    the JAX package's."""
    for (name, got, j16), (_, _, j32) in zip(pairs16, pairs32):
        scale = np.abs(j32).max()
        assert np.isfinite(got).all(), name
        port_err = np.abs(got - j32).mean() / scale
        jax_err = np.abs(j16 - j32).mean() / scale
        assert port_err <= 1.5 * jax_err + 1e-6, (name, port_err, jax_err)


@pytest.mark.parametrize("pose", [False, True])
def test_featnet_fp32_vs_jax(pose):
    rel, feat, w, pe, tree, g = inputs(pose)
    jh, jgrads = jax_featnet(False, rel, feat, w, pe, tree, g)
    h, ts, tpe, mlp = port_featnet(False, rel, feat, w, pe, tree, g)
    np.testing.assert_allclose(h, jh, rtol=1e-5, atol=1e-7)
    assert_grads(ts, tpe, mlp, jgrads, 1e-4, 1e-6)


@pytest.mark.parametrize("pose", [False, True])
def test_featnet_bf16_vs_jax(pose):
    rel, feat, w, pe, tree, g = inputs(pose)
    jh, j16 = jax_featnet(True, rel, feat, w, pe, tree, g)
    _, j32 = jax_featnet(False, rel, feat, w, pe, tree, g)
    h, ts, tpe, mlp = port_featnet(True, rel, feat, w, pe, tree, g)
    assert np.abs(h - jh).max() <= 1e-2 * np.abs(jh).max()
    assert_bf16_grads(grad_pairs(ts, tpe, mlp, j16),
                      grad_pairs(ts, tpe, mlp, j32))


def k4_train(rel, feat, w, pe, tree, g):
    """h and the gradients through FeatMLPTrain (K4's plain forward on
    the CPU, the recompute backward)."""
    mlp = torch_mlp(tree)
    ts = [torch.tensor(rel, requires_grad=True),
          torch.tensor(feat).to(torch.bfloat16).requires_grad_(),
          torch.tensor(w, requires_grad=True)]
    tpe = None if pe is None else torch.tensor(pe, requires_grad=True)
    layers = [(l.weight.to(torch.bfloat16), l.bias.to(torch.bfloat16))
              for l in mlp.layers]
    wts = pack_weights([(a.detach(), b.detach()) for a, b in layers], F,
                       N_PE, None if tpe is None else tpe.detach())
    h = ttp.FeatMLPTrain.apply(wts, N_PE, *ts, tpe,
                               *(t for layer in layers for t in layer))
    h.backward(torch.tensor(g))
    return h.detach().numpy(), ts, tpe, mlp


@pytest.mark.parametrize("pose", [False, True])
def test_k4_function_vs_formulation_and_jax(pose):
    rel, feat, w, pe, tree, g = inputs(pose)
    feat = torch.tensor(feat).to(torch.bfloat16).float().numpy()
    h, ts, tpe, mlp = k4_train(rel, feat, w, pe, tree, g)
    # the backward is the bf16 formulation's at the same cotangent
    _, fts, ftpe, fmlp = port_featnet(True, rel, feat, w, pe, tree, g)
    for a, b in zip(ts + [tpe] * (pe is not None),
                    fts + [ftpe] * (pe is not None)):
        np.testing.assert_allclose(a.grad.float().numpy(),
                                   b.grad.float().numpy(), rtol=1e-6,
                                   atol=1e-6)
    for (n, p), q in zip(mlp.named_parameters(), fmlp.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    # against the JAX custom VJP, its Pallas kernel in interpret mode
    btree = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                   tree)

    def f(r, fe, ww, p, params):
        return jax_featmlp_agg(r, fe, ww, params, K=K, pe_freqs=N_PE,
                               pose_embedding=p, interpret=True)

    jargs = [jnp.asarray(rel), jnp.asarray(feat, jnp.bfloat16),
             jnp.asarray(w), None if pe is None else jnp.asarray(pe), btree]
    jh, vjp = jax.vjp(f, *jargs)
    jgrads = vjp(jnp.asarray(g))
    jh = np.asarray(jh)
    assert np.abs(h - jh).max() <= 1e-3 * np.abs(jh).max()
    _, j32 = jax_featnet(False, rel, feat, w, pe, tree, g)
    ts[1] = _as_f32_grad(ts[1])
    assert_bf16_grads(grad_pairs(ts, tpe, mlp, jgrads),
                      grad_pairs(ts, tpe, mlp, j32))


def _as_f32_grad(t):
    """A leaf whose ``.grad`` is the given tensor's gradient in fp32."""
    out = t.detach().float()
    out.grad = t.grad.float()
    return out


def loss_inputs():
    rng = np.random.default_rng(5)
    P, J, S = 300, 5, 40
    pcd = rng.normal(size=(P, 3)).astype(np.float32)
    nn_i = np.argsort(((pcd[:, None] - pcd[None]) ** 2).sum(-1), 1)[:, :8]
    nn_dist = np.sqrt(((pcd[:, None] - pcd[nn_i]) ** 2).sum(-1)
                      + 1e-6).astype(np.float32)
    state = {"nn_i": nn_i, "nn_distance": nn_dist,
             "skeleton_pcd": rng.normal(size=(S, 3)).astype(np.float32)}
    warped = (pcd + rng.normal(size=pcd.shape) * 0.05).astype(np.float32)
    lbs = rng.random((P, J)).astype(np.float32)
    lbs = lbs / lbs.sum(-1, keepdims=True)
    return dict(state=state, warped=warped, lbs=lbs,
                global_t=rng.normal(size=3).astype(np.float32),
                thetas=rng.normal(size=J).astype(np.float32),
                joints=rng.normal(size=(J, 3)).astype(np.float32),
                proj=(rng.random((2, 50, 2)) * 30).astype(np.float32),
                mask=(rng.random((2, 70, 2)) * 30).astype(np.float32))


@pytest.mark.parametrize("loss", ["arap", "tv", "sparsity", "trans",
                                  "joint_chamfer", "chamfer_2d"])
def test_losses_vs_jax(loss):
    d = loss_inputs()
    js = {k: jnp.asarray(v) for k, v in d["state"].items()}
    ts = {k: torch.as_tensor(v) for k, v in d["state"].items()}
    ts["nn_i"] = ts["nn_i"].long()
    j = {k: jnp.asarray(v) for k, v in d.items() if k != "state"}
    t = {k: torch.as_tensor(v) for k, v in d.items() if k != "state"}
    calls = {
        "arap": (lambda m, s, a: m.arap_loss(s, a["warped"])),
        "tv": (lambda m, s, a: m.neighbour_weight_tv_loss(s, a["lbs"])),
        "sparsity": (lambda m, s, a: m.weight_sparsity_loss(a["lbs"])),
        "trans": (lambda m, s, a: m.transformation_reg_loss(a["global_t"],
                                                            a["thetas"])),
        "joint_chamfer": (lambda m, s, a: m.joint_chamfer_loss(s,
                                                               a["joints"])),
        "chamfer_2d": (lambda m, s, a: m.batch_chamfer_2d(a["proj"],
                                                          a["mask"])),
    }
    want = float(calls[loss](jtp, js, j))
    got = float(calls[loss](ttp, ts, t))
    assert want != 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_samplers_vs_jax():
    """The same times for the same seed, over a growing curriculum."""
    js = jsamplers.InverseProportionalSampler(9, seed=11)
    ts = tsamplers.InverseProportionalSampler(9, seed=11)
    for step in range(1, 200):
        jw = jsamplers.curriculum_window(step, 9, 120, 2)
        tw = tsamplers.curriculum_window(step, 9, 120, 2)
        assert jw == tw
        assert js.sample(jw[1], jw[0]) == ts.sample(tw[1], tw[0])
    np.testing.assert_array_equal(js.counts, ts.counts)
    for args in [(0, 9, 3.5), (8, 9, 4.0), (4, 9, 20.0), (1, 9, 1.0)]:
        assert (jsamplers.curriculum_range(*args)
                == tsamplers.curriculum_range(*args))
