"""K4's gathering front (``kernels.featmlp.featmlp_gather``): the exact
render path's aggregation in ``featnet_plain``'s rounding. The kernel runs
only on the card (``chip_smoke.py`` phase 3 holds it against the gather
and ``featnet_plain`` there); on the CPU:

- ``plain_chain``, the chain's arithmetic over the packed operands
  (``pack_plain_weights``), equals ``featnet_plain`` in bf16 bit for bit,
  with and without a pose embedding, at F 32 / 64 / 128. Each output of a
  layer takes one input of each part (features and PE; the pose
  embedding), so every fp32 sum is exact in any order and what is held is
  the packing and the rounding: the product (with the pose term) rounded,
  then the bf16 bias, then leaky-ReLU. K4's own rounding (the bias in
  fp32, the pose folded into it) differs on the same inputs.
- ``gather_rows_plain``, the front's geometry in the kernel's order
  (that of the plain path's sums on the card, where ``chip_smoke.py``
  holds kth bit-equal), against the plain path's expressions on the CPU,
  which sums the squares in another order: kth, the weights and the
  offsets within fp32 rounding; the live prefix clears the rest.
- ``gather_kernel_ok`` takes the kernel only on the card, with gradients
  off, ``featmlp_kernel`` off, bf16 aggregation, two layers or more, F in
  the kernel's widths, K dividing a tile and not ``render_pcd_direct``;
  a frame prepared with gradients builds no tables, nor a frame of the
  shared path, an exact one without gradients does, and a render through
  the front's plain version (the predicate told the CPU is the card)
  matches the plain path's, where the same render in K4's own rounding
  (``chip_smoke.gather_k4_rounding``, the smoke's control) does not.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from apnerf_torch.data.bench_scene import bench_config, bench_heads  # noqa: E402
from apnerf_torch.kernels import featmlp as fm  # noqa: E402
from apnerf_torch.models import temporal_points as tp  # noqa: E402

K, N_PE, DEPTH, POSE = 8, 10, 4, 64
P = 3 + 6 * N_PE


def sparse_layers(g, F, pose):
    """feat_net's bf16 layers with one nonzero weight an output in each
    part of a layer's input ([PE | features], then the pose embedding),
    at random places; dense biases."""
    dins = [P + F + (POSE if pose else 0)] + [F] * (DEPTH - 1)
    layers = []
    for din in dins:
        wt = torch.zeros(F, din)
        rows = torch.arange(F)
        main = torch.randint(0, P + F if din > F else din, (F,), generator=g)
        wt[rows, main] = torch.randn(F, generator=g)
        if din > P + F:
            side = P + F + torch.randint(0, POSE, (F,), generator=g)
            wt[rows, side] = torch.randn(F, generator=g)
        b = 0.3 * torch.randn(F, generator=g)
        layers.append((wt.to(torch.bfloat16), b.to(torch.bfloat16)))
    return layers


def chain_inputs(g, F, M=48):
    rel = 0.2 * torch.randn(M, K, 3, generator=g)
    feat = torch.randn(M, K, F, generator=g).to(torch.bfloat16)
    w = torch.rand(M, K, generator=g) + 0.1
    return rel, feat, w / w.sum(-1, keepdim=True)


@pytest.mark.parametrize("pose", [False, True], ids=["no_pose", "pose64"])
@pytest.mark.parametrize("F", [32, 64, 128])
def test_plain_chain_equals_featnet_plain(F, pose):
    g = torch.Generator().manual_seed(F + pose)
    layers = sparse_layers(g, F, pose)
    rel, feat, w = chain_inputs(g, F)
    pe = 0.5 * torch.randn(1, POSE, generator=g) if pose else None
    want = tp.featnet_plain(layers, rel, feat, w, pe, N_PE, torch.bfloat16)
    got = fm.plain_chain(rel, feat, w,
                         fm.pack_plain_weights(layers, F, N_PE, pe))
    assert torch.equal(got, want)
    # K4's own rounding on the same operands is another formulation
    k4 = fm.featmlp_plain(rel, feat, w, fm.pack_weights(layers, F, N_PE, pe))
    assert not torch.equal(k4, want)


def test_pack_plain_weights_layout():
    """The PE rows zero-padded, the feature rows after them, the same image
    as K4's; the biases' bf16 values; the pose term as the exact products
    of the pose embedding's and its rows' bf16 values, summed."""
    g = torch.Generator().manual_seed(5)
    F = 32
    layers = [(torch.randn(F, P + F + POSE, generator=g).to(torch.bfloat16),
               torch.randn(F, generator=g).to(torch.bfloat16))] + [
        (torch.randn(F, F, generator=g).to(torch.bfloat16),
         torch.randn(F, generator=g).to(torch.bfloat16))]
    pe = torch.randn(1, POSE, generator=g)
    wts = fm.pack_plain_weights(layers, F, N_PE, pe)
    k4 = fm.pack_weights(layers, F, N_PE, pe)
    assert wts.P_pad == 64 and torch.equal(wts.image, k4.image)
    W1 = layers[0][0].t().float()
    assert torch.equal(wts.w1[:P].float(), W1[:P])
    assert not wts.w1[P:wts.P_pad].any()
    assert torch.equal(wts.w1[wts.P_pad:].float(), W1[P:P + F])
    assert torch.equal(wts.b1, layers[0][1].float())
    assert torch.equal(wts.bl[0], layers[1][1].float())
    want = (pe.to(torch.bfloat16).float().reshape(-1, 1)
            * W1[P + F:]).double().sum(0)
    np.testing.assert_allclose(wts.pose.double(), want, rtol=1e-6)
    assert fm.pack_plain_weights(layers[:1], F, N_PE, pe).bl.shape == (0, F)
    with pytest.raises(ValueError, match="pose embedding"):
        fm.pack_plain_weights(layers, F, N_PE, None)


def tables(g, Pp=300, F=32):
    geo = torch.cat([torch.rand(Pp, 3, generator=g),
                     torch.randn(Pp, 9, generator=g)], -1)
    feat = torch.randn(Pp, F, generator=g).to(torch.bfloat16)
    return geo, feat


def test_gather_rows_match_plain_path():
    """The front's geometry against ``_exact_slots``' expressions."""
    g = torch.Generator().manual_seed(7)
    geo, _ = tables(g)
    n = 200
    q = torch.rand(n, 3, generator=g)
    idx = torch.randint(0, geo.shape[0], (n, K), generator=g,
                        dtype=torch.int32)
    rel, w, kth = fm.gather_rows_plain(q, idx, geo, 1e-6)
    gg = geo[idx.long()]
    rel_p = q[:, None, :] - gg[..., :3]
    to_nn = (rel_p ** 2).sum(-1)
    ww = 1.0 / (to_nn + 1e-6)
    ww = ww / ww.sum(-1, keepdim=True)
    rc = torch.einsum("mkab,mkb->mka", gg[..., 3:].reshape(n, K, 3, 3),
                      rel_p)
    torch.testing.assert_close(kth, to_nn.amax(-1), rtol=2 ** -23, atol=0)
    d = rel_p
    card = (d[..., 0] * d[..., 0] + d[..., 2] * d[..., 2]) + d[..., 1] ** 2
    assert torch.equal(kth, card.amax(-1))
    torch.testing.assert_close(w, ww, rtol=1e-6, atol=0)
    torch.testing.assert_close(rel, rc, rtol=1e-5, atol=1e-6)


def test_gather_live_prefix():
    """Past the live prefix: h 0, kth +inf, w 0; before it, the rows of a
    call without one."""
    g = torch.Generator().manual_seed(9)
    F = 32
    geo, feat = tables(g, F=F)
    layers = sparse_layers(g, F, False)
    tabs = fm.GatherTables(geo, feat,
                           fm.pack_plain_weights(layers, F, N_PE, None))
    n, n_live = 40, 23
    q = torch.rand(n, 3, generator=g)
    idx = torch.randint(0, geo.shape[0], (n, K), generator=g,
                        dtype=torch.int32)
    h, kth, w = fm.featmlp_gather(q, idx, tabs, 1e-6, want_w=True)
    live = torch.arange(n) < n_live
    hl, kl, wl = fm.featmlp_gather(q, idx, tabs, 1e-6, live=live,
                                   want_w=True)
    assert torch.equal(hl[:n_live], h[:n_live])
    assert torch.equal(kl[:n_live], kth[:n_live])
    assert torch.equal(wl[:n_live], w[:n_live])
    assert not hl[n_live:].any() and not wl[n_live:].any()
    assert torch.isinf(kl[n_live:]).all()
    assert fm.featmlp_gather(q, idx, tabs, 1e-6)[2] is None


BASE_CFG = dict(featmlp_kernel=False, knn_share=1)


@pytest.mark.parametrize("case, over, device, grad, direct, want", [
    ("taken", {}, "cuda", False, False, True),
    ("cpu", {}, "cpu", False, False, False),
    ("grad", {}, "cuda", True, False, False),
    ("featmlp_kernel", dict(featmlp_kernel=True), "cuda", False, False,
     False),
    ("fp32_agg", dict(agg_bf16=False), "cuda", False, False, False),
    ("one_layer", dict(feat_depth=1), "cuda", False, False, False),
    ("width", dict(feat_dim=96), "cuda", False, False, False),
    ("neighbours", dict(neighbours=12), "cuda", False, False, False),
    ("pcd_direct", {}, "cuda", False, True, False),
])
def test_gather_kernel_dispatch(case, over, device, grad, direct, want):
    cfg = bench_config(100, 4, 128, **{**BASE_CFG, **over})
    with torch.set_grad_enabled(grad):
        assert fm.gather_kernel_ok(torch.device(device), cfg, direct) is want


@pytest.fixture(scope="module")
def small_model():
    rng = np.random.default_rng(0)
    J, F, Pn = 4, 32, 400
    joints = np.zeros((J, 3), np.float32)
    joints[:, 1] = np.linspace(-0.2, 0.2, J)
    bones = [[j, j + 1] for j in range(J - 1)]
    pcd = (joints[rng.integers(0, J, Pn)]
           + rng.normal(size=(Pn, 3)) * 0.05).astype(np.float32)
    feat = (rng.normal(size=(Pn, F)) * 0.3).astype(np.float32)
    cfg = bench_config(Pn, J, F, knn_share=1, featmlp_kernel=False,
                       sample_budget=32, max_steps=128, coarse_stride=16,
                       active_fraction=1.0, pass_fraction=0.3)
    gen = torch.Generator().manual_seed(1)
    model = tp.init_params(cfg, pcd, joints, bones, feat,
                           np.full(Pn, 0.5, np.float32),
                           np.full((Pn, 3), 0.5, np.float32),
                           bench_heads(cfg, gen), generator=gen,
                           device="cpu")
    state = tp.init_state(cfg, pcd, joints, bones, pcd[::40],
                          pcd.min(0) - 0.1, pcd.max(0) + 0.1, device="cpu")
    return model, state


def _rays(n=96):
    rng = np.random.default_rng(2)
    o = np.tile(np.array([[0.0, 0.0, 1.5]], np.float32), (n, 1))
    d = np.stack([rng.uniform(-0.12, 0.12, n), rng.uniform(-0.25, 0.25, n),
                  -np.ones(n)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.tensor(o), torch.tensor(d), torch.tensor(d)


def test_frame_tables_and_render_through_front(small_model, monkeypatch):
    """With the predicate told the CPU is the card: a frame prepared with
    gradients builds no tables, nor one of the shared path; an exact one
    without gradients builds them, and its render through the front's
    plain version matches the plain path's, where the front in K4's own
    rounding (the bias in fp32, as switching K4 on would give) does not.
    Over a black background the image is the figure's alone: the front
    reads at most 9.3e-10 off the plain path (the sums of an fp32 product
    in another order), K4's rounding 2.7e-7; the LBS-weight images depend
    on the weights alone, 2.4e-7 off (a few float32 steps, the weights'
    sum in the card's order)."""
    model, state = small_model
    real = fm.gather_kernel_ok
    plain_front = fm.featmlp_gather_plain

    def as_card(dev, cfg, direct=False):
        return real(torch.device("cuda"), cfg, direct)

    def render(card, front=plain_front):
        monkeypatch.setattr(fm, "gather_kernel_ok", as_card if card else real)
        monkeypatch.setattr(fm, "featmlp_gather_plain", front)
        o, d, v = _rays()
        with torch.no_grad():
            frame = tp.prepare_frame(model, state, t=torch.tensor([0.3]))
            return frame, tp.forward(model, state, o, d, v, near=0.5,
                                     far=6.0, bg=0.0, render_weights=True,
                                     frame=frame)

    monkeypatch.setattr(fm, "gather_kernel_ok", as_card)
    with torch.enable_grad():
        assert tp.prepare_frame(model, state, t=torch.tensor([0.3]))[
            "point_sources"].gather_tabs is None
    # a frame of the shared path neither
    exact = model.cfg
    model.cfg = dataclasses.replace(exact, knn_share=16)
    try:
        with torch.no_grad():
            assert tp.prepare_frame(model, state, t=torch.tensor([0.3]))[
                "point_sources"].gather_tabs is None
    finally:
        model.cfg = exact
    frame, got = render(True)
    tabs = frame["point_sources"].gather_tabs
    assert tabs is not None and tabs.feat.dtype == torch.bfloat16
    assert tabs.wts.pose is None
    _, k4 = render(True, cs.gather_k4_rounding)
    _, want = render(False)
    assert got["knn_path"] == want["knn_path"] == "exact"
    assert torch.equal(got["budget_audit"], want["budget_audit"])
    assert int(want["budget_audit"][2]) > 0
    gap = (got["rgb_marched"] - want["rgb_marched"]).abs().max()
    k4_gap = (k4["rgb_marched"] - want["rgb_marched"]).abs().max()
    assert float(gap) <= 2e-8 < float(k4_gap), (gap, k4_gap)
    d = (got["lbs_w_per_sample"] - want["lbs_w_per_sample"]).abs()
    assert float(d.max()) <= 1e-6
