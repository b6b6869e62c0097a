"""Plain PyTorch version of kernel K4 (apnerf_torch.kernels.featmlp)
against ``featmlp_agg(..., interpret=True)`` on the CPU, at the bf16
tolerance of tests/test_kernels_interpret.py (rtol 2e-2, atol 5e-3): both
sides round every layer to bf16, in different summation orders."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.mark.parametrize("M,K,F,pb,pd,depth", [
    (193, 8, 128, 10, 32, 4),     # pose embedding, M not a block multiple
    (64, 4, 32, 4, 0, 2),         # no pose embedding, feat_depth 2
    (45, 8, 128, 10, 0, 5),       # 5 layers (the CUDA chain streams two)
    (7, 8, 64, 6, 0, 3),          # fewer rows than one 64-row tile
])
def test_featmlp_plain_vs_pallas(M, K, F, pb, pd, depth):
    from apnerf.ops import nn as jnn
    from apnerf.kernels.featmlp_pallas import featmlp_agg as jagg
    from apnerf_torch.kernels.featmlp import featmlp_agg as tagg, \
        pack_weights

    rng = np.random.default_rng(M)
    P = 3 * (1 + 2 * pb)
    rel = rng.normal(size=(M, K, 3)).astype(np.float32) * 0.1
    feat = rng.normal(size=(M, K, F)).astype(np.float32)
    w = rng.random((M, K)).astype(np.float32)
    pe = rng.normal(size=(pd,)).astype(np.float32) * 0.1 if pd else None
    fp = jnn.init_mlp(jax.random.PRNGKey(depth), [P + F + pd] + [F] * depth)
    fp_bf = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), fp)
    want = jagg(jnp.asarray(rel), jnp.asarray(feat).astype(jnp.bfloat16),
                jnp.asarray(w), fp_bf, K=K, pe_freqs=pb,
                pose_embedding=None if pe is None else jnp.asarray(pe),
                interpret=True)

    def bf(x):
        return torch.tensor(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16)

    layers = [(bf(lp["w"]).t(), bf(lp["b"])) for lp in fp_bf["layers"]]
    wts = pack_weights(layers, F, pb, None if pe is None else torch.tensor(pe))
    got = tagg(torch.tensor(rel), torch.tensor(feat).to(torch.bfloat16),
               torch.tensor(w), wts)
    assert got.shape == (M, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-2, atol=5e-3)


def test_pack_weights_layout():
    """Layer 1 splits into PE rows (zero-padded to a multiple of 16) and
    feature rows; the pose embedding folds into the fp32 bias."""
    from apnerf_torch.kernels.featmlp import pack_weights
    g = torch.Generator().manual_seed(0)
    F, pb, pd = 32, 4, 6
    P = 3 * (1 + 2 * pb)
    w1 = torch.randn(F, P + F + pd, generator=g).to(torch.bfloat16)
    b1 = torch.randn(F, generator=g).to(torch.bfloat16)
    w2 = torch.randn(F, F, generator=g).to(torch.bfloat16)
    b2 = torch.randn(F, generator=g).to(torch.bfloat16)
    pose = torch.randn(pd, generator=g)
    W1, B1, WL, BL, n_pe, P_pad = pack_weights([(w1, b1), (w2, b2)], F, pb,
                                               pose)[:6]
    assert n_pe == pb and P_pad == 32 and W1.shape == (P_pad + F, F)
    assert torch.equal(W1[:P], w1.t()[:P])
    assert not W1[P:P_pad].any()
    assert torch.equal(W1[P_pad:], w1.t()[P:P + F])
    torch.testing.assert_close(
        B1, b1.float() + pose @ w1.t()[P + F:].float())
    assert torch.equal(WL[0], w2.t()) and torch.equal(BL[0], b2.float())


def unswizzle(image, kd, F):
    """Numpy model of the layout ``wgmma`` reads as a K-major B operand
    with the 128-byte swizzle: ``image`` (uint16 words of bf16) holds
    ceil(kd / 64) chunks of [F rows (n)] x [64 k], the 16-byte unit j of
    row n at unit ``j ^ (n % 8)``. Returns the logical [kd, F] matrix and
    the number of words read."""
    chunks = -(-kd // 64)
    out = np.zeros((chunks * 64, F), np.uint16)
    for c in range(chunks):
        for n in range(F):
            for kk in range(64):
                unit = (kk // 8) ^ (n % 8)
                word = (c * F * 128 + n * 128 + unit * 16) // 2 + kk % 8
                out[c * 64 + kk, n] = image[word]
    assert not out[kd:].any()                   # K is zero-padded
    return out[:kd], chunks * F * 64


def fragment_k_order(F):
    """Numpy model of ``csrc/featmlp_chain.cuh:load_feat``: which feature
    column lands at which K position of the m64k16 A fragments. Lane quad
    index q loads the 16-byte vector q + 4 i of a row (columns 8 (q + 4 i)
    .. + 7) as four registers x, y, z, w, which become a[2 i][0], a[2 i][2],
    a[2 i + 1][0], a[2 i + 1][2]; register a[s][0] holds K positions 16 s +
    2 q + {0, 1} and a[s][2] positions 16 s + 8 + 2 q + {0, 1}."""
    col_at = np.full(F, -1)
    for q in range(4):
        for i in range(F // 32):
            c0 = 8 * (q + 4 * i)
            for reg, (s, second) in enumerate(((2 * i, 0), (2 * i, 1),
                                               (2 * i + 1, 0),
                                               (2 * i + 1, 1))):
                for e in range(2):
                    col_at[16 * s + 8 * second + 2 * q + e] = c0 + 2 * reg + e
    return col_at


@pytest.mark.parametrize("F", [32, 64, 128])
def test_feat_k_order_matches_the_fragment_layout(F):
    from apnerf_torch.kernels.featmlp import feat_k_order
    order = feat_k_order(F).numpy()
    assert sorted(order.tolist()) == list(range(F))
    np.testing.assert_array_equal(order, fragment_k_order(F))


@pytest.mark.parametrize("depth", [1, 2, 4, 5])
@pytest.mark.parametrize("F", [32, 64, 128])
def test_weight_image_unswizzles_to_the_logical_weights(F, depth):
    """``pack_weights``' kernel image, read back through a numpy model of
    the swizzle and of the feature K order, is w1 / wl bit for bit."""
    from apnerf_torch.kernels.featmlp import pack_weights
    g = torch.Generator().manual_seed(F + depth)
    pb = 10 if F > 32 else 4
    P = 3 * (1 + 2 * pb)
    dims = [P + F] + [F] * depth
    layers = [(torch.randn(dout, din, generator=g).to(torch.bfloat16),
               torch.randn(dout, generator=g).to(torch.bfloat16))
              for din, dout in zip(dims[:-1], dims[1:])]
    wts = pack_weights(layers, F, pb, None)
    image = wts.image.numpy().view(np.uint16)
    w1 = wts.w1.view(torch.int16).numpy().view(np.uint16)
    wl = wts.wl.view(torch.int16).numpy().view(np.uint16)
    feat, n = unswizzle(image, F, F)
    np.testing.assert_array_equal(feat, w1[wts.P_pad:][fragment_k_order(F)])
    pe, m = unswizzle(image[n:], wts.P_pad, F)
    np.testing.assert_array_equal(pe, w1[:wts.P_pad])
    off = n + m
    for i in range(depth - 1):
        hidden, n = unswizzle(image[off:], F, F)
        np.testing.assert_array_equal(hidden, wl[i])
        off += n
    assert off == image.size


@pytest.mark.parametrize("F,P_pad,L,mode,resident", [
    (128, 64, 4, "resident", 4),      # the bench width: 206,208 bytes
    (128, 64, 1, "resident", 1),
    (128, 64, 5, "streamed", 3),      # layer 1 + 2 hidden + the slot
    (128, 64, 9, "streamed", 3),
    (128, 80, 4, "streamed", 2),      # a second PE chunk costs a layer
    (64, 64, 8, "resident", 8),
    (32, 32, 2, "resident", 2),
    (128, 384, 2, "refused", 0),      # not even layer 1 and a slot fit
])
def test_chain_plan_rule(F, P_pad, L, mode, resident):
    """Which layers stay in shared memory is a pure function of the
    shapes: all of them when they fit beside the operand tiles, else as
    many as fit beside one streaming slot, else the shape is refused."""
    from apnerf_torch.kernels import featmlp as fm
    plan = fm.chain_plan(F, P_pad, L)
    assert (plan["mode"], plan["resident"]) == (mode, resident)
    assert plan["smem_bytes"] <= fm.SMEM_LIMIT
    if mode == "streamed":
        # one more resident layer would not fit beside the slot
        wh = -(-F // 64) * F * 128
        assert plan["smem_bytes"] + wh > fm.SMEM_LIMIT


def test_chain_refuses_what_does_not_fit():
    """A shape whose first layer does not fit the chain's shared memory is
    refused by the wrapper's check, by the rule and not by a failed
    launch."""
    from apnerf_torch.kernels import featmlp as fm
    F, pb = 128, 60                                   # P = 363, P_pad = 368
    g = torch.Generator().manual_seed(0)
    P = 3 * (1 + 2 * pb)
    layers = [(torch.randn(F, P + F, generator=g).to(torch.bfloat16),
               torch.randn(F, generator=g).to(torch.bfloat16))]
    wts = fm.pack_weights(layers, F, pb, None)
    assert fm.chain_plan(F, wts.P_pad, 1)["mode"] == "refused"
    with pytest.raises(ValueError, match="does not fit"):
        fm.check_chain(wts, F, "featmlp")
