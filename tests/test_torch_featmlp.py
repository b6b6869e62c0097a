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
                                               pose)
    assert n_pe == pb and P_pad == 32 and W1.shape == (P_pad + F, F)
    assert torch.equal(W1[:P], w1.t()[:P])
    assert not W1[P:P_pad].any()
    assert torch.equal(W1[P_pad:], w1.t()[P:P + F])
    torch.testing.assert_close(
        B1, b1.float() + pose @ w1.t()[P + F:].float())
    assert torch.equal(WL[0], w2.t()) and torch.equal(BL[0], b2.float())
