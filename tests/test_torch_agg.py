"""Plain PyTorch version of kernel K6 (apnerf_torch.kernels.agg) against
``apnerf.kernels.agg_pallas.fused_subgroup_agg`` in interpret mode on the
CPU, at the sizes of tests/test_kernels_interpret.py (S = 16 subgroups of
share 4, kc candidates, K = 8, F = 32, pe 10, sb = 8, 15% invalid slots).

Tolerances: ``kd2`` is a max over exactly formed fp32 distances; the Pallas
kernel adds the three squares in another order, hence 1e-6 relative, and
both sides must call the same samples invalid (> 1e17). ``h``: both sides
round the three hidden layers to bf16 with fp32 accumulation in different
summation orders, measured 8.4e-5 max abs (|h| up to 0.34); the bound is
1e-3, far inside the 0.05 that the JAX test allows against XLA.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apnerf.kernels.agg_pallas import fused_subgroup_agg as jagg
from apnerf.ops import nn as jnn
from apnerf_torch.kernels import agg as tagg
from apnerf_torch.kernels.featmlp import pack_weights

S, SHARE, K, F, PE = 16, 4, 8, 32, 10
EPS = 1e-6
H_ATOL = 1e-3


def inputs(kc, seed=5, invalid=0.15):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, SHARE, 3)).astype(np.float32) * 0.2
    nbr = (q[:, :1] + rng.normal(size=(S, kc, 3)).astype(np.float32)
           * 0.1).astype(np.float32)
    nbr[rng.uniform(size=(S, kc)) < invalid] = 2e9
    rot = rng.normal(size=(S, kc, 9)).astype(np.float32)
    feat = rng.normal(size=(S, kc, F)).astype(np.float32) * 0.3
    fin = 3 * (1 + 2 * PE) + F
    fp = jnn.init_mlp(jax.random.PRNGKey(0), [fin] + [F] * 4)
    return q, nbr, rot, feat, fp


def port_weights(fp):
    def bf(x):
        return torch.tensor(np.asarray(
            x.astype(jnp.bfloat16).astype(jnp.float32))).to(torch.bfloat16)
    return pack_weights([(bf(lp["w"]).t(), bf(lp["b"]))
                         for lp in fp["layers"]], F, PE, None)


def run_port(q, nbr, rot, feat, fp):
    return tagg.fused_subgroup_agg(
        torch.tensor(q), torch.tensor(nbr), torch.tensor(rot),
        torch.tensor(feat).to(torch.bfloat16), port_weights(fp), K, EPS)


@pytest.mark.parametrize("kc", [12, 8, 16])
def test_agg_plain_vs_pallas(kc):
    """kc > K (the rank mask selects; 12 leaves rows of a 64-row tile idle,
    16 does not) and kc == K (it still runs)."""
    q, nbr, rot, feat, fp = inputs(kc)
    jh, jkd2 = jagg(jnp.asarray(q), jnp.asarray(nbr.transpose(1, 0, 2)),
                    jnp.asarray(rot.transpose(1, 0, 2)),
                    jnp.asarray(feat.transpose(1, 0, 2), jnp.bfloat16), fp,
                    share=SHARE, K=K, eps=EPS, sb=8)
    jh = np.asarray(jh).transpose(1, 0, 2)               # -> [S, share, F]
    jkd2 = np.asarray(jkd2).T
    h, kd2 = run_port(q, nbr, rot, feat, fp)
    assert h.shape == (S, SHARE, F) and h.dtype == torch.float32
    assert kd2.shape == (S, SHARE) and kd2.dtype == torch.float32
    h, kd2 = h.numpy(), kd2.numpy()
    ok = jkd2 < 1e17
    # at kc == K every invalid slot reaches the top-K: both kinds occur
    assert ok.any() and (kc > K or (~ok).any())
    np.testing.assert_array_equal(kd2 > 1e17, ~ok)
    np.testing.assert_allclose(kd2[ok], jkd2[ok], rtol=1e-6, atol=0)
    assert np.isfinite(h).all()
    np.testing.assert_allclose(h[ok], jh[ok], rtol=0, atol=H_ATOL)


def test_agg_single_candidate_vs_pallas():
    """kc = K = 1: one row a member at weight 1, so nothing averages a bf16
    step away (the CUDA kernel reduces such members through its shared
    tile, 64 members a tile). 2000 subgroups of 4, as ``chip_smoke.py``
    runs it on the card; members whose only candidate is invalid carry the
    sentinel row at weight 1 and are left out, as the render drops them.
    Measured 5.6e-4 max abs on ``h`` (|h| up to 0.41) against the 1e-3
    bound."""
    n_sub = 2000
    rng = np.random.default_rng(11)
    q = rng.normal(size=(n_sub, SHARE, 3)).astype(np.float32) * 0.2
    nbr = (q[:, :1] + rng.normal(size=(n_sub, 1, 3)).astype(np.float32)
           * 0.1).astype(np.float32)
    nbr[rng.uniform(size=(n_sub, 1)) < 0.15] = 2e9
    rot = rng.normal(size=(n_sub, 1, 9)).astype(np.float32)
    feat = rng.normal(size=(n_sub, 1, F)).astype(np.float32) * 0.3
    fp = inputs(1)[4]
    jh, jkd2 = jagg(jnp.asarray(q), jnp.asarray(nbr.transpose(1, 0, 2)),
                    jnp.asarray(rot.transpose(1, 0, 2)),
                    jnp.asarray(feat.transpose(1, 0, 2), jnp.bfloat16), fp,
                    share=SHARE, K=1, eps=EPS, sb=8)
    jh = np.asarray(jh).transpose(1, 0, 2)
    jkd2 = np.asarray(jkd2).T
    h, kd2 = tagg.fused_subgroup_agg(
        torch.tensor(q), torch.tensor(nbr), torch.tensor(rot),
        torch.tensor(feat).to(torch.bfloat16), port_weights(fp), 1, EPS)
    h, kd2 = h.numpy(), kd2.numpy()
    ok = jkd2 < 1e17
    assert 0.7 < ok.mean() < 0.95
    np.testing.assert_array_equal(kd2 > 1e17, ~ok)
    np.testing.assert_allclose(kd2[ok], jkd2[ok], rtol=1e-6, atol=0)
    assert np.isfinite(h).all()
    np.testing.assert_allclose(h[ok], jh[ok], rtol=0, atol=H_ATOL)


def test_agg_geometry_matches_definition():
    """``subgroup_geometry`` against a numpy loop: distances formed as
    (dx*dx + dy*dy) + dz*dz bit for bit, the K smallest selected with ties
    by candidate position (a duplicated candidate), weights normalised."""
    q, nbr, rot, _, _ = inputs(12, seed=7)
    nbr[:, 5] = nbr[:, 2]                                # exact ties
    rc, w, kd2 = tagg.subgroup_geometry(torch.tensor(q), torch.tensor(nbr),
                                        torch.tensor(rot), K, EPS)
    rc, w, kd2 = rc.numpy(), w.numpy(), kd2.numpy()
    for s in range(S):
        for m in range(SHARE):
            d = q[s, m] - nbr[s]
            sq = d * d
            tn = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
            order = sorted(range(12), key=lambda k: (tn[k], k))[:K]
            assert kd2[s, m] == tn[order].max()
            assert set(np.nonzero(w[s, m])[0]) == set(order)
            assert (5 in order) <= (2 in order)          # tie: lower index
            np.testing.assert_allclose(w[s, m].sum(), 1.0, rtol=1e-6)
            np.testing.assert_allclose(
                rc[s, m], np.einsum("kab,kb->ka", rot[s].reshape(12, 3, 3),
                                    d), rtol=1e-5, atol=1e-3 * np.abs(d).max())


def test_agg_invalid_slots_stay_finite():
    """Sentinel candidates with kc > K: their rows run through sin / cos of
    ~1e12 and the MLP and meet a weight of exactly 0 or ~1e-19, so ``h``
    stays finite everywhere, and a sample with >= K valid candidates is
    untouched by what the invalid slots hold."""
    q, nbr, rot, feat, fp = inputs(12, seed=9, invalid=0.3)
    h, kd2 = run_port(q, nbr, rot, feat, fp)
    assert torch.isfinite(h).all()
    valid = torch.tensor(nbr[..., 0] < 1e9)              # [S, kc]
    enough = valid.sum(-1) >= K
    assert 0 < int(enough.sum()) < S
    assert bool((kd2[enough] < 1e17).all())
    assert bool((kd2[~enough] > 1e17).all())
    rot2, feat2 = rot.copy(), feat.copy()
    rot2[~valid.numpy()] *= -3.0
    feat2[~valid.numpy()] += 1.0
    h2, kd2_2 = run_port(q, nbr, rot2, feat2, fp)
    assert torch.equal(kd2, kd2_2)
    assert torch.equal(h[enough], h2[enough])


def test_agg_cuda_entry_refuses_cpu_tensors():
    """On the CPU the wrapper takes the plain version; the CUDA entry
    itself never falls back."""
    q, nbr, rot, feat, fp = inputs(8)
    with pytest.raises(ValueError, match="CUDA"):
        tagg.fused_subgroup_agg_cuda(
            torch.tensor(q), torch.tensor(nbr), torch.tensor(rot),
            torch.tensor(feat).to(torch.bfloat16), port_weights(fp), K, EPS)


def test_agg_cuda_entry_refuses_what_the_chain_cannot_hold():
    """The chain's shared-memory rule is checked before anything is
    launched: a first layer too wide for it raises."""
    from apnerf_torch.kernels.featmlp import chain_plan
    g = torch.Generator().manual_seed(0)
    pe, kc = 64, 8                                     # P_pad = 400
    fin = 3 * (1 + 2 * pe) + F
    layers = [(torch.randn(F, fin, generator=g).to(torch.bfloat16),
               torch.randn(F, generator=g).to(torch.bfloat16))]
    wts = pack_weights(layers, F, pe, None)
    assert chain_plan(F, wts.P_pad, 1)["mode"] == "refused"
    q, nbr, rot, feat, _ = inputs(kc)
    with pytest.raises(ValueError, match="does not fit"):
        tagg.fused_subgroup_agg_cuda(
            torch.tensor(q), torch.tensor(nbr), torch.tensor(rot),
            torch.tensor(feat).to(torch.bfloat16), wts, K, EPS)
