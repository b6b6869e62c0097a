"""The max gate ``chip_smoke.py`` holds kernel K4 (``featmlp_agg``) to, on
the CPU: each element of h may differ from the plain version's by one bf16
step of each neighbour's last-layer output times the neighbour's weight
(a bf16 round that falls the other way), and what is left over is held to
``K4_REL_MAX_ERR`` of max |h|.

A stand-in for the kernel whose every last-layer round falls the other way
must leave nothing over (tolerance 1e-6 of max |h|, the fp32 sum order),
although its raw max error exceeds ``K4_REL_MAX_ERR``; a row of h set to 0
must stay far over the gate.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from apnerf_torch.kernels import featmlp as fm  # noqa: E402


def test_bf16_step_is_the_spacing_of_bf16():
    x = torch.tensor([0.0, 1.0, 1.5, 2.0, 3.39, -3.39, 4.1, 1e-3, 77.5])
    step = cs.bf16_step(torch, x)
    assert step[0] == 0
    v = x[1:].abs().to(torch.bfloat16)
    nxt = (v.view(torch.int16) + 1).view(torch.bfloat16)
    assert torch.equal(step[1:], nxt.float() - v.float())


@pytest.fixture(scope="module")
def k4_case():
    g = torch.Generator().manual_seed(0)
    M, K, F, n_pe = 400, 8, 32, 4
    rel = 0.05 * torch.randn(M, K, 3, generator=g)
    feat = (0.1 * torch.randn(M, K, F, generator=g)).to(torch.bfloat16)
    w = torch.rand(M, K, generator=g)
    w = w / w.sum(-1, keepdim=True)
    dims = [3 * (1 + 2 * n_pe) + F] + [F] * 3
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = 8.0 / np.sqrt(din)  # outputs of order 1-100
        layers.append((((torch.rand(dout, din, generator=g) * 2 - 1)
                        * bound).to(torch.bfloat16),
                       ((torch.rand(dout, generator=g) * 2 - 1)
                        * bound).to(torch.bfloat16)))
    wts = fm.pack_weights(layers, F, n_pe, None)
    return rel, feat, w, wts


def test_flipped_last_rounds_pass_and_a_wrong_row_fails(k4_case):
    rel, feat, w, wts = k4_case
    M, K, _ = rel.shape
    F = feat.shape[-1]
    ph = fm.featmlp_plain(rel, feat, w, wts)
    top = float(ph.abs().max())
    f = cs.last_layer_rows(rel, feat, wts)
    unrounded = fm.featmlp_plain(
        rel.reshape(M * K, 1, 3), feat.reshape(M * K, 1, F),
        torch.ones(M * K, 1), wts, round_last=False).reshape(M, K, F)
    step = cs.bf16_step(torch, f)
    flipped = torch.where(unrounded > f, f + step, f - step)
    h = (flipped * w[..., None]).sum(1)
    d = (h - ph).abs()
    assert float(d.max()) / top > cs.K4_REL_MAX_ERR
    assert cs.beyond_last_round(torch, d, f, w) / top < 1e-6
    wrong = ph.clone()
    wrong[7] = 0
    d = (wrong - ph).abs()
    assert cs.beyond_last_round(torch, d, f, w) / top > 0.1
