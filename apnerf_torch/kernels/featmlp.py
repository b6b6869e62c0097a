"""K4: fused PE + feat_net + weighted K-reduction (``csrc/featmlp.cu``).

Port of ``apnerf/kernels/featmlp_pallas.py:featmlp_agg`` (forward):

    h[m] = sum_k w[m, k] * feat_net(poc_fre(rel[m, k]) ++ feat[m, k] (++ pose))

bf16 x bf16 GEMMs accumulated in fp32, bias in fp32, leaky-ReLU, bf16
rounding after every layer. The caller hands over ``feat_net`` already in
bf16, biases included (the model casts it); a pose embedding is folded
into the layer-1 bias in fp32, as the TPU kernel does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..ops.encoding import poc_fre, poc_freqs
from ..ops.nn import leaky_relu
from . import LAUNCHES, check, on_cpu, raise_on_error, stream_handle

ROWS = 128                   # rows per CUDA block (csrc/featmlp.cu kRows)
WIDTHS = (32, 64, 128)       # feature widths the kernel is built for


class FeatMLPWeights(NamedTuple):
    """K4's weight operands, packed once per set of weights (per frame in
    the render): layer 1 as PE rows zero-padded to ``P_pad`` then feature
    rows, the hidden layers stacked, fp32 biases."""
    w1: torch.Tensor         # [P_pad + F, F] bf16
    b1: torch.Tensor         # [F] f32, pose embedding folded in
    wl: torch.Tensor         # [L - 1, F, F] bf16
    bl: torch.Tensor         # [L - 1, F] f32
    n_pe: int
    P_pad: int


def pack_weights(layers: List[Tuple[torch.Tensor, torch.Tensor]], F: int,
                 n_pe: int,
                 pose_embedding: Optional[torch.Tensor]) -> FeatMLPWeights:
    """Kernel operands from ``[(weight [dout, din] bf16, bias bf16), ...]``:
    the PE rows of layer 1 padded with zero rows to a multiple of 16, then
    its feature rows; the pose embedding's layer-1 contribution added to
    b1."""
    P = 3 * (1 + 2 * n_pe)
    P_pad = -(-P // 16) * 16
    W1 = layers[0][0].t()                              # [din, F]
    if W1.shape[1] != F or W1.shape[0] < P + F:
        raise ValueError(f"featmlp: layer 1 is {tuple(W1.shape)}, expected "
                         f"[{P} + {F} (+ pose), {F}]")
    dev = W1.device
    w1 = torch.zeros((P_pad + F, F), dtype=torch.bfloat16, device=dev)
    w1[:P] = W1[:P].to(torch.bfloat16)
    w1[P_pad:] = W1[P:P + F].to(torch.bfloat16)
    b1 = layers[0][1].float()
    if pose_embedding is not None:
        Wp = W1[P + F:].float()
        b1 = b1 + pose_embedding.reshape(1, -1).float() @ Wp
        b1 = b1.reshape(F)
    elif W1.shape[0] != P + F:
        raise ValueError("featmlp: layer 1 takes a pose embedding; none given")
    for wt, _ in layers[1:]:
        if tuple(wt.shape) != (F, F):
            raise ValueError(f"featmlp: hidden layer {tuple(wt.shape)}, "
                             f"expected ({F}, {F})")
    if len(layers) > 1:
        wl = torch.stack([wt.t().to(torch.bfloat16) for wt, _ in layers[1:]])
        bl = torch.stack([b.float() for _, b in layers[1:]])
    else:
        wl = torch.zeros((0, F, F), dtype=torch.bfloat16, device=dev)
        bl = torch.zeros((0, F), dtype=torch.float32, device=dev)
    return FeatMLPWeights(w1.contiguous(), b1.contiguous(), wl.contiguous(),
                          bl.contiguous(), n_pe, P_pad)


def featmlp_plain(rel, feat, w, wts: FeatMLPWeights, round_last=True):
    """Plain PyTorch K4 on packed operands: exact products of bf16 values
    accumulated in fp32, fp32 bias, leaky-ReLU, bf16 round per layer
    (``round_last=False``: the last layer stays fp32, as kernel K6 keeps
    it)."""
    w1, b1, wl, bl, n_pe, P_pad = wts
    M, K, _ = rel.shape
    F = feat.shape[-1]
    e = poc_fre(rel.reshape(M * K, 3).float(), poc_freqs(n_pe, rel.device))
    e = torch.nn.functional.pad(e, (0, P_pad - e.shape[1]))
    a = torch.cat([e.to(torch.bfloat16), feat.reshape(M * K, F)], dim=-1)
    n_hidden = wl.shape[0]
    h = leaky_relu(a.float() @ w1.float() + b1)
    for i in range(n_hidden):
        h = leaky_relu(h.to(torch.bfloat16).float() @ wl[i].float() + bl[i])
    if round_last:
        h = h.to(torch.bfloat16).float()
    hw = h.reshape(M, K, F) * w.reshape(M, K, 1).float()
    return hw.sum(1)


def featmlp_cuda(rel, feat, w, wts: FeatMLPWeights):
    """Launch K4 on the inputs' CUDA device."""
    w1, b1, wl, bl, n_pe, P_pad = wts
    M, K, _ = rel.shape
    F = feat.shape[-1]
    L = wl.shape[0] + 1
    if F not in WIDTHS or ROWS % K != 0 or P_pad % 16 != 0:
        raise ValueError(f"featmlp: unsupported F={F}, K={K}, P_pad={P_pad}")
    check(rel, "rel", torch.float32, (M, K, 3))
    check(feat, "feat", torch.bfloat16, (M, K, F))
    check(w, "w", torch.float32, (M, K))
    check(w1, "w1", torch.bfloat16, (P_pad + F, F))
    check(b1, "b1", torch.float32, (F,))
    check(wl, "wl", torch.bfloat16, (L - 1, F, F))
    check(bl, "bl", torch.float32, (L - 1, F))
    from .build import load_library
    lib = load_library()
    out = torch.empty((M, F), dtype=torch.float32, device=rel.device)
    LAUNCHES["featmlp"] += 1
    raise_on_error(lib.featmlp_launch(
        rel.data_ptr(), feat.data_ptr(), w.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), wl.data_ptr(), bl.data_ptr(), M, K, F, n_pe, P_pad, L,
        out.data_ptr(), stream_handle(rel)), "featmlp")
    return out


def featmlp_agg(rel: torch.Tensor, feat: torch.Tensor, w: torch.Tensor,
                wts: FeatMLPWeights) -> torch.Tensor:
    """rel [M, K, 3] f32, feat [M, K, F] bf16, w [M, K] f32, ``wts`` the
    ``pack_weights`` of feat_net's bf16 layers -> h [M, F] f32.

    The kernel on CUDA tensors, the plain version on CPU tensors."""
    args = (rel.float().contiguous(), feat.to(torch.bfloat16).contiguous(),
            w.float().contiguous(), wts)
    if on_cpu(rel, feat, w, wts.w1):
        return featmlp_plain(*args)
    return featmlp_cuda(*args)
