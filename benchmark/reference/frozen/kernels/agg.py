"""K6: fused subgroup-shared neighbour aggregation (``csrc/agg.cu``).

Port of ``apnerf/kernels/agg_pallas.py:fused_subgroup_agg`` (forward only;
the render uses it, training never does). Per subgroup of ``share`` member
samples and ``kc`` shared candidate points: member-candidate squared
distances, the exact top-K-of-kc rank mask (ties by candidate position),
inverse-distance weights, the canonical-frame rotation of the offsets, the
positional encoding, ``feat_net`` (bf16 in, fp32 accumulate, the last layer
not rounded) on all ``kc`` candidates and the weighted candidate reduction.
Only the aggregated features and the kth distances leave the kernel.

Layouts are the card's, not the TPU kernel's: every operand is
subgroup-major, ``packed[idx]`` as the caller gathers it, and the outputs
are ``[S, share, .]`` so the heads run on them with nothing to transpose
(the TPU kernel takes candidate-major tables and writes member-major).
Invalid candidate slots must arrive at a far sentinel position (2e9): they
rank last, their weight is 0 or ~1e-19, and a sample whose top-K reaches
one gets ``kd2`` far beyond any radius. The weights are K4's
``FeatMLPWeights`` (``featmlp.pack_weights``) without a pose embedding.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import LAUNCHES, check, on_cpu, raise_on_error, stream_handle
from .featmlp import (ROWS, WIDTHS, FeatMLPWeights, check_chain,
                      featmlp_plain)

KD2_FLOOR = -3.4e38     # kd2 of a member none of whose candidates is top


def subgroup_geometry(q_sub: torch.Tensor, nbr: torch.Tensor,
                      rot: torch.Tensor, K: int, eps: float):
    """The part of K6 before ``feat_net``, in plain PyTorch: q_sub
    [S, share, 3], nbr [S, kc, 3], rot [S, kc, 9] -> (rc [S, share, kc, 3]
    canonical-frame offsets, w [S, share, kc] normalised top-K weights, kd2
    [S, share]). Distances as the kernels form them, ``(dx*dx + dy*dy) +
    dz*dz`` with every op rounded, so ``kd2`` and the selected set are
    bit-equal to the kernel's."""
    kc = nbr.shape[1]
    d = q_sub[:, :, None, :] - nbr[:, None, :, :]        # [S, share, kc, 3]
    dx, dy, dz = d.unbind(-1)
    to_nn = (dx * dx + dy * dy) + dz * dz
    ar = torch.arange(kc, device=q_sub.device)
    less = (to_nn[..., :, None] > to_nn[..., None, :]) | (
        (to_nn[..., :, None] == to_nn[..., None, :])
        & (ar[:, None] > ar[None, :]))
    top = less.sum(-1) < K
    kd2 = torch.where(top, to_nn, torch.full_like(to_nn, KD2_FLOOR)).amax(-1)
    w = torch.where(top, 1.0 / (to_nn + eps), torch.zeros_like(to_nn))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
    R = rot[:, None]                                     # [S, 1, kc, 9]
    rc = torch.stack([
        R[..., 0] * dx + R[..., 1] * dy + R[..., 2] * dz,
        R[..., 3] * dx + R[..., 4] * dy + R[..., 5] * dz,
        R[..., 6] * dx + R[..., 7] * dy + R[..., 8] * dz], -1)
    return rc, w, kd2


def fused_subgroup_agg_plain(q_sub, nbr, rot, feat, wts: FeatMLPWeights,
                             K: int, eps: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K6: ``subgroup_geometry``, then K4's plain chain on
    every (member, candidate) row with the last layer kept in fp32."""
    S, share, _ = q_sub.shape
    kc, F = feat.shape[1], feat.shape[2]
    rc, w, kd2 = subgroup_geometry(q_sub, nbr, rot, K, eps)
    feat_m = feat[:, None].expand(S, share, kc, F)
    h = featmlp_plain(rc.reshape(S * share, kc, 3),
                      feat_m.reshape(S * share, kc, F),
                      w.reshape(S * share, kc), wts, round_last=False)
    return h.reshape(S, share, F), kd2


def fused_subgroup_agg_cuda(q_sub, nbr, rot, feat, wts: FeatMLPWeights,
                            K: int, eps: float):
    """Launch K6 on the inputs' CUDA device."""
    w1, b1, wl, bl, n_pe, P_pad, image = wts
    S, share, _ = q_sub.shape
    kc, F = feat.shape[1], feat.shape[2]
    L = wl.shape[0] + 1
    if (F not in WIDTHS or not 1 <= K <= kc <= ROWS or P_pad % 16 != 0
            or S * share >= 2 ** 31 // max(F, kc)):
        raise ValueError(f"fused_subgroup_agg: unsupported F={F}, K={K}, "
                         f"kc={kc}, P_pad={P_pad}, S={S}, share={share}")
    check_chain(wts, F, "fused_subgroup_agg")
    check(q_sub, "q_sub", torch.float32, (S, share, 3))
    check(nbr, "nbr", torch.float32, (S, kc, 3))
    check(rot, "rot", torch.float32, (S, kc, 9))
    check(feat, "feat", torch.bfloat16, (S, kc, F))
    check(w1, "w1", torch.bfloat16, (P_pad + F, F))
    check(b1, "b1", torch.float32, (F,))
    check(wl, "wl", torch.bfloat16, (L - 1, F, F))
    check(bl, "bl", torch.float32, (L - 1, F))
    from .build import load_library
    lib = load_library()
    h = torch.empty((S, share, F), dtype=torch.float32, device=q_sub.device)
    kd2 = torch.empty((S, share), dtype=torch.float32, device=q_sub.device)
    LAUNCHES["agg"] += 1
    raise_on_error(lib.agg_launch(
        q_sub.data_ptr(), nbr.data_ptr(), rot.data_ptr(), feat.data_ptr(),
        image.data_ptr(), b1.data_ptr(), bl.data_ptr(), S, share, kc, K,
        float(eps), F, n_pe, P_pad, L, h.data_ptr(), kd2.data_ptr(),
        stream_handle(q_sub)), "fused_subgroup_agg")
    return h, kd2


def fused_subgroup_agg(q_sub: torch.Tensor, nbr: torch.Tensor,
                       rot: torch.Tensor, feat: torch.Tensor,
                       wts: FeatMLPWeights, K: int, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q_sub [S, share, 3] f32 member positions, nbr [S, kc, 3] f32
    candidate positions (invalid slots at 2e9), rot [S, kc, 9] f32
    row-major canonical-frame rotations, feat [S, kc, F] bf16 candidate
    features, ``wts`` the ``pack_weights`` of feat_net's bf16 layers ->
    (h [S, share, F] f32, kd2 [S, share] f32).

    The kernel on CUDA tensors, the plain version on CPU tensors."""
    args = (q_sub.float().contiguous(), nbr.float().contiguous(),
            rot.float().contiguous(), feat.to(torch.bfloat16).contiguous(),
            wts, int(K), float(eps))
    if on_cpu(q_sub, nbr, rot, feat, wts.w1):
        return fused_subgroup_agg_plain(*args)
    return fused_subgroup_agg_cuda(*args)
