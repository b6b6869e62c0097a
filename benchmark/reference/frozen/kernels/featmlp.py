"""K4: fused PE + feat_net + weighted K-reduction (``csrc/featmlp.cu``).

Port of ``apnerf/kernels/featmlp_pallas.py:featmlp_agg`` (forward):

    h[m] = sum_k w[m, k] * feat_net(poc_fre(rel[m, k]) ++ feat[m, k] (++ pose))

bf16 x bf16 GEMMs accumulated in fp32, bias in fp32, leaky-ReLU, bf16
rounding after every layer. The caller hands over ``feat_net`` already in
bf16, biases included (the model casts it); a pose embedding is folded
into the layer-1 bias in fp32, as the TPU kernel does.

The kernel is a persistent ``wgmma`` chain (``csrc/featmlp_chain.cuh``,
shared with K6) that keeps every layer's weights in shared memory for the
life of a block. ``pack_weights`` lays them out once, host-side, as the
exact shared-memory image (``weight_image``); ``chain_plan`` is the rule
for which layers stay resident, which are streamed, and which shapes are
refused.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..ops.encoding import poc_fre, poc_freqs
from ..ops.nn import leaky_relu
from . import LAUNCHES, check, on_cpu, raise_on_error, stream_handle

ROWS = 128                   # most rows reduced into one output row
WIDTHS = (32, 64, 128)       # feature widths the kernel is built for
# csrc/featmlp_chain.cuh: warpgroups a block, rows a warpgroup's tile, K
# values and bytes of one swizzled row, the dynamic shared memory a block
# may have on sm_90
GROUPS = 3
TILE_ROWS = 64
CHUNK = 64
CHUNK_BYTES = 128
SMEM_LIMIT = 232448
# a warpgroup's scratch, per row slot of a member: two RowData (x 3 f32,
# wrow f32) and a Scratch (tn f32, cand 12 f32, wraw f32, top u8)
SCRATCH_BYTES = ROWS * (2 * (3 + 1) * 4 + (4 + 12 * 4 + 4 + 1))


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
    image: torch.Tensor      # uint8: ``weight_image`` of w1 and wl


def swizzled_chunks(w: torch.Tensor) -> torch.Tensor:
    """w [kd, F] bf16 (rows k, columns n) -> the bytes of ceil(kd / 64)
    chunks, each [F rows (n)] x [64 k] bf16 with K contiguous in 128-byte
    rows and the 128-byte swizzle (the 16-byte unit j of row n lies at unit
    ``j ^ (n % 8)``): what ``wgmma`` reads as a K-major B operand. K is
    zero-padded to whole chunks."""
    kd, F = w.shape
    chunks = -(-kd // CHUNK)
    wp = torch.zeros((chunks * CHUNK, F), dtype=w.dtype, device=w.device)
    wp[:kd] = w
    t = wp.reshape(chunks, CHUNK, F).permute(0, 2, 1)      # [c, n, k]
    t = t.reshape(chunks, F, 8, 8)                         # k -> (unit, e)
    n = torch.arange(F, device=w.device)
    unit = torch.arange(8, device=w.device)
    src = unit[None, :] ^ (n[:, None] % 8)                 # [F, 8]
    out = t.gather(2, src[None, :, :, None].expand(chunks, F, 8, 8))
    return out.contiguous().reshape(-1).view(torch.uint8)


def feat_k_order(F: int, device=None) -> torch.Tensor:
    """The feature column that sits at each K position of layer 1's
    feature half (``csrc/featmlp_chain.cuh:load_feat``): a lane loads 16
    bytes (8 columns) of a row at once and they fill the A fragments of two
    k16 steps, so position ``32 i + 16 u + 8 v + 2 q + e`` holds column
    ``8 (q + 4 i) + 4 u + 2 v + e``."""
    p = torch.arange(F, device=device)
    i, u, v, q, e = p // 32, (p // 16) % 2, (p // 8) % 2, (p // 2) % 4, p % 2
    return 8 * (q + 4 * i) + 4 * u + 2 * v + e


def weight_image(w1: torch.Tensor, wl: torch.Tensor, P_pad: int
                 ) -> torch.Tensor:
    """The chain's shared-memory image of all layers: layer 1 as its
    feature rows in ``feat_k_order`` then its PE rows (each
    ``swizzled_chunks``), then every hidden layer."""
    F = w1.shape[1]
    feat_rows = w1[P_pad:][feat_k_order(F, w1.device)]
    parts = [swizzled_chunks(feat_rows), swizzled_chunks(w1[:P_pad])]
    parts += [swizzled_chunks(w) for w in wl]
    return torch.cat(parts).contiguous()


def chain_plan(F: int, P_pad: int, n_layers: int) -> dict:
    """Which layers of the chain stay in shared memory (the rule of
    ``csrc/featmlp_chain.cuh:plan_chain``): ``mode`` "resident" (all),
    "streamed" (layers ``resident`` .. through one extra slot, the block in
    lock step) or "refused" (not even layer 1 and a slot fit), with
    ``resident`` and ``smem_bytes``."""
    chunks_f, chunks_p = -(-F // CHUNK), -(-P_pad // CHUNK)
    w1 = (chunks_f + chunks_p) * F * CHUNK_BYTES
    wh = chunks_f * F * CHUNK_BYTES
    fixed = GROUPS * (chunks_p * TILE_ROWS * CHUNK_BYTES + SCRATCH_BYTES)
    for r in range(n_layers, 0, -1):
        total = w1 + (r - 1) * wh + (wh if r < n_layers else 0) + fixed
        if total <= SMEM_LIMIT:
            return dict(mode="resident" if r == n_layers else "streamed",
                        resident=r, smem_bytes=total)
    return dict(mode="refused", resident=0, smem_bytes=0)


def pack_weights(layers: List[Tuple[torch.Tensor, torch.Tensor]], F: int,
                 n_pe: int,
                 pose_embedding: Optional[torch.Tensor]) -> FeatMLPWeights:
    """Kernel operands from ``[(weight [dout, din] bf16, bias bf16), ...]``:
    the PE rows of layer 1 padded with zero rows to a multiple of 16, then
    its feature rows; the pose embedding's layer-1 contribution added to
    b1; and the kernels' shared-memory image of the same weights."""
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
    w1, wl = w1.contiguous(), wl.contiguous()
    return FeatMLPWeights(w1, b1.contiguous(), wl, bl.contiguous(), n_pe,
                          P_pad, weight_image(w1, wl, P_pad))


def featmlp_plain(rel, feat, w, wts: FeatMLPWeights, round_last=True):
    """Plain PyTorch K4 on packed operands: exact products of bf16 values
    accumulated in fp32, fp32 bias, leaky-ReLU, bf16 round per layer
    (``round_last=False``: the last layer stays fp32, as kernel K6 keeps
    it)."""
    w1, b1, wl, bl, n_pe, P_pad = wts[:6]
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


def check_chain(wts: FeatMLPWeights, F: int, what: str) -> None:
    """Raise unless the chain takes these weights: the image is the one of
    ``w1`` / ``wl`` in size, on the card, and ``chain_plan`` does not refuse
    the shape."""
    L = wts.wl.shape[0] + 1
    plan = chain_plan(F, wts.P_pad, L)
    if plan["mode"] == "refused":
        raise ValueError(f"{what}: F={F}, P_pad={wts.P_pad} does not fit "
                         "the chain's shared memory")
    chunks_f, chunks_p = -(-F // CHUNK), -(-wts.P_pad // CHUNK)
    n_bytes = ((chunks_f + chunks_p) + (L - 1) * chunks_f) * F * CHUNK_BYTES
    check(wts.image, "image", torch.uint8, (n_bytes,))


def featmlp_cuda(rel, feat, w, wts: FeatMLPWeights):
    """Launch K4 on the inputs' CUDA device."""
    w1, b1, wl, bl, n_pe, P_pad, image = wts
    M, K, _ = rel.shape
    F = feat.shape[-1]
    L = wl.shape[0] + 1
    if F not in WIDTHS or ROWS % K != 0 or P_pad % 16 != 0:
        raise ValueError(f"featmlp: unsupported F={F}, K={K}, P_pad={P_pad}")
    check_chain(wts, F, "featmlp")
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
        rel.data_ptr(), feat.data_ptr(), w.data_ptr(), image.data_ptr(),
        b1.data_ptr(), bl.data_ptr(), M, K, F, n_pe, P_pad, L,
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
