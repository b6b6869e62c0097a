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

``featmlp_gather`` is K4's gathering front on the same chain: the exact
render path's whole aggregation (the gathers from the frame's point tables,
the offsets, the weights, the rotation and ``feat_net``) in
``featnet_plain``'s rounding, which rounds each layer's product to bf16
before its bf16 bias add, and a pose embedding's layer-1 term with the
product. ``gather_kernel_ok`` says where the model takes it.
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


def _layer_operands(layers: List[Tuple[torch.Tensor, torch.Tensor]],
                    F: int, n_pe: int, pose: bool):
    """``pack_weights``' shared part: (P, P_pad, W1 [din, F] as given, w1,
    wl), w1 the PE rows of layer 1 zero-padded to ``P_pad`` then its
    feature rows, wl the hidden layers stacked, both bf16."""
    P = 3 * (1 + 2 * n_pe)
    P_pad = -(-P // 16) * 16
    W1 = layers[0][0].t()                              # [din, F]
    if W1.shape[1] != F or W1.shape[0] < P + F:
        raise ValueError(f"featmlp: layer 1 is {tuple(W1.shape)}, expected "
                         f"[{P} + {F} (+ pose), {F}]")
    if not pose and W1.shape[0] != P + F:
        raise ValueError("featmlp: layer 1 takes a pose embedding; none given")
    dev = W1.device
    w1 = torch.zeros((P_pad + F, F), dtype=torch.bfloat16, device=dev)
    w1[:P] = W1[:P].to(torch.bfloat16)
    w1[P_pad:] = W1[P:P + F].to(torch.bfloat16)
    for wt, _ in layers[1:]:
        if tuple(wt.shape) != (F, F):
            raise ValueError(f"featmlp: hidden layer {tuple(wt.shape)}, "
                             f"expected ({F}, {F})")
    if len(layers) > 1:
        wl = torch.stack([wt.t().to(torch.bfloat16) for wt, _ in layers[1:]])
    else:
        wl = torch.zeros((0, F, F), dtype=torch.bfloat16, device=dev)
    return P, P_pad, W1, w1.contiguous(), wl.contiguous()


def _hidden_biases(layers, F: int, dtype: torch.dtype) -> torch.Tensor:
    """The hidden layers' biases [L - 1, F] as ``dtype`` values, in fp32."""
    if len(layers) == 1:
        return torch.zeros((0, F), dtype=torch.float32,
                           device=layers[0][1].device)
    return torch.stack([b.to(dtype).float() for _, b in layers[1:]]
                       ).contiguous()


def pack_weights(layers: List[Tuple[torch.Tensor, torch.Tensor]], F: int,
                 n_pe: int,
                 pose_embedding: Optional[torch.Tensor]) -> FeatMLPWeights:
    """Kernel operands from ``[(weight [dout, din] bf16, bias bf16), ...]``:
    the PE rows of layer 1 padded with zero rows to a multiple of 16, then
    its feature rows; the pose embedding's layer-1 contribution added to
    b1; and the kernels' shared-memory image of the same weights."""
    P, P_pad, W1, w1, wl = _layer_operands(layers, F, n_pe,
                                           pose_embedding is not None)
    b1 = layers[0][1].float()
    if pose_embedding is not None:
        Wp = W1[P + F:].float()
        b1 = b1 + pose_embedding.reshape(1, -1).float() @ Wp
        b1 = b1.reshape(F)
    return FeatMLPWeights(w1, b1.contiguous(), wl,
                          _hidden_biases(layers, F, torch.float32), n_pe,
                          P_pad, weight_image(w1, wl, P_pad))


class PlainWeights(NamedTuple):
    """The gathering front's weight operands: K4's ``w1`` / ``wl`` and
    image, the biases as their bf16 values (in fp32), and ``pose``, the
    pose embedding's layer-1 term [F] in fp32 (None without one), which
    the kernel adds to the layer-1 product before its round."""
    w1: torch.Tensor         # [P_pad + F, F] bf16
    b1: torch.Tensor         # [F] f32 (bf16 values)
    wl: torch.Tensor         # [L - 1, F, F] bf16
    bl: torch.Tensor         # [L - 1, F] f32 (bf16 values)
    pose: Optional[torch.Tensor]
    n_pe: int
    P_pad: int
    image: torch.Tensor      # uint8: ``weight_image`` of w1 and wl


def pack_plain_weights(layers: List[Tuple[torch.Tensor, torch.Tensor]],
                       F: int, n_pe: int,
                       pose_embedding: Optional[torch.Tensor]
                       ) -> PlainWeights:
    """``pack_weights`` for ``featnet_plain``'s rounding: the biases rounded
    to bf16, and the pose embedding's layer-1 term sum_j bf16(pose_j)
    bf16(W1[P + F + j]), the exact products summed in fp32."""
    P, P_pad, W1, w1, wl = _layer_operands(layers, F, n_pe,
                                           pose_embedding is not None)
    pose = None
    if pose_embedding is not None:
        e = pose_embedding.reshape(-1).to(torch.bfloat16).float()
        Wp = W1[P + F:].to(torch.bfloat16).float()
        pose = (e[:, None] * Wp).sum(0).contiguous()
    return PlainWeights(w1, layers[0][1].to(torch.bfloat16).float(), wl,
                        _hidden_biases(layers, F, torch.bfloat16), pose,
                        n_pe, P_pad, weight_image(w1, wl, P_pad))


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


def _plain_act(acc: torch.Tensor, b: torch.Tensor,
               addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer's epilogue in ``featnet_plain``'s rounding (the chain's
    ``plain_act``): the fp32 product (plus ``addend``) rounded to bf16, the
    bias (bf16 values) added and rounded, leaky-ReLU, rounded -> bf16."""
    if addend is not None:
        acc = acc + addend
    y = (acc.to(torch.bfloat16).float() + b).to(torch.bfloat16).float()
    return leaky_relu(y).to(torch.bfloat16)


def plain_chain(rel, feat, w, wts: PlainWeights) -> torch.Tensor:
    """The gathering front's chain on packed operands in plain PyTorch:
    exact products of bf16 values summed in fp32, every layer in
    ``featnet_plain``'s rounding (``_plain_act``, the pose term in layer
    1's), the weighted K-sum in fp32. rel [M, K, 3], feat [M, K, F], w
    [M, K] -> h [M, F] f32."""
    w1, b1, wl, bl, pose, n_pe, P_pad = wts[:7]
    M, K, _ = rel.shape
    F = feat.shape[-1]
    e = poc_fre(rel.reshape(M * K, 3).float(), poc_freqs(n_pe, rel.device))
    e = torch.nn.functional.pad(e, (0, P_pad - e.shape[1]))
    a = torch.cat([e.to(torch.bfloat16),
                   feat.reshape(M * K, F).to(torch.bfloat16)], dim=-1)
    x = _plain_act(a.float() @ w1.float(), b1, pose)
    for i in range(wl.shape[0]):
        x = _plain_act(x.float() @ wl[i].float(), bl[i])
    return (x.float().reshape(M, K, F) * w.reshape(M, K, 1).float()).sum(1)


class GatherTables(NamedTuple):
    """What the gathering front reads of a frame, built once a frame: the
    point tables in the k-NN's row order (position and inverse rotation
    [Pp, 12] f32; features [Pp, F] cast to bf16 once, the values a cast
    after the gather gives) and ``pack_plain_weights`` of feat_net."""
    geo: torch.Tensor
    feat: torch.Tensor
    wts: PlainWeights


def gather_kernel_ok(device, cfg, render_pcd_direct: bool = False) -> bool:
    """Does the exact path's aggregation take ``featmlp_gather``'s kernel?
    On a CUDA device with gradients disabled, for the formulation it
    computes (``featmlp_kernel`` off: K4's own front keeps that; bf16
    aggregation; at least two layers), the widths it is built for (F in
    ``WIDTHS``, ``neighbours`` dividing a warp) and not for
    ``render_pcd_direct``, whose extras read the gathered rows. Elsewhere
    (the CPU, training) the model gathers and runs ``featnet_plain``."""
    return (torch.device(device).type == "cuda"
            and not torch.is_grad_enabled() and not cfg.featmlp_kernel
            and cfg.agg_bf16 and cfg.feat_depth >= 2
            and cfg.feat_dim in WIDTHS and 32 % cfg.neighbours == 0
            and not render_pcd_direct)


def gather_rows_plain(q, idx, geo, eps: float):
    """The gathering front's geometry in plain PyTorch, in the kernel's
    rounding order, which is that of the plain path's sums on the card:
    the offsets d = q - pos[idx], d2 = (d.x d.x + d.z d.z) + d.y d.y, w =
    1 / (d2 + eps) over its pairwise sum ((w0 + w1) + (w2 + w3)) + ...,
    rel = rot[idx] d row by row as (r0 d.x + r1 d.y) + r2 d.z. -> (rel [n,
    K, 3], w [n, K], kth [n])."""
    n, K = idx.shape
    g = geo.index_select(0, idx.reshape(-1).long()).reshape(n, K, 12)
    d = q[:, None, :] - g[..., :3]
    d2 = (d[..., 0] * d[..., 0] + d[..., 2] * d[..., 2]) + d[..., 1] * d[..., 1]
    wr = 1.0 / (d2 + eps)
    s = wr
    while s.shape[1] > 1:
        s = s[:, 0::2] + s[:, 1::2]
    s = s[:, 0]
    R = g[..., 3:].reshape(n, K, 3, 3)
    rel = (R[..., 0] * d[..., 0:1] + R[..., 1] * d[..., 1:2]) \
        + R[..., 2] * d[..., 2:3]
    return rel, wr / s[:, None], d2.amax(-1)


def featmlp_gather_plain(q, idx, tabs: GatherTables, eps: float,
                         live=None, want_w=False):
    """Plain PyTorch of the gathering front (``featmlp_gather``)."""
    geo, feat, wts = tabs
    n, K = idx.shape
    rel, w, kth = gather_rows_plain(q, idx, geo, eps)
    fk = feat.index_select(0, idx.reshape(-1).long()).reshape(n, K, -1)
    h = plain_chain(rel, fk, w, wts)
    if live is not None:
        keep = torch.arange(n, device=q.device) < live.sum()
        h = torch.where(keep[:, None], h, torch.zeros_like(h))
        kth = torch.where(keep, kth, torch.full_like(kth, float("inf")))
        w = torch.where(keep[:, None], w, torch.zeros_like(w))
    return h, kth, w if want_w else None


def featmlp_gather_cuda(q, idx, tabs: GatherTables, eps: float, live=None,
                        want_w=False):
    """Launch K4's gathering front on the inputs' CUDA device."""
    geo, feat, wts = tabs
    w1, b1, wl, bl, pose, n_pe, P_pad, image = wts
    n, K = idx.shape
    Pp, F = feat.shape
    L = wl.shape[0] + 1
    if F not in WIDTHS or 32 % K != 0 or P_pad % 16 != 0:
        raise ValueError(f"featmlp_gather: unsupported F={F}, K={K}, "
                         f"P_pad={P_pad}")
    check_chain(wts, F, "featmlp_gather")
    check(q, "q", torch.float32, (n, 3))
    check(idx, "idx", torch.int32, (n, K))
    check(geo, "geo", torch.float32, (Pp, 12))
    check(feat, "feat", torch.bfloat16, (Pp, F))
    check(b1, "b1", torch.float32, (F,))
    check(bl, "bl", torch.float32, (L - 1, F))
    if pose is not None:
        check(pose, "pose", torch.float32, (F,))
    if geo.data_ptr() % 16 or feat.data_ptr() % 16:
        raise ValueError("featmlp_gather: the tables must be 16-byte aligned")
    count = None
    if live is not None:
        check(live, "live", torch.bool, (n,))
        count = live.sum(dtype=torch.int32).reshape(1)
    from .build import load_library
    lib = load_library()
    dev = q.device
    h = torch.empty((n, F), dtype=torch.float32, device=dev)
    kth = torch.empty((n,), dtype=torch.float32, device=dev)
    w = torch.empty((n, K), dtype=torch.float32, device=dev) if want_w \
        else None
    LAUNCHES["featmlp_gather"] += 1
    raise_on_error(lib.featmlp_gather_launch(
        q.data_ptr(), idx.data_ptr(), geo.data_ptr(), feat.data_ptr(),
        image.data_ptr(), b1.data_ptr(), bl.data_ptr(), _ptr(pose),
        _ptr(count), n, K, float(eps), F, n_pe, P_pad, L, h.data_ptr(),
        kth.data_ptr(), _ptr(w), stream_handle(q)), "featmlp_gather")
    return h, kth, w


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's address, or NULL for None."""
    return None if t is None else t.data_ptr()


def featmlp_gather(q: torch.Tensor, idx: torch.Tensor, tabs: GatherTables,
                   eps: float, live: Optional[torch.Tensor] = None,
                   want_w: bool = False):
    """The exact path's aggregation of the slots ``q`` [n, 3] over their K
    neighbours ``idx`` [n, K] (rows of the tables, int32) -> (h [n, F] f32,
    kth [n] f32, the largest squared distance, and w [n, K] f32, the
    normalised weights, when ``want_w``, else None). ``live`` [n] bool: the
    slots that passed the budget, all of them first; the others get h 0,
    kth +inf, w 0.

    The kernel on CUDA tensors, the plain version on CPU tensors."""
    args = (q.float().contiguous(), idx.contiguous(), tabs, eps, live,
            want_w)
    if on_cpu(q, idx, tabs.geo, tabs.feat):
        return featmlp_gather_plain(*args)
    return featmlp_gather_cuda(*args)


def check_chain(wts, F: int, what: str) -> None:
    """Raise unless the chain takes these weights (``FeatMLPWeights`` or
    ``PlainWeights``): the image is the one of ``w1`` / ``wl`` in size, on
    the card, and ``chain_plan`` does not refuse the shape."""
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
