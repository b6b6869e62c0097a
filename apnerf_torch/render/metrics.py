"""Evaluation metrics: PSNR, SSIM, LPIPS (port of
``apnerf/render/metrics.py``).

PSNR from the MSE; SSIM with an 11-tap Gaussian window (the mip-NeRF
formulation), in float64 with torch on the CPU or, given one, the card;
LPIPS through the ``lpips`` package when it is installed, else
``render.lpips`` (official weights from ``APNERF_LPIPS_WEIGHTS`` or the
seeded-random fallback, whose honest name ``lpips_metric_name`` gives).
"""
from __future__ import annotations

import os
from contextlib import nullcontext

import numpy as np
import torch

from .. import resolve_device


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log10(mse))


def psnr(img, ref) -> float:
    return mse2psnr(float(np.mean(np.square(np.asarray(img) - np.asarray(ref)))))


_SSIM_STREAMS = {}


def rgb_ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5,
             k1=0.01, k2=0.03, return_map=False, device=None):
    """SSIM with separable Gaussian filtering (valid region only), in
    float64 with torch on ``device`` (None: the CPU), the window's sums
    taken tap by tap in order. The images come from the host. On a CUDA
    device it runs on a stream of its own, so that reading the score back
    waits for none of the work queued on the caller's stream
    (``render_viewpoints`` scores view i while view i + 1 renders); one
    stream a device, kept, so that its memory blocks serve every call. On
    one host core, five float64 blurs of a 400 x 400 view take longer than
    the view's render on the card."""
    device = torch.device(device or "cpu")
    hw = filter_size // 2
    offsets = (np.arange(filter_size) - hw + (2 * hw - filter_size + 1) / 2)
    filt = np.exp(-0.5 * (offsets / filter_sigma) ** 2)
    filt = filt / filt.sum()
    side = None
    if device.type == "cuda":
        side = _SSIM_STREAMS.get(device)
        if side is None:
            side = _SSIM_STREAMS[device] = torch.cuda.Stream(device)
    with torch.cuda.stream(side) if side is not None else nullcontext():
        a = torch.as_tensor(np.asarray(img0)).to(device).double()
        b = torch.as_tensor(np.asarray(img1)).to(device).double()
        assert a.ndim == 3 and a.shape[-1] == 3 and a.shape == b.shape
        z = torch.stack([a, b, a * a, b * b, a * b])  # blurred at once
        n = z.shape[1] - 2 * hw
        y = float(filt[0]) * z[:, :n]
        for k in range(1, filter_size):
            y = y + float(filt[k]) * z[:, k:k + n]
        n = z.shape[2] - 2 * hw
        x = float(filt[0]) * y[:, :, :n]
        for k in range(1, filter_size):
            x = x + float(filt[k]) * y[:, :, k:k + n]
        mu0, mu1 = x[0], x[1]
        s00 = (x[2] - mu0 * mu0).clamp_min(0.0)
        s11 = (x[3] - mu1 * mu1).clamp_min(0.0)
        s01 = x[4] - mu0 * mu1
        s01 = torch.sign(s01) * torch.minimum(torch.sqrt(s00 * s11),
                                              s01.abs())
        c1 = (k1 * max_val) ** 2
        c2 = (k2 * max_val) ** 2
        ssim_map = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / (
            (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2))
        if return_map:
            return ssim_map.cpu().numpy()
        return float(ssim_map.mean())


_LPIPS_CACHE = {}


def lpips_metric_name(net_name="alex") -> str:
    """The honest name of the LPIPS metric this environment computes:
    ``lpips_<net>`` with the official pipeline (the ``lpips`` package, or
    official weights via ``APNERF_LPIPS_WEIGHTS``), otherwise
    ``lpips_rand_<net>``, the seeded-random-feature fallback, whose scores
    are self-consistent but NOT comparable to published LPIPS. Loggers and
    tables use this name so the two are never conflated."""
    try:
        import lpips as _  # noqa: F401
        return f"lpips_{net_name}"
    except ImportError:
        pass
    path = os.environ.get("APNERF_LPIPS_WEIGHTS", "")
    if path and os.path.exists(path):
        return f"lpips_{net_name}"
    return f"lpips_rand_{net_name}"


def rgb_lpips(gt, im, net_name="alex", device=None) -> float:
    """LPIPS perceptual distance between two [H, W, 3] images in [0, 1],
    on ``device`` (``None``: the CUDA device; raises without one): the
    ``lpips`` package when importable, otherwise ``render.lpips``."""
    device = resolve_device(device)
    try:
        import lpips as lpips_pkg
    except ImportError:
        from . import lpips as own
        return own.lpips(gt, im, net_name=net_name, device=device)
    key = (net_name, str(device))
    if key not in _LPIPS_CACHE:
        _LPIPS_CACHE[key] = lpips_pkg.LPIPS(
            net=net_name, version="0.1").eval().to(device)
    g = torch.from_numpy(np.asarray(gt, np.float32)).permute(2, 0, 1)[None]
    p = torch.from_numpy(np.asarray(im, np.float32)).permute(2, 0, 1)[None]
    with torch.no_grad():
        return float(_LPIPS_CACHE[key](g.to(device), p.to(device),
                                       normalize=True).item())


def to8b(x):
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)
