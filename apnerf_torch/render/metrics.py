"""Evaluation metrics: PSNR, SSIM, LPIPS (port of
``apnerf/render/metrics.py``).

PSNR from the MSE; SSIM with an 11-tap Gaussian window (the mip-NeRF
formulation), in float64 on the host; LPIPS through the ``lpips`` package
when it is installed, else ``render.lpips`` (official weights from
``APNERF_LPIPS_WEIGHTS`` or the seeded-random fallback, whose honest name
``lpips_metric_name`` gives).
"""
from __future__ import annotations

import os

import numpy as np
import torch
from scipy.ndimage import convolve1d

from .. import resolve_device


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log10(mse))


def psnr(img, ref) -> float:
    return mse2psnr(float(np.mean(np.square(np.asarray(img) - np.asarray(ref)))))


def rgb_ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5,
             k1=0.01, k2=0.03, return_map=False):
    """SSIM with separable Gaussian filtering (valid region only)."""
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    assert img0.ndim == 3 and img0.shape[-1] == 3 and img0.shape == img1.shape

    hw = filter_size // 2
    offsets = (np.arange(filter_size) - hw + (2 * hw - filter_size + 1) / 2)
    filt = np.exp(-0.5 * (offsets / filter_sigma) ** 2)
    filt /= filt.sum()

    def blur(z):
        # separable filter, then crop to the 'valid' region
        out = convolve1d(convolve1d(z, filt, axis=0), filt, axis=1)
        return out[hw:-hw or None, hw:-hw or None]

    mu0, mu1 = blur(img0), blur(img1)
    s00 = blur(img0 * img0) - mu0 * mu0
    s11 = blur(img1 * img1) - mu1 * mu1
    s01 = blur(img0 * img1) - mu0 * mu1
    s00 = np.maximum(s00, 0.0)
    s11 = np.maximum(s11, 0.0)
    s01 = np.sign(s01) * np.minimum(np.sqrt(s00 * s11), np.abs(s01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / (
        (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2))
    return ssim_map if return_map else float(ssim_map.mean())


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
