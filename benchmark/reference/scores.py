"""The test views' scores, worked out again with numpy alone: PSNR from the
mean squared error, and SSIM as mip-NeRF defines it (an 11-tap Gaussian
window of sigma 1.5, separable, over the valid region; the covariance
clipped by the two variances), in float64 unless ``dtype`` says
otherwise."""
from __future__ import annotations

import numpy as np


def as_unit(img) -> np.ndarray:
    """An image [H, W, >= 3] as colours in [0, 1] (uint8 divided by 255),
    its first three channels."""
    a = np.asarray(img)
    a = a.astype(np.float64) / 255.0 if a.dtype == np.uint8 else \
        a.astype(np.float64)
    return a[..., :3]


def psnr(img, gt) -> float:
    d = np.asarray(img, np.float64) - as_unit(gt)
    return float(-10.0 * np.log10(np.mean(d * d)))


def gaussian(n: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(n, dtype=np.float64) - 0.5 * (n - 1)
    f = np.exp(-0.5 * (x / sigma) ** 2)
    return f / f.sum()


def blur(z: np.ndarray, f: np.ndarray) -> np.ndarray:
    """``z`` [H, W, C] filtered by ``f`` along both image axes, the valid
    region only: [H - n + 1, W - n + 1, C]."""
    n = len(f)
    H, W = z.shape[:2]
    rows = sum(f[k] * z[k:H - n + 1 + k] for k in range(n))
    return sum(f[k] * rows[:, k:W - n + 1 + k] for k in range(n))


def ssim(img, gt, dtype=np.float64, k1: float = 0.01, k2: float = 0.03
         ) -> float:
    """The mean SSIM of ``img`` against ``gt``, colours in [0, 1]."""
    a = np.asarray(img, np.float64).astype(dtype)
    b = as_unit(gt).astype(dtype)
    f = gaussian().astype(dtype)
    mu_a, mu_b = blur(a, f), blur(b, f)
    var_a = np.maximum(blur(a * a, f) - mu_a * mu_a, 0)
    var_b = np.maximum(blur(b * b, f) - mu_b * mu_b, 0)
    cov = blur(a * b, f) - mu_a * mu_b
    cov = np.sign(cov) * np.minimum(np.sqrt(var_a * var_b), np.abs(cov))
    c1, c2 = k1 ** 2, k2 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(np.mean(s, dtype=np.float64))
