"""Image resampling on numpy: ``area_resize``, the counterpart of
``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` for downscales,
which the dataset loaders use without ``cv2``."""
from __future__ import annotations

import numpy as np


def coverage_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in]: the share of input pixel j in output pixel i, the
    overlap of [j, j + 1) with [i s, (i + 1) s) over s = n_in / n_out."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    j = np.arange(n_in)[None, :]
    overlap = np.minimum(j + 1, lo + s) - np.maximum(j, lo)
    return np.clip(overlap, 0.0, None) / s


def area_resize(img: np.ndarray, size) -> np.ndarray:
    """``img`` [H, W] or [H, W, C] resampled to ``size`` = (w, h) (cv2's
    order) by pixel-area averaging, in the input's dtype: uint8 rounded to
    the nearest level (halves up, as cv2's fixed-point rounding); float
    computed in float64. Only downscales (h <= H, w <= W) are
    supported."""
    w, h = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    if h > H or w > W or h < 1 or w < 1:
        raise ValueError(f"area_resize downscales only: {W} x {H} -> "
                         f"{w} x {h}")
    if (h, w) == (H, W):
        return img.copy()
    x = np.asarray(img, np.float64)
    if H % h == 0 and W % w == 0:
        # whole blocks: every weight is 1 / (block size)
        out = x.reshape(h, H // h, w, W // w, *x.shape[2:]).mean((1, 3))
    else:
        out = np.tensordot(coverage_weights(H, h), x, axes=(1, 0))
        out = np.moveaxis(np.tensordot(coverage_weights(W, w), out,
                                       axes=(1, 1)), 0, 1)
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    if np.issubdtype(img.dtype, np.integer):
        raise ValueError(f"area_resize takes uint8 or float images, got "
                         f"{img.dtype}")
    return out.astype(img.dtype)
