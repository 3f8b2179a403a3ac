"""Image-quality metrics for the eval driver (beyond reference parity).

The reference's test.py compares models only visually (figures/grids);
summary.json here additionally reports per-model L1 (reference-style),
PSNR and SSIM. SSIM follows Wang et al. 2004 with the standard 11-tap
Gaussian window (sigma 1.5), per-channel then averaged — the same
convention as skimage's structural_similarity(data_range=1) on float
images in [0, 1].

Counterpart of ``vae_cyclegan_tpu/utils/metrics.py``, copied (numpy).
"""
from __future__ import annotations

import numpy as np


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(r ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _filter2d(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' Gaussian filter over the leading two axes."""
    pad = len(k) // 2
    out = np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 0, img)
    out = np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 1, out)
    return out


PSNR_CAP_DB = 99.0  # finite ceiling for exact matches: keeps summary.json
# strictly RFC-compliant (json.dump would emit the non-standard token
# `Infinity`, which strict parsers reject) and averageable.


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return PSNR_CAP_DB
    return float(min(10.0 * np.log10(data_range ** 2 / mse), PSNR_CAP_DB))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM of two (H, W) or (H, W, C) images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[:, :, None]
        b = b[:, :, None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    k = _gaussian_kernel()
    vals = []
    for c in range(a.shape[2]):
        x, y = a[:, :, c], b[:, :, c]
        mu_x = _filter2d(x, k)
        mu_y = _filter2d(y, k)
        xx = _filter2d(x * x, k) - mu_x * mu_x
        yy = _filter2d(y * y, k) - mu_y * mu_y
        xy = _filter2d(x * y, k) - mu_x * mu_y
        num = (2 * mu_x * mu_y + c1) * (2 * xy + c2)
        den = (mu_x ** 2 + mu_y ** 2 + c1) * (xx + yy + c2)
        vals.append(np.mean(num / den))
    return float(np.mean(vals))
