"""Image quality metrics: PSNR and SSIM (Wang et al. 2004).

Used to quality-gate the opt-in turbo approximations (controlnet_interval,
deepcache_interval — see pipelines/lcm_img2img.FrameSpec) against the
reference-parity program, and to quantify temporal warm-start flicker.
The reference (venetanji/videosd) ships no quality measurement at all;
these are the rebuild's own gates.

Pure NumPy (fp64 accumulation) — these run on host over uint8 frames; the
volumes are tiny (a handful of 512x512 frames per measurement).
"""

from __future__ import annotations

import numpy as np

__all__ = ["psnr", "ssim"]


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB. Identical inputs -> inf."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(r**2) / (2.0 * sigma**2))
    return k / k.sum()


def _filter2_valid(img: np.ndarray, k1d: np.ndarray) -> np.ndarray:
    """Separable 2D Gaussian filter, 'valid' region, over leading 2 axes."""
    # img: [H, W] or [H, W, C]; convolve rows then cols, valid mode
    from scipy.ndimage import convolve1d

    out = convolve1d(img, k1d, axis=0, mode="constant")
    out = convolve1d(out, k1d, axis=1, mode="constant")
    pad = len(k1d) // 2
    return out[pad:-pad, pad:-pad]


def ssim(
    a: np.ndarray,
    b: np.ndarray,
    data_range: float = 255.0,
    win_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean structural similarity (Wang et al. 2004, Gaussian window).

    Accepts [H, W] or [H, W, C] (channels averaged, matching the common
    per-channel-mean convention). Identical inputs -> 1.0.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    if a.ndim != 3:
        raise ValueError(f"expected [H,W] or [H,W,C], got {a.shape}")
    if min(a.shape[0], a.shape[1]) < win_size:
        raise ValueError(f"image {a.shape} smaller than window {win_size}")

    k = _gaussian_kernel(win_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_a = _filter2_valid(a, k)
    mu_b = _filter2_valid(b, k)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    # E[x^2] - E[x]^2 under the same window
    var_a = _filter2_valid(a * a, k) - mu_aa
    var_b = _filter2_valid(b * b, k) - mu_bb
    cov = _filter2_valid(a * b, k) - mu_ab

    num = (2.0 * mu_ab + c1) * (2.0 * cov + c2)
    den = (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))
