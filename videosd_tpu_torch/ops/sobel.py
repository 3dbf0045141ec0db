"""Sobel edge control image ("canny") on device tensors.

Counterpart of ``videosd_tpu/ops/sobel.py``: PIL-compatible luma with its
truncation, zero-padded 3x3 Sobel magnitude, normalization by each image's
max, and the double threshold (>= high -> 1, <= low -> 0, middle kept),
all in fp32 with the same operation order so thresholds land on the same
pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["div_rn", "rgb_to_gray", "sobel_control_image", "sobel_edges", "sobel_magnitude"]


def div_rn(x, d: float):
    """``x / d``, correctly rounded on every device.

    On CUDA, torch computes ``tensor / python_float`` as ``tensor * (1/d)``,
    which is off by one ulp for 126 of the 256 values ``u / 255``; dividing
    by a 0-dim tensor on ``x``'s device is a true division everywhere.  The
    divisor is filled on the device (``torch.full``), not copied from the
    host, so a CUDA graph can capture the division.
    """
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def rgb_to_gray(rgb):
    """[..., H, W, 3] float in [0,1] -> [..., H, W] luma that floors like
    PIL's ``convert("L")`` on uint8: floor((299R + 587G + 114B) / 1000)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    l255 = 299.0 * r + 587.0 * g + 114.0 * b
    return div_rn(torch.floor(div_rn(l255 * 255.0, 1000.0)), 255.0)


def sobel_magnitude(gray):
    """[..., H, W] gray -> [..., H, W] fp32 zero-padded 3x3 Sobel |grad|."""
    g = gray.float()
    h, w = g.shape[-2:]
    p = F.pad(g, (1, 1, 1, 1))

    def sh(dy, dx):
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    tl, tc, tr = sh(-1, -1), sh(-1, 0), sh(-1, 1)
    ml, mr = sh(0, -1), sh(0, 1)
    bl, bc, br = sh(1, -1), sh(1, 0), sh(1, 1)
    gx = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    gy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    # fp64 sqrt rounded to fp32 is the correctly rounded fp32 sqrt on every
    # backend (torch's vectorized CPU sqrt is not, and XLA's is)
    return torch.sqrt((gx * gx + gy * gy).double()).float()


def sobel_edges(gray, low_threshold=0.11, high_threshold=0.8):
    """[..., H, W] gray in [0,1] -> [..., H, W] edge map in [0,1]."""
    mag = sobel_magnitude(gray)
    mx = torch.amax(mag, dim=(-2, -1), keepdim=True)
    edge = mag / torch.clamp(mx, min=1e-12)
    edge = torch.where(edge >= high_threshold, 1.0, edge)
    return torch.where(edge <= low_threshold, 0.0, edge)


def sobel_control_image(rgb, low_threshold=0.11, high_threshold=0.8):
    """RGB [0,1] NHWC -> 3-channel edge control image in [0,1] (NHWC)."""
    edge = sobel_edges(rgb_to_gray(rgb), low_threshold, high_threshold)
    return edge[..., None].expand(*edge.shape, 3)
