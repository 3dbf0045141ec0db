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

__all__ = ["rgb_to_gray", "sobel_control_image", "sobel_edges"]


def rgb_to_gray(rgb):
    """[..., H, W, 3] float in [0,1] -> [..., H, W] luma that floors like
    PIL's ``convert("L")`` on uint8: floor((299R + 587G + 114B) / 1000)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    l255 = 299.0 * r + 587.0 * g + 114.0 * b
    return torch.floor(l255 * 255.0 / 1000.0) / 255.0


def sobel_edges(gray, low_threshold=0.11, high_threshold=0.8):
    """[..., H, W] gray in [0,1] -> [..., H, W] edge map in [0,1]."""
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
    mag = torch.sqrt((gx * gx + gy * gy).double()).float()

    mx = torch.amax(mag, dim=(-2, -1), keepdim=True)
    edge = mag / torch.clamp(mx, min=1e-12)
    edge = torch.where(edge >= high_threshold, 1.0, edge)
    return torch.where(edge <= low_threshold, 0.0, edge)


def sobel_control_image(rgb, low_threshold=0.11, high_threshold=0.8):
    """RGB [0,1] NHWC -> 3-channel edge control image in [0,1] (NHWC)."""
    edge = sobel_edges(rgb_to_gray(rgb), low_threshold, high_threshold)
    return edge[..., None].expand(*edge.shape, 3)
