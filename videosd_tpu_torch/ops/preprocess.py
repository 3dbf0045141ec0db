"""Frame pre/post-processing on device tensors.

Counterpart of ``videosd_tpu/ops/preprocess.py`` for the frame program's
static-crop path: center crop to the target aspect, uint8 -> [0,1] fp32,
and [-1,1] -> uint8.  A crop that still needs resizing (the lanczos3
``crop_resize`` of the JAX package) is not ported yet and raises.
"""

from __future__ import annotations

import torch

from videosd_tpu_torch.ops.sobel import div_rn

__all__ = ["center_crop_box", "postprocess_image", "preprocess_frame"]


def center_crop_box(in_w: int, in_h: int, out_w: int, out_h: int):
    """Center-crop box as (left, top, right, bottom) ints (PIL floors)."""
    if in_w / in_h > out_w / out_h:
        new_w = in_h * (out_w / out_h)
        left = (in_w - new_w) / 2
        top = 0.0
        right = (in_w + new_w) / 2
        bottom = float(in_h)
    else:
        new_h = in_w * (out_h / out_w)
        left = 0.0
        top = (in_h - new_h) / 2
        right = float(in_w)
        bottom = (in_h + new_h) / 2
    return int(left), int(top), int(right), int(bottom)


def preprocess_frame(frame_u8, out_h: int, out_w: int, dtype=torch.float32):
    """uint8 [..., H, W, 3] -> [..., out_h, out_w, 3] float in [0,1]."""
    in_h, in_w = frame_u8.shape[-3], frame_u8.shape[-2]
    left, top, right, bottom = center_crop_box(in_w, in_h, out_w, out_h)
    if (bottom - top, right - left) != (out_h, out_w):
        raise NotImplementedError(
            f"resizing a {bottom - top}x{right - left} crop to {out_h}x{out_w} "
            "(lanczos3 crop_resize) is not ported yet"
        )
    cropped = frame_u8[..., top:bottom, left:right, :]
    return div_rn(cropped.float(), 255.0).to(dtype)


def postprocess_image(img):
    """[-1,1] float NHWC -> uint8 NHWC: to [0,1], clamp, round half to even."""
    x = torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8)
