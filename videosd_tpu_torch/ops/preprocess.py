"""Frame pre/post-processing on device tensors.

Counterpart of ``videosd_tpu/ops/preprocess.py``: center crop to the
target aspect (resized with JAX's antialiased lanczos3 when the crop
differs from the target), the traced-box lanczos3 ``crop_resize`` that the
serving engine's mailboxes go through, the I420 layouts, and [-1,1] ->
uint8.  Tap positions and divisions keep the JAX order of operations in
fp32, so a box lands on the same source pixels on every device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from videosd_tpu_torch.ops.sobel import div_rn

__all__ = [
    "center_crop_box",
    "crop_resize",
    "i420_to_rgb255",
    "i420_to_rgb_host",
    "postprocess_image",
    "preprocess_frame",
    "rgb_to_i420",
    "rgb_to_i420_host",
    "yuv420_to_rgb",
]


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


# ------------------------------------------------------------ traced box


def _lanczos3_kernel(x):
    """Lanczos-3, exactly 1 at 0 and 0 at nonzero integers, so an
    identity-scale resample is an exact crop."""
    ax = x.abs()
    safe = torch.where(ax < 1e-6, 1.0, math.pi * x)
    third = div_rn(safe, 3.0)
    val = torch.where(ax < 1e-6, 1.0, (torch.sin(safe) / safe) * (torch.sin(third) / third))
    return torch.where(ax < 3.0, val, 0.0)


def _resample_rows(x, start, length, out_n: int):
    """Lanczos3 resample of ``x`` [B, N, ...] along dim 1 onto ``out_n``
    samples of each element's source interval [start, start+length) ([B]
    fp32, integer-valued).  Taps are clamped into the interval, so pixels
    outside it (mailbox padding) never contribute; a downscale stretches
    the kernel by the scale (antialias).  The tap count is a static budget
    from the worst downscale the buffer allows."""
    in_cap = x.shape[1]
    taps = int(np.ceil(2.0 * 3.0 * max(1.0, in_cap / out_n))) + 2
    scale = div_rn(length, float(out_n))
    kscale = torch.clamp(scale, min=1.0)
    support = 3.0 * kscale
    i = torch.arange(out_n, dtype=torch.float32, device=x.device)
    centers = start[:, None] + (i + 0.5)[None, :] * scale[:, None] - 0.5  # [B, out]
    lo = torch.floor(centers - support[:, None]) + 1.0
    idx = lo[..., None] + torch.arange(taps, dtype=torch.float32, device=x.device)
    wts = _lanczos3_kernel((idx - centers[..., None]) / kscale[:, None, None])
    wts = wts / wts.sum(-1, keepdim=True)  # [B, out, taps]
    last = start + length - 1.0
    idx = torch.clamp(idx, start[:, None, None], last[:, None, None]).long()
    idx = idx.clamp(0, in_cap - 1)
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    g = x[rows, idx]  # [B, out, taps, ...]
    wts = wts.reshape(*wts.shape, *(1,) * (x.ndim - 2))
    return (g * wts).sum(2)


def crop_resize(frame, box, out_h: int, out_w: int, dtype=torch.float32):
    """Per-element source rectangle -> fixed-size float [0,1] output.

    ``frame`` [B, Hm, Wm, 3] uint8 (or float in [0,255]): camera frames in
    the top-left corner of a fixed-size mailbox.  ``box`` [B, 4] int
    (top, left, height, width), as data: one program serves every camera
    geometry that fits the mailbox.  Separable lanczos3 with taps clamped
    to the box; a box of the output's size is an exact crop.
    """
    box = torch.as_tensor(box).to(frame.device).float()
    top, left, h, w = box.unbind(-1)
    f = frame.float()
    rows = _resample_rows(f, top, h, out_h)  # [B, out_h, Wm, 3]
    out = _resample_rows(rows.transpose(1, 2), left, w, out_w).transpose(1, 2)
    return torch.clamp(div_rn(out, 255.0), 0.0, 1.0).to(dtype)


# ------------------------------------------------------------ static crop


@functools.lru_cache(maxsize=32)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] fp32 weights of ``jax.image.resize(..., "lanczos3")``
    along one axis (JAX's ``compute_weight_mat`` with antialias and zero
    translation): the kernel stretched by the downscale, each column
    normalized by its sum (zero when the sum is below 1000 eps), and
    columns whose sample lies outside [-0.5, in - 0.5] zeroed."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    pix = f32(np.pi) * x
    y = f32(3.0) * np.sin(pix) * np.sin(pix / f32(3.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(x > f32(1e-3), y / np.where(x != 0, f32(np.pi**2) * (x * x), f32(1)), f32(1))
    w = np.where(x > f32(3.0), f32(0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


@functools.lru_cache(maxsize=32)
def _resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """:func:`_resize_matrix` on ``device``, copied there once: a CUDA graph
    that captures the resize reads these tensors, never a host array."""
    return torch.from_numpy(_resize_matrix(in_size, out_size)).to(device)


def _resize_lanczos3(x, out_h: int, out_w: int):
    """[..., H, W, C] fp32 -> [..., out_h, out_w, C]: the axis weights of
    :func:`_resize_matrix` applied as two fp32 products (TF32 off)."""
    wh, ww = (_resize_weights(n, m, x.device)
              for n, m in ((x.shape[-3], out_h), (x.shape[-2], out_w)))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.einsum("...hwc,ho->...owc", x, wh)
        return torch.einsum("...hwc,wo->...hoc", x, ww)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def preprocess_frame(frame_u8, out_h: int, out_w: int, dtype=torch.float32):
    """uint8 [..., H, W, 3] (or float in [0,255]) -> [..., out_h, out_w, 3]
    float in [0,1]: center crop to the target aspect, then lanczos3 resize
    (antialiased, as ``jax.image.resize``) when the crop is not the target
    size."""
    in_h, in_w = frame_u8.shape[-3], frame_u8.shape[-2]
    left, top, right, bottom = center_crop_box(in_w, in_h, out_w, out_h)
    cropped = frame_u8[..., top:bottom, left:right, :]
    x = div_rn(cropped.float(), 255.0)
    if (bottom - top, right - left) != (out_h, out_w):
        x = torch.clamp(_resize_lanczos3(x, out_h, out_w), 0.0, 1.0)
    return x.to(dtype)


def postprocess_image(img):
    """[-1,1] float NHWC -> uint8 NHWC: to [0,1], clamp, round half to even."""
    x = torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8)


# ------------------------------------------------------------ I420


def yuv420_to_rgb(y, u, v):
    """Planar YUV420 (BT.601 full range) -> float RGB [..., H, W, 3] in
    [0,1].  ``y`` [..., H, W]; ``u``, ``v`` [..., H/2, W/2] uint8; chroma is
    upsampled nearest."""
    yf = y.float()
    h, w = yf.shape[-2:]

    def up(c):
        c = c.float().repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        return c[..., :h, :w] - 128.0

    uf, vf = up(u), up(v)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return torch.clamp(div_rn(torch.stack([r, g, b], dim=-1), 255.0), 0.0, 1.0)


def rgb_to_i420(img_u8):
    """uint8 RGB [..., H, W, 3] -> packed planar I420 [..., H*3//2, W]
    uint8 (BT.601 full range; chroma 2x2 box-averaged).  Rows [0, H) are
    Y, then U and V, each packing two chroma rows of W//2 per row."""
    H, W = img_u8.shape[-3], img_u8.shape[-2]
    if H % 4 or W % 2:
        raise ValueError(f"I420 pack needs H%4==0 and W%2==0, got {H}x{W}")
    f = img_u8.float()
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    lead = y.shape[:-2]

    def sub(c):  # 2x2 box average
        c = c.reshape(*lead, H // 2, 2, W // 2, 2)
        return c.sum(-1).sum(-2) * 0.25

    def q(c):
        return torch.round(torch.clamp(c, 0.0, 255.0)).to(torch.uint8)

    return torch.cat([q(y), q(sub(u)).reshape(*lead, H // 4, W),
                      q(sub(v)).reshape(*lead, H // 4, W)], dim=-2)


def i420_to_rgb255(packed):
    """Packed I420 [..., H*3//2, W] uint8 -> float32 RGB [..., H, W, 3] in
    [0, 255], the layout :func:`crop_resize` and :func:`preprocess_frame`
    take."""
    H = (packed.shape[-2] * 2) // 3
    W = packed.shape[-1]
    lead = packed.shape[:-2]
    y = packed[..., :H, :]
    u = packed[..., H:H + H // 4, :].reshape(*lead, H // 2, W // 2)
    v = packed[..., H + H // 4:, :].reshape(*lead, H // 2, W // 2)
    return yuv420_to_rgb(y, u, v) * 255.0


def rgb_to_i420_host(img: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> packed I420 [H*3//2, W] uint8 in numpy, the
    math of :func:`rgb_to_i420` (a copy of the JAX package's host helper)."""
    H, W = img.shape[:2]
    if H % 4 or W % 2:
        raise ValueError(f"I420 pack needs H%4==0 and W%2==0, got {H}x{W}")
    f = img.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def sub(c):
        return c.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))

    def q(x):
        return np.clip(x, 0.0, 255.0).round().astype(np.uint8)

    out = np.empty((H * 3 // 2, W), np.uint8)
    out[:H] = q(y)
    out[H:H + H // 4] = q(sub(u)).reshape(H // 4, W)
    out[H + H // 4:] = q(sub(v)).reshape(H // 4, W)
    return out


def i420_to_rgb_host(buf: np.ndarray) -> np.ndarray:
    """Packed I420 [H*3//2, W] uint8 -> RGB24 [H, W, 3] uint8 in numpy,
    nearest chroma upsample (a copy of the JAX package's host helper)."""
    H = (buf.shape[0] * 2) // 3
    W = buf.shape[1]
    y = buf[:H].astype(np.float32)
    u = buf[H:H + H // 4].reshape(H // 2, W // 2).astype(np.float32) - 128.0
    v = buf[H + H // 4:].reshape(H // 2, W // 2).astype(np.float32) - 128.0
    u = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)
    v = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 255.0).round().astype(np.uint8)
