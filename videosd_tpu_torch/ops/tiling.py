"""Spatial tiling for KL VAE encode and decode at large resolutions.

Counterpart of ``videosd_tpu/ops/tiling.py``: the decoder (or encoder) runs
over overlapping tiles of a fixed size, and the overlaps are feather-blended
with the same 1-D ramps (numpy, fp32), so peak activation memory is one
tile's whatever the output size.  At the default 64-latent tile each decode
tile runs the KL VAE's mid attention at S = 4096, d = 512 on kernel K1.

The blend runs in fp32 on the tiles' device; the result is fp32, like the
JAX function's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tiled_decode", "tiled_encode"]


def _blend_weights(tile: int, overlap: int) -> np.ndarray:
    """1-D feathering ramp: 0..1 over `overlap`, flat 1 in the interior."""
    w = np.ones((tile,), np.float32)
    if overlap > 0:
        ramp = (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1.0)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


def _starts(n: int, tile: int, step: int) -> list[int]:
    """Tile origins along one axis: every ``step``, and the last flush with the end."""
    starts = list(range(0, max(n - tile, 0) + 1, step))
    if starts[-1] != n - tile:
        starts.append(n - tile)
    return starts


def _blend(fn, x, tile: int, overlap: int, in_scale: int, out_scale: int, channels: int):
    """Runs ``fn`` on [B, tile, tile, C] tiles of ``x`` [B, H, W, C] and
    blends the [B, tile*out_scale/in_scale, ...] results: ``in_scale`` and
    ``out_scale`` map input pixels to output pixels (8 and 1 for encode,
    1 and 8 for decode)."""
    b, hh, ww, _ = x.shape
    step = tile - overlap
    ot = tile * out_scale // in_scale
    out = torch.zeros((b, hh * out_scale // in_scale, ww * out_scale // in_scale, channels),
                      dtype=torch.float32, device=x.device)
    acc = torch.zeros((1, *out.shape[1:3], 1), dtype=torch.float32, device=x.device)
    wt1d = torch.from_numpy(_blend_weights(ot, overlap * out_scale // in_scale)).to(x.device)
    wgt = (wt1d[:, None, None] * wt1d[None, :, None])[None]
    for y0 in _starts(hh, tile, step):
        for x0 in _starts(ww, tile, step):
            part = fn(x[:, y0:y0 + tile, x0:x0 + tile, :]).float()
            oy, ox = y0 * out_scale // in_scale, x0 * out_scale // in_scale
            out[:, oy:oy + ot, ox:ox + ot] += part * wgt
            acc[:, oy:oy + ot, ox:ox + ot] += wgt
    return out / torch.clamp(acc, min=1e-8)


def tiled_decode(decode_fn, z, *, tile: int = 64, overlap: int = 8, scale: int = 8):
    """Decode latents ``z`` [B,h,w,C] via overlapping tiles of ``tile``
    latents.  ``decode_fn``: latents [B,tile,tile,C] -> image; ``scale``:
    the decoder's upsampling factor (8 for SD VAEs).  Returns the fp32
    image [B, h*scale, w*scale, 3]."""
    if z.shape[1] <= tile and z.shape[2] <= tile:
        return decode_fn(z)
    return _blend(decode_fn, z, tile, overlap, 1, scale, 3)


def tiled_encode(encode_fn, img, *, tile: int = 512, overlap: int = 64, scale: int = 8):
    """Encode an image [B,H,W,3] via overlapping pixel tiles -> fp32 latents."""
    if img.shape[1] <= tile and img.shape[2] <= tile:
        return encode_fn(img)
    return _blend(encode_fn, img, tile, overlap, scale, 1, 4)
