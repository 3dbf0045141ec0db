"""TAESD, the tiny autoencoder for SD latents, as torch modules.

Counterpart of ``videosd_tpu/models/taesd.py`` on its default (unpacked)
path.  Parameter names are diffusers' ``AutoencoderTiny`` names: flat
``encoder.layers.N`` / ``decoder.layers.N`` indices, with the
parameter-free clamp, ReLU and upsample entries holding their places.
Convs keep the compute dtype for their outputs (the JAX package's
``f32_out=False`` at pixel resolution).  The public functions take and
return NHWC like the JAX ones: images in [-1, 1], latents [B, h, w, 4].
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["AutoencoderTiny", "TAESDConfig", "taesd_decode", "taesd_encode"]


@dataclasses.dataclass(frozen=True)
class TAESDConfig:
    latent_channels: int = 4
    hidden: int = 64
    num_stages: int = 3  # number of 2x down/up stages
    blocks_per_stage: int = 3  # latents are unscaled: diffusers' scaling_factor is 1


class TAESDBlock(nn.Module):
    """conv(3x3) ReLU conv ReLU conv, identity skip, ReLU."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(ch, ch, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(ch, ch, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(ch, ch, 3, padding=1),
        )

    def forward(self, x):
        return F.relu(self.conv(x) + x)


class AutoencoderTiny(nn.Module):
    def __init__(self, cfg: TAESDConfig):
        super().__init__()
        self.cfg = cfg
        h, z = cfg.hidden, cfg.latent_channels
        enc: list[nn.Module] = [nn.Conv2d(3, h, 3, padding=1), TAESDBlock(h)]
        for _ in range(cfg.num_stages):
            enc.append(nn.Conv2d(h, h, 3, stride=2, padding=1, bias=False))
            enc += [TAESDBlock(h) for _ in range(cfg.blocks_per_stage)]
        enc.append(nn.Conv2d(h, z, 3, padding=1))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(enc)

        # layers 0 and 2 are the parameter-free clamp and ReLU
        dec: list[nn.Module] = [nn.Identity(), nn.Conv2d(z, h, 3, padding=1), nn.ReLU()]
        for _ in range(cfg.num_stages):
            dec += [TAESDBlock(h) for _ in range(cfg.blocks_per_stage)]
            dec.append(nn.Upsample(scale_factor=2, mode="nearest"))
            dec.append(nn.Conv2d(h, h, 3, padding=1, bias=False))
        dec += [TAESDBlock(h), nn.Conv2d(h, 3, 3, padding=1)]
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(dec)

    def encode(self, x01):
        """NCHW [0,1] image -> NCHW latents."""
        h = x01
        for layer in self.encoder.layers:
            h = layer(h)
        return h

    def decode(self, z):
        """NCHW latents -> NCHW [0,1] image; the latents are soft-clamped
        with tanh(z/3)*3 in fp32 first."""
        h = (torch.tanh(z.float() / 3.0) * 3.0).to(z.dtype)
        for layer in list(self.decoder.layers)[1:]:
            h = layer(h)
        return h


def taesd_encode(model: AutoencoderTiny, x):
    """[B,H,W,3] image in [-1,1] -> [B,H/8,W/8,4] latents (NHWC)."""
    h = ((x + 1.0) * 0.5).to(x.dtype)
    return model.encode(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def taesd_decode(model: AutoencoderTiny, z):
    """[B,h,w,4] latents -> [B,8h,8w,3] image in [-1,1] (NHWC)."""
    img01 = model.decode(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return img01 * 2.0 - 1.0
