"""ControlNet as torch modules, sharing the UNet's encoder blocks.

Counterpart of ``videosd_tpu/models/controlnet.py`` with diffusers'
``ControlNetModel`` parameter names: the UNet's conv_in, time embedding,
down and mid blocks, plus

1. a conditioning embedder that maps the [0,1] RGB control image through a
   small conv stack onto the latent grid, added after conv_in, and
2. zero-initialized 1x1 convs on every skip output and on the mid output.

An SDXL-family ControlNet copies the UNet encoder, so it carries the same
``text_time`` embedder (``add_embedding``), fed the same pooled embedding
and time ids.

The residuals are scaled per batch element by ``conditioning_scale`` and,
in guess mode (the default, as the reference calls it), by diffusers'
``logspace(-1, 0)`` ramp from the shallowest skip to the mid block.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videosd_tpu_torch.models.unet import UNetConfig, UNetEncoder

__all__ = ["ControlNetModel", "controlnet_apply"]

_COND_CHANNELS = (16, 32, 96, 256)


class ControlNetConditioningEmbedding(nn.Module):
    def __init__(self, out_ch: int):
        super().__init__()
        c = _COND_CHANNELS
        self.conv_in = nn.Conv2d(3, c[0], 3, padding=1)
        blocks = []
        for i in range(len(c) - 1):
            blocks.append(nn.Conv2d(c[i], c[i], 3, padding=1))
            blocks.append(nn.Conv2d(c[i], c[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(c[-1], out_ch, 3, padding=1)

    def forward(self, cond):
        c = F.silu(self.conv_in(cond))
        for blk in self.blocks:
            c = F.silu(blk(c))
        return self.conv_out(c)


class ControlNetModel(UNetEncoder):
    block_scopes = False
    # parameters that the JAX package initializes to zero
    ZERO_INIT = ("controlnet_down_blocks.", "controlnet_mid_block.",
                 "controlnet_cond_embedding.conv_out.")

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        ch0 = cfg.block_out_channels[0]
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(ch0)
        chans = [ch0]
        n = len(cfg.block_out_channels)
        for i, out_ch in enumerate(cfg.block_out_channels):
            chans += [out_ch] * cfg.layers_per_block
            if i != n - 1:
                chans.append(out_ch)
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in chans])
        ch = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(ch, ch, 1)

    def forward(
        self,
        sample,
        timesteps,
        encoder_hidden_states,
        controlnet_cond,
        conditioning_scale=1.0,
        timestep_cond=None,
        guess_mode: bool = True,
        added_cond_kwargs=None,
    ):
        """NCHW forward -> (down residuals, mid residual), NCHW.

        ``controlnet_cond``: [B,3,H,W] control image in [0,1] at pixel
        resolution; ``conditioning_scale``: a scalar or a [B] tensor;
        ``added_cond_kwargs``: SDXL's pooled embedding and time ids.
        """
        temb = self.embed(timesteps, timestep_cond, added_cond_kwargs)
        context = encoder_hidden_states.to(sample.dtype)
        x = self.conv_in(sample)
        x = x + self.controlnet_cond_embedding(controlnet_cond.to(sample.dtype))
        x, down_res = self.encode(x, temb, context)

        scale = torch.as_tensor(conditioning_scale, dtype=torch.float32, device=x.device)
        scale = scale.reshape(scale.shape + (1,) * (x.ndim - scale.ndim)).to(x.dtype)
        n_out = len(down_res) + 1
        ramp = np.logspace(-1, 0, n_out) if guess_mode else np.ones(n_out)
        ramp = ramp.astype(np.float32)
        out_down = [
            zc(r) * (scale * float(ramp[i]))
            for i, (zc, r) in enumerate(zip(self.controlnet_down_blocks, down_res))
        ]
        out_mid = self.controlnet_mid_block(x) * (scale * float(ramp[-1]))
        return out_down, out_mid


def controlnet_apply(
    model: ControlNetModel,
    sample,
    timesteps,
    encoder_hidden_states,
    controlnet_cond,
    *,
    conditioning_scale=1.0,
    timestep_cond=None,
    added_cond_kwargs=None,
    guess_mode: bool = True,
):
    """ControlNet forward with the JAX package's layouts: NHWC ``sample`` and
    ``controlnet_cond``; returns NHWC (down residuals, mid residual)."""
    down, mid = model(
        sample.permute(0, 3, 1, 2),
        timesteps,
        encoder_hidden_states,
        controlnet_cond.permute(0, 3, 1, 2),
        conditioning_scale=conditioning_scale,
        timestep_cond=timestep_cond,
        guess_mode=guess_mode,
        added_cond_kwargs=added_cond_kwargs,
    )
    return [r.permute(0, 2, 3, 1) for r in down], mid.permute(0, 2, 3, 1)
