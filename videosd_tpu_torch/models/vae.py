"""AutoencoderKL, the stock SD VAE, as torch modules.

Counterpart of ``videosd_tpu/models/vae.py``: the fidelity VAE that
``FrameSpec(vae="kl")`` runs in place of TAESD.  Parameter names are
diffusers' ``AutoencoderKL`` names (``io/weights.py::vae_plan``), so a
diffusers ``vae/`` snapshot loads with ``load_state_dict``.  Activations are
NCHW inside the modules; :func:`vae_encode` and :func:`vae_decode` take and
return NHWC like the JAX functions: images in [-1, 1], unscaled latents
[B, h, w, 4] (``scaling_factor`` is the pipeline's, as in diffusers).

Where it could drift from JAX, and does not:

* the encoder's downsamplers pad right and bottom by one and then run a
  stride-2 conv without padding, so a side of H pixels gives ``H // 8``
  latents (TAESD rounds up);
* group norms take ``eps=1e-6`` (the UNet's take 1e-5);
* the mid attention folds the NCHW activation into ``[B, H*W, C]`` tokens in
  row-major (h, w) order, JAX's ``reshape(b, h*w, c)`` of NHWC, and runs
  through ``layers.attention`` with one head, so it routes to kernel K1
  exactly where JAX routes to its flash kernel (d = C: 512 at sd15 widths,
  the wide kernel above 256);
* sample mode clips logvar to [-30, 20] and draws in fp32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from videosd_tpu_torch.models.layers import GroupNorm, attention, upsample_nearest2d

__all__ = ["AutoencoderKL", "VAEConfig", "VAE_PRESETS", "vae_decode", "vae_encode"]

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


VAE_PRESETS: dict[str, VAEConfig] = {
    "sd15": VAEConfig(),
    "sd21": VAEConfig(),
    # the tiny family's (videosd_tpu/pipelines/lcm_img2img.py ModelBundle.random)
    "tiny": VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4),
}


class ResnetBlock(nn.Module):
    """GroupNorm SiLU conv GroupNorm SiLU conv, with a 1x1 shortcut where the
    channels change; no time embedding."""

    def __init__(self, cfg: VAEConfig, cin: int, cout: int):
        super().__init__()
        g = cfg.norm_num_groups
        self.norm1 = GroupNorm(g, cin, eps=_EPS)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(g, cout, eps=_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    """Single-head self-attention over the H*W tokens, with a residual."""

    def __init__(self, cfg: VAEConfig, ch: int):
        super().__init__()
        self.group_norm = GroupNorm(cfg.norm_num_groups, ch, eps=_EPS)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        # Q, K and V as one GEMM; K1 reads the three slices of its output in place
        w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
        bias = torch.cat([self.to_q.bias, self.to_k.bias, self.to_v.bias])
        q, k, v = F.linear(y, w, bias).chunk(3, dim=-1)
        y = self.to_out[0](attention(q, k, v, num_heads=1))
        return x + y.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class MidBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cfg, ch, ch), ResnetBlock(cfg, ch, ch)])
        self.attentions = nn.ModuleList([MidAttention(cfg, ch)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Conv(nn.Module):
    """A holder of one conv under diffusers' ``...samplers.0.conv`` name."""

    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=0 if stride == 2 else 1)


class _Stage(nn.Module):
    def __init__(self, cfg: VAEConfig, cin: int, cout: int, layers: int, sampler: str | None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(cfg, cin if j == 0 else cout, cout) for j in range(layers)]
        )
        if sampler == "down":
            self.downsamplers = nn.ModuleList([_Conv(cout, 2)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([_Conv(cout, 1)])

    def forward(self, x):
        for rn in self.resnets:
            x = rn(x)
        if hasattr(self, "downsamplers"):
            # pad right and bottom only, then a stride-2 conv: H // 2
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0].conv(upsample_nearest2d(x))
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        n = len(chans)
        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [_Stage(cfg, chans[max(i - 1, 0)], c, cfg.layers_per_block,
                    "down" if i != n - 1 else None) for i, c in enumerate(chans)]
        )
        self.mid_block = MidBlock(cfg, chans[-1])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, chans[-1], eps=_EPS)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        n = len(rev)
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(cfg, rev[0])
        self.up_blocks = nn.ModuleList(
            [_Stage(cfg, rev[max(i - 1, 0)], c, cfg.layers_per_block + 1,
                    "up" if i != n - 1 else None) for i, c in enumerate(rev)]
        )
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, rev[-1], eps=_EPS)
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        z = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * z, 2 * z, 1)
        self.post_quant_conv = nn.Conv2d(z, z, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def vae_encode(model: AutoencoderKL, x, cfg: VAEConfig | None = None, *, sample: bool = False,
               generator: torch.Generator | None = None, noise=None):
    """[B,H,W,3] in [-1,1] -> unscaled latents [B,H//8,W//8,4]: the
    posterior's mean, or with ``sample=True`` a draw from it (fp32 math,
    logvar clipped to [-30, 20], cast back to ``x``'s dtype).  The draw's
    standard normals come from ``noise`` ([B,h,w,4]) when given, else from
    ``generator`` (not JAX's threefry bits: the tests pass JAX's noise)."""
    del cfg  # the model carries its config; the argument mirrors the JAX signature
    moments = model.quant_conv(model.encoder(_nchw(x))).permute(0, 2, 3, 1)
    mean, logvar = moments.chunk(2, dim=-1)
    if not sample:
        return mean.contiguous()
    if noise is None:
        if generator is None:
            raise ValueError("vae_encode(sample=True) needs a generator or noise")
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    std = torch.exp(0.5 * torch.clamp(logvar.float(), -30.0, 20.0))
    return (mean.float() + std * noise.float()).to(x.dtype)


def vae_decode(model: AutoencoderKL, z, cfg: VAEConfig | None = None):
    """Unscaled latents [B,h,w,4] -> [B,8h,8w,3] in [-1,1] (unclamped)."""
    del cfg
    h = model.post_quant_conv(_nchw(z))
    return model.decoder(h).permute(0, 2, 3, 1)
