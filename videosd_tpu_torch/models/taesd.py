"""TAESD, the tiny autoencoder for SD latents, as torch modules.

Counterpart of ``videosd_tpu/models/taesd.py``.  Parameter names are
diffusers' ``AutoencoderTiny`` names: flat ``encoder.layers.N`` /
``decoder.layers.N`` indices, with the parameter-free clamp, ReLU and
upsample entries holding their places.  Convs keep the compute dtype for
their outputs (the JAX package's ``f32_out=False`` at pixel resolution).
The public functions take and return NHWC like the JAX ones: images in
[-1, 1], latents [B, h, w, 4].

Three routes through the residual blocks, chosen by :class:`TAESDConfig`
as in JAX: the default NCHW modules; ``packed_convs``, the
pixel-pair-packed layout with block-packed taps and library convs; and
``pallas_convs``, the same packed activations through kernel K3
(``ops/cuda/taesd_conv.py``), falling back to ``packed_convs`` for shapes
the kernel does not take.  The packed routes keep activations
NHWC-contiguous and hand channels_last views to the library convs, so they
add no layout copies.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from videosd_tpu_torch.ops.cuda import taesd_conv

__all__ = ["AutoencoderTiny", "TAESDConfig", "taesd_decode", "taesd_encode"]


@dataclasses.dataclass(frozen=True)
class TAESDConfig:
    latent_channels: int = 4
    hidden: int = 64
    num_stages: int = 3  # number of 2x down/up stages
    blocks_per_stage: int = 3  # latents are unscaled: diffusers' scaling_factor is 1
    # residual blocks on pixel-pair-packed [B, H, W/2, 2C] activations with
    # block-packed [3, 3, 2C, 2C] taps (50 % zeros) and library convs
    packed_convs: bool = False
    # residual blocks through kernel K3 on the same packed activations
    # (the JAX name: there it selects the Pallas kernel)
    pallas_convs: bool = False


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
        h = _soft_clamp(z)
        for layer in list(self.decoder.layers)[1:]:
            h = layer(h)
        return h


def _soft_clamp(z):
    return (torch.tanh(z.float() / 3.0) * 3.0).to(z.dtype)


# ---- pixel-pair-packed routes (TAESDConfig.packed_convs / pallas_convs) ----
#
# [B, H, W, C] -> [B, H, W/2, 2C] is a free reshape in NHWC.  A 3x3 SAME
# stride-1 conv becomes a 3x3 conv over packed columns whose [2C, 2C] taps
# hold the [C, C] taps block-wise: output sub-pixel i_out at packed column j
# reads input sub-pixel i_in at packed column j + dj iff dx = 2 dj + i_in -
# i_out lands in {-1, 0, 1}.


def _pack2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h, w // 2, 2 * c)


def _unpack2(x):
    b, h, w2, c2 = x.shape
    return x.reshape(b, h, w2 * 2, c2 // 2)


def _pack2_kernel(k):
    """[3, 3, Cin, Cout] SAME-conv taps (HWIO) -> [3, 3, 2Cin, 2Cout] packed."""
    kh, kw, ci, co = k.shape
    assert kh == 3 and kw == 3, "pair packing is derived for 3x3 kernels"
    wp = k.new_zeros((kh, 3, 2 * ci, 2 * co))
    for dj in (-1, 0, 1):
        for i_in in (0, 1):
            for i_out in (0, 1):
                dx = 2 * dj + i_in - i_out
                if -1 <= dx <= 1:
                    wp[:, dj + 1, i_in * ci : (i_in + 1) * ci, i_out * co : (i_out + 1) * co] = k[
                        :, dx + 1
                    ]
    return wp


def _conv_nhwc(conv: nn.Module, x):
    """A library conv (or upsample) on NHWC ``x`` through a channels_last view."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _conv2d_packed(conv: nn.Conv2d, xp):
    kp = _pack2_kernel(conv.weight.permute(2, 3, 1, 0).to(xp.dtype))
    y = _conv_nhwc(lambda x: F.conv2d(x, kp.permute(3, 2, 0, 1), padding=1), xp)
    if conv.bias is not None:
        y = y + conv.bias.to(y.dtype).repeat(2)
    return y.to(xp.dtype)


def _block_convs(block: TAESDBlock):
    return block.conv[0], block.conv[2], block.conv[4]


def _block_apply_packed(block: TAESDBlock, xp):
    c0, c1, c2 = _block_convs(block)
    h = F.relu(_conv2d_packed(c0, xp))
    h = F.relu(_conv2d_packed(c1, h))
    h = _conv2d_packed(c2, h)
    return F.relu(h + xp)


def _block_apply_pallas(block: TAESDBlock, xp):
    """The residual block through K3; shapes outside :func:`taesd_conv.supports`
    take the packed library route."""
    if not taesd_conv.supports(xp.shape):
        return _block_apply_packed(block, xp)
    c0, c1, c2 = _block_convs(block)
    h = taesd_conv.packed_conv3x3(c0.weight, c0.bias, xp, relu=True)
    h = taesd_conv.packed_conv3x3(c1.weight, c1.bias, h, relu=True)
    return taesd_conv.packed_conv3x3(c2.weight, c2.bias, h, relu=True, skip=xp)


def _block_fn(cfg: TAESDConfig):
    if not (cfg.packed_convs or cfg.pallas_convs):
        return None
    return _block_apply_pallas if cfg.pallas_convs else _block_apply_packed


def taesd_encode(model: AutoencoderTiny, x, cfg: TAESDConfig | None = None):
    """[B,H,W,3] image in [-1,1] -> [B,H/8,W/8,4] latents (NHWC).

    ``cfg`` (default ``model.cfg``) picks the route; the packed routes run
    only when W is a multiple of 2^(num_stages+1), as in JAX."""
    cfg = model.cfg if cfg is None else cfg
    h = ((x + 1.0) * 0.5).to(x.dtype)
    block_fn = _block_fn(cfg)
    if block_fn is None or h.shape[2] % (2 ** (cfg.num_stages + 1)) != 0:
        return model.encode(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    layers = iter(model.encoder.layers)
    h = _conv_nhwc(next(layers), h)  # conv_in
    hp = block_fn(next(layers), _pack2(h))  # block_in
    for _ in range(cfg.num_stages):
        # the stride-2 down convs stay library convs between free reshapes
        hp = _pack2(_conv_nhwc(next(layers), _unpack2(hp)))
        for _ in range(cfg.blocks_per_stage):
            hp = block_fn(next(layers), hp)
    return _conv_nhwc(next(layers), _unpack2(hp))  # conv_out


def taesd_decode(model: AutoencoderTiny, z, cfg: TAESDConfig | None = None):
    """[B,h,w,4] latents -> [B,8h,8w,3] image in [-1,1] (NHWC).

    ``cfg`` (default ``model.cfg``) picks the route; the packed routes run
    only when w is even, as in JAX."""
    cfg = model.cfg if cfg is None else cfg
    block_fn = _block_fn(cfg)
    if block_fn is None or z.shape[2] % 2 != 0:
        img01 = model.decode(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return img01 * 2.0 - 1.0
    layers = iter(list(model.decoder.layers)[1:])  # layer 0 is the clamp
    h = F.relu(_conv_nhwc(next(layers), _soft_clamp(z)))  # conv_in, then layer 2's ReLU
    next(layers)
    for _ in range(cfg.num_stages):
        hp = _pack2(h)
        for _ in range(cfg.blocks_per_stage):
            hp = block_fn(next(layers), hp)
        h = _conv_nhwc(next(layers), _unpack2(hp))  # nearest 2x upsample
        h = _conv_nhwc(next(layers), h)  # up conv
    h = _unpack2(block_fn(next(layers), _pack2(h)))  # block_out
    return _conv_nhwc(next(layers), h) * 2.0 - 1.0  # conv_out, [0,1] -> [-1,1]
