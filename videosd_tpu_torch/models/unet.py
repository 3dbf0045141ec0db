"""Conditional diffusion UNet (SD1.5 parity path) as torch modules.

Counterpart of ``videosd_tpu/models/unet.py``.  Module and parameter
names are diffusers' ``UNet2DConditionModel`` names, so a diffusers-layout
state dict loads with ``load_state_dict``; activations are NCHW inside the
modules.  :func:`unet_apply` keeps the JAX package's NHWC interface.

Covered: resnets, Transformer2D with the 1x1 projections applied as linears
on the token view, fused-QKV self-attention (long sequences go to kernel
K1 through ``layers.attention``), 77-token cross-attention, the LCM
guidance ``cond_proj``, the ControlNet residual adds, and the DeepCache
split (the deep feature out of a full pass, and the shallow pass over a
cached one), and the reference-attention hooks: the WRITE pass banks each
self-attention's normed input (``bank_out``) and the READ pass attends
over it beside its own tokens (``bank``, a :class:`BankReader`), with an
``adain`` hook after every resnet(+attention) pair of the down and up
blocks and after the mid block (``pipelines/reference_attn.py``).  Not
covered yet: SDXL ``text_time``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from videosd_tpu_torch.models.layers import (
    GroupNorm,
    LayerNorm,
    attention,
    geglu,
    timestep_embedding,
    upsample_nearest2d,
)

__all__ = ["UNET_PRESETS", "BankReader", "UNet2DConditionModel", "UNetConfig", "unet_apply"]


class BankReader:
    """Sequential reader over a flat attention bank.

    The WRITE pass appends one entry per self-attention call site in
    traversal order (``bank_out``); the READ pass consumes them in the same
    order, whichever block it is in.

    ``fidelity`` (style fidelity, [B,1,1] fp32 or a scalar) blends the
    banked and the plain self-attention OUTPUTS at each read site: 0 is the
    no-reference block exactly, 1 fully banked attention.  Scaling the
    banked tokens instead would leave zero tokens holding softmax mass at
    fidelity 0.
    """

    def __init__(self, entries, fidelity=1.0):
        self.entries = list(entries)
        self.fidelity = fidelity
        self._i = 0

    def next(self):
        e = self.entries[self._i]
        self._i += 1
        return e


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    # True for blocks with cross-attention transformers, outermost first.
    attn_down: tuple = (True, True, True, False)
    layers_per_block: int = 2
    transformer_depth: tuple = (1, 1, 1, 1)
    # SD1.5 stores "attention_head_dim=8" meaning 8 HEADS; SD2.x/SDXL store
    # the per-head dim.  `head_dim_is_num_heads` selects the interpretation.
    attention_head_dim: int = 8
    head_dim_is_num_heads: bool = True
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    time_cond_proj_dim: int | None = None  # LCM guidance embedding (w) input
    use_linear_projection: bool = False
    addition_embed_type: str | None = None  # "text_time" (SDXL) is not ported
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def num_heads(self, channels: int) -> int:
        if self.head_dim_is_num_heads:
            return self.attention_head_dim
        return max(1, channels // self.attention_head_dim)

    @property
    def attn_up(self) -> tuple:
        return tuple(reversed(self.attn_down))


UNET_PRESETS: dict[str, UNetConfig] = {
    # SimianLuo/LCM_Dreamshaper_v7 and SD1.5-family ControlNet hosts
    "sd15": UNetConfig(time_cond_proj_dim=256),
    # tiny config for tests: the sd15 topology at 2 stages and narrow widths
    "tiny": UNetConfig(
        block_out_channels=(32, 64),
        attn_down=(True, False),
        layers_per_block=1,
        transformer_depth=(1, 1),
        attention_head_dim=4,
        head_dim_is_num_heads=True,
        cross_attention_dim=32,
        norm_num_groups=8,
        time_cond_proj_dim=32,
    ),
}


def _check_supported(cfg: UNetConfig) -> None:
    if cfg.addition_embed_type is not None or cfg.use_linear_projection:
        raise NotImplementedError(
            "SD2.x/SDXL UNets (linear projections, text_time) are not ported yet"
        )


# ------------------------------------------------------------------ blocks


class ResnetBlock2D(nn.Module):
    def __init__(self, cfg: UNetConfig, cin: int, cout: int):
        super().__init__()
        g = cfg.norm_num_groups
        self.norm1 = GroupNorm(g, cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(cfg.time_embed_dim, cout)
        self.norm2 = GroupNorm(g, cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        t = self.time_emb_proj(F.silu(temb))
        h = h + t[:, :, None, None].to(h.dtype)
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x, context=None):
        if context is None:
            # self-attention: Q/K/V as one GEMM over the concatenated weights
            w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
            q, k, v = F.linear(x, w).chunk(3, dim=-1)
        else:
            q = self.to_q(x)
            w = torch.cat([self.to_k.weight, self.to_v.weight])
            k, v = F.linear(context, w).chunk(2, dim=-1)
        out = attention(q, k, v, num_heads=self.heads)
        return self.to_out[0](out)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        inner = dim * 4
        self.net = nn.ModuleList([_GEGLUProj(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x):
        return geglu(x, self.net[0].proj, self.net[2])


class BasicTransformerBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, cfg.cross_attention_dim, heads)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, self_kv=None, self_kv_weight=1.0):
        """``self_kv``: banked tokens [B, S', C] that the self-attention also
        attends over (keys and values from ``cat([h, self_kv])``);
        ``self_kv_weight`` blends that banked output with the plain one in
        fp32 (0: the plain block exactly)."""
        h = self.norm1(x)
        if self_kv is None:
            attn = self.attn1(h)
        else:
            banked = self.attn1(h, torch.cat([h, self_kv], dim=1))
            plain = self.attn1(h)
            sf = self_kv_weight
            attn = (sf * banked.float() + (1.0 - sf) * plain.float()).to(x.dtype)
        x = x + attn
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int, depth: int):
        super().__init__()
        heads = cfg.num_heads(channels)
        self.norm = GroupNorm(cfg.norm_num_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(cfg, channels, heads) for _ in range(depth)]
        )

    @staticmethod
    def _as_linear(mod, h):
        # a 1x1 conv is a linear over the token view (the JAX _proj_as_linear)
        return F.linear(h, mod.weight.reshape(mod.weight.shape[0], -1), mod.bias)

    def forward(self, x, context, bank=None, bank_out=None):
        """``bank_out``: a list the WRITE pass appends each inner block's
        ``norm1`` of its input to; ``bank``: the READ pass's
        :class:`BankReader`."""
        b, c, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self._as_linear(self.proj_in, h)
        for blk in self.transformer_blocks:
            if bank_out is not None:
                bank_out.append(blk.norm1(h))
            if bank is None:
                h = blk(h, context)
            else:
                h = blk(h, context, self_kv=bank.next(), self_kv_weight=bank.fidelity)
        h = self._as_linear(self.proj_out, h)
        return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


class _Resample(nn.Module):
    def __init__(self, ch: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=1)


class DownBlock2D(nn.Module):
    def __init__(self, cfg: UNetConfig, idx: int, cin: int, cout: int, final: bool):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cfg, cin if i == 0 else cout, cout) for i in range(n)]
        )
        self.attentions = nn.ModuleList(
            [Transformer2DModel(cfg, cout, cfg.transformer_depth[idx]) for _ in range(n)]
            if cfg.attn_down[idx]
            else []
        )
        self.downsamplers = None if final else nn.ModuleList([_Resample(cout, stride=2)])

    def resnets_and_attentions(self, x, temb, context, bank=None, bank_out=None, adain=None):
        """The block without its downsampler (DeepCache's shallow path);
        ``adain`` runs after each resnet(+attention) pair."""
        res = []
        for i, rn in enumerate(self.resnets):
            x = rn(x, temb)
            if len(self.attentions):
                x = self.attentions[i](x, context, bank=bank, bank_out=bank_out)
            if adain is not None:
                x = adain(x)
            res.append(x)
        return x, res

    def forward(self, x, temb, context, **hooks):
        x, res = self.resnets_and_attentions(x, temb, context, **hooks)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(x)
            res.append(x)
        return x, res


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        depth = cfg.transformer_depth[-1] if cfg.transformer_depth[-1] > 0 else 1
        self.resnets = nn.ModuleList([ResnetBlock2D(cfg, ch, ch), ResnetBlock2D(cfg, ch, ch)])
        self.attentions = nn.ModuleList([Transformer2DModel(cfg, ch, depth)])

    def forward(self, x, temb, context, bank=None, bank_out=None, adain=None):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context, bank=bank, bank_out=bank_out)
        x = self.resnets[1](x, temb)
        return x if adain is None else adain(x)


class UpBlock2D(nn.Module):
    """idx counts up blocks outermost-last (diffusers ``up_blocks`` order);
    resnet i takes cat(current, skip)."""

    def __init__(self, cfg, idx: int, in_ch: int, prev_out: int, out_ch: int, final: bool):
        super().__init__()
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList()
        for i in range(n):
            res_skip = in_ch if i == n - 1 else out_ch
            res_in = prev_out if i == 0 else out_ch
            self.resnets.append(ResnetBlock2D(cfg, res_in + res_skip, out_ch))
        depth = tuple(reversed(cfg.transformer_depth))[idx]
        self.attentions = nn.ModuleList(
            [Transformer2DModel(cfg, out_ch, depth) for _ in range(n)] if cfg.attn_up[idx] else []
        )
        self.upsamplers = None if final else nn.ModuleList([_Resample(out_ch)])

    def forward(self, x, res_samples, temb, context, bank=None, bank_out=None, adain=None):
        for i, rn in enumerate(self.resnets):
            x = rn(torch.cat([x, res_samples.pop()], dim=1), temb)
            if len(self.attentions):
                x = self.attentions[i](x, context, bank=bank, bank_out=bank_out)
            if adain is not None:
                x = adain(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0].conv(upsample_nearest2d(x))
        return x


class TimestepEmbedding(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        ch0, ted = cfg.block_out_channels[0], cfg.time_embed_dim
        self.linear_1 = nn.Linear(ch0, ted)
        self.linear_2 = nn.Linear(ted, ted)
        self.cond_proj = (
            nn.Linear(cfg.time_cond_proj_dim, ch0, bias=False)
            if cfg.time_cond_proj_dim is not None
            else None
        )

    def forward(self, cfg: UNetConfig, timesteps, timestep_cond=None):
        """Sinusoidal t-embedding -> MLP; the LCM guidance cond is added
        before the MLP."""
        temb = timestep_embedding(
            timesteps,
            cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift,
        ).to(self.linear_1.weight.dtype)
        if timestep_cond is not None and self.cond_proj is not None:
            temb = temb + self.cond_proj(timestep_cond.to(temb.dtype))
        return self.linear_2(F.silu(self.linear_1(temb)))


class UNetEncoder(nn.Module):
    """conv_in, time embedding, down blocks and mid block: the part the UNet
    and the ControlNet share."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(cfg)
        n = len(cfg.block_out_channels)
        self.down_blocks = nn.ModuleList()
        ch = ch0
        for i, out_ch in enumerate(cfg.block_out_channels):
            self.down_blocks.append(DownBlock2D(cfg, i, ch, out_ch, final=(i == n - 1)))
            ch = out_ch
        self.mid_block = UNetMidBlock2DCrossAttn(cfg)

    def encode(self, x, temb, context, **hooks):
        """Down and mid blocks; ``hooks`` (``bank``, ``bank_out``, ``adain``)
        reach every block."""
        down_res = [x]
        for blk in self.down_blocks:
            x, res = blk(x, temb, context, **hooks)
            down_res.extend(res)
        return self.mid_block(x, temb, context, **hooks), down_res


class UNet2DConditionModel(UNetEncoder):
    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        rev = list(reversed(cfg.block_out_channels))
        n = len(rev)
        self.up_blocks = nn.ModuleList()
        prev_out = rev[0]
        for i, out_ch in enumerate(rev):
            in_ch = rev[min(i + 1, n - 1)]
            self.up_blocks.append(
                UpBlock2D(cfg, i, in_ch, prev_out, out_ch, final=(i == n - 1))
            )
            prev_out = out_ch
        ch0 = cfg.block_out_channels[0]
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch0)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample,
        timesteps,
        encoder_hidden_states,
        timestep_cond=None,
        down_block_additional_residuals=None,
        mid_block_additional_residual=None,
        deep_feature=None,
        return_deep_feature: bool = False,
        bank=None,
        bank_out=None,
        adain=None,
    ):
        """NCHW forward; the ControlNet residuals and the deep feature are
        NCHW too.  ``bank``/``bank_out``/``adain``: the reference-attention
        READ and WRITE hooks (``pipelines/reference_attn.py``).

        DeepCache split (Ma et al., arXiv:2312.00858), as the JAX
        ``unet_apply``: ``return_deep_feature=True`` also returns the
        feature entering the last up block.  Passed back as
        ``deep_feature``, it runs only the shallow path -- conv_in, the
        first down block's resnets and attentions (not its downsampler),
        the last up block over the cached feature, conv_out -- which
        reproduces the full pass exactly on the same inputs.  The shallow
        path uses only the first ``layers_per_block + 1`` ControlNet down
        residuals.
        """
        temb = self.time_embedding(self.cfg, timesteps, timestep_cond)
        context = encoder_hidden_states.to(sample.dtype)
        x = self.conv_in(sample)
        if deep_feature is not None:
            if bank is not None or bank_out is not None or adain is not None:
                raise ValueError("deep_feature is incompatible with bank/adain modes")
            if mid_block_additional_residual is not None:
                raise ValueError("deep_feature is incompatible with mid_block_additional_residual")
            if return_deep_feature:
                raise ValueError("return_deep_feature requires a full pass (deep_feature=None)")
            if len(self.down_blocks) < 2:
                raise ValueError("deep_feature split needs >= 2 resolution blocks")
            _, res = self.down_blocks[0].resnets_and_attentions(x, temb, context)
            down_res = self._add_residuals([x, *res], down_block_additional_residuals)
            return self._head(self.up_blocks[-1](deep_feature, down_res, temb, context))
        hooks = dict(bank=bank, bank_out=bank_out, adain=adain)
        x, down_res = self.encode(x, temb, context, **hooks)
        down_res = self._add_residuals(down_res, down_block_additional_residuals)
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual.to(x.dtype)
        n = self.cfg.layers_per_block + 1
        deep = None
        for blk in self.up_blocks:
            deep = x
            res_samples, down_res = down_res[-n:], down_res[:-n]
            x = blk(x, res_samples, temb, context, **hooks)
        out = self._head(x)
        return (out, deep) if return_deep_feature else out

    @staticmethod
    def _add_residuals(down_res, residuals):
        """Add the ControlNet residuals to the skip stack, pairwise (a
        shorter stack takes the first residuals)."""
        if residuals is None:
            return down_res
        return [r + a.to(r.dtype) for r, a in zip(down_res, residuals)]

    def _head(self, x):
        return self.conv_out(F.silu(self.conv_norm_out(x)))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def unet_apply(
    model: UNet2DConditionModel,
    sample,
    timesteps,
    encoder_hidden_states,
    *,
    timestep_cond=None,
    down_block_additional_residuals=None,
    mid_block_additional_residual=None,
    deep_feature=None,
    return_deep_feature: bool = False,
    bank=None,
    bank_out=None,
    adain=None,
):
    """UNet forward with the JAX package's layouts: ``sample`` [B,h,w,C] NHWC,
    ``timesteps`` [B], context [B,S,D], ControlNet residuals and the
    DeepCache feature NHWC; returns NHWC (and the deep feature with
    ``return_deep_feature``).  The reference-attention hooks pass through;
    ``adain`` sees NCHW activations."""
    down = (
        None
        if down_block_additional_residuals is None
        else [_nchw(r) for r in down_block_additional_residuals]
    )
    mid = (
        None if mid_block_additional_residual is None else _nchw(mid_block_additional_residual)
    )
    out = model(
        _nchw(sample),
        timesteps,
        encoder_hidden_states,
        timestep_cond=timestep_cond,
        down_block_additional_residuals=down,
        mid_block_additional_residual=mid,
        deep_feature=None if deep_feature is None else _nchw(deep_feature),
        return_deep_feature=return_deep_feature,
        bank=bank,
        bank_out=bank_out,
        adain=adain,
    )
    if return_deep_feature:
        return _nhwc(out[0]), _nhwc(out[1])
    return _nhwc(out)
