"""Plain float32 reference of the models in a frame: the UNet, the ControlNet,
the CLIP text towers and TAESD.

A frozen copy of the measured package's module structure, so that a state
dict with diffusers' names loads into both, with every fused or kernel route
replaced by the textbook math: ``F.group_norm``, ``F.layer_norm``, attention
as ``softmax(q kᵀ / √d) v``, the GEGLU and the OpenCLIP gelu in their exact
erf form.  Nothing here imports the measured package.  Run with TF32 off
(``frame.no_tf32``), so float32 means float32 on the card.

``attention_calls``, when set to a list, records every attention as
``(kind, batch, heads, sq, sk, d)`` ("self" or "cross"): the benchmark's
roofline counts the attention work from it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# set to a list to record every attention call (see the module docstring)
attention_calls: list | None = None


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The UNet's (and its ControlNet's) published widths."""

    block_out_channels: tuple = (320, 640, 1280, 1280)
    attn_down: tuple = (True, True, True, False)
    layers_per_block: int = 2
    transformer_depth: tuple = (1, 1, 1, 1)
    attention_head_dim: int = 8
    head_dim_is_num_heads: bool = True
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    time_cond_proj_dim: int | None = None
    use_linear_projection: bool = False
    addition_embed_type: str | None = None
    addition_time_embed_dim: int | None = None
    projection_class_embeddings_input_dim: int | None = None
    in_channels: int = 4
    out_channels: int = 4

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def num_heads(self, channels: int) -> int:
        if self.head_dim_is_num_heads:
            return self.attention_head_dim
        return max(1, channels // self.attention_head_dim)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    output_hidden_state: int = -1
    projection_dim: int | None = None


@dataclasses.dataclass(frozen=True)
class TAESDConfig:
    latent_channels: int = 4
    hidden: int = 64
    num_stages: int = 3
    blocks_per_stage: int = 3


def config_from(cls, d: dict):
    """A config dataclass from a JSON object (lists become tuples)."""
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


# ------------------------------------------------------------------ attention


def attention(q, k, v, heads: int, mask=None, kind: str = "self"):
    """[B, S, H*D] multi-head attention, softmax over fp32 logits."""
    b, sq, width = q.shape
    sk, d = k.shape[1], width // heads
    if attention_calls is not None:
        attention_calls.append((kind, b, heads, sq, sk, d))

    def split(x, s):
        return x.reshape(b, s, heads, d).transpose(1, 2)

    logits = split(q, sq) @ split(k, sk).transpose(-1, -2) / math.sqrt(d)
    if mask is not None:
        logits = logits + mask
    out = torch.softmax(logits, dim=-1) @ split(v, sk)
    return out.transpose(1, 2).reshape(b, sq, width)


def timestep_embedding(t, dim: int):
    """Sinusoidal embedding, cos first (flip_sin_to_cos, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def guidance_embedding(w, dim: int):
    """LCM's guidance-scale embedding: w·1000, sin first, log(1e4)/(half-1)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device)
                      * -(math.log(10000.0) / (half - 1)))
    e = (w.float() * 1000.0)[:, None] * freqs[None]
    return torch.cat([torch.sin(e), torch.cos(e)], dim=1)


# ------------------------------------------------------------------ UNet blocks


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


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
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
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
        kind = "self" if context is None else "cross"
        context = x if context is None else context
        out = attention(self.to_q(x), self.to_k(context), self.to_v(context), self.heads,
                        kind=kind)
        return self.to_out[0](out)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_GEGLUProj(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        a, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](a * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, cfg.cross_attention_dim, heads)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int, depth: int):
        super().__init__()
        self.norm = GroupNorm(cfg.norm_num_groups, channels, eps=1e-6)
        if cfg.use_linear_projection:
            self.proj_in = nn.Linear(channels, channels)
            self.proj_out = nn.Linear(channels, channels)
        else:
            self.proj_in = nn.Conv2d(channels, channels, 1)
            self.proj_out = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(cfg, channels, cfg.num_heads(channels)) for _ in range(depth)])

    @staticmethod
    def _linear(mod, h):  # a 1x1 conv is a linear over the tokens
        return F.linear(h, mod.weight.reshape(mod.weight.shape[0], -1), mod.bias)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self._linear(self.proj_in, self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        for blk in self.transformer_blocks:
            h = blk(h, context)
        h = self._linear(self.proj_out, h)
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
            [ResnetBlock2D(cfg, cin if i == 0 else cout, cout) for i in range(n)])
        self.attentions = nn.ModuleList(
            [Transformer2DModel(cfg, cout, cfg.transformer_depth[idx]) for _ in range(n)]
            if cfg.attn_down[idx] else [])
        self.downsamplers = None if final else nn.ModuleList([_Resample(cout, stride=2)])

    def forward(self, x, temb, context):
        res = []
        for i, rn in enumerate(self.resnets):
            x = rn(x, temb)
            if len(self.attentions):
                x = self.attentions[i](x, context)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(x)
            res.append(x)
        return x, res


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        depth = max(1, cfg.transformer_depth[-1])
        self.resnets = nn.ModuleList([ResnetBlock2D(cfg, ch, ch), ResnetBlock2D(cfg, ch, ch)])
        self.attentions = nn.ModuleList([Transformer2DModel(cfg, ch, depth)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UpBlock2D(nn.Module):
    def __init__(self, cfg, idx: int, in_ch: int, prev_out: int, out_ch: int, final: bool):
        super().__init__()
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList()
        for i in range(n):
            skip = in_ch if i == n - 1 else out_ch
            self.resnets.append(ResnetBlock2D(cfg, (prev_out if i == 0 else out_ch) + skip,
                                              out_ch))
        depth = tuple(reversed(cfg.transformer_depth))[idx]
        self.attentions = nn.ModuleList(
            [Transformer2DModel(cfg, out_ch, depth) for _ in range(n)]
            if tuple(reversed(cfg.attn_down))[idx] else [])
        self.upsamplers = None if final else nn.ModuleList([_Resample(out_ch)])

    def forward(self, x, skips, temb, context):
        for i, rn in enumerate(self.resnets):
            x = rn(torch.cat([x, skips.pop()], dim=1), temb)
            if len(self.attentions):
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0].conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


class TimestepEmbedding(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        ch0, ted = cfg.block_out_channels[0], cfg.time_embed_dim
        self.linear_1 = nn.Linear(ch0, ted)
        self.linear_2 = nn.Linear(ted, ted)
        self.cond_proj = (nn.Linear(cfg.time_cond_proj_dim, ch0, bias=False)
                          if cfg.time_cond_proj_dim is not None else None)


class AddEmbedding(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.linear_1 = nn.Linear(cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim)
        self.linear_2 = nn.Linear(cfg.time_embed_dim, cfg.time_embed_dim)


class UNetEncoder(nn.Module):
    """conv_in, the time embeddings, the down and the mid blocks."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.block_out_channels[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(cfg)
        self.add_embedding = AddEmbedding(cfg) if cfg.addition_embed_type == "text_time" else None
        self.down_blocks = nn.ModuleList()
        ch, n = cfg.block_out_channels[0], len(cfg.block_out_channels)
        for i, out_ch in enumerate(cfg.block_out_channels):
            self.down_blocks.append(DownBlock2D(cfg, i, ch, out_ch, final=i == n - 1))
            ch = out_ch
        self.mid_block = UNetMidBlock2DCrossAttn(cfg)

    def embed(self, t, w_emb=None, text_embeds=None, time_ids=None):
        cfg, te = self.cfg, self.time_embedding
        temb = timestep_embedding(t, cfg.block_out_channels[0])
        if w_emb is not None and te.cond_proj is not None:
            temb = temb + te.cond_proj(w_emb)
        temb = te.linear_2(F.silu(te.linear_1(temb)))
        if self.add_embedding is not None:
            b = time_ids.shape[0]
            t_emb = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
            x = torch.cat([text_embeds, t_emb.reshape(b, -1)], dim=-1)
            temb = temb + self.add_embedding.linear_2(F.silu(self.add_embedding.linear_1(x)))
        return temb

    def encode(self, x, temb, context):
        skips = [x]
        for blk in self.down_blocks:
            x, res = blk(x, temb, context)
            skips.extend(res)
        return x, skips


class UNet2DConditionModel(UNetEncoder):
    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, out_ch in enumerate(rev):
            self.up_blocks.append(UpBlock2D(cfg, i, rev[min(i + 1, len(rev) - 1)], prev, out_ch,
                                            final=i == len(rev) - 1))
            prev = out_ch
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, cfg.block_out_channels[0])
        self.conv_out = nn.Conv2d(cfg.block_out_channels[0], cfg.out_channels, 3, padding=1)

    def forward(self, x, t, context, w_emb=None, down_res=None, mid_res=None, text_embeds=None,
                time_ids=None):
        temb = self.embed(t, w_emb, text_embeds, time_ids)
        x, skips = self.encode(self.conv_in(x), temb, context)
        if down_res is not None:
            skips = [s + r for s, r in zip(skips, down_res)]
        x = self.mid_block(x, temb, context)
        if mid_res is not None:
            x = x + mid_res
        n = self.cfg.layers_per_block + 1
        for blk in self.up_blocks:
            x = blk(x, skips[-n:], temb, context)
            skips = skips[:-n]
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class ControlNetConditioningEmbedding(nn.Module):
    CHANNELS = (16, 32, 96, 256)

    def __init__(self, out_ch: int):
        super().__init__()
        c = self.CHANNELS
        self.conv_in = nn.Conv2d(3, c[0], 3, padding=1)
        blocks = []
        for i in range(len(c) - 1):
            blocks += [nn.Conv2d(c[i], c[i], 3, padding=1),
                       nn.Conv2d(c[i], c[i + 1], 3, stride=2, padding=1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(c[-1], out_ch, 3, padding=1)

    def forward(self, cond):
        c = F.silu(self.conv_in(cond))
        for blk in self.blocks:
            c = F.silu(blk(c))
        return self.conv_out(c)


class ControlNetModel(UNetEncoder):
    """The UNet's encoder with a conditioning embedder and a 1x1 conv on
    every skip and on the mid output.  The residuals are scaled by the
    element's conditioning scale and, in guess mode, by diffusers'
    logspace(-1, 0) ramp from the shallowest skip to the mid block."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        ch0 = cfg.block_out_channels[0]
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(ch0)
        chans = [ch0]
        for i, out_ch in enumerate(cfg.block_out_channels):
            chans += [out_ch] * cfg.layers_per_block
            if i != len(cfg.block_out_channels) - 1:
                chans.append(out_ch)
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in chans])
        ch = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(ch, ch, 1)

    def forward(self, x, t, context, cond, scale, w_emb=None, text_embeds=None, time_ids=None):
        temb = self.embed(t, w_emb, text_embeds, time_ids)
        x = self.conv_in(x) + self.controlnet_cond_embedding(cond)
        x, skips = self.encode(x, temb, context)
        x = self.mid_block(x, temb, context)
        ramp = np.logspace(-1, 0, len(skips) + 1)
        s = scale.float()[:, None, None, None]
        down = [zc(r) * (s * float(ramp[i]))
                for i, (zc, r) in enumerate(zip(self.controlnet_down_blocks, skips))]
        return down, self.controlnet_mid_block(x) * (s * float(ramp[-1]))


# ------------------------------------------------------------------ CLIP


class _ClipLayer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.layer_norm2 = nn.LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.mlp.fc2 = nn.Linear(cfg.intermediate_size, d)


class CLIPTextModel(nn.Module):
    """Pre-LN blocks with a causal mask; the context is the final state after
    the last LN, or the k-th last hidden state without it
    (``output_hidden_state=-k``); the pooled output is the final state at
    the end-of-text token (the ids' argmax), projected where the tower has a
    ``text_projection``."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, d)
        tm.embeddings.position_embedding = nn.Embedding(cfg.max_position_embeddings, d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([_ClipLayer(cfg) for _ in range(cfg.num_layers)])
        tm.final_layer_norm = nn.LayerNorm(d)
        self.text_projection = (None if cfg.projection_dim is None
                                else nn.Linear(d, cfg.projection_dim, bias=False))

    def forward(self, ids):
        cfg, tm = self.cfg, self.text_model
        ids = ids.long()
        seq = ids.shape[1]
        x = (tm.embeddings.token_embedding(ids.clamp(0, cfg.vocab_size - 1))
             + tm.embeddings.position_embedding.weight[:seq][None])
        mask = torch.triu(torch.full((seq, seq), float("-inf"), device=x.device), 1)
        states = [x]
        for layer in tm.encoder.layers:
            sa = layer.self_attn
            h = layer.layer_norm1(x)
            x = x + sa.out_proj(attention(sa.q_proj(h), sa.k_proj(h), sa.v_proj(h),
                                          cfg.num_heads, mask, kind="text"))
            h = layer.mlp.fc1(layer.layer_norm2(x))
            h = h * torch.sigmoid(1.702 * h) if cfg.hidden_act == "quick_gelu" else F.gelu(h)
            x = x + layer.mlp.fc2(h)
            states.append(x)
        final = tm.final_layer_norm(x)
        context = final if cfg.output_hidden_state == -1 else states[cfg.output_hidden_state]
        pooled = final[torch.arange(final.shape[0], device=x.device), ids.argmax(dim=-1)]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return context, pooled


# ------------------------------------------------------------------ TAESD


class TAESDBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(ch, ch, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(ch, ch, 3, padding=1))

    def forward(self, x):
        return F.relu(self.conv(x) + x)


class AutoencoderTiny(nn.Module):
    """TAESD with diffusers' flat layer indices; the decoder soft-clamps the
    latents with tanh(z/3)·3 first (its layer 0)."""

    def __init__(self, cfg: TAESDConfig):
        super().__init__()
        h, z = cfg.hidden, cfg.latent_channels
        enc: list = [nn.Conv2d(3, h, 3, padding=1), TAESDBlock(h)]
        for _ in range(cfg.num_stages):
            enc.append(nn.Conv2d(h, h, 3, stride=2, padding=1, bias=False))
            enc += [TAESDBlock(h) for _ in range(cfg.blocks_per_stage)]
        enc.append(nn.Conv2d(h, z, 3, padding=1))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(enc)
        dec: list = [nn.Identity(), nn.Conv2d(z, h, 3, padding=1), nn.ReLU()]
        for _ in range(cfg.num_stages):
            dec += [TAESDBlock(h) for _ in range(cfg.blocks_per_stage)]
            dec += [nn.Upsample(scale_factor=2, mode="nearest"),
                    nn.Conv2d(h, h, 3, padding=1, bias=False)]
        dec += [TAESDBlock(h), nn.Conv2d(h, 3, 3, padding=1)]
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(dec)

    def encode(self, x01):
        for layer in self.encoder.layers:
            x01 = layer(x01)
        return x01

    def decode(self, z):
        h = torch.tanh(z / 3.0) * 3.0
        for layer in list(self.decoder.layers)[1:]:
            h = layer(h)
        return h
