"""CLIP text encoder (the SD1.5 text tower) as torch modules.

Counterpart of ``videosd_tpu/models/clip_text.py`` with transformers'
``CLIPTextModel`` parameter names (``text_model.*``).  Pre-LN blocks,
causal mask, quick_gelu, final LN; the pooled output is the final hidden
state at the EOT token (argmax of the ids).  Its attention is masked, so it
stays on the plain route, as it did under XLA.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from videosd_tpu_torch.models.layers import LayerNorm, attention

__all__ = ["CLIP_PRESETS", "CLIPTextConfig", "CLIPTextModel"]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # quick_gelu (CLIP) | gelu (OpenCLIP)
    # -1 = final hidden state; -2 = penultimate (SD2.x/SDXL)
    output_hidden_state: int = -1
    projection_dim: int | None = None  # text_projection for SDXL tower 2


CLIP_PRESETS = {
    "sd15": CLIPTextConfig(),
    "tiny": CLIPTextConfig(
        vocab_size=1000,
        hidden_size=32,
        num_layers=2,
        num_heads=2,
        intermediate_size=64,
    ),
}


def _act(name: str, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise NotImplementedError(f"hidden_act={name!r} (SD2.x/SDXL towers) is not ported yet")


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = LayerNorm(d)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.layer_norm2 = LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.mlp.fc2 = nn.Linear(cfg.intermediate_size, d)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.output_hidden_state != -1 or cfg.projection_dim is not None:
            raise NotImplementedError("penultimate-state and projected towers are not ported yet")
        self.cfg = cfg
        d = cfg.hidden_size
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, d)
        tm.embeddings.position_embedding = nn.Embedding(cfg.max_position_embeddings, d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.num_layers)])
        tm.final_layer_norm = LayerNorm(d)
        self.text_model = tm

    def forward(self, input_ids):
        """[B, S] ids -> (last_hidden_state [B,S,D], pooled [B,D])."""
        cfg, tm = self.cfg, self.text_model
        # out-of-vocab ids are clamped, like the JAX take(mode="clip")
        ids = input_ids.long().clamp(0, cfg.vocab_size - 1)
        seq = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:seq][None]
        causal = torch.triu(
            torch.full((seq, seq), float("-inf"), dtype=torch.float32, device=x.device), 1
        )[None, None]
        for layer in tm.encoder.layers:
            h = layer.layer_norm1(x)
            sa = layer.self_attn
            h = attention(sa.q_proj(h), sa.k_proj(h), sa.v_proj(h), num_heads=cfg.num_heads,
                          mask=causal)
            x = x + sa.out_proj(h)
            h = layer.mlp.fc1(layer.layer_norm2(x))
            h = _act(cfg.hidden_act, h.float()).to(h.dtype)
            x = x + layer.mlp.fc2(h)
        final = tm.final_layer_norm(x)
        eot = input_ids.long().argmax(dim=-1)
        pooled = final[torch.arange(final.shape[0], device=final.device), eot]
        return final, pooled
