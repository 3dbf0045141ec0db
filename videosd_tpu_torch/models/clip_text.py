"""CLIP text encoders (SD1.5's CLIP ViT-L/14, SD2.1's OpenCLIP ViT-H and
SDXL's two towers) as torch modules.

Counterpart of ``videosd_tpu/models/clip_text.py`` with transformers'
``CLIPTextModel`` parameter names (``text_model.*``, and
``text_projection`` for ``CLIPTextModelWithProjection``).  Pre-LN blocks,
causal mask, quick_gelu (CLIP) or gelu (OpenCLIP), final LN; the pooled
output is the final hidden state at the EOT token (argmax of the ids),
passed through ``text_projection`` where the tower has one.  SDXL's towers
give the penultimate layer's state as the context, without the final LN
(``output_hidden_state=-2``); their pooled output still comes from the
whole tower.  The attention is masked, so it stays on the plain route, as
it did under XLA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from videosd_tpu_torch.models.layers import LayerNorm, attention

__all__ = ["CLIP_PRESETS", "CLIPTextConfig", "CLIPTextModel", "second_tower_for", "tower_for"]


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


# by tower, with the JAX package's names; ``tower_for`` maps a family to its
# first tower
CLIP_PRESETS = {
    "sd15": CLIPTextConfig(),
    # SD2.1 / SD-Turbo: OpenCLIP ViT-H/14's text tower (its 24th layer dropped)
    "sd21": CLIPTextConfig(
        hidden_size=1024,
        num_layers=23,
        num_heads=16,
        intermediate_size=4096,
        hidden_act="gelu",
    ),
    # SDXL tower 1: CLIP ViT-L/14, the penultimate state as the context
    "sdxl-1": CLIPTextConfig(output_hidden_state=-2),
    # SDXL tower 2: OpenCLIP ViT-bigG/14, penultimate state, projected pooled
    "sdxl-2": CLIPTextConfig(
        hidden_size=1280,
        num_layers=32,
        num_heads=20,
        intermediate_size=5120,
        hidden_act="gelu",
        output_hidden_state=-2,
        projection_dim=1280,
    ),
    "tiny": CLIPTextConfig(
        vocab_size=1000,
        hidden_size=32,
        num_layers=2,
        num_heads=2,
        intermediate_size=64,
    ),
}

# a family's first tower, as JAX's ``ModelBundle.random`` picks it
_FAMILY_TOWER = {"sd15": "sd15", "sd21": "sd21", "sdxl": "sdxl-1", "tiny": "tiny",
                 "tiny-xl": "tiny"}


def tower_for(family: str) -> str:
    """The CLIP preset of ``family``'s (first) text tower; sd15 for a
    family the table does not name (``sd15-base``)."""
    return _FAMILY_TOWER.get(family, "sd15")


def second_tower_for(family: str) -> str:
    """The CLIP preset of an SDXL-family bundle's second tower
    (``tiny-xl`` reuses the tiny tower)."""
    return "sdxl-2" if family == "sdxl" else "tiny"


def _act(name: str, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        # transformers' "gelu" is the exact erf form; the tanh form only for
        # a bf16 input, as the JAX tower's gelu(approximate=bf16).  The
        # tower passes fp32 in either dtype, so it is erf in both.
        return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
    raise ValueError(f"unknown hidden_act {name!r}")


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
        self.text_projection = (None if cfg.projection_dim is None
                                else nn.Linear(d, cfg.projection_dim, bias=False))

    def forward(self, input_ids):
        """[B, S] ids -> (context [B,S,D], pooled [B,D|P]): the context is the
        final (post-LN) state, or with ``output_hidden_state=-k`` the k-th
        last of the embeddings and the layers' outputs, without the LN."""
        cfg, tm = self.cfg, self.text_model
        # out-of-vocab ids are clamped, like the JAX take(mode="clip")
        ids = input_ids.long().clamp(0, cfg.vocab_size - 1)
        seq = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:seq][None]
        causal = torch.triu(
            torch.full((seq, seq), float("-inf"), dtype=torch.float32, device=x.device), 1
        )[None, None]
        hidden_states = [x]
        for layer in tm.encoder.layers:
            h = layer.layer_norm1(x)
            sa = layer.self_attn
            h = attention(sa.q_proj(h), sa.k_proj(h), sa.v_proj(h), num_heads=cfg.num_heads,
                          mask=causal)
            x = x + sa.out_proj(h)
            h = layer.mlp.fc1(layer.layer_norm2(x))
            h = _act(cfg.hidden_act, h.float()).to(h.dtype)
            x = x + layer.mlp.fc2(h)
            hidden_states.append(x)
        final = tm.final_layer_norm(x)
        context = final if cfg.output_hidden_state == -1 else hidden_states[cfg.output_hidden_state]
        eot = input_ids.long().argmax(dim=-1)
        pooled = final[torch.arange(final.shape[0], device=final.device), eot]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return context, pooled
