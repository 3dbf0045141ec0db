"""Weight plans and the weight crossing from the JAX package to the port.

The plan functions are a numpy copy of ``videosd_tpu/io/weights.py``
(``unet_plan``, ``controlnet_plan``, ``clip_plan``, ``taesd_plan``,
``vae_plan``), built on the port's own config dataclasses: each walks a model's structure and
emits ``(jax_path, torch_key, kind)`` triples, where ``kind`` fixes the
layout change (conv HWIO <-> OIHW, linear [in,out] <-> [out,in], norm
scale <-> weight, raw as is).  The torch keys are diffusers' state-dict
names, which are also the port modules' own.

:func:`state_dict_from_jax` is the crossing: it turns a JAX parameter tree
with numpy leaves into a state dict the port's modules load.
:func:`load_model_dir` reads one model of a diffusers snapshot (``unet/``,
``vae/``, ...) and :func:`load_bundle_dir` a ``bundle.json`` directory.
"""

from __future__ import annotations

import json
import os
from collections.abc import Iterable

import numpy as np
import torch

from videosd_tpu_torch.io.safetensors import read_safetensors
from videosd_tpu_torch.models.clip_text import CLIPTextConfig
from videosd_tpu_torch.models.taesd import TAESDConfig
from videosd_tpu_torch.models.unet import UNetConfig
from videosd_tpu_torch.models.vae import VAEConfig

__all__ = [
    "Plan",
    "clip_plan",
    "controlnet_plan",
    "load_bundle_dir",
    "load_model_dir",
    "state_dict_from_jax",
    "taesd_plan",
    "unet_plan",
    "vae_plan",
]

Plan = list[tuple[tuple, str, str]]  # (jax_path, torch_prefix, kind)


def _wb(plan: Plan, jpath: tuple, tkey: str, kind: str, bias: bool = True):
    plan.append((jpath + ("kernel" if kind in ("conv", "linear") else "scale",), tkey + ".weight", kind))
    if bias:
        plan.append((jpath + ("bias",), tkey + ".bias", "raw"))


def _resnet_plan(plan: Plan, jp: tuple, tp: str, has_shortcut: bool, time_emb: bool = True):
    _wb(plan, jp + ("norm1",), tp + ".norm1", "norm")
    _wb(plan, jp + ("conv1",), tp + ".conv1", "conv")
    if time_emb:
        _wb(plan, jp + ("time_emb_proj",), tp + ".time_emb_proj", "linear")
    _wb(plan, jp + ("norm2",), tp + ".norm2", "norm")
    _wb(plan, jp + ("conv2",), tp + ".conv2", "conv")
    if has_shortcut:
        _wb(plan, jp + ("conv_shortcut",), tp + ".conv_shortcut", "conv")


def _attn_block_plan(plan: Plan, jp: tuple, tp: str):
    _wb(plan, jp + ("norm1",), tp + ".norm1", "norm")
    for name in ("to_q", "to_k", "to_v"):
        plan.append((jp + ("attn1", name, "kernel"), f"{tp}.attn1.{name}.weight", "linear"))
        plan.append((jp + ("attn2", name, "kernel"), f"{tp}.attn2.{name}.weight", "linear"))
    for a in ("attn1", "attn2"):
        _wb(plan, jp + (a, "to_out"), f"{tp}.{a}.to_out.0", "linear")
    _wb(plan, jp + ("norm2",), tp + ".norm2", "norm")
    _wb(plan, jp + ("norm3",), tp + ".norm3", "norm")
    _wb(plan, jp + ("ff", "proj"), tp + ".ff.net.0.proj", "linear")
    _wb(plan, jp + ("ff", "out"), tp + ".ff.net.2", "linear")


def _transformer2d_plan(plan: Plan, jp: tuple, tp: str, depth: int, linear_proj: bool):
    _wb(plan, jp + ("norm",), tp + ".norm", "norm")
    kind = "linear" if linear_proj else "conv"
    _wb(plan, jp + ("proj_in",), tp + ".proj_in", kind)
    for k in range(depth):
        _attn_block_plan(plan, jp + ("transformer_blocks", k), f"{tp}.transformer_blocks.{k}")
    _wb(plan, jp + ("proj_out",), tp + ".proj_out", kind)


def _unet_body_plan(plan: Plan, cfg: UNetConfig, *, up_blocks: bool):
    n = len(cfg.block_out_channels)
    ch = cfg.block_out_channels[0]
    for i, out_ch in enumerate(cfg.block_out_channels):
        for j in range(cfg.layers_per_block):
            in_ch = ch if j == 0 else out_ch
            _resnet_plan(
                plan,
                ("down_blocks", i, "resnets", j),
                f"down_blocks.{i}.resnets.{j}",
                in_ch != out_ch,
            )
            if cfg.attn_down[i]:
                _transformer2d_plan(
                    plan,
                    ("down_blocks", i, "attentions", j),
                    f"down_blocks.{i}.attentions.{j}",
                    cfg.transformer_depth[i],
                    cfg.use_linear_projection,
                )
        if i != n - 1:
            _wb(
                plan,
                ("down_blocks", i, "downsamplers", 0, "conv"),
                f"down_blocks.{i}.downsamplers.0.conv",
                "conv",
            )
        ch = out_ch

    _resnet_plan(plan, ("mid_block", "resnets", 0), "mid_block.resnets.0", False)
    _resnet_plan(plan, ("mid_block", "resnets", 1), "mid_block.resnets.1", False)
    mid_depth = cfg.transformer_depth[-1] if cfg.transformer_depth[-1] > 0 else 1
    _transformer2d_plan(
        plan,
        ("mid_block", "attentions", 0),
        "mid_block.attentions.0",
        mid_depth,
        cfg.use_linear_projection,
    )

    if not up_blocks:
        return
    rev = list(reversed(cfg.block_out_channels))
    prev_out = rev[0]
    for i, out_ch in enumerate(rev):
        in_ch = rev[min(i + 1, n - 1)]
        for j in range(cfg.layers_per_block + 1):
            res_skip = in_ch if j == cfg.layers_per_block else out_ch
            res_in = prev_out if j == 0 else out_ch
            _resnet_plan(
                plan,
                ("up_blocks", i, "resnets", j),
                f"up_blocks.{i}.resnets.{j}",
                True if (res_in + res_skip) != out_ch else False,
            )
            if cfg.attn_up[i]:
                depth = tuple(reversed(cfg.transformer_depth))[i]
                _transformer2d_plan(
                    plan,
                    ("up_blocks", i, "attentions", j),
                    f"up_blocks.{i}.attentions.{j}",
                    depth,
                    cfg.use_linear_projection,
                )
        if i != n - 1:
            _wb(
                plan,
                ("up_blocks", i, "upsamplers", 0, "conv"),
                f"up_blocks.{i}.upsamplers.0.conv",
                "conv",
            )
        prev_out = out_ch


def unet_plan(cfg: UNetConfig) -> Plan:
    plan: Plan = []
    _wb(plan, ("conv_in",), "conv_in", "conv")
    _wb(plan, ("time_embedding", "linear_1"), "time_embedding.linear_1", "linear")
    _wb(plan, ("time_embedding", "linear_2"), "time_embedding.linear_2", "linear")
    if cfg.time_cond_proj_dim is not None:
        plan.append(
            (
                ("time_embedding", "cond_proj", "kernel"),
                "time_embedding.cond_proj.weight",
                "linear",
            )
        )
    if cfg.addition_embed_type == "text_time":
        _wb(plan, ("add_embedding", "linear_1"), "add_embedding.linear_1", "linear")
        _wb(plan, ("add_embedding", "linear_2"), "add_embedding.linear_2", "linear")
    _unet_body_plan(plan, cfg, up_blocks=True)
    _wb(plan, ("conv_norm_out",), "conv_norm_out", "norm")
    _wb(plan, ("conv_out",), "conv_out", "conv")
    return plan


def controlnet_plan(cfg: UNetConfig) -> Plan:
    plan: Plan = []
    _wb(plan, ("conv_in",), "conv_in", "conv")
    _wb(plan, ("time_embedding", "linear_1"), "time_embedding.linear_1", "linear")
    _wb(plan, ("time_embedding", "linear_2"), "time_embedding.linear_2", "linear")
    if cfg.time_cond_proj_dim is not None:
        plan.append(
            (
                ("time_embedding", "cond_proj", "kernel"),
                "time_embedding.cond_proj.weight",
                "linear",
            )
        )
    if cfg.addition_embed_type == "text_time":
        _wb(plan, ("add_embedding", "linear_1"), "add_embedding.linear_1", "linear")
        _wb(plan, ("add_embedding", "linear_2"), "add_embedding.linear_2", "linear")
    ce = ("controlnet_cond_embedding",)
    _wb(plan, ce + ("conv_in",), "controlnet_cond_embedding.conv_in", "conv")
    for i in range(6):
        _wb(plan, ce + ("blocks", i), f"controlnet_cond_embedding.blocks.{i}", "conv")
    _wb(plan, ce + ("conv_out",), "controlnet_cond_embedding.conv_out", "conv")
    _unet_body_plan(plan, cfg, up_blocks=False)
    n = len(cfg.block_out_channels)
    n_zero = 1 + cfg.layers_per_block * n + (n - 1)
    for i in range(n_zero):
        _wb(plan, ("controlnet_down_blocks", i), f"controlnet_down_blocks.{i}", "conv")
    _wb(plan, ("controlnet_mid_block",), "controlnet_mid_block", "conv")
    return plan


def clip_plan(cfg: CLIPTextConfig) -> Plan:
    plan: Plan = [
        (("token_embedding",), "text_model.embeddings.token_embedding.weight", "raw"),
        (
            ("position_embedding",),
            "text_model.embeddings.position_embedding.weight",
            "raw",
        ),
    ]
    for i in range(cfg.num_layers):
        jp = ("layers", i)
        tp = f"text_model.encoder.layers.{i}"
        _wb(plan, jp + ("layer_norm1",), tp + ".layer_norm1", "norm")
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _wb(plan, jp + ("self_attn", name), f"{tp}.self_attn.{name}", "linear")
        _wb(plan, jp + ("layer_norm2",), tp + ".layer_norm2", "norm")
        _wb(plan, jp + ("mlp", "fc1"), tp + ".mlp.fc1", "linear")
        _wb(plan, jp + ("mlp", "fc2"), tp + ".mlp.fc2", "linear")
    _wb(plan, ("final_layer_norm",), "text_model.final_layer_norm", "norm")
    if cfg.projection_dim is not None:
        plan.append((("text_projection", "kernel"), "text_projection.weight", "linear"))
    return plan


def _taesd_block_plan(plan: Plan, jp: tuple, tp: str):
    for c in range(3):
        _wb(plan, jp + ("conv", c), f"{tp}.conv.{2 * c}", "conv")


def taesd_plan(cfg: TAESDConfig = TAESDConfig()) -> Plan:
    """AutoencoderTiny sequential `layers` indices -> our staged tree."""
    plan: Plan = []
    li = 0
    _wb(plan, ("encoder", "conv_in"), f"encoder.layers.{li}", "conv"); li += 1
    _taesd_block_plan(plan, ("encoder", "block_in"), f"encoder.layers.{li}"); li += 1
    for s in range(cfg.num_stages):
        plan.append(
            (
                ("encoder", "stages", s, "down", "kernel"),
                f"encoder.layers.{li}.weight",
                "conv",
            )
        )
        li += 1
        for b in range(cfg.blocks_per_stage):
            _taesd_block_plan(
                plan, ("encoder", "stages", s, "blocks", b), f"encoder.layers.{li}"
            )
            li += 1
    _wb(plan, ("encoder", "conv_out"), f"encoder.layers.{li}", "conv")

    li = 1  # decoder.layers.0 is the parameter-free Clamp
    _wb(plan, ("decoder", "conv_in"), f"decoder.layers.{li}", "conv"); li += 2  # skip ReLU
    for s in range(cfg.num_stages):
        for b in range(cfg.blocks_per_stage):
            _taesd_block_plan(
                plan, ("decoder", "stages", s, "blocks", b), f"decoder.layers.{li}"
            )
            li += 1
        li += 1  # Upsample (no params)
        plan.append(
            (("decoder", "stages", s, "up", "kernel"), f"decoder.layers.{li}.weight", "conv")
        )
        li += 1
    _taesd_block_plan(plan, ("decoder", "block_out"), f"decoder.layers.{li}"); li += 1
    _wb(plan, ("decoder", "conv_out"), f"decoder.layers.{li}", "conv")
    return plan


def vae_plan(cfg: VAEConfig = VAEConfig()) -> Plan:
    plan: Plan = []
    n = len(cfg.block_out_channels)

    def half(prefix_j: str, prefix_t: str, channels: Iterable[int], *, encoder: bool):
        chans = list(channels)
        ch = chans[0] if encoder else chans[-1]
        layers = cfg.layers_per_block + (0 if encoder else 1)
        blocks = chans if encoder else list(reversed(chans))
        for i, out_ch in enumerate(blocks):
            for j in range(layers):
                in_ch = ch if j == 0 else out_ch
                _resnet_plan(
                    plan,
                    (prefix_j, f"{'down' if encoder else 'up'}_blocks", i, "resnets", j),
                    f"{prefix_t}.{'down' if encoder else 'up'}_blocks.{i}.resnets.{j}",
                    in_ch != out_ch,
                    time_emb=False,
                )
            if i != n - 1:
                kind = "downsamplers" if encoder else "upsamplers"
                _wb(
                    plan,
                    (prefix_j, f"{'down' if encoder else 'up'}_blocks", i, kind, 0, "conv"),
                    f"{prefix_t}.{'down' if encoder else 'up'}_blocks.{i}.{kind}.0.conv",
                    "conv",
                )
            ch = out_ch
        for r in (0, 1):
            _resnet_plan(
                plan,
                (prefix_j, "mid", "resnets", r),
                f"{prefix_t}.mid_block.resnets.{r}",
                False,
                time_emb=False,
            )
        ap = (prefix_j, "mid", "attentions", 0)
        tp = f"{prefix_t}.mid_block.attentions.0"
        _wb(plan, ap + ("group_norm",), tp + ".group_norm", "norm")
        for name in ("to_q", "to_k", "to_v"):
            _wb(plan, ap + (name,), f"{tp}.{name}", "linear")
        _wb(plan, ap + ("to_out",), tp + ".to_out.0", "linear")
        _wb(plan, (prefix_j, "conv_norm_out"), f"{prefix_t}.conv_norm_out", "norm")
        _wb(plan, (prefix_j, "conv_in"), f"{prefix_t}.conv_in", "conv")
        _wb(plan, (prefix_j, "conv_out"), f"{prefix_t}.conv_out", "conv")

    half("encoder", "encoder", cfg.block_out_channels, encoder=True)
    half("decoder", "decoder", cfg.block_out_channels, encoder=False)
    _wb(plan, ("encoder", "quant_conv"), "quant_conv", "conv")
    _wb(plan, ("decoder", "post_quant_conv"), "post_quant_conv", "conv")
    return plan


def _to_torch(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == "linear":
        return np.transpose(arr, (1, 0))
    return arr


def state_dict_from_jax(params: dict, plan: Plan) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> torch state dict (fp32, CPU).

    Raises ``KeyError`` naming the path when the tree lacks a planned leaf.
    """
    out: dict[str, torch.Tensor] = {}
    for jpath, tkey, kind in plan:
        node = params
        for p in jpath:
            try:
                node = node[p]
            except (KeyError, IndexError) as e:
                raise KeyError(f"parameter tree has no {jpath} (for {tkey})") from e
        arr = _to_torch(np.asarray(node, np.float32), kind)
        out[tkey] = torch.from_numpy(np.array(arr))  # a writable copy
    return out


def load_bundle_dir(ckpt_dir: str) -> tuple[str, dict[str, dict[str, torch.Tensor]]]:
    """Read a ``bundle.json`` checkpoint directory (the layout
    ``videosd_tpu/io/checkpoint.py::save_bundle`` writes: one
    ``<model>.safetensors`` of diffusers-named tensors per model).

    Returns ``(family, {model_name: state_dict})``.
    """
    with open(os.path.join(ckpt_dir, "bundle.json")) as f:
        meta = json.load(f)
    state_dicts = {}
    for name in meta["models"]:
        tensors = read_safetensors(os.path.join(ckpt_dir, f"{name}.safetensors"))
        state_dicts[name] = {k: torch.from_numpy(v) for k, v in tensors.items()}
    return meta["family"], state_dicts


def load_model_dir(model_dir: str, subdir: str, plan: Plan) -> dict[str, torch.Tensor]:
    """One model of a diffusers-layout snapshot (e.g. ``<snapshot>/unet``):
    every ``*.safetensors`` in the directory, read with the port's reader,
    as a state dict of the plan's diffusers names (fp32, CPU).  The
    counterpart of ``videosd_tpu/io/weights.py::load_model_dir``: a
    directory without ``.safetensors`` raises ``FileNotFoundError``, a
    missing plan key ``KeyError``, and tensors the plan does not name are
    ignored, as JAX's ``convert`` ignores them."""
    d = os.path.join(model_dir, subdir) if subdir else model_dir
    tensors: dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".safetensors"):
            tensors.update(read_safetensors(os.path.join(d, fn)))
    if not tensors:
        raise FileNotFoundError(f"no .safetensors under {d}")
    missing = [tk for _, tk, _ in plan if tk not in tensors]
    if missing:
        raise KeyError(f"checkpoint missing {len(missing)} keys, e.g. {missing[:5]}")
    return {tk: torch.from_numpy(np.array(tensors[tk], np.float32)) for _, tk, _ in plan}
