"""Post-training int8 (w8a8) quantization of the UNet/ControlNet linears.

Counterpart of ``videosd_tpu/ops/quant.py``, with its policy:

* every transformer-block feed-forward (``ff.net.0.proj`` / ``ff.net.2``);
* self-attention q/k/v/out and cross-attention q/out projections whose
  model dim is >= ``min_attn_dim`` (default 640);
* never the cross-attention k/v (their product runs over the 77-token
  text context), never a conv, norm or embedding, and never the VAE,
  TAESD or the text towers.

Where the JAX walker rewrites a parameter tree, this one replaces the
``nn.Linear`` modules of a model in place by :class:`LinearW8A8` (int8
``w8``, fp32 ``sw`` and ``bias`` buffers); the attention and GEGLU
forwards dispatch on the module.  It is idempotent.  The mode is off by
default (config ``quant: int8``); what it costs or saves on the card is
measured by ``chip_smoke.py`` (PERF.md).  :func:`quantize_state_dict`
applies the same transform to a plain state dict, so a checkpoint swapped
into a quantized engine lines up with its modules key for key.
"""

from __future__ import annotations

from torch import nn

from videosd_tpu_torch.models.layers import LinearW8A8, quantize_linear
from videosd_tpu_torch.models.unet import BasicTransformerBlock

__all__ = [
    "quant_stats",
    "quantize_bundle_params",
    "quantize_state_dict",
    "quantize_transformer_linears",
]


def _quantize(parent: nn.Module, name: str) -> None:
    setattr(parent, name, LinearW8A8.from_linear(getattr(parent, name)))


def quantize_transformer_linears(module: nn.Module, *, min_attn_dim: int = 640) -> nn.Module:
    """Replace the selected linears of every transformer block of ``module``
    (a UNet or ControlNet) by their w8a8 form, in place; returns
    ``module``.  Blocks already quantized are left alone."""
    for blk in module.modules():
        if not isinstance(blk, BasicTransformerBlock):
            continue
        for name in ("attn1", "attn2"):
            a = getattr(blk, name)
            if isinstance(a.to_q, LinearW8A8) or a.to_q.in_features < min_attn_dim:
                continue
            # cross-attn k/v: a 77-token product, nothing to win
            for key in ("to_q", "to_k", "to_v") if name == "attn1" else ("to_q",):
                _quantize(a, key)
            _quantize(a.to_out, "0")
        ff = blk.ff.net
        if isinstance(ff[0].proj, nn.Linear):
            _quantize(ff[0], "proj")
            _quantize(ff, "2")
    return module


def quantize_bundle_params(bundle, *, min_attn_dim: int = 640):
    """Quantize the denoiser towers of a ``ModelBundle`` in place (the
    ``unet`` and, where the bundle has one, the ``controlnet``); the VAE,
    TAESD and the text towers stay as they are.  Returns ``bundle``."""
    for tower in ("unet", "controlnet"):
        if tower in bundle.models:
            quantize_transformer_linears(bundle.models[tower], min_attn_dim=min_attn_dim)
    return bundle


def quantize_state_dict(model: nn.Module, state_dict: dict) -> dict:
    """``state_dict`` (of ``model``'s plain form) with every linear that is
    a :class:`LinearW8A8` in ``model`` put in w8a8 form
    (``prefix.weight`` -> ``prefix.w8``, ``prefix.sw``; the bias in fp32),
    by the same :func:`quantize_linear`.  Entries already in w8a8 form and
    every other tensor pass as they are."""
    out = dict(state_dict)
    for name, mod in model.named_modules():
        if isinstance(mod, LinearW8A8) and f"{name}.weight" in out:
            bias = out.pop(f"{name}.bias", None)
            q = quantize_linear(out.pop(f"{name}.weight"), bias)
            out.update({f"{name}.{k}": v for k, v in q.items()})
    return out


def quant_stats(module: nn.Module) -> dict[str, int]:
    """Count quantized and plain linears (for /stats and tests), as the JAX
    count does: a :class:`LinearW8A8` is quantized, an ``nn.Linear`` (a
    2-D weight) plain."""
    mods = list(module.modules())
    return {"quantized_linears": sum(isinstance(m, LinearW8A8) for m in mods),
            "plain_linears": sum(isinstance(m, nn.Linear) for m in mods)}
