"""The benchmark's weights: drawn on the device from the run's seed.

Every model of a configuration gets its state dict, with diffusers' names,
from one ``torch.Generator`` on the serving device and a few large draws in
the served dtype: one uniform draw for all the conv and linear weights of a
model and one for their biases, sliced into the tensors, each scaled to its
bound; one normal draw per embedding table.  The same seed gives the same
values, so the reference draws them again after the window rather than
holding a second copy through it.

The rule keeps activations of order one through the stack (weights uniform
in ±√(3/fan_in), biases in ±1/√fan_in, norms at 1 and 0), and it draws the
ControlNet's output convs like every other conv, so the ControlNet's
residuals reach the UNet (zero convs would hide the ControlNet from the
comparison).  TAESD's last decoder conv is drawn at a fifth of its bound
with its biases at 0.5, so the decoded image lies inside [0, 1] rather
than clipped at its ends, and the image comparison sees its pixels.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["draw_state_dicts"]


def _image_out(model: nn.Module) -> str | None:
    """The prefix of a TAESD's last decoder conv (the image's), else None."""
    layers = getattr(getattr(model, "decoder", None), "layers", None)
    return None if layers is None else f"decoder.layers.{len(layers) - 1}."


def _leaves(model: nn.Module):
    """(weights, biases, norms, tables, halves): ``(key, shape, bound)`` of
    every conv and linear weight and bias, the norm parameters' keys, the
    embedding tables' ``(key, shape, std)``, in module order, and the keys of
    biases set to 0.5 (the image's)."""
    weights, biases, norms, tables, halves = [], [], [], [], []
    image = _image_out(model)
    for name, mod in model.named_modules():
        prefix = name + "." if name else ""
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            scale = 0.2 if prefix == image else 1.0
            weights.append((prefix + "weight", tuple(mod.weight.shape),
                            scale * math.sqrt(3.0 / fan_in)))
            if mod.bias is not None and prefix == image:
                halves.append((prefix + "bias", tuple(mod.bias.shape)))
            elif mod.bias is not None:
                biases.append((prefix + "bias", tuple(mod.bias.shape), 1.0 / math.sqrt(fan_in)))
        elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            norms.append((prefix, tuple(mod.weight.shape)))
        elif isinstance(mod, nn.Embedding):
            std = 0.01 if name.endswith("position_embedding") else 0.02
            tables.append((prefix + "weight", tuple(mod.weight.shape), std))
    return weights, biases, norms, tables, halves


def _uniform(leaves, gen, dtype, device) -> dict:
    """One uniform draw in [-1, 1) sliced into the leaves, each scaled by its
    bound in place."""
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.rand(sum(sizes), generator=gen, dtype=dtype, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for (key, shape, bound), n in zip(leaves, sizes):
        out[key] = flat[at:at + n].view(shape).mul_(bound)
        at += n
    return out


@torch.no_grad()
def draw_state_dicts(models: dict, seed: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """``{model name: state dict}`` for ``models`` (modules of the right
    shapes, e.g. on the meta device), drawn from ``seed`` on ``device`` in
    ``dtype``: the models in sorted order, each one draw of weights, one of
    biases and one per table."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name in sorted(models):
        model = models[name]
        weights, biases, norms, tables, halves = _leaves(model)
        sd = _uniform(weights, gen, dtype, device)
        if biases:
            sd.update(_uniform(biases, gen, dtype, device))
        for prefix, shape in norms:
            sd[prefix + "weight"] = torch.ones(shape, dtype=dtype, device=device)
            sd[prefix + "bias"] = torch.zeros(shape, dtype=dtype, device=device)
        for key, shape in halves:
            sd[key] = torch.full(shape, 0.5, dtype=dtype, device=device)
        for key, shape, std in tables:
            sd[key] = torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)
        missing = set(model.state_dict()) - set(sd)
        if missing:
            raise ValueError(f"no init rule for {sorted(missing)[:5]} of {name}")
        out[name] = sd
    return out
