"""LoRA adapter loading and load-time fusion (LCM-LoRA et al.), on the port.

Counterpart of ``videosd_tpu/io/lora.py``: read a LoRA ``.safetensors``
file in any of the three wire formats seen in the wild and FUSE it into the
models' weights at load time,

    W  <-  W + scale * (alpha / r) * up @ down

Key formats (auto-detected per tensor):

* **diffusers/PEFT**: ``unet.<module>.lora_A.weight`` / ``.lora_B.weight``
  and ``text_encoder.<module>.lora_A.weight``;
* **legacy diffusers** (pre-PEFT, incl. the attn-processor spelling):
  ``unet.<module>.lora.down.weight`` / ``.lora.up.weight`` and
  ``...processor.to_q_lora.down.weight``;
* **kohya / A1111**: ``lora_unet_<module_with_underscores>.lora_down.weight``
  / ``.lora_up.weight`` / ``.alpha`` (underscore-joined module paths
  resolve against the weight plan's module names).

The port's state dicts are in torch layout, as the adapters are, so a delta
adds without a transpose.  It is formed in numpy fp32 exactly as the JAX
package forms it and added to the weight in fp32 before one cast back to
the weight's dtype, so a fused weight equals JAX's bit for bit on any
device.  LoRA fuses first and int8 second (``ops/quant.py``); the engine
re-fuses the configured adapters into a swapped-in checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Iterable

import numpy as np
import torch

from videosd_tpu_torch.io import weights as W
from videosd_tpu_torch.io.safetensors import read_safetensors

__all__ = [
    "LoRAEntry",
    "fuse_bundle_loras",
    "fuse_lora",
    "fuse_state_dict_loras",
    "read_lora",
]

log = logging.getLogger("videosd_tpu_torch.lora")


@dataclasses.dataclass
class LoRAEntry:
    """One adapted module: ``delta_W = (alpha/r) * up @ down`` (torch layout)."""

    down: np.ndarray | None = None  # [r, I] or [r, I, kh, kw]
    up: np.ndarray | None = None  # [O, r] or [O, r, 1, 1]
    alpha: float | None = None  # None -> alpha == r (factor 1)

    @property
    def rank(self) -> int:
        return int(self.down.shape[0])

    def scaling(self) -> float:
        return 1.0 if self.alpha is None else float(self.alpha) / self.rank

    def delta(self) -> np.ndarray:
        """Dense torch-layout delta: [O, I] (linear) or [O, I, kh, kw] (conv)."""
        up = np.asarray(self.up, np.float32)
        down = np.asarray(self.down, np.float32)
        if down.ndim == 2:
            return up @ down
        # conv LoRA: down holds the spatial taps [r, I, kh, kw]; up is a
        # 1x1 "pointwise" [O, r, 1, 1]
        return np.einsum("or,rikl->oikl", up[:, :, 0, 0], down)


# ------------------------------------------------------------------ parsing

# tower prefixes, dotted (diffusers/PEFT/legacy) and kohya forms
_DOTTED_PREFIXES = {
    "unet.": "unet",
    "text_encoder.": "text_encoder",
    "text_encoder_2.": "text_encoder_2",
}
_KOHYA_PREFIXES = {
    "lora_unet_": "unet",
    "lora_te_": "text_encoder",
    "lora_te1_": "text_encoder",
    "lora_te2_": "text_encoder_2",
}


def _classify(key: str):
    """Split a tensor key -> (tower, module, part) or None if not LoRA.

    ``part`` is "down" | "up" | "alpha".  ``module`` keeps the source
    spelling (dotted or underscore-joined); matching against the plan
    happens in :func:`fuse_lora`.
    """
    for pfx, tower in _KOHYA_PREFIXES.items():
        if key.startswith(pfx):
            rest = key[len(pfx):]
            for suffix, part in (
                (".lora_down.weight", "down"),
                (".lora_up.weight", "up"),
                (".alpha", "alpha"),
            ):
                if rest.endswith(suffix):
                    return tower, rest[: -len(suffix)], part
            return None
    for pfx, tower in _DOTTED_PREFIXES.items():
        if key.startswith(pfx):
            rest = key[len(pfx):]
            for suffix, part in (
                # PEFT (diffusers >= 0.24); also seen without ".weight"
                (".lora_A.weight", "down"),
                (".lora_B.weight", "up"),
                (".lora_A", "down"),
                (".lora_B", "up"),
                # legacy diffusers
                (".lora.down.weight", "down"),
                (".lora.up.weight", "up"),
                (".alpha", "alpha"),
            ):
                if rest.endswith(suffix):
                    return tower, rest[: -len(suffix)], part
            # legacy attn-processor spelling (no ".lora." infix):
            #   <block>.processor.to_q_lora.down.weight -> <block>.to_q
            for suffix, part in ((".down.weight", "down"), (".up.weight", "up")):
                if rest.endswith(suffix):
                    module = rest[: -len(suffix)]
                    if module.endswith("_lora") and ".processor." in module:
                        head, tail = module.rsplit(".processor.", 1)
                        module = f"{head}.{tail[: -len('_lora')]}"
                        # processors named the out projection to_out_lora
                        if module.endswith(".to_out"):
                            module += ".0"
                        return tower, module, part
            return None
    return None


def read_lora(path: str) -> dict[str, dict[str, LoRAEntry]]:
    """Read a LoRA safetensors file -> {tower: {module: LoRAEntry}}.

    Raises ``KeyError`` on unrecognized tensor keys (a loud failure beats
    silently dropping half an adapter) and on modules missing a down/up
    half.
    """
    towers: dict[str, dict[str, LoRAEntry]] = {}
    unknown: list[str] = []
    for key, arr in read_safetensors(path).items():
        parsed = _classify(key)
        if parsed is None:
            unknown.append(key)
            continue
        tower, module, part = parsed
        entry = towers.setdefault(tower, {}).setdefault(module, LoRAEntry())
        if part == "alpha":
            entry.alpha = float(np.asarray(arr).reshape(()))
        else:
            setattr(entry, part, np.asarray(arr))
    if unknown:
        raise KeyError(
            f"{path}: {len(unknown)} tensor keys in no known LoRA format, e.g. {unknown[:3]}")
    for tower, mods in towers.items():
        half = [m for m, e in mods.items() if e.down is None or e.up is None]
        if half:
            raise KeyError(f"{path}: modules missing a lora down/up half in {tower}: {half[:3]}")
    return towers


# ------------------------------------------------------------------- fusion


def fuse_lora(state_dict: dict, plan: W.Plan, modules: dict[str, LoRAEntry], *,
              scale: float = 1.0) -> tuple[dict, list[str]]:
    """Fuse one tower's LoRA modules into its torch state dict.

    ``plan`` is the tower's weight plan (``io/weights.py``): its linear and
    conv weight keys are the module-name vocabulary, in dotted and kohya
    underscore spellings.  Returns ``(new_state_dict, unmatched_modules)``;
    the new dict holds new tensors for the fused weights (on their device,
    in their dtype) and shares every other tensor.  A delta whose shape
    differs from its weight's raises ``ValueError``.
    """
    by_name: dict[str, str] = {}
    for _, tkey, kind in plan:
        if kind in ("linear", "conv") and tkey.endswith(".weight"):
            module = tkey[: -len(".weight")]
            by_name[module] = by_name[module.replace(".", "_")] = tkey
    out = dict(state_dict)
    unmatched: list[str] = []
    for module, entry in modules.items():
        tkey = by_name.get(module)
        if tkey is None:
            unmatched.append(module)
            continue
        w = out[tkey]
        delta = entry.delta() * (scale * entry.scaling())
        if tuple(delta.shape) != tuple(w.shape):
            raise ValueError(
                f"lora delta shape {delta.shape} != param {tuple(w.shape)} for module {module!r}")
        out[tkey] = (w.float() + torch.from_numpy(delta).to(w.device)).to(w.dtype)
    return out, unmatched


# tower name in the LoRA file -> the bundle's model of it
_TOWER_MODELS = {
    "unet": "unet",
    "text_encoder": "clip",
    "text_encoder_2": "clip2",
}


def _plan(bundle, tower: str) -> W.Plan:
    if tower == "unet":
        return W.unet_plan(bundle.unet_cfg)
    return W.clip_plan(bundle.clip_cfg if tower == "text_encoder" else bundle.clip2_cfg)


def fuse_state_dict_loras(bundle, state_dicts: dict, loras: Iterable[tuple[str, float]], *,
                          strict: bool = False) -> tuple[dict, dict[str, int]]:
    """Fuse ``[(path, scale), ...]`` adapters into ``state_dicts``
    (``{model name: state dict}``, of ``bundle``'s family: its configs give
    the plans).  Returns the new ``{model name: state dict}`` (untouched
    tensors shared) and the fused-module counts per tower.  A tower the
    dicts lack, or modules that match no weight, warn (or raise
    ``KeyError`` under ``strict``): a text-encoder-only tree with a
    unet+te adapter is a legitimate partial application."""
    out = dict(state_dicts)
    stats: dict[str, int] = {}
    for path, scale in loras:
        for tower, modules in read_lora(path).items():
            name = _TOWER_MODELS.get(tower)
            if name is None or out.get(name) is None:
                msg = f"{path}: no {tower!r} tower in the serving bundle"
                if strict:
                    raise KeyError(msg)
                log.warning("lora: %s — skipped %d modules", msg, len(modules))
                continue
            out[name], unmatched = fuse_lora(out[name], _plan(bundle, tower), modules,
                                             scale=scale)
            if unmatched:
                msg = (f"{path}: {len(unmatched)} {tower} modules matched no param "
                       f"(e.g. {unmatched[:3]})")
                if strict:
                    raise KeyError(msg)
                log.warning("lora: %s", msg)
            n = len(modules) - len(unmatched)
            stats[tower] = stats.get(tower, 0) + n
            log.info("lora: fused %d %s modules from %s (scale %.3g)", n, tower,
                     os.path.basename(path), scale)
    return out, stats


def fuse_bundle_loras(bundle, loras: Iterable[tuple[str, float]], *,
                      strict: bool = False) -> dict[str, int]:
    """Fuse ``[(path, scale), ...]`` adapters into a ``ModelBundle``'s
    models in place (the fused weights are copied into their parameters, so
    programs built over the modules read them).  Returns the fused-module
    counts per tower; see :func:`fuse_state_dict_loras`."""
    models = {name: bundle.models[name] for name in _TOWER_MODELS.values()
              if name in bundle.models}
    fused, stats = fuse_state_dict_loras(
        bundle, {name: m.state_dict() for name, m in models.items()}, loras, strict=strict)
    with torch.no_grad():
        for name, m in models.items():
            m.load_state_dict(fused[name], strict=True)
    return stats
