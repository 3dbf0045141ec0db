"""Bundle checkpoints: one ``<model>.safetensors`` per model and a manifest.

Counterpart of ``videosd_tpu/io/checkpoint.py::save_bundle``: the directory
holds one file of diffusers-named fp32 tensors per model of the bundle (the
names and order of the model's weight plan) and ``bundle.json``
(``{"family": ..., "models": [...]}``).  The port's ``ModelBundle.from_dir``
(``io/weights.py::load_bundle_dir``) and the JAX package's
``load_bundle_params`` read it; for the same weights the files are the ones
the JAX ``save_bundle`` writes.
"""

from __future__ import annotations

import json
import os

from videosd_tpu_torch.io.safetensors import write_safetensors
from videosd_tpu_torch.io.weights import (
    clip_plan,
    controlnet_plan,
    taesd_plan,
    unet_plan,
    vae_plan,
)

__all__ = ["save_bundle"]

# the JAX package's models in its order (an SDXL bundle's second text tower
# is "clip2")
_PLANS = {
    "unet": lambda b: unet_plan(b.unet_cfg),
    "controlnet": lambda b: controlnet_plan(b.unet_cfg),
    "clip": lambda b: clip_plan(b.clip_cfg),
    "clip2": lambda b: clip_plan(b.clip2_cfg),
    "taesd": lambda b: taesd_plan(b.taesd_cfg),
    "vae": lambda b: vae_plan(b.vae_cfg),
}


def save_bundle(bundle, out_dir: str) -> None:
    """Write every model of ``bundle`` (a ``ModelBundle``) into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    meta = {"family": bundle.family, "models": []}
    for name, plan_fn in _PLANS.items():
        if name not in bundle.models:
            continue
        sd = bundle.models[name].state_dict()
        tensors = {tk: sd[tk].detach().float().cpu().numpy() for _, tk, _ in plan_fn(bundle)}
        write_safetensors(os.path.join(out_dir, f"{name}.safetensors"), tensors)
        meta["models"].append(name)
    with open(os.path.join(out_dir, "bundle.json"), "w") as f:
        json.dump(meta, f)
