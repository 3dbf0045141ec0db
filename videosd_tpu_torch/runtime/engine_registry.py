"""Engine mixin: the multi-model checkpoint registry.

The port's counterpart of ``videosd_tpu/runtime/engine_registry.py``:
resolving `models:` registry entries into bundles whose state dicts match
the serving bundle's exactly (keys, shapes, dtypes), and background
loading.  Where the JAX engine passes another param tree to the same
jitted program, the port's programs read the serving bundle's modules (a
CUDA graph holds their addresses), so a batch of another model first
copies that model's weights into the serving modules in place (device to
device, in stream order with the replays; the default's weights are kept
aside once another model was swapped in).  Every program is shared, as in
the JAX engine.  LoRA entries raise until the LoRA port.
"""

from __future__ import annotations

import logging
import threading

import torch

__all__ = ["ModelRegistryMixin"]


class ModelRegistryMixin:

    def _check_like_serving(self, state_dicts: dict) -> None:
        """Raise ValueError unless ``state_dicts`` ({model name: state
        dict}) matches the serving bundle model for model, key for key, in
        shape and dtype: the programs (and their CUDA graphs) were built
        over the serving modules, which the weights are copied into."""
        cur = {name: m.state_dict() for name, m in self.bundle.models.items()}
        if set(state_dicts) != set(cur):
            raise ValueError(
                f"state dicts differ from the serving bundle: models {sorted(state_dicts)}, "
                f"serving {sorted(cur)}"
            )
        for name, sd in cur.items():
            new = state_dicts[name]
            missing = [k for k in sd if k not in new]
            extra = set(new) - set(sd)
            if missing or extra:
                raise ValueError(
                    f"{name}: {len(missing)} serving tensors missing from the new state dict "
                    f"(first: {missing[:2]}), {len(extra)} unknown"
                )
            bad = [k for k, v in sd.items()
                   if not isinstance(new[k], torch.Tensor) or tuple(v.shape) != tuple(new[k].shape)
                   or v.dtype != new[k].dtype]
            if bad:
                raise ValueError(
                    f"{name}: {len(bad)}/{len(sd)} tensors differ in shape/dtype from the serving "
                    f"bundle (first: {bad[:2]}; same family + dtype required for a swap "
                    "without new programs)"
                )

    def _load_weights(self, state_dicts: dict) -> None:
        """Copy ``state_dicts`` into the serving modules in place, on the
        current stream (callers hold ``_weights_lock``)."""
        with torch.no_grad():
            for name, sd in state_dicts.items():
                self.bundle.models[name].load_state_dict(sd, strict=True)

    @staticmethod
    def _clone_weights(state_dicts: dict) -> dict:
        return {name: {k: v.detach().clone() for k, v in sd.items()}
                for name, sd in state_dicts.items()}

    def _use_weights(self, model: str) -> None:
        """Put ``model``'s weights ("" = the default) in the serving modules
        before a dispatch of its batch (dispatch thread; callers hold
        ``_weights_lock``).  A no-op while they are there already."""
        if model == self._weights_in_modules:
            return
        if not self._weights_in_modules:  # keep the default's aside
            self._default_weights = self._clone_weights(
                {n: m.state_dict() for n, m in self.bundle.models.items()})
        if model:
            extra = self._extra_bundle(model)
            self._load_weights({n: m.state_dict() for n, m in extra.models.items()})
        else:
            self._load_weights(self._default_weights)
        self._weights_in_modules = model

    @property
    def model_names(self) -> list[str]:
        """Registry names a stream's "model" option may select ("" is the
        config default checkpoint and always valid)."""
        return sorted((getattr(self.config, "models", None) or {}).keys())

    def load_models(self) -> None:
        """Eagerly resolve every configured extra checkpoint (server
        startup calls this so the first stream that asks for one doesn't
        pay the load)."""
        for name in self.model_names:
            self._extra_bundle(name)

    def _extra_bundle(self, name: str):
        """Bundle for a named registry entry, loaded once.  Weight
        resolution mirrors the default bundle (local HF cache via
        io/discovery, LOUD random-init fallback — each entry gets a
        distinct init seed so even weightless A/Bs differ); its state dicts
        must match the serving bundle's."""
        entry = (getattr(self.config, "models", None) or {}).get(name)
        if entry is None:
            raise KeyError(f"unknown model {name!r}; configured: "
                           f"{self.model_names}")
        with self._extra_lock:
            bundle = self._extra_bundles.get(name)
            if bundle is not None:
                return bundle
            import zlib

            from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle

            self._check_unported_weights(entry.get("lora"))
            log = logging.getLogger("videosd_tpu_torch.engine")
            family = self.config.family
            dtype = torch.bfloat16 if self.config.dtype == "bfloat16" else torch.float32
            resolved = None
            setting = str(getattr(self.config, "weights", "random") or "random")
            if setting.lower() != "random" and not family.startswith("tiny"):
                from videosd_tpu_torch.io.discovery import resolve_weights

                # named entries resolve their own repos; "auto" discovery
                # only (an explicit path in `weights` means the DEFAULT
                # checkpoint, not every registry entry)
                resolved = resolve_weights(
                    entry["model"], controlnet=entry["controlnet"], setting="auto"
                )
            if resolved is not None:
                log.info("models[%s]: loading %s", name, resolved["model_dir"])
                bundle = ModelBundle.from_pretrained(
                    resolved["model_dir"],
                    family=family,
                    controlnet_dir=resolved["controlnet_dir"],
                    taesd_dir=resolved["taesd_dir"],
                    dtype=dtype,
                    with_controlnet=True,
                    device=self.device,
                )
            else:
                log.info(
                    "models[%s]: no cached snapshot of %r — RANDOM-INIT "
                    "weights (distinct per-entry seed)",
                    name,
                    entry["model"],
                )
                bundle = ModelBundle.random(
                    family,
                    dtype=dtype,
                    seed=1 + (zlib.crc32(name.encode()) & 0x7FFFFFFF),
                    device=self.device,
                    with_controlnet="controlnet" in self.bundle.models,
                    with_kl_vae="vae" in self.bundle.models,
                )
            self._check_like_serving({n: m.state_dict() for n, m in bundle.models.items()})
            self._extra_bundles[name] = bundle
            return bundle

    def params_for(self, model: str) -> str:
        """The weights a batch runs with: "" (or an unknown name, which the
        group key never produces) is the default checkpoint, a registry
        name that entry (copied into the serving modules at dispatch,
        :meth:`_use_weights`)."""
        return model if model and model in self._extra_bundles else ""

    def _stream_model(self, st) -> str:
        """The validated registry name for a stream ("" = default).  An
        unknown name serves the default checkpoint rather than erroring
        mid-stream (the data channel ignores junk)."""
        name = str(st.options.get("model") or "")
        if name and name not in (getattr(self.config, "models", None) or {}):
            return ""
        return name

    def _load_model_background(self, name: str):
        """Resolve a cold `models:` registry entry off the serving loop
        (host-side checkpoint conversion can take minutes); batches that
        ask for it meanwhile serve the default weights — the model-load
        analog of a cold bucket's nearest-ready fallback."""
        marker = ("model-load", name)
        if marker in self._compiling:
            return
        self._compiling.add(marker)
        logging.getLogger("videosd_tpu_torch.engine").info(
            "loading models[%s] in background (serving default checkpoint "
            "meanwhile)", name,
        )

        def work():
            try:
                self._extra_bundle(name)
            except Exception:
                logging.getLogger("videosd_tpu_torch.engine").exception(
                    "background model load failed for %r", name
                )
            finally:
                self._compiling.discard(marker)

        t = threading.Thread(target=work, name="model-load", daemon=True)
        self._bg_threads = {th for th in self._bg_threads if th.is_alive()}
        self._bg_threads.add(t)
        t.start()
