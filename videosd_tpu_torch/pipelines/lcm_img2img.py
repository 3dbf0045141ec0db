"""The per-frame LCM img2img (+ControlNet) program on PyTorch.

Counterpart of ``videosd_tpu/pipelines/lcm_img2img.py``.  The chain after
prompt encoding, per frame:

    unpack I420 (optional) -> crop (the engine's per-element ``src_box``
    through lanczos3 ``crop_resize``, or the static center crop) ->
    Sobel control image -> VAE encode -> warm-start blend (optional) ->
    add_noise at the first valid ladder step -> S x (ControlNet + UNet +
    LCM step) -> VAE decode -> safety hook (optional) -> uint8

The VAE is TAESD (``FrameSpec.vae="taesd"``, the default) or the stock KL
autoencoder (``vae="kl"``, ``models/vae.py``: latents scaled by
``scaling_factor`` after encode and unscaled before decode), which a bundle
carries when it was built with ``with_kl_vae=True`` or loaded from a
checkpoint that holds a ``vae``.

``strength``, ``guidance_scale``, ``controlnet_scale``, ``seed`` and
``warm_alpha`` are per batch element, as in the JAX program: each element
follows its own masked timestep ladder.  Random numbers enter through one
seam: ``noise`` of shape ``[S+1, B, h, w, 4]``, row 0 for the forward
noise and row s+1 for the re-noise of step s.  Without it, each element's
rows are drawn from a ``torch.Generator`` seeded with that element's seed;
these are not JAX's threefry bits, so the tests feed JAX's noise through
the seam.

The production levers of the JAX ``FrameSpec`` run as there:
``controlnet_interval`` and ``deepcache_interval`` (with
``interval_refresh_last``) reuse the ControlNet residuals and the UNet's
deep trunk between refresh steps; ``deepcache_temporal`` carries the
trunk across frames (produce returns the per-step features, reuse runs
shallow passes over them).

A call stages its inputs on the host (checks, host-to-device copies, the
seeded noise) and then runs the body, a function of device buffers alone.
``frame_program`` runs the two eagerly, as JAX's ``frame_program`` is the
function its ``build_frame_program`` jits; the program that
``build_frame_program`` returns keeps static buffers per call signature and,
on a CUDA bundle, replays one CUDA graph per signature, captured at its
first call (the port's counterpart of ``jax.jit``).

Convs, GEMMs and norms are library calls, and
the long self-attentions go to kernel K1 (``ops/cuda/flash_attention.py``)
on every UNet pass, full or shallow, every ControlNet call and, on the KL
path, the VAE's mid attention in encode and decode (d = 512 at sd15 widths,
K1's kernel for head dims above 256).  TAESD
follows ``bundle.taesd_cfg``; the ``taesd_pallas`` path of the JAX server
sends its residual-block convs to kernel K3 (``ops/cuda/taesd_conv.py``)::

    bundle = dataclasses.replace(
        bundle, taesd_cfg=dataclasses.replace(bundle.taesd_cfg, pallas_convs=True))
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import os
import threading
import time
from typing import Any

import torch
from torch.profiler import record_function
from torch import nn

from videosd_tpu_torch.io.weights import (
    clip_plan,
    controlnet_plan,
    load_bundle_dir,
    load_model_dir,
    taesd_plan,
    unet_plan,
    vae_plan,
)
from videosd_tpu_torch.models.clip_text import CLIP_PRESETS, CLIPTextConfig, CLIPTextModel
from videosd_tpu_torch.models.controlnet import ControlNetModel
from videosd_tpu_torch.models.layers import guidance_embedding
from videosd_tpu_torch.models.taesd import AutoencoderTiny, TAESDConfig, taesd_decode, taesd_encode
from videosd_tpu_torch.models.unet import UNET_PRESETS, UNet2DConditionModel, UNetConfig
from videosd_tpu_torch.models.vae import (
    VAE_PRESETS,
    AutoencoderKL,
    VAEConfig,
    vae_decode,
    vae_encode,
)
from videosd_tpu_torch.ops.cuda import flash_attention, taesd_conv
from videosd_tpu_torch.ops.preprocess import (
    crop_resize,
    i420_to_rgb255,
    postprocess_image,
    preprocess_frame,
)
from videosd_tpu_torch.ops.sobel import div_rn, sobel_control_image
from videosd_tpu_torch.schedulers.lcm import (
    LCMSchedulerConfig,
    add_noise,
    make_alphas_cumprod,
    step,
    timestep_schedule,
)
from videosd_tpu_torch.text.tokenizer import CLIPTokenizer, find_vocab_dir

__all__ = [
    "FrameProgram",
    "FrameSpec",
    "ModelBundle",
    "build_frame_program",
    "build_prompt_encoder",
    "frame_program",
    "kernel_launches",
]


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """Static shape and schedule of one frame-program bucket: the fields of
    the JAX ``FrameSpec``, with its meanings (``vae``: ``"taesd"`` or
    ``"kl"``, the latter on a bundle that carries a KL VAE)."""

    batch: int = 1
    height: int = 512
    width: int = 512
    in_height: int | None = None
    in_width: int | None = None
    in_format: str = "rgb"
    steps: int = 4
    use_controlnet: bool = True
    vae: str = "taesd"
    canny_low: float = 0.11
    canny_high: float = 0.8
    lcm_origin_steps: int = 50
    # ControlNet keep-window: step i keeps the residuals iff
    # i/steps >= start and (i+1)/steps <= end
    control_guidance_start: float = 0.0
    control_guidance_end: float = 1.0
    controlnet_interval: int = 1
    deepcache_interval: int = 1
    deepcache_temporal: bool = False
    interval_refresh_last: bool = False

    def resolved_in_shape(self) -> tuple[int, int]:
        return (self.in_height or self.height, self.in_width or self.width)


def _resolve_device(device) -> torch.device:
    """The bundle's device.  The entry points build on the card unless the
    caller names another device; without a card they raise, never falling
    back to the CPU on their own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ModelBundle builds on the card by default and torch.cuda.is_available() is "
            'False; pass device="cpu" to run on the CPU'
        )
    return device


def _empty_module(ctor, dtype, device) -> nn.Module:
    """Build a module without running torch's own initializers."""
    with torch.device("meta"):
        mod = ctor()
    return mod.to(dtype=dtype).to_empty(device=device).eval().requires_grad_(False)


@torch.no_grad()
def init_like_jax(model: nn.Module, gen: torch.Generator, zero_prefixes=()) -> None:
    """The JAX package's init rule: conv and linear weights uniform in
    +-1/sqrt(fan_in) (zeros under ``zero_prefixes``), zero biases, unit
    norm scales.  Draws come from ``gen`` in module order."""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            if any((name + ".").startswith(p) for p in zero_prefixes):
                w.zero_()
            else:
                bound = w[0].numel() ** -0.5
                u = torch.rand(w.shape, generator=gen, device=w.device, dtype=torch.float32)
                w.copy_(u * (2.0 * bound) - bound)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


@dataclasses.dataclass
class ModelBundle:
    """The models and configs of one family, resident on ``device``."""

    family: str
    unet_cfg: UNetConfig
    clip_cfg: CLIPTextConfig
    sched_cfg: LCMSchedulerConfig
    models: dict  # {"unet", "controlnet", "taesd", "clip", "vae"} -> nn.Module
    alphas_cumprod: torch.Tensor
    tokenizer: CLIPTokenizer
    taesd_cfg: TAESDConfig
    vae_cfg: VAEConfig  # the KL VAE's, whether or not ``models`` holds one
    dtype: torch.dtype
    device: torch.device
    # optional post-decode hook, images_pm1 [B,H,W,3] -> images_pm1
    # (pipelines/safety.py); None = off
    safety_hook: Any = None

    @classmethod
    def random(
        cls,
        family: str = "sd15",
        *,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        with_controlnet: bool = True,
        with_kl_vae: bool = False,
    ) -> "ModelBundle":
        """Randomly initialized bundle, drawn with the JAX init rule from a
        ``torch.Generator`` seeded with ``seed`` (not the JAX values; the
        KL VAE, with ``with_kl_vae``, is drawn last, so the other models'
        values do not depend on it).  On ``device="meta"`` the models have
        shapes and no values (for counting, ``ops/flops.py``)."""
        if family not in UNET_PRESETS:
            raise NotImplementedError(f"family {family!r} is not ported yet")
        device = _resolve_device(device)
        unet_cfg = UNET_PRESETS[family]
        clip_cfg = CLIP_PRESETS[family]
        taesd_cfg = (
            TAESDConfig(hidden=16, blocks_per_stage=1) if family == "tiny" else TAESDConfig()
        )
        vae_cfg = VAE_PRESETS[family]
        models = {"unet": _empty_module(lambda: UNet2DConditionModel(unet_cfg), dtype, device)}
        if with_controlnet:
            models["controlnet"] = _empty_module(lambda: ControlNetModel(unet_cfg), dtype, device)
        models["taesd"] = _empty_module(lambda: AutoencoderTiny(taesd_cfg), dtype, device)
        models["clip"] = _empty_module(lambda: CLIPTextModel(clip_cfg), dtype, device)
        if with_kl_vae:
            models["vae"] = _empty_module(lambda: AutoencoderKL(vae_cfg), dtype, device)
        if device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(seed)
            init_like_jax(models["unet"], gen)
            if with_controlnet:
                init_like_jax(models["controlnet"], gen, ControlNetModel.ZERO_INIT)
            init_like_jax(models["taesd"], gen)
            init_like_jax(models["clip"], gen)
            emb = models["clip"].text_model.embeddings
            for table, std in ((emb.token_embedding, 0.02), (emb.position_embedding, 0.01)):
                with torch.no_grad():
                    table.weight.copy_(
                        torch.randn(table.weight.shape, generator=gen, device=device) * std
                    )
            if with_kl_vae:
                init_like_jax(models["vae"], gen)
        sched_cfg = LCMSchedulerConfig()
        return cls(
            family=family,
            unet_cfg=unet_cfg,
            clip_cfg=clip_cfg,
            sched_cfg=sched_cfg,
            models=models,
            alphas_cumprod=torch.from_numpy(make_alphas_cumprod(sched_cfg)).to(device),
            tokenizer=CLIPTokenizer(find_vocab_dir(), vocab_size=clip_cfg.vocab_size),
            taesd_cfg=taesd_cfg,
            vae_cfg=vae_cfg,
            dtype=dtype,
            device=device,
        )

    @classmethod
    def from_state_dicts(
        cls, family: str, state_dicts: dict, *, dtype=torch.float32, device="cuda"
    ) -> "ModelBundle":
        """A bundle whose models load the given diffusers-named state dicts
        (strictly: a missing or extra key raises); models absent from
        ``state_dicts`` keep the random init."""
        bundle = cls.random(family, dtype=dtype, device=device,
                            with_controlnet="controlnet" in state_dicts,
                            with_kl_vae="vae" in state_dicts)
        for name, sd in state_dicts.items():
            if name not in bundle.models:
                raise KeyError(f"no model {name!r} in a {family} bundle")
            bundle.models[name].load_state_dict(sd, strict=True)
        return bundle

    @classmethod
    def from_dir(cls, path: str, *, family: str = "sd15", dtype=None, device="cuda",
                 **kw) -> "ModelBundle":
        """Load a checkpoint directory of either layout, as the JAX loader
        does: a ``bundle.json`` directory (``save_bundle``'s, e.g. the
        committed ``examples/toy_tiny_ckpt``; its family is the recorded
        one, and ``kw`` must be empty), else a diffusers snapshot through
        :meth:`from_pretrained` (``family`` and ``kw`` passed on).
        ``dtype=None`` picks fp32 for tiny families and bf16 otherwise."""
        if not os.path.isfile(os.path.join(path, "bundle.json")):
            return cls.from_pretrained(path, family=family, dtype=dtype or torch.bfloat16,
                                       device=device, **kw)
        if kw:
            raise TypeError(f"from_dir(bundle.json layout) got unsupported kwargs {sorted(kw)}")
        family, state_dicts = load_bundle_dir(path)
        if dtype is None:
            dtype = torch.float32 if family.startswith("tiny") else torch.bfloat16
        return cls.from_state_dicts(family, state_dicts, dtype=dtype, device=device)

    @classmethod
    def from_pretrained(cls, model_dir: str, *, family: str = "sd15",
                        controlnet_dir: str | None = None, taesd_dir: str | None = None,
                        dtype=torch.bfloat16, with_controlnet: bool | None = None,
                        device="cuda") -> "ModelBundle":
        """Load a diffusers-layout snapshot (``unet/``, ``text_encoder/``,
        optional ``vae/`` and ``tokenizer/``), the counterpart of the JAX
        ``ModelBundle.from_pretrained``.  A snapshot without a loadable
        ``vae/`` (no ``.safetensors``, or a missing tensor) gives a bundle
        without a KL VAE, as a TAESD-only deployment.  The ControlNet and
        TAESD come from their own directories; without them the ControlNet
        (with ``with_controlnet``, default: whether ``controlnet_dir`` is
        given) and TAESD keep the random init, the ControlNet's zeroed
        output convs making it a no-op.  The tokenizer reads ``tokenizer/``
        or the snapshot's own ``vocab.json``."""
        if family not in UNET_PRESETS:
            raise NotImplementedError(f"family {family!r} is not ported yet")
        unet_cfg, clip_cfg = UNET_PRESETS[family], CLIP_PRESETS[family]
        state_dicts = {
            "unet": load_model_dir(model_dir, "unet", unet_plan(unet_cfg)),
            "clip": load_model_dir(model_dir, "text_encoder", clip_plan(clip_cfg)),
        }
        try:
            state_dicts["vae"] = load_model_dir(model_dir, "vae", vae_plan(VAE_PRESETS[family]))
        except (FileNotFoundError, KeyError):
            pass  # TAESD-only deployments (the reference swaps the VAE out)
        if controlnet_dir:
            state_dicts["controlnet"] = load_model_dir(controlnet_dir, "",
                                                       controlnet_plan(unet_cfg))
        if with_controlnet is None:
            with_controlnet = controlnet_dir is not None
        bundle = cls.random(family, dtype=dtype, device=device,
                            with_controlnet=with_controlnet or "controlnet" in state_dicts,
                            with_kl_vae="vae" in state_dicts)
        if taesd_dir:
            state_dicts["taesd"] = load_model_dir(taesd_dir, "", taesd_plan(bundle.taesd_cfg))
        for name, sd in state_dicts.items():
            bundle.models[name].load_state_dict(sd, strict=True)
        for sub in ("tokenizer", ""):
            cand = os.path.join(model_dir, sub)
            if os.path.isfile(os.path.join(cand, "vocab.json")):
                bundle.tokenizer = CLIPTokenizer(cand, pad_to_eos=family != "sd21")
                break
        return bundle


def _check_spec(bundle: ModelBundle, spec: FrameSpec) -> None:
    if spec.vae not in ("taesd", "kl"):
        raise ValueError(f"FrameSpec.vae must be taesd or kl, got {spec.vae!r}")
    if spec.vae == "kl" and "vae" not in bundle.models:
        raise ValueError('FrameSpec.vae="kl" needs a bundle with a KL VAE '
                         "(ModelBundle.random(with_kl_vae=True), or a checkpoint with a vae)")
    if spec.in_format not in ("rgb", "i420"):
        raise ValueError(f"FrameSpec.in_format must be rgb or i420, got {spec.in_format!r}")
    if spec.deepcache_temporal and spec.deepcache_interval > 1:
        raise ValueError(
            "deepcache_temporal is mutually exclusive with "
            "deepcache_interval>1 (per-step vs carried trunk caches)"
        )
    if spec.use_controlnet and "controlnet" not in bundle.models:
        raise ValueError("spec.use_controlnet needs a bundle with a ControlNet")


def _per_element(x, batch: int):
    return torch.as_tensor(x, dtype=torch.float32).reshape(batch)


def _latent_hw(bundle: ModelBundle, spec: FrameSpec) -> tuple[int, int]:
    """The latents' height and width: TAESD's stride-2 convs round up, the
    KL encoder's (right and bottom padded by one) round down."""
    if spec.vae == "kl":
        f = 2 ** (len(bundle.vae_cfg.block_out_channels) - 1)
        return spec.height // f, spec.width // f
    f = 2 ** bundle.taesd_cfg.num_stages
    return -(-spec.height // f), -(-spec.width // f)


def _times(x, f: float):
    """``x * f`` as JAX computes it with a Python float: ``f`` rounded to
    ``x``'s dtype first, and filled on the device (no host copy)."""
    return x * torch.full((), f, dtype=x.dtype, device=x.device)


def _draw_noise(seeds, out) -> None:
    """Fill ``out`` [S+1, B, h, w, 4] fp32: element b's rows from a generator
    seeded with ``seeds[b]``, on ``out``'s device."""
    for b, s in enumerate(seeds):
        g = torch.Generator(device=out.device).manual_seed(int(s))
        out[:, b] = torch.randn((out.shape[0], *out.shape[2:]), generator=g, device=out.device)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _check_frames(spec: FrameSpec, frame_u8):
    """Check the upload layout: [B, Hin, Win, 3] for rgb, packed
    [B, Hin*3//2, Win] for i420."""
    B = spec.batch
    frame_u8 = torch.as_tensor(frame_u8)
    if spec.in_format == "i420":
        hin, win = spec.resolved_in_shape()
        want = (B, hin * 3 // 2, win)
        ok = tuple(frame_u8.shape) == want
    else:
        want = (B, "H", "W", 3)
        ok = frame_u8.ndim == 4 and frame_u8.shape[0] == B and frame_u8.shape[3] == 3
    if not ok or frame_u8.dtype != torch.uint8:
        raise ValueError(f"expected {spec.in_format} uint8 frames {want}, got {frame_u8.dtype} "
                         f"{tuple(frame_u8.shape)}")
    return frame_u8


def _call_inputs(bundle: ModelBundle, spec: FrameSpec, frame_u8, prompt_embeds, strength,
                 guidance_scale, controlnet_scale, noise, warm_latents, warm_alpha,
                 pooled_embeds, src_box, deep_caches) -> dict:
    """Check one call's inputs and bring them to their staged dtypes and
    shapes, on whatever device they arrived: ``{name: tensor or None}``
    named and ordered as :func:`_frame_body`'s arguments (``noise`` None:
    drawn from the seeds)."""
    if pooled_embeds is not None:
        raise NotImplementedError("frame_program(pooled_embeds=...) (SDXL) is not ported yet")
    B, S = spec.batch, spec.steps
    latent = (B, *_latent_hw(bundle, spec), 4)
    if warm_latents is not None:
        if warm_alpha is None:
            raise ValueError("warm_latents needs warm_alpha")
        warm_latents = torch.as_tensor(warm_latents)
        if tuple(warm_latents.shape) != latent:
            raise ValueError(f"warm_latents must be {latent}, got {tuple(warm_latents.shape)}")
        warm_alpha = _per_element(warm_alpha, B)
    else:
        warm_alpha = None
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=torch.float32)
        if tuple(noise.shape) != (S + 1, *latent):
            raise ValueError(f"noise must be {(S + 1, *latent)}, got {tuple(noise.shape)}")
    if src_box is not None:
        src_box = torch.as_tensor(src_box)
        if tuple(src_box.shape) != (B, 4):
            raise ValueError(f"src_box must be [{B}, 4], got {tuple(src_box.shape)}")
    if deep_caches is not None:
        if not spec.deepcache_temporal:
            raise ValueError("deep_caches needs FrameSpec.deepcache_temporal")
        deep_caches = torch.as_tensor(deep_caches)
        if tuple(deep_caches.shape[:2]) != (B, S):
            raise ValueError(f"deep_caches must be [{B}, {S}, h, w, c], got "
                             f"{tuple(deep_caches.shape)}")
    return {
        "frame": _check_frames(spec, frame_u8),
        "context": torch.as_tensor(prompt_embeds),
        "strength": _per_element(strength, B),
        "guidance": _per_element(guidance_scale, B),
        "cn_scale": _per_element(controlnet_scale, B),
        "noise": noise,
        "warm_latents": warm_latents,
        "warm_alpha": warm_alpha,
        "src_box": src_box,
        "deep_caches": deep_caches,
    }


def _staged_dtype(bundle: ModelBundle, name: str, x) -> torch.dtype:
    if name == "context":
        return bundle.dtype
    if name in ("noise", "warm_latents"):
        return torch.float32
    return x.dtype  # frame (uint8), the per-element fp32 scalars, src_box, deep_caches


def _new_buffers(bundle: ModelBundle, spec: FrameSpec, inputs: dict,
                 noise_rows: int | None = None) -> dict:
    """Empty device buffers for ``inputs``, each in its staged dtype; the
    noise buffer [noise_rows (default S+1), B, h, w, 4] always exists."""
    dev = bundle.device
    bufs = {name: None if x is None else torch.empty(x.shape, dtype=_staged_dtype(bundle, name, x),
                                                     device=dev)
            for name, x in inputs.items()}
    bufs["noise"] = torch.empty((noise_rows or spec.steps + 1, spec.batch,
                                 *_latent_hw(bundle, spec), 4), dtype=torch.float32, device=dev)
    return bufs


def _stage(bufs: dict, inputs: dict, seed, batch: int) -> None:
    """Copy a call's inputs into the device buffers and fill the noise:
    the host side of the frame program, where every host-to-device copy and
    every read of the seeds happen."""
    for name, x in inputs.items():
        if x is not None:
            bufs[name].copy_(x)
    if inputs["noise"] is None:
        _draw_noise(torch.as_tensor(seed).reshape(batch).tolist(), bufs["noise"])


def _apply_hook(hook, images):
    """The bundle's safety hook; under a CUDA graph capture a hook that
    syncs with the host or copies from it fails, and the error names it."""
    if not (images.is_cuda and torch.cuda.is_current_stream_capturing()):
        return hook(images)
    try:
        return hook(images)
    except RuntimeError as err:
        raise RuntimeError(f"the bundle's safety_hook {hook!r} failed inside the frame "
                           f"program's CUDA graph capture (a host sync or a host copy?): "
                           f"{err}") from err


def _encode_latents(bundle: ModelBundle, spec: FrameSpec, img_pm1):
    """[B, H, W, 3] images in [-1, 1] -> [B, h, w, 4] latents, through
    TAESD or the KL VAE (scaled by its ``scaling_factor``)."""
    if spec.vae == "kl":
        return _times(vae_encode(bundle.models["vae"], img_pm1), bundle.vae_cfg.scaling_factor)
    return taesd_encode(bundle.models["taesd"], img_pm1, bundle.taesd_cfg)


def _decode_latents(bundle: ModelBundle, spec: FrameSpec, z):
    """The inverse of :func:`_encode_latents`: images in [-1, 1]."""
    if spec.vae == "kl":
        # a true division (torch on CUDA multiplies by the reciprocal of a float)
        return vae_decode(bundle.models["vae"], div_rn(z, bundle.vae_cfg.scaling_factor))
    return taesd_decode(bundle.models["taesd"], z, bundle.taesd_cfg)


def _frame_body(bundle: ModelBundle, spec: FrameSpec, frame, context, strength, guidance,
                cn_scale, noise, warm_latents=None, warm_alpha=None, src_box=None,
                deep_caches=None):
    """The device side of :func:`frame_program`: a function of staged device
    tensors that makes no host sync, no host-to-device copy and allocates no
    host constant, so a CUDA graph can capture it."""
    dtype, S = bundle.dtype, spec.steps
    unet, models = bundle.models["unet"], bundle.models
    cfg = bundle.unet_cfg

    # the stages carry the JAX program's named scopes, as profiler ranges
    # (record_function adds no kernel): the trace by block reads them
    with record_function("preprocess"):
        rgb = i420_to_rgb255(frame) if spec.in_format == "i420" else frame
        if src_box is not None:
            img01 = crop_resize(rgb, src_box, spec.height, spec.width)
        else:
            img01 = preprocess_frame(rgb, spec.height, spec.width)
        ctrl = None
        if spec.use_controlnet:
            ctrl = _nchw(sobel_control_image(img01, spec.canny_low, spec.canny_high).to(dtype))
        img_pm1 = (img01 * 2.0 - 1.0).to(dtype)
    with record_function("vae_encode"):
        latents0 = _encode_latents(bundle, spec, img_pm1)  # [B, h, w, 4]
    if warm_latents is not None:
        a = warm_alpha[:, None, None, None]
        latents0 = ((1.0 - a) * latents0.float() + a * warm_latents).to(latents0.dtype)

    ts, valid = timestep_schedule(bundle.sched_cfg, S, strength, spec.lcm_origin_steps)

    # forward-noise to the first VALID ladder step
    alphas = bundle.alphas_cumprod
    first_idx = valid.to(torch.int32).argmax(dim=1)
    t_first = ts.gather(1, first_idx[:, None])[:, 0]
    latents = add_noise(alphas, latents0, noise[0], t_first)

    w_emb = None
    if cfg.time_cond_proj_dim is not None:
        w_emb = guidance_embedding(guidance, cfg.time_cond_proj_dim).to(dtype)
    denoised = latents0

    cn_interval = max(1, int(spec.controlnet_interval))
    dc_interval = max(1, int(spec.deepcache_interval))
    cn_cache = None  # residuals at the base scale, reused between refreshes
    dc_cache = None  # NCHW deep-trunk feature, reused between refreshes
    temporal_produce = spec.deepcache_temporal and deep_caches is None
    new_caches = []

    def refresh(s: int, k: int) -> bool:
        return s % k == 0 or (spec.interval_refresh_last and s == S - 1)

    for s in range(S):
        t = ts[:, s]
        t_prev = ts[:, s + 1] if s + 1 < S else t
        x = _nchw(latents)
        down_res = mid_res = None
        # the keep-window is all-or-nothing per step, so keep is 1 wherever
        # the ControlNet runs and the base-scale cache is used as it is
        keep = 1.0 - float(
            s / S < spec.control_guidance_start or (s + 1) / S > spec.control_guidance_end
        )
        if spec.use_controlnet and keep > 0.0:
            if cn_interval == 1 or cn_cache is None or refresh(s, cn_interval):
                with record_function("controlnet"):
                    cn_cache = models["controlnet"](
                        x, t, context, ctrl, conditioning_scale=cn_scale, timestep_cond=w_emb,
                    )
            down_res, mid_res = cn_cache
        unet_kw = dict(timestep_cond=w_emb, down_block_additional_residuals=down_res)
        with record_function("unet"):
            if deep_caches is not None:
                # temporal reuse: shallow pass over the carried feature of step
                # s (the mid residual conditions the carried trunk; it is dropped)
                eps = unet(x, t, context, deep_feature=_nchw(deep_caches[:, s]), **unet_kw)
            elif temporal_produce or (dc_interval > 1
                                      and (dc_cache is None or refresh(s, dc_interval))):
                # a full pass that also captures the trunk's output feature
                eps, dc_cache = unet(x, t, context, mid_block_additional_residual=mid_res,
                                     return_deep_feature=True, **unet_kw)
                if temporal_produce:
                    new_caches.append(dc_cache)
            elif dc_interval > 1:
                eps = unet(x, t, context, deep_feature=dc_cache, **unet_kw)
            else:
                eps = unet(x, t, context, mid_block_additional_residual=mid_res, **unet_kw)
        new_lat, new_den = step(
            bundle.sched_cfg, alphas, eps.permute(0, 2, 3, 1), t, t_prev, latents,
            noise=noise[s + 1] if S > 1 else None, multistep=S > 1,
        )
        m = valid[:, s][:, None, None, None]
        latents = torch.where(m, new_lat, latents)
        denoised = torch.where(m, new_den, denoised)

    with record_function("vae_decode"):
        out = _decode_latents(bundle, spec, denoised)
    if bundle.safety_hook is not None:
        with record_function("safety"):
            out = _apply_hook(bundle.safety_hook, out)
    with record_function("postprocess"):
        if temporal_produce:
            caches = torch.stack([f.permute(0, 2, 3, 1) for f in new_caches], dim=1)
            return postprocess_image(out), denoised, caches
        return postprocess_image(out), denoised


@torch.inference_mode()
def frame_program(
    bundle: ModelBundle,
    spec: FrameSpec,
    frame_u8,
    prompt_embeds,
    strength,
    guidance_scale,
    controlnet_scale,
    seed,
    noise=None,
    *,
    warm_latents=None,
    warm_alpha=None,
    pooled_embeds=None,
    src_box=None,
    deep_caches=None,
):
    """One frame batch, run eagerly: staging, then :func:`_frame_body`.

    ``frame_u8``: uint8 [B, Hin, Win, 3], or packed [B, Hin*3//2, Win] for
    ``in_format="i420"``.  ``src_box``: optional [B, 4] int (top, left,
    height, width), the true camera extent inside a mailbox frame, resized
    by ``crop_resize``; without it the whole frame is center-cropped.
    ``prompt_embeds`` [B, 77, D]; ``strength``/``guidance_scale``/
    ``controlnet_scale`` [B] floats, ``seed`` [B] ints.
    ``warm_latents`` [B, h, w, 4] with ``warm_alpha`` [B]: the encoded
    frame becomes ``(1-a)*encoded + a*warm`` (fp32 blend, cast back);
    ``a = 0`` leaves it unchanged.  ``deep_caches`` [B, S, h', w', c']
    (``deepcache_temporal`` only): reuse mode.

    Returns (images_u8 [B,H,W,3], denoised latents [B,h,w,4] in the bundle
    dtype), and in temporal produce mode (``deepcache_temporal`` without
    ``deep_caches``) also the per-step deep features [B, S, h', w', c'].
    """
    _check_spec(bundle, spec)
    inputs = _call_inputs(bundle, spec, frame_u8, prompt_embeds, strength, guidance_scale,
                          controlnet_scale, noise, warm_latents, warm_alpha, pooled_embeds,
                          src_box, deep_caches)
    bufs = _new_buffers(bundle, spec, inputs)
    _stage(bufs, inputs, seed, spec.batch)
    return _frame_body(bundle, spec, **bufs)


def kernel_launches() -> dict:
    """The launch counts of the kernels a frame may run (K1 up to d = 256
    and above it, and K3, each in bf16 and fp32), as their wrappers keep
    them."""
    return {"flash_attention": flash_attention.launches,
            "flash_attention_fp32": flash_attention.launches_fp32,
            "flash_attention_wide": flash_attention.launches_wide,
            "flash_attention_wide_fp32": flash_attention.launches_wide_fp32,
            "taesd_conv3x3": taesd_conv.launches,
            "taesd_conv3x3_fp32": taesd_conv.launches_fp32}


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """The one side stream of ``device`` that every warm-up and capture runs
    on (as ``torch.cuda.graph``'s default capture stream): its library
    handles and cached blocks serve every bucket."""
    return torch.cuda.Stream(device)


@functools.lru_cache(maxsize=None)
def _capture_lock(device: torch.device):
    """One warm-up and capture at a time on ``device``: they share its side
    stream, and a serving engine captures on background threads."""
    return threading.Lock()


_GRAPH_POOLS: dict = {}


def _graph_pool(device: torch.device):
    """The memory pool every CUDA graph on ``device`` captures into (call
    under :func:`_capture_lock`).  Graphs that share a pool may reuse each
    other's intermediate blocks, which is safe because every program
    replays on its caller's stream and clones its outputs right after the
    replay, in stream order, before any other graph can run: no two replays
    overlap, and no replay's static outputs are read after another replay.

    The pool is kept alive by a graph of its own: the allocators drop a
    pool when its last graph dies, and capturing into a dropped pool's
    handle fails.  A failed capture retires the pool
    (:meth:`_Bucket._capture`)."""
    entry = _GRAPH_POOLS.get(device)
    if entry is None:
        handle, keeper = torch.cuda.graph_pool_handle(), torch.cuda.CUDAGraph()
        with torch.cuda.stream(_capture_stream(device)):
            keeper.capture_begin(pool=handle, capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            keeper.capture_end()
        entry = _GRAPH_POOLS[device] = (handle, keeper)
    return entry[0]


class _Bucket:
    """One call signature of a program: its static input buffers and, on a
    CUDA bundle, the CUDA graph of ``body(**buffers)`` captured over them
    and its static outputs."""

    def __init__(self, bundle: ModelBundle, buffers: dict, body):
        self.bundle, self.buffers, self.body = bundle, buffers, body
        self.graph = self.outputs = None
        self.launches = dict.fromkeys(kernel_launches(), 0)
        self.capture_s = 0.0  # wall time of the warm-up and the capture

    def run(self) -> tuple:
        if self.bundle.device.type != "cuda":
            return self.body(**self.buffers)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.outputs

    def _capture(self) -> None:
        """Warm up eagerly on a side stream (library plans and handles, K1's
        library and tensor maps, K3's taps, the resize matrices: every cache
        built at first use), then capture the body on that stream, into the
        device's shared pool (:func:`_graph_pool`).  The capture is in
        ``thread_local`` mode and makes no device-wide sync, so another
        thread may replay other graphs meanwhile.  A fault raises; nothing
        falls back to the eager program."""
        dev = self.bundle.device
        t0 = time.perf_counter()
        side = _capture_stream(dev)
        with _capture_lock(dev):
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.body(**self.buffers)
                side.synchronize()
                gc.collect()  # no tensor of the warm-up is freed by the collector mid-capture
                before = kernel_launches()
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=_graph_pool(dev), capture_error_mode="thread_local")
                try:
                    outputs = self.body(**self.buffers)
                except BaseException:
                    # the fault invalidated the capture, so ending it fails too,
                    # and the allocator then never stops recording into the
                    # pool: later captures take a new one
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    _GRAPH_POOLS.pop(dev, None)
                    raise
                graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.launches = {k: n - before[k] for k, n in kernel_launches().items()}
        self.graph, self.outputs = graph, outputs
        self.capture_s = time.perf_counter() - t0


class _Program:
    """The calling convention of :class:`FrameProgram` and the reference
    program: a bucket per call signature, staged inputs, cloned outputs.
    Subclasses give ``_body(bundle, spec, **buffers)`` and the rows of
    their noise buffer beyond the frame's S+1 (``extra_noise_rows``)."""

    extra_noise_rows = 0

    def __init__(self, bundle: ModelBundle, spec: FrameSpec):
        self.bundle, self.spec = bundle, spec
        self.buckets: dict = {}
        self.last_launches: dict | None = None

    def _run(self, inputs: dict, seed) -> tuple:
        """``inputs``: a call's checked inputs, named as the body's arguments."""
        key = tuple((name, tuple(x.shape), _staged_dtype(self.bundle, name, x))
                    for name, x in inputs.items() if x is not None and name != "noise")
        bucket = self.buckets.get(key)
        if bucket is None:
            rows = self.spec.steps + 1 + self.extra_noise_rows
            bucket = self.buckets[key] = _Bucket(
                self.bundle, _new_buffers(self.bundle, self.spec, inputs, rows),
                functools.partial(self._body, self.bundle, self.spec))
        with record_function("stage"):
            _stage(bucket.buffers, inputs, seed, self.spec.batch)
        outputs = bucket.run()
        self.last_launches = bucket.launches
        return tuple(x.clone() for x in outputs)


class FrameProgram(_Program):
    """The frame program of one (bundle, spec) bucket, the port's
    counterpart of the JAX package's jitted ``build_frame_program``.

    Each call signature (which optional inputs are given, with their shapes
    and dtypes: warm start, ``src_box``, temporal reuse) has its own static
    device buffers.  A call checks its inputs, copies them into those
    buffers and draws the noise there (:func:`_stage`), then runs
    :func:`_frame_body` over them: on a CUDA bundle by replaying the CUDA
    graph captured at the signature's first call, on any other device
    eagerly.  It returns new tensors (clones of the body's outputs), so a
    later call never overwrites an earlier call's results.  Calls are
    ordered on the caller's current stream; the first call of a signature
    also warms up and captures (``bucket.capture_s``).

    ``last_launches``: the kernel launches of one call of the signature the
    last call ran (:func:`kernel_launches`' names), counted while its graph
    was captured; a replay calls no wrapper, so the wrappers' own counts
    move only at capture.
    """

    _body = staticmethod(_frame_body)

    def __init__(self, bundle: ModelBundle, spec: FrameSpec):
        _check_spec(bundle, spec)
        super().__init__(bundle, spec)

    @torch.inference_mode()
    def __call__(self, frame_u8, prompt_embeds, strength, guidance, cn_scale, seed, noise=None,
                 *, warm_latents=None, warm_alpha=None, pooled_embeds=None, src_box=None,
                 deep_caches=None):
        inputs = _call_inputs(self.bundle, self.spec, frame_u8, prompt_embeds, strength,
                              guidance, cn_scale, noise, warm_latents, warm_alpha, pooled_embeds,
                              src_box, deep_caches)
        return self._run(inputs, seed)


def build_frame_program(bundle: ModelBundle, spec: FrameSpec) -> FrameProgram:
    """Check ``spec`` against what the port runs and return
    ``f(frame_u8, prompt_embeds, strength, guidance, cn_scale, seed,
    noise=None, *, warm_latents, warm_alpha, pooled_embeds, src_box,
    deep_caches)`` -> ``(images_u8, denoised_latents[, deep_caches])``: the
    JAX program's arguments without its ``params`` (the models live on the
    bundle), plus the noise seam.  On a CUDA bundle each call signature is
    one CUDA graph, captured at its first call (:class:`FrameProgram`)."""
    return FrameProgram(bundle, spec)


def build_prompt_encoder(bundle: ModelBundle):
    """``input_ids [B, 77] -> (context [B,77,D], pooled [B,D])`` on the
    bundle's device."""
    clip = bundle.models["clip"]

    @torch.inference_mode()
    def encode(input_ids):
        return clip(torch.as_tensor(input_ids).to(bundle.device))

    return encode
