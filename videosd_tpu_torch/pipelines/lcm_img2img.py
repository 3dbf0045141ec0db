"""The per-frame LCM img2img (+ControlNet) program on PyTorch.

Counterpart of ``videosd_tpu/pipelines/lcm_img2img.py``.  The chain after
prompt encoding, per frame:

    unpack I420 (optional) -> crop (the engine's per-element ``src_box``
    through lanczos3 ``crop_resize``, or the static center crop) ->
    Sobel control image -> TAESD encode -> warm-start blend (optional) ->
    add_noise at the first valid ladder step -> S x (ControlNet + UNet +
    LCM step) -> TAESD decode -> safety hook (optional) -> uint8

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

The program runs eagerly; convs, GEMMs and norms are library calls, and
the long self-attentions go to kernel K1 (``ops/cuda/flash_attention.py``)
on every UNet pass, full or shallow, and every ControlNet call.  TAESD
follows ``bundle.taesd_cfg``; the ``taesd_pallas`` path of the JAX server
sends its residual-block convs to kernel K3 (``ops/cuda/taesd_conv.py``)::

    bundle = dataclasses.replace(
        bundle, taesd_cfg=dataclasses.replace(bundle.taesd_cfg, pallas_convs=True))
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from videosd_tpu_torch.io.weights import load_bundle_dir
from videosd_tpu_torch.models.clip_text import CLIP_PRESETS, CLIPTextConfig, CLIPTextModel
from videosd_tpu_torch.models.controlnet import ControlNetModel
from videosd_tpu_torch.models.layers import guidance_embedding
from videosd_tpu_torch.models.taesd import AutoencoderTiny, TAESDConfig, taesd_decode, taesd_encode
from videosd_tpu_torch.models.unet import UNET_PRESETS, UNet2DConditionModel, UNetConfig
from videosd_tpu_torch.ops.preprocess import (
    crop_resize,
    i420_to_rgb255,
    postprocess_image,
    preprocess_frame,
)
from videosd_tpu_torch.ops.sobel import sobel_control_image
from videosd_tpu_torch.schedulers.lcm import (
    LCMSchedulerConfig,
    add_noise,
    make_alphas_cumprod,
    step,
    timestep_schedule,
)
from videosd_tpu_torch.text.tokenizer import CLIPTokenizer, find_vocab_dir

__all__ = ["FrameSpec", "ModelBundle", "build_frame_program", "build_prompt_encoder"]


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """Static shape and schedule of one frame-program bucket: the fields of
    the JAX ``FrameSpec``, with its meanings (``vae="kl"`` is not ported
    and raises in :func:`build_frame_program`)."""

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
    models: dict  # {"unet", "controlnet", "taesd", "clip"} -> nn.Module
    alphas_cumprod: torch.Tensor
    tokenizer: CLIPTokenizer
    taesd_cfg: TAESDConfig
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
    ) -> "ModelBundle":
        """Randomly initialized bundle, drawn with the JAX init rule from a
        ``torch.Generator`` seeded with ``seed`` (not the JAX values)."""
        if family not in UNET_PRESETS:
            raise NotImplementedError(f"family {family!r} is not ported yet")
        device = _resolve_device(device)
        unet_cfg = UNET_PRESETS[family]
        clip_cfg = CLIP_PRESETS[family]
        taesd_cfg = (
            TAESDConfig(hidden=16, blocks_per_stage=1) if family == "tiny" else TAESDConfig()
        )
        gen = torch.Generator(device=device).manual_seed(seed)
        models = {"unet": _empty_module(lambda: UNet2DConditionModel(unet_cfg), dtype, device)}
        init_like_jax(models["unet"], gen)
        if with_controlnet:
            cn = _empty_module(lambda: ControlNetModel(unet_cfg), dtype, device)
            init_like_jax(cn, gen, ControlNetModel.ZERO_INIT)
            models["controlnet"] = cn
        models["taesd"] = _empty_module(lambda: AutoencoderTiny(taesd_cfg), dtype, device)
        init_like_jax(models["taesd"], gen)
        clip = _empty_module(lambda: CLIPTextModel(clip_cfg), dtype, device)
        init_like_jax(clip, gen)
        emb = clip.text_model.embeddings
        for table, std in ((emb.token_embedding, 0.02), (emb.position_embedding, 0.01)):
            with torch.no_grad():
                table.weight.copy_(
                    torch.randn(table.weight.shape, generator=gen, device=device) * std
                )
        models["clip"] = clip
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
                            with_controlnet="controlnet" in state_dicts)
        for name, sd in state_dicts.items():
            if name not in bundle.models:
                raise KeyError(f"no model {name!r} in a {family} bundle")
            bundle.models[name].load_state_dict(sd, strict=True)
        return bundle

    @classmethod
    def from_dir(cls, path: str, *, dtype=None, device="cuda") -> "ModelBundle":
        """Load a ``bundle.json`` checkpoint directory (e.g. the committed
        ``examples/toy_tiny_ckpt``).  ``dtype=None`` picks fp32 for tiny
        families and bf16 otherwise, like the JAX loader."""
        family, state_dicts = load_bundle_dir(path)
        if dtype is None:
            dtype = torch.float32 if family.startswith("tiny") else torch.bfloat16
        return cls.from_state_dicts(family, state_dicts, dtype=dtype, device=device)


def _check_spec(bundle: ModelBundle, spec: FrameSpec) -> None:
    if spec.vae != "taesd":
        raise NotImplementedError(f"FrameSpec.vae={spec.vae!r} is not ported yet")
    if spec.in_format not in ("rgb", "i420"):
        raise ValueError(f"FrameSpec.in_format must be rgb or i420, got {spec.in_format!r}")
    if spec.deepcache_temporal and spec.deepcache_interval > 1:
        raise ValueError(
            "deepcache_temporal is mutually exclusive with "
            "deepcache_interval>1 (per-step vs carried trunk caches)"
        )
    if spec.use_controlnet and "controlnet" not in bundle.models:
        raise ValueError("spec.use_controlnet needs a bundle with a ControlNet")


def _per_element(x, batch: int, dtype, device):
    return torch.as_tensor(x, dtype=dtype).to(device).reshape(batch)


def _seeded_noise(seeds, steps: int, latent_shape, device):
    """[S+1, B, h, w, 4] fp32: element b's rows from a generator seeded with
    ``seeds[b]``."""
    out = torch.empty((steps + 1, len(seeds), *latent_shape), dtype=torch.float32, device=device)
    for b, s in enumerate(seeds):
        g = torch.Generator(device=device).manual_seed(int(s))
        out[:, b] = torch.randn((steps + 1, *latent_shape), generator=g, device=device)
    return out


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _load_frames(spec: FrameSpec, frame_u8, dev):
    """Check the upload layout and move it to ``dev``: [B, Hin, Win, 3]
    for rgb, packed [B, Hin*3//2, Win] for i420."""
    B = spec.batch
    frame_u8 = torch.as_tensor(frame_u8).to(dev)
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
    """One frame batch.

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
    if pooled_embeds is not None:
        raise NotImplementedError("frame_program(pooled_embeds=...) (SDXL) is not ported yet")
    dev, dtype = bundle.device, bundle.dtype
    B, S = spec.batch, spec.steps
    frame_u8 = _load_frames(spec, frame_u8, dev)
    strength = _per_element(strength, B, torch.float32, dev)
    guidance_scale = _per_element(guidance_scale, B, torch.float32, dev)
    controlnet_scale = _per_element(controlnet_scale, B, torch.float32, dev)
    unet, models = bundle.models["unet"], bundle.models
    cfg = bundle.unet_cfg

    frame = i420_to_rgb255(frame_u8) if spec.in_format == "i420" else frame_u8
    if src_box is not None:
        img01 = crop_resize(frame, src_box, spec.height, spec.width)
    else:
        img01 = preprocess_frame(frame, spec.height, spec.width)
    ctrl = None
    if spec.use_controlnet:
        ctrl = _nchw(sobel_control_image(img01, spec.canny_low, spec.canny_high).to(dtype))
    img_pm1 = (img01 * 2.0 - 1.0).to(dtype)
    latents0 = taesd_encode(models["taesd"], img_pm1, bundle.taesd_cfg)  # [B, h, w, 4]
    if warm_latents is not None:
        if warm_alpha is None:
            raise ValueError("warm_latents needs warm_alpha")
        a = _per_element(warm_alpha, B, torch.float32, dev)[:, None, None, None]
        warm = torch.as_tensor(warm_latents).to(dev, torch.float32)
        latents0 = ((1.0 - a) * latents0.float() + a * warm).to(latents0.dtype)

    ts, valid = timestep_schedule(bundle.sched_cfg, S, strength, spec.lcm_origin_steps)
    if noise is None:
        seeds = torch.as_tensor(seed).reshape(B).tolist()
        noise = _seeded_noise(seeds, S, latents0.shape[1:], dev)
    else:
        noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)
        if tuple(noise.shape) != (S + 1, *latents0.shape):
            raise ValueError(f"noise must be {(S + 1, *latents0.shape)}, got {tuple(noise.shape)}")

    # forward-noise to the first VALID ladder step
    alphas = bundle.alphas_cumprod
    first_idx = valid.to(torch.int32).argmax(dim=1)
    t_first = ts.gather(1, first_idx[:, None])[:, 0]
    latents = add_noise(alphas, latents0, noise[0], t_first)

    w_emb = None
    if cfg.time_cond_proj_dim is not None:
        w_emb = guidance_embedding(guidance_scale, cfg.time_cond_proj_dim).to(dtype)
    context = prompt_embeds.to(dev, dtype)
    denoised = latents0

    cn_interval = max(1, int(spec.controlnet_interval))
    dc_interval = max(1, int(spec.deepcache_interval))
    cn_cache = None  # residuals at the base scale, reused between refreshes
    dc_cache = None  # NCHW deep-trunk feature, reused between refreshes
    if deep_caches is not None:
        if not spec.deepcache_temporal:
            raise ValueError("deep_caches needs FrameSpec.deepcache_temporal")
        deep_caches = torch.as_tensor(deep_caches).to(dev)
        if tuple(deep_caches.shape[:2]) != (B, S):
            raise ValueError(f"deep_caches must be [{B}, {S}, h, w, c], got "
                             f"{tuple(deep_caches.shape)}")
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
                cn_cache = models["controlnet"](
                    x, t, context, ctrl, conditioning_scale=controlnet_scale,
                    timestep_cond=w_emb,
                )
            down_res, mid_res = cn_cache
        unet_kw = dict(timestep_cond=w_emb, down_block_additional_residuals=down_res)
        if deep_caches is not None:
            # temporal reuse: shallow pass over the carried feature of step s
            # (the mid residual conditions the carried trunk; it is dropped)
            eps = unet(x, t, context, deep_feature=_nchw(deep_caches[:, s]), **unet_kw)
        elif temporal_produce or (dc_interval > 1 and (dc_cache is None or refresh(s, dc_interval))):
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

    out = taesd_decode(models["taesd"], denoised, bundle.taesd_cfg)
    if bundle.safety_hook is not None:
        out = bundle.safety_hook(out)
    if temporal_produce:
        caches = torch.stack([f.permute(0, 2, 3, 1) for f in new_caches], dim=1)
        return postprocess_image(out), denoised, caches
    return postprocess_image(out), denoised


def build_frame_program(bundle: ModelBundle, spec: FrameSpec):
    """Check ``spec`` against what the port runs and return
    ``f(frame_u8, prompt_embeds, strength, guidance, cn_scale, seed,
    noise=None, *, warm_latents, warm_alpha, pooled_embeds, src_box,
    deep_caches)`` -> ``(images_u8, denoised_latents[, deep_caches])``: the
    JAX program's arguments without its ``params`` (the models live on the
    bundle), plus the noise seam."""
    _check_spec(bundle, spec)

    def program(frame_u8, prompt_embeds, strength, guidance, cn_scale, seed, noise=None, *,
                warm_latents=None, warm_alpha=None, pooled_embeds=None, src_box=None,
                deep_caches=None):
        return frame_program(
            bundle, spec, frame_u8, prompt_embeds, strength, guidance, cn_scale, seed, noise,
            warm_latents=warm_latents, warm_alpha=warm_alpha, pooled_embeds=pooled_embeds,
            src_box=src_box, deep_caches=deep_caches,
        )

    return program


def build_prompt_encoder(bundle: ModelBundle):
    """``input_ids [B, 77] -> (context [B,77,D], pooled [B,D])`` on the
    bundle's device."""
    clip = bundle.models["clip"]

    @torch.inference_mode()
    def encode(input_ids):
        return clip(torch.as_tensor(input_ids).to(bundle.device))

    return encode
