"""The per-frame LCM img2img (+ControlNet) program on PyTorch.

Counterpart of ``videosd_tpu/pipelines/lcm_img2img.py`` on its parity
path.  The chain after prompt encoding, per frame:

    preprocess (crop, [0,1]) -> Sobel control image -> TAESD encode ->
    add_noise at the first valid ladder step -> S x (ControlNet + UNet +
    LCM step) -> TAESD decode -> uint8 postprocess

``strength``, ``guidance_scale``, ``controlnet_scale`` and ``seed`` are
per batch element, as in the JAX program: each element follows its own
masked timestep ladder.  Random numbers enter through one seam: ``noise``
of shape ``[S+1, B, h, w, 4]``, row 0 for the forward noise and row s+1
for the re-noise of step s.  Without it, each element's rows are drawn
from a ``torch.Generator`` seeded with that element's seed; these are not
JAX's threefry bits, so the tests feed JAX's noise through the seam.

The program runs eagerly; convs, GEMMs and norms are library calls, and
the long self-attentions go to kernel K1 (``ops/cuda/flash_attention.py``).
TAESD follows ``bundle.taesd_cfg``; the ``taesd_pallas`` path of the JAX
server sends its residual-block convs to kernel K3
(``ops/cuda/taesd_conv.py``)::

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
from videosd_tpu_torch.ops.preprocess import postprocess_image, preprocess_frame
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
    """Static shape and schedule of one frame-program bucket (the fields of
    the JAX ``FrameSpec``; those outside the parity path raise in
    :func:`build_frame_program`)."""

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


# FrameSpec fields whose non-default values the port does not run yet
_PARITY_ONLY = {
    "in_format": "rgb",
    "vae": "taesd",
    "controlnet_interval": 1,
    "deepcache_interval": 1,
    "deepcache_temporal": False,
    "interval_refresh_last": False,
}


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
    # the JAX bundle's post-decode safety hook; not ported
    safety_hook: Any = None

    @classmethod
    def random(
        cls,
        family: str = "sd15",
        *,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device="cpu",
        with_controlnet: bool = True,
    ) -> "ModelBundle":
        """Randomly initialized bundle, drawn with the JAX init rule from a
        ``torch.Generator`` seeded with ``seed`` (not the JAX values)."""
        if family not in UNET_PRESETS:
            raise NotImplementedError(f"family {family!r} is not ported yet")
        device = torch.device(device)
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
        cls, family: str, state_dicts: dict, *, dtype=torch.float32, device="cpu"
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
    def from_dir(cls, path: str, *, dtype=None, device="cpu") -> "ModelBundle":
        """Load a ``bundle.json`` checkpoint directory (e.g. the committed
        ``examples/toy_tiny_ckpt``).  ``dtype=None`` picks fp32 for tiny
        families and bf16 otherwise, like the JAX loader."""
        family, state_dicts = load_bundle_dir(path)
        if dtype is None:
            dtype = torch.float32 if family.startswith("tiny") else torch.bfloat16
        return cls.from_state_dicts(family, state_dicts, dtype=dtype, device=device)


def _check_spec(bundle: ModelBundle, spec: FrameSpec) -> None:
    for name, parity in _PARITY_ONLY.items():
        if getattr(spec, name) != parity:
            raise NotImplementedError(f"FrameSpec.{name}={getattr(spec, name)!r} is not ported yet")
    if bundle.safety_hook is not None:
        raise NotImplementedError("ModelBundle.safety_hook is not ported yet")
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
    """One frame batch: ``frame_u8`` [B, Hin, Win, 3] uint8, ``prompt_embeds``
    [B, 77, D]; ``strength``/``guidance_scale``/``controlnet_scale`` [B]
    floats, ``seed`` [B] ints.  Returns (images_u8 [B,H,W,3], denoised
    latents [B,h,w,4] in the bundle dtype)."""
    for name, val in (("warm_latents", warm_latents), ("warm_alpha", warm_alpha),
                      ("pooled_embeds", pooled_embeds), ("src_box", src_box),
                      ("deep_caches", deep_caches)):
        if val is not None:
            raise NotImplementedError(f"frame_program({name}=...) is not ported yet")
    dev, dtype = bundle.device, bundle.dtype
    B, S = spec.batch, spec.steps
    frame_u8 = torch.as_tensor(frame_u8).to(dev)
    if frame_u8.shape[0] != B or frame_u8.dtype != torch.uint8:
        raise ValueError(f"expected uint8 frames with batch {B}, got {frame_u8.dtype} "
                         f"{tuple(frame_u8.shape)}")
    strength = _per_element(strength, B, torch.float32, dev)
    guidance_scale = _per_element(guidance_scale, B, torch.float32, dev)
    controlnet_scale = _per_element(controlnet_scale, B, torch.float32, dev)
    unet, models = bundle.models["unet"], bundle.models
    cfg = bundle.unet_cfg

    img01 = preprocess_frame(frame_u8, spec.height, spec.width)
    ctrl = None
    if spec.use_controlnet:
        ctrl = _nchw(sobel_control_image(img01, spec.canny_low, spec.canny_high).to(dtype))
    img_pm1 = (img01 * 2.0 - 1.0).to(dtype)
    latents0 = taesd_encode(models["taesd"], img_pm1, bundle.taesd_cfg)  # [B, h, w, 4]

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

    for s in range(S):
        t = ts[:, s]
        t_prev = ts[:, s + 1] if s + 1 < S else t
        x = _nchw(latents)
        down_res = mid_res = None
        keep = 1.0 - float(
            s / S < spec.control_guidance_start or (s + 1) / S > spec.control_guidance_end
        )
        if spec.use_controlnet and keep > 0.0:
            down_res, mid_res = models["controlnet"](
                x, t, context, ctrl, conditioning_scale=controlnet_scale * keep,
                timestep_cond=w_emb,
            )
        eps = unet(
            x, t, context, timestep_cond=w_emb,
            down_block_additional_residuals=down_res, mid_block_additional_residual=mid_res,
        ).permute(0, 2, 3, 1)
        new_lat, new_den = step(
            bundle.sched_cfg, alphas, eps, t, t_prev, latents,
            noise=noise[s + 1] if S > 1 else None, multistep=S > 1,
        )
        m = valid[:, s][:, None, None, None]
        latents = torch.where(m, new_lat, latents)
        denoised = torch.where(m, new_den, denoised)

    out = taesd_decode(models["taesd"], denoised, bundle.taesd_cfg)
    return postprocess_image(out), denoised


def build_frame_program(bundle: ModelBundle, spec: FrameSpec):
    """Check ``spec`` against what the port runs and return
    ``f(frame_u8, prompt_embeds, strength, guidance, controlnet_scale, seed,
    noise=None) -> (images_u8, denoised_latents)``."""
    _check_spec(bundle, spec)

    def program(frame_u8, prompt_embeds, strength, guidance, cn_scale, seed, noise=None,
                **unported):
        return frame_program(bundle, spec, frame_u8, prompt_embeds, strength, guidance,
                             cn_scale, seed, noise, **unported)

    return program


def build_prompt_encoder(bundle: ModelBundle):
    """``input_ids [B, 77] -> (context [B,77,D], pooled [B,D])`` on the
    bundle's device."""
    clip = bundle.models["clip"]

    @torch.inference_mode()
    def encode(input_ids):
        return clip(torch.as_tensor(input_ids).to(bundle.device))

    return encode
