"""Reference-attention ("reference-only") style-transfer frame program.

Counterpart of ``videosd_tpu/pipelines/reference_attn.py``.  Each denoise
step runs the UNet twice: a WRITE pass on the reference image, noised to
the step's timestep, banks every self-attention's normed input
(``bank_out``) and the GroupNorm-style statistics after every
resnet(+attention) pair (:class:`AdainBank`); the READ pass on the frame's
latents attends over its own tokens and the banked ones
(:class:`~videosd_tpu_torch.models.unet.BankReader`) and AdaIN-matches its
activations to the banked statistics.

``style_fidelity`` blends, in fp32, the banked and the plain
self-attention outputs, and the AdaIN-styled and the raw activations: 0 is
the plain (no-ControlNet) frame program exactly, 1 the full reference.  It
is [B] (one blend for both mechanisms) or [B, 2] (attention fidelity,
AdaIN fidelity; a mechanism switched off is fidelity 0).

Random numbers enter through one seam as in the frame program: ``noise``
[S+1, B, h, w, 4] (row 0 the forward noise, row s+1 step s's re-noise) and
``ref_noise`` [B, h, w, 4], the ONE tensor the reference image is re-noised
with at every step (the JAX program's ``fold_in(key, 0)``, ``fold_in(key,
s+1)`` and ``fold_in(key, 10_000)`` draws).  Without them each element's
rows come from a ``torch.Generator`` seeded with its seed.

:func:`build_reference_program` returns a program with the conventions of
``FrameProgram``: one CUDA graph per call signature, captured at its first
call on a CUDA bundle (eager elsewhere), static buffers, clones out, and
``last_launches`` counted at capture.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from videosd_tpu_torch.models.layers import guidance_embedding
from videosd_tpu_torch.models.unet import BankReader
from videosd_tpu_torch.ops.preprocess import (
    crop_resize,
    i420_to_rgb255,
    postprocess_image,
    preprocess_frame,
)
from videosd_tpu_torch.pipelines.lcm_img2img import (
    FrameSpec,
    ModelBundle,
    _check_frames,
    _check_spec,
    _decode_latents,
    _encode_latents,
    _latent_hw,
    _nchw,
    _new_buffers,
    _per_element,
    _Program,
    _stage,
)
from videosd_tpu_torch.schedulers.lcm import add_noise, step, timestep_schedule

__all__ = ["AdainBank", "ReferenceProgram", "build_reference_program",
           "reference_frame_program"]


class AdainBank:
    """Ordered bank of per-channel activation statistics (NCHW).

    ``write`` records (mean, std) over the spatial dims (2, 3) of each call
    site in fp32 and passes the activations through; ``read`` re-normalizes
    the activations to the recorded statistics, blended with the raw ones
    by ``fidelity`` ([B, 1, 1, 1] or a scalar).  The variance is the
    population one (``jnp.var``'s ddof = 0, ``correction=0`` here), and
    std = sqrt(var + eps).
    """

    def __init__(self, mode: str, stats=None, fidelity=1.0, eps: float = 1e-5):
        if mode not in ("write", "read", "off"):
            raise ValueError(f"AdainBank mode must be write, read or off, got {mode!r}")
        self.mode = mode
        self.stats = list(stats) if stats is not None else []
        self.fidelity = fidelity
        self.eps = eps
        self._i = 0

    def __call__(self, x):
        if self.mode == "off":
            return x
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), keepdim=True, correction=0)
        std = torch.sqrt(var + self.eps)
        if self.mode == "write":
            self.stats.append((mean, std))
            return x
        ref_mean, ref_std = self.stats[self._i]
        self._i += 1
        styled = ((xf - mean) / std) * ref_std + ref_mean
        out = self.fidelity * styled + (1.0 - self.fidelity) * xf
        return out.to(x.dtype)


def _check_ref_spec(bundle: ModelBundle, spec: FrameSpec) -> None:
    # the reference mode runs no ControlNet and no interval caches (the
    # JAX program ignores those fields); the rest is checked as the frame
    # program checks it
    _check_spec(bundle, dataclasses.replace(
        spec, use_controlnet=False, deepcache_temporal=False, deepcache_interval=1))


def _ref_inputs(bundle: ModelBundle, spec: FrameSpec, frame_u8, ref_u8, prompt_embeds,
                strength, guidance, style_fidelity, noise, ref_noise, pooled_embeds, src_box,
                ref_box) -> dict:
    """Check one call's inputs: ``{name: tensor or None}`` named and ordered
    as :func:`_reference_body`'s arguments (``noise`` holds the frame's
    S+1 rows and the reference's one, or None: drawn from the seeds)."""
    if pooled_embeds is not None:
        raise NotImplementedError("the reference program's pooled_embeds (SDXL) is not ported yet")
    B, S = spec.batch, spec.steps
    latent = (B, *_latent_hw(bundle, spec), 4)
    if (noise is None) != (ref_noise is None):
        raise ValueError("pass noise and ref_noise together, or neither")
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=torch.float32)
        ref_noise = torch.as_tensor(ref_noise, dtype=torch.float32)
        if tuple(noise.shape) != (S + 1, *latent) or tuple(ref_noise.shape) != latent:
            raise ValueError(f"noise must be {(S + 1, *latent)} and ref_noise {latent}, got "
                             f"{tuple(noise.shape)} and {tuple(ref_noise.shape)}")
        noise = torch.cat([noise, ref_noise[None].to(noise.device)])
    ref = torch.as_tensor(ref_u8)
    if ref.ndim != 4 or ref.shape[0] != B or ref.shape[3] != 3 or ref.dtype != torch.uint8:
        raise ValueError(f"expected rgb uint8 reference frames ({B}, H, W, 3), got {ref.dtype} "
                         f"{tuple(ref.shape)}")
    sf = torch.as_tensor(style_fidelity, dtype=torch.float32)
    if tuple(sf.shape) not in ((B,), (B, 2)):
        raise ValueError(f"style_fidelity must be [{B}] or [{B}, 2], got {tuple(sf.shape)}")
    boxes = {}
    for name, box in (("src_box", src_box), ("ref_box", ref_box)):
        if box is not None:
            box = torch.as_tensor(box)
            if tuple(box.shape) != (B, 4):
                raise ValueError(f"{name} must be [{B}, 4], got {tuple(box.shape)}")
        boxes[name] = box
    return {
        "frame": _check_frames(spec, frame_u8),
        "ref": ref,
        "context": torch.as_tensor(prompt_embeds),
        "strength": _per_element(strength, B),
        "guidance": _per_element(guidance, B),
        "sf": sf,
        "noise": noise,
        **boxes,
    }


def _to01(spec: FrameSpec, rgb, box):
    if box is not None:
        return crop_resize(rgb, box, spec.height, spec.width)
    return preprocess_frame(rgb, spec.height, spec.width)


def _reference_body(bundle: ModelBundle, spec: FrameSpec, frame, ref, context, strength,
                    guidance, sf, noise, src_box=None, ref_box=None):
    """The device side of :func:`reference_frame_program`, capturable as
    ``lcm_img2img._frame_body`` is (no host sync, no host copy).  ``noise``
    is [S+2, B, h, w, 4]: the frame's S+1 rows, then the reference's."""
    dtype, S = bundle.dtype, spec.steps
    unet, cfg = bundle.models["unet"], bundle.unet_cfg
    alphas = bundle.alphas_cumprod

    # camera frames may arrive packed 4:2:0; the style reference is RGB
    with record_function("preprocess"):
        rgb = i420_to_rgb255(frame) if spec.in_format == "i420" else frame
        img_pm1 = (_to01(spec, rgb, src_box) * 2.0 - 1.0).to(dtype)
        ref_pm1 = (_to01(spec, ref, ref_box) * 2.0 - 1.0).to(dtype)
    with record_function("vae_encode"):
        latents0 = _encode_latents(bundle, spec, img_pm1)
        ref_lat0 = _encode_latents(bundle, spec, ref_pm1)

    ts, valid = timestep_schedule(bundle.sched_cfg, S, strength, spec.lcm_origin_steps)
    first_idx = valid.to(torch.int32).argmax(dim=1)
    t_first = ts.gather(1, first_idx[:, None])[:, 0]
    latents = add_noise(alphas, latents0, noise[0], t_first)
    ref_noise = noise[S + 1]  # one tensor, re-noised to every step's t

    w_emb = None
    if cfg.time_cond_proj_dim is not None:
        w_emb = guidance_embedding(guidance, cfg.time_cond_proj_dim).to(dtype)
    context = context.to(dtype)
    sf_attn, sf_adain = (sf[:, 0], sf[:, 1]) if sf.ndim == 2 else (sf, sf)
    denoised = latents0

    for s in range(S):
        t = ts[:, s]
        t_prev = ts[:, s + 1] if s + 1 < S else t
        ref_xt = add_noise(alphas, ref_lat0, ref_noise, t)
        # WRITE pass: bank the self-attention tokens and the statistics
        bank_out: list = []
        adain_w = AdainBank("write")
        with record_function("unet"):
            unet(_nchw(ref_xt), t, context, timestep_cond=w_emb, bank_out=bank_out,
                 adain=adain_w)
            # READ pass on the frame's latents
            bank = BankReader([b.to(dtype) for b in bank_out], fidelity=sf_attn[:, None, None])
            adain_r = AdainBank("read", stats=adain_w.stats,
                                fidelity=sf_adain[:, None, None, None])
            eps = unet(_nchw(latents), t, context, timestep_cond=w_emb, bank=bank, adain=adain_r)
        new_lat, new_den = step(
            bundle.sched_cfg, alphas, eps.permute(0, 2, 3, 1), t, t_prev, latents,
            noise=noise[s + 1] if S > 1 else None, multistep=S > 1,
        )
        m = valid[:, s][:, None, None, None]
        latents = torch.where(m, new_lat, latents)
        denoised = torch.where(m, new_den, denoised)

    with record_function("vae_decode"):
        out = _decode_latents(bundle, spec, denoised)
    with record_function("postprocess"):
        return postprocess_image(out), denoised


@torch.inference_mode()
def reference_frame_program(bundle: ModelBundle, spec: FrameSpec, frame_u8, ref_frame_u8,
                            prompt_embeds, strength, guidance_scale, style_fidelity, seed,
                            noise=None, ref_noise=None, *, pooled_embeds=None, src_box=None,
                            ref_box=None):
    """One reference-mode frame batch, run eagerly.

    ``frame_u8`` as the frame program's (RGB, or packed I420 with
    ``in_format="i420"``); ``ref_frame_u8`` [B, H, W, 3] uint8, the style
    reference; ``src_box``/``ref_box`` optional [B, 4] (top, left, height,
    width) extents of the camera frame and of the reference inside their
    frames, resized by ``crop_resize``.  ``style_fidelity`` [B] or [B, 2].
    No ControlNet runs in this mode.  Returns (images_u8 [B,H,W,3],
    denoised latents [B,h,w,4] in the bundle dtype).
    """
    _check_ref_spec(bundle, spec)
    inputs = _ref_inputs(bundle, spec, frame_u8, ref_frame_u8, prompt_embeds, strength,
                         guidance_scale, style_fidelity, noise, ref_noise, pooled_embeds,
                         src_box, ref_box)
    bufs = _new_buffers(bundle, spec, inputs, spec.steps + 2)
    _stage(bufs, inputs, seed, spec.batch)
    return _reference_body(bundle, spec, **bufs)


class ReferenceProgram(_Program):
    """The reference-mode program of one (bundle, spec) bucket, with the
    calling conventions of ``FrameProgram`` (a CUDA graph per call
    signature on a CUDA bundle, static buffers, clones out,
    ``last_launches`` counted at capture)."""

    _body = staticmethod(_reference_body)
    extra_noise_rows = 1  # the reference's one noise tensor

    def __init__(self, bundle: ModelBundle, spec: FrameSpec):
        _check_ref_spec(bundle, spec)
        super().__init__(bundle, spec)

    @torch.inference_mode()
    def __call__(self, frame_u8, ref_u8, prompt_embeds, strength, guidance, style_fidelity,
                 seed, noise=None, ref_noise=None, *, pooled_embeds=None, src_box=None,
                 ref_box=None):
        inputs = _ref_inputs(self.bundle, self.spec, frame_u8, ref_u8, prompt_embeds, strength,
                             guidance, style_fidelity, noise, ref_noise, pooled_embeds,
                             src_box, ref_box)
        return self._run(inputs, seed)


def build_reference_program(bundle: ModelBundle, spec: FrameSpec) -> ReferenceProgram:
    """``f(frame_u8, ref_u8, prompt_embeds, strength, guidance,
    style_fidelity, seed, noise=None, ref_noise=None, *, pooled_embeds,
    src_box, ref_box)`` -> ``(images_u8, denoised_latents)``: the JAX
    program's arguments without its ``params``, plus the noise seam."""
    return ReferenceProgram(bundle, spec)
