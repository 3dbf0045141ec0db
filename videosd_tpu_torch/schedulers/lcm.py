"""LCM (Latent Consistency Model) scheduler as functions on torch tensors.

Counterpart of ``videosd_tpu/schedulers/lcm.py``.  ``make_alphas_cumprod``
and its helpers are a numpy copy of the original.  The per-step functions
take per-batch-element tensors (strength, timesteps) and never sync with
the host, so one frame program serves elements with different settings:
the strength-aware ladder is a fixed-width schedule whose leading slots
are marked invalid when an element has fewer real steps than ``steps``.
Random numbers come in as tensors (``noise``); there is no PRNG here.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "LCMSchedulerConfig",
    "add_noise",
    "boundary_scalings",
    "make_alphas_cumprod",
    "step",
    "timestep_schedule",
]


@dataclasses.dataclass(frozen=True)
class LCMSchedulerConfig:
    """Static scheduler configuration.  Defaults match SD1.5-family
    checkpoints (scaled_linear 0.00085..0.012, 1000 train steps)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    prediction_type: str = "epsilon"  # epsilon | sample | v_prediction
    lcm_origin_steps: int = 50
    sigma_data: float = 0.5
    # the reference divides t by 0.1 in its boundary scalings
    timestep_scaling: float = 10.0
    set_alpha_to_one: bool = True
    rescale_betas_zero_snr: bool = False


def _betas_for_alpha_bar(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """Cosine (squaredcos_cap_v2) beta schedule."""

    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero-SNR rescale (Lin et al. 2023)."""
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_bar_sqrt = np.sqrt(alphas_cumprod)

    alphas_bar_sqrt_0 = alphas_bar_sqrt[0].copy()
    alphas_bar_sqrt_T = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt -= alphas_bar_sqrt_T
    alphas_bar_sqrt *= alphas_bar_sqrt_0 / (alphas_bar_sqrt_0 - alphas_bar_sqrt_T)

    alphas_bar = alphas_bar_sqrt**2
    alphas = alphas_bar[1:] / alphas_bar[:-1]
    alphas = np.concatenate([alphas_bar[0:1], alphas])
    return 1.0 - alphas


def make_alphas_cumprod(cfg: LCMSchedulerConfig) -> np.ndarray:
    """Precompute the fp32 ``alphas_cumprod`` table for a config."""
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    elif cfg.beta_schedule == "scaled_linear":
        betas = (
            np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n, dtype=np.float64)
            ** 2
        )
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        betas = _betas_for_alpha_bar(n)
    else:
        raise ValueError(f"unknown beta_schedule: {cfg.beta_schedule}")

    if cfg.rescale_betas_zero_snr:
        betas = _rescale_zero_terminal_snr(betas)

    alphas_cumprod = np.cumprod(1.0 - betas)
    return alphas_cumprod.astype(np.float32)


def timestep_schedule(
    cfg: LCMSchedulerConfig,
    num_inference_steps: int,
    strength,
    lcm_origin_steps: int | None = None,
):
    """Strength-aware LCM ladder as a fixed-width masked schedule.

    ``strength``: a scalar or a [B] tensor.  Returns ``(timesteps, valid)``
    of shape ``strength.shape + (num_inference_steps,)``: the ``k`` real
    timesteps fill the LAST ``k`` slots in decreasing-t order; earlier slots
    are padding with ``valid == False`` and a clamped timestep that must not
    be used.
    """
    if lcm_origin_steps is None:
        lcm_origin_steps = cfg.lcm_origin_steps
    if num_inference_steps > cfg.num_train_timesteps:
        raise ValueError(
            f"num_inference_steps {num_inference_steps} > num_train_timesteps"
            f" {cfg.num_train_timesteps}"
        )
    steps = num_inference_steps
    c = cfg.num_train_timesteps // lcm_origin_steps
    strength = torch.as_tensor(strength, dtype=torch.float32)
    origin = torch.tensor(float(lcm_origin_steps), dtype=torch.float32, device=strength.device)
    n = torch.floor(origin * strength).to(torch.int64)[..., None]
    skip = torch.clamp(n // steps, min=1)
    k = torch.clamp((n + skip - 1) // skip, max=steps)
    s = torch.arange(steps, dtype=torch.int64, device=strength.device)
    i = s - (steps - k)
    valid = i >= 0
    j = torch.clamp((n - 1) - i * skip, min=0)
    timesteps = torch.clamp((j + 1) * c - 1, 0, cfg.num_train_timesteps - 1)
    return timesteps, valid


def boundary_scalings(cfg: LCMSchedulerConfig, t):
    """LCM consistency boundary-condition scalings (c_skip, c_out)."""
    ts = torch.as_tensor(t).float() * cfg.timestep_scaling
    sd2 = cfg.sigma_data**2
    c_skip = sd2 / (ts**2 + sd2)
    c_out = ts / torch.sqrt(ts**2 + sd2)
    return c_skip, c_out


def _bcast(v, like):
    v = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def add_noise(alphas_cumprod, original_samples, noise, t):
    """Forward-noise ``x0`` to timestep ``t`` (a scalar or [B]), in fp32."""
    a = _bcast(alphas_cumprod[t], original_samples)
    out = torch.sqrt(a) * original_samples.float() + torch.sqrt(1.0 - a) * noise.float()
    return out.to(original_samples.dtype)


def step(
    cfg: LCMSchedulerConfig,
    alphas_cumprod,
    model_output,
    t,
    t_prev,
    sample,
    *,
    noise=None,
    multistep: bool = True,
):
    """One LCM consistency step; returns ``(prev_sample, denoised)`` in
    ``sample``'s dtype.  ``t_prev`` is the next (smaller) timestep of the
    ladder; ``noise`` is the re-noise tensor, required when ``multistep``."""
    x = sample.float()
    eps = model_output.float()
    a_t = _bcast(alphas_cumprod[t], x)
    b_t = 1.0 - a_t
    if cfg.prediction_type == "epsilon":
        pred_x0 = (x - torch.sqrt(b_t) * eps) / torch.sqrt(a_t)
    elif cfg.prediction_type == "sample":
        pred_x0 = eps
    elif cfg.prediction_type == "v_prediction":
        pred_x0 = torch.sqrt(a_t) * x - torch.sqrt(b_t) * eps
    else:
        raise ValueError(f"unknown prediction_type: {cfg.prediction_type}")

    c_skip, c_out = boundary_scalings(cfg, t)
    denoised = _bcast(c_out, x) * pred_x0 + _bcast(c_skip, x) * x

    if multistep:
        if noise is None:
            raise ValueError("multistep step() needs `noise`")
        a_prev = _bcast(alphas_cumprod[t_prev], x)
        prev_sample = torch.sqrt(a_prev) * denoised + torch.sqrt(1.0 - a_prev) * noise.float()
    else:
        prev_sample = denoised
    return prev_sample.to(sample.dtype), denoised.to(sample.dtype)
