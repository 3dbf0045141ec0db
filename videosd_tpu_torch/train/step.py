"""Train steps for the UNet and the ControlNet (noise-prediction objective).

Counterpart of ``videosd_tpu/train/step.py``: eps-prediction MSE over
random timesteps, ``mean((pred.float() - noise)^2)`` on latents forward-noised
by the scheduler's ``add_noise``.  In PyTorch's idiom a step updates the
trained ``nn.Module`` in place through its optimizer and returns
``{"loss": ...}``; the state is ``{"model": module, "optimizer": optimizer}``
(:func:`init_train_state`).

Random numbers: threefry is not ported, so each step draws its timesteps
and noise from an explicit ``torch.Generator`` on the latents' device
(``generator=``), or takes them as tensors (``t=`` [B] and ``noise=``, the
latents' shape): the seam the tests pass JAX's own draws through.

Routed self-attentions run kernel K1 forward and the plain math backward
(``models/layers.py::FlashAttentionRecompute``), as the JAX step runs its
Pallas forward under ``_attention_pallas_diff``.  Inputs made under
``torch.inference_mode()`` (the prompt encoder's embeddings) cannot be saved
for backward; the steps take a plain copy of such a tensor.

The sharded UNet step (``make_train_step(sched_cfg, mesh=mesh)``, JAX's
``mesh`` variant) keeps the single-device step's state and call.  It draws
t and noise for the whole batch first (the single-device step's draws),
splits the batch over the data rows, and runs each row's forward and
backward on the row's placed copy of the model
(``parallel/mesh.py::shard_params``: attention and feed-forward split over
the row's model slots).  The gradient of the global mean loss is the mean
over rows of each row's mean-loss gradient: ``reduce_grads`` forms it in
the caller's model (the master; across processes with one all-reduce),
the optimizer steps the whole master, and the placements are loaded from
it again before the next step.  Stepping whole tensors keeps Adafactor's
statistics over each whole tensor, as GSPMD forms them in JAX; it costs
one whole copy of the model and its optimizer state (``mesh.py``'s list of
placement differences).
"""

from __future__ import annotations

import weakref

import torch

from videosd_tpu_torch.models.controlnet import controlnet_apply
from videosd_tpu_torch.models.unet import unet_apply
from videosd_tpu_torch.parallel.mesh import data_sharding, reduce_data, reduce_grads, shard_params
from videosd_tpu_torch.schedulers.lcm import LCMSchedulerConfig, add_noise, make_alphas_cumprod

__all__ = [
    "init_train_state",
    "make_controlnet_eval",
    "make_controlnet_train_step",
    "make_train_step",
]


def init_train_state(model: torch.nn.Module, optimizer) -> dict:
    """Switch gradients on for ``model`` and bind ``optimizer`` (a callable
    that takes the module: ``train/optim.py``'s ``adam``, ``adamw`` or
    ``adafactor``) to it: ``{"model": model, "optimizer": ...}``."""
    model.requires_grad_(True)
    return {"model": model, "optimizer": optimizer(model)}


def _plain(x):
    """``x``, or a copy of it made outside inference mode, so autograd can
    save it."""
    return x.clone() if x is not None and x.is_inference() else x


def _draws(latents, t_hi: int, generator, t, noise):
    """(t [B] int64, noise fp32 of the latents' shape) on the latents'
    device: the given tensors, else drawn from ``generator``."""
    if (t is None) != (noise is None):
        raise ValueError("pass t= and noise= together, or neither")
    if t is None:
        if generator is None:
            raise ValueError("a step needs generator= (a torch.Generator on the latents' "
                             "device) or explicit t= and noise=")
        t = torch.randint(0, t_hi, (latents.shape[0],), generator=generator,
                          device=latents.device)
        noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                            dtype=torch.float32)
    return (torch.as_tensor(t, device=latents.device).long(),
            torch.as_tensor(noise, device=latents.device, dtype=torch.float32))


def _eps_mse(pred, noise):
    err = pred.float() - noise
    return torch.mean(err * err)


def make_train_step(sched_cfg: LCMSchedulerConfig, mesh=None):
    """The UNet's train step.

    ``step(state, batch, *, generator=None, t=None, noise=None) ->
    {"loss": fp32 scalar tensor}``; ``batch`` holds ``latents`` [B,h,w,4]
    (NHWC, the JAX layout), ``context`` [B,S,D] and, when the config has LCM
    guidance conditioning, ``w_cond`` [B, time_cond_proj_dim].  Timesteps
    are drawn over the full schedule.

    ``mesh`` (``parallel/mesh.py::make_mesh``): the batch is split over its
    data rows (B a multiple of the data axis) and each row runs on its own
    placed copy of the model; the loss returned is the global mean.  Over a
    mesh that spans processes every process passes the whole batch and the
    same draws (the same generator seed, or the same ``t``/``noise``) and
    runs its own rows; every process ends the step with the same model.
    """
    alphas = torch.from_numpy(make_alphas_cumprod(sched_cfg))
    if mesh is not None:
        return _sharded_train_step(sched_cfg, mesh, alphas)

    def train_step(state, batch, *, generator=None, t=None, noise=None):
        unet, opt = state["model"], state["optimizer"]
        latents = _plain(batch["latents"])
        t, noise = _draws(latents, sched_cfg.num_train_timesteps, generator, t, noise)
        opt.zero_grad(set_to_none=True)
        noisy = add_noise(alphas.to(latents.device), latents, noise, t)
        pred = unet_apply(unet, noisy, t, _plain(batch["context"]),
                          timestep_cond=_plain(batch.get("w_cond")))
        loss = _eps_mse(pred, noise)
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    return train_step


def _sharded_train_step(sched_cfg: LCMSchedulerConfig, mesh, alphas):
    """:func:`make_train_step` over ``mesh``: the placements are made at
    the first call on a model and loaded from it in place at each later
    one; ``step.placements()`` gives this process's rows' placements."""
    placed = {"model": lambda: None, "rows": None}

    def train_step(state, batch, *, generator=None, t=None, noise=None):
        unet, opt = state["model"], state["optimizer"]
        latents = _plain(batch["latents"])
        t, noise = _draws(latents, sched_cfg.num_train_timesteps, generator, t, noise)
        split = data_sharding(mesh, latents.shape[0])
        if placed["model"]() is not unet:
            placed["model"], placed["rows"] = weakref.ref(unet), shard_params({"unet": unet},
                                                                              mesh)
        else:
            for row in placed["rows"]:
                row.load({"unet": unet})
        context, w_cond = _plain(batch["context"]), _plain(batch.get("w_cond"))
        opt.zero_grad(set_to_none=True)
        losses = []
        for row in placed["rows"]:
            dev, rows = row.device, split[row.row]
            t_r, noise_r = t[rows].to(dev), noise[rows].to(dev)
            noisy = add_noise(alphas.to(dev), latents[rows].to(dev), noise_r, t_r)
            pred = unet_apply(row.models["unet"], noisy, t_r, context[rows].to(dev),
                              timestep_cond=None if w_cond is None else w_cond[rows].to(dev))
            loss = _eps_mse(pred, noise_r)
            loss.backward()
            losses.append(loss.detach())
        reduce_grads(placed["rows"], {"unet": unet}, mesh)
        for row in placed["rows"]:
            row.models["unet"].zero_grad(set_to_none=True)
        opt.step()
        return {"loss": (reduce_data(losses, mesh) / mesh.shape["data"]).to(latents.device)}

    train_step.placements = lambda: placed["rows"]
    return train_step


def make_controlnet_train_step(sched_cfg: LCMSchedulerConfig, t_max: int | None = None):
    """The ControlNet's train step against a frozen UNet (the ControlNet
    paper's recipe; JAX ``make_controlnet_train_step``).

    ``step(state, unet, batch, *, generator=None, t=None, noise=None) ->
    {"loss": ...}``; ``state`` holds the ControlNet, ``batch`` adds
    ``control`` [B,H,W,3] (the canny map in [0, 1] at pixel resolution) to
    the UNet step's.  The UNet's parameters are set not to require grad;
    gradients still flow through its activations to the ControlNet's
    residuals, wired into its skip stack as the frame program wires them.
    ``t_max``: timesteps are drawn below it (default: the full schedule).
    """
    alphas = torch.from_numpy(make_alphas_cumprod(sched_cfg))
    t_hi = int(t_max or sched_cfg.num_train_timesteps)

    def train_step(state, unet, batch, *, generator=None, t=None, noise=None):
        cn, opt = state["model"], state["optimizer"]
        unet.requires_grad_(False)
        latents = _plain(batch["latents"])
        t, noise = _draws(latents, t_hi, generator, t, noise)
        context, w_cond = _plain(batch["context"]), _plain(batch.get("w_cond"))
        opt.zero_grad(set_to_none=True)
        noisy = add_noise(alphas.to(latents.device), latents, noise, t)
        down, mid = controlnet_apply(cn, noisy, t, context, _plain(batch["control"]),
                                     conditioning_scale=1.0, timestep_cond=w_cond)
        pred = unet_apply(unet, noisy, t, context, timestep_cond=w_cond,
                          down_block_additional_residuals=down,
                          mid_block_additional_residual=mid)
        loss = _eps_mse(pred, noise)
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    return train_step


def make_controlnet_eval(sched_cfg: LCMSchedulerConfig):
    """The paired eval of the ControlNet stage: eps-prediction MSE without
    and with the ControlNet's residuals, on the same noise and explicit
    timesteps (``base - cn`` says whether the ControlNet learned anything).

    ``evaluate(controlnet, unet, batch, t, *, generator=None, noise=None) ->
    (base_loss, cn_loss)``, fp32 scalar tensors; ``t`` [B] ints.
    """
    alphas = torch.from_numpy(make_alphas_cumprod(sched_cfg))

    @torch.no_grad()
    def evaluate(controlnet, unet, batch, t, *, generator=None, noise=None):
        latents = batch["latents"]
        if noise is None:
            if generator is None:
                raise ValueError("evaluate needs generator= or noise=")
            noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                                dtype=torch.float32)
        t = torch.as_tensor(t, device=latents.device).long()
        noise = torch.as_tensor(noise, device=latents.device, dtype=torch.float32)
        noisy = add_noise(alphas.to(latents.device), latents, noise, t)
        w_cond = batch.get("w_cond")
        base = unet_apply(unet, noisy, t, batch["context"], timestep_cond=w_cond)
        down, mid = controlnet_apply(controlnet, noisy, t, batch["context"], batch["control"],
                                     conditioning_scale=1.0, timestep_cond=w_cond)
        with_cn = unet_apply(unet, noisy, t, batch["context"], timestep_cond=w_cond,
                             down_block_additional_residuals=down,
                             mid_block_additional_residual=mid)
        return _eps_mse(base, noise), _eps_mse(with_cn, noise)

    return evaluate
