"""The optimizers the training tools use, as ``torch.optim.Optimizer``\\ s.

The port's own copies of the three optax transforms that
``videosd_tpu/tools/train_toy.py`` builds, at optax 0.2.6's defaults:

* :class:`Adam` is ``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0, the bias-corrected moments, ``m / (sqrt(v) + eps)``;
* :class:`AdamW` is ``optax.adamw(lr)``: the same, plus ``weight_decay *
  param`` added to the update before the learning rate scales it, with
  optax's weight decay of **1e-4** (``torch.optim.AdamW``'s default is 0.01);
* :class:`Adafactor` is ``optax.adafactor(lr)``: the factored second moment
  over the two largest dims when the second largest has at least 128
  entries, decay ``1 - t^-0.8``, eps 1e-30, update clipping to block RMS
  1, the step scaled by the parameter's RMS (at least 1e-3), no momentum.
  ``torch.optim.Adafactor`` is another algorithm (no parameter-scale step,
  another decay and eps) and is not used.

A parameter without a gradient is updated as optax updates a zero
gradient (its moments decay; AdamW still decays the weight).

The factored dims are picked as optax picks them on the JAX layout of the
tensor, so the choice does not depend on the port's layout: a conv weight
is OIHW here and HWIO in JAX, a linear weight ``[out, in]`` here and
``[in, out]`` there.  Given a module, the optimizers read each parameter's
layout from the layer that owns it (:func:`jax_layouts`); given bare
parameters, they take the layout as it is.

:func:`adam`, :func:`adamw` and :func:`adafactor` return, like optax's
functions of the same names, an optimizer not yet bound to parameters: a
callable that takes the module to train.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

__all__ = ["Adafactor", "Adam", "AdamW", "adafactor", "adam", "adamw", "jax_layouts"]

# optax 0.2.6's defaults: scale_by_adam's, and adafactor's (factor a weight's
# second moment when its second largest dim has at least 128 entries; decay
# 1 - t^-0.8; eps 1e-30; updates clipped to block RMS 1; the step scaled by
# the weight's RMS, at least 1e-3)
B1, B2, EPS = 0.9, 0.999, 1e-8
MIN_DIM_SIZE_TO_FACTOR, DECAY_RATE, FACTORED_EPS = 128, 0.8, 1e-30
CLIPPING_THRESHOLD, MIN_SCALE = 1.0, 1e-3

# OIHW -> HWIO, [out, in] -> [in, out]: the permutation that views a port
# weight in the JAX package's layout (io/weights.py::_to_torch inverted)
_CONV_TO_JAX = (2, 3, 1, 0)
_LINEAR_TO_JAX = (1, 0)


def jax_layouts(module: nn.Module) -> dict:
    """``{parameter: permutation}`` that views each conv and linear weight of
    ``module`` in the JAX package's layout; other parameters are absent
    (their layout is the same on both sides)."""
    out = {}
    for mod in module.modules():
        if isinstance(mod, nn.Conv2d):
            out[mod.weight] = _CONV_TO_JAX
        elif isinstance(mod, nn.Linear):
            out[mod.weight] = _LINEAR_TO_JAX
    return out


def _params(params):
    """(parameter list, layouts) for a module or an iterable of parameters."""
    if isinstance(params, nn.Module):
        return [p for p in params.parameters() if p.requires_grad], jax_layouts(params)
    return list(params), {}


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in fp32, as optax computes it (in fp64 it is up to
    1.3e-5 away for b2 = 0.999, whose fp32 value is 0.99900001)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _grad(p):
    return p.grad if p.grad is not None else torch.zeros_like(p)


class Adam(torch.optim.Optimizer):
    """``optax.adam`` (and, with ``weight_decay``, ``optax.adamw``)."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        params, _ = _params(params)
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                g = _grad(p)
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
                mu = st["mu"].mul_(B1).add_(g, alpha=1.0 - B1)
                nu = st["nu"].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                mu_hat = mu / _bias_correction(B1, st["count"])
                nu_hat = nu / _bias_correction(B2, st["count"])
                update = mu_hat / (torch.sqrt(nu_hat) + EPS)
                if wd:
                    update.add_(p, alpha=wd)
                p.add_(update, alpha=-lr)
        return loss


class AdamW(Adam):
    """``optax.adamw``: :class:`Adam` with optax's weight decay, 1e-4."""

    def __init__(self, params, lr: float, weight_decay: float = 1e-4):
        super().__init__(params, lr, weight_decay)


def _factored_dims(shape):
    """optax's ``_factored_dims``: the two largest dims (second largest,
    largest) of ``shape``, or None below two dims or when the second largest
    is smaller than MIN_DIM_SIZE_TO_FACTOR."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x):
    return torch.sqrt(torch.mean(x * x))


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` at its defaults (no momentum, no weight decay,
    no decay offset)."""

    def __init__(self, params, lr: float):
        params, self._layouts = _params(params)
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                perm = self._layouts.get(p, tuple(range(p.ndim)))
                g = _grad(p).permute(perm)  # the JAX layout, as a view
                if not st:
                    st["count"] = 0
                    dims = _factored_dims(g.shape)
                    st["dims"] = dims
                    if dims is None:
                        st["v"] = torch.zeros_like(g)
                    else:
                        d1, d0 = dims
                        st["v_row"] = g.new_zeros(np.delete(g.shape, d0).tolist())
                        st["v_col"] = g.new_zeros(np.delete(g.shape, d1).tolist())
                # optax's decay 1 - t^-0.8, in fp32
                t = st["count"] + 1
                decay = float(np.float32(1.0) - np.float32(t) ** np.float32(-DECAY_RATE))
                grad_sqr = g * g + FACTORED_EPS
                if st["dims"] is None:
                    v = st["v"].mul_(decay).add_(grad_sqr, alpha=1.0 - decay)
                    update = g * v ** -0.5
                else:
                    d1, d0 = st["dims"]
                    v_row = st["v_row"].mul_(decay).add_(grad_sqr.mean(d0), alpha=1.0 - decay)
                    v_col = st["v_col"].mul_(decay).add_(grad_sqr.mean(d1), alpha=1.0 - decay)
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
                    update = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                st["count"] += 1
                # clip_by_block_rms, scale_by_learning_rate, scale_by_param_block_rms
                # (on the device: no host sync per parameter)
                update = update / torch.clamp(_rms(update) / CLIPPING_THRESHOLD, min=1.0)
                update = update * group["lr"]
                p_rms = _rms(p)
                update = update * torch.where(p_rms <= MIN_SCALE,
                                              torch.full_like(p_rms, MIN_SCALE), p_rms)
                inverse = tuple(int(i) for i in np.argsort(perm))
                p.sub_(update.permute(inverse))
        return loss


def adam(learning_rate: float):
    """``optax.adam(learning_rate)``: a callable that takes the module to train."""
    return functools.partial(Adam, lr=learning_rate)


def adamw(learning_rate: float):
    """``optax.adamw(learning_rate)``, weight decay 1e-4."""
    return functools.partial(AdamW, lr=learning_rate)


def adafactor(learning_rate: float):
    """``optax.adafactor(learning_rate)``."""
    return functools.partial(Adafactor, lr=learning_rate)
