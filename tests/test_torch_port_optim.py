"""The port's optimizers (``train/optim.py``) against optax 0.2.6.

``adam``, ``adamw`` and ``adafactor`` are fed the same gradients as
``optax.adam``, ``optax.adamw`` and ``optax.adafactor`` at their defaults
for five steps; the weights stay within 1e-6 of the largest absolute value
of optax's (per tensor) after every step.  The weights are the JAX
package's layouts on the optax side (conv HWIO, linear ``[in, out]``) and
the port's on the other (OIHW, ``[out, in]``): Adafactor's factored shapes
(two dims of at least 128, a square one whose tie optax breaks by axis
order), unfactored ones, 1-D biases, a zero bias (the parameter-scale
floor) and a parameter that gets no gradient (a zero one in optax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from videosd_tpu_torch.train import optim as PO

torch.set_num_threads(1)

STEPS, LR, BAR = 5, 1e-2, 1e-6


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(128, 256, 3)  # HWIO [3,3,128,256]: factored over (I, O)
        self.square = nn.Conv2d(160, 160, 1)  # [1,1,160,160]: a tie between I and O
        self.proj = nn.Linear(192, 128)  # [in, out] = [192, 128]: factored
        self.small = nn.Linear(64, 32)  # unfactored
        self.conv_small = nn.Conv2d(4, 8, 3)  # unfactored
        self.scale = nn.Parameter(torch.ones(32))


def _to_jax(arr):
    if arr.ndim == 4:
        return np.transpose(arr, (2, 3, 1, 0))
    if arr.ndim == 2:
        return arr.T
    return arr


def _to_torch(arr):
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2:
        return arr.T
    return arr


@pytest.mark.parametrize("name", ["adam", "adamw", "adafactor"])
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(0)
    net = _Net()
    with torch.no_grad():
        for pname, p in net.named_parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.1))
        net.proj.bias.zero_()  # the parameter-scale step's floor (RMS 0 -> 1e-3)
    frozen = "small.bias"  # gets no gradient: optax sees a zero one
    opt = getattr(PO, name)(LR)(net)
    tx = getattr(optax, name)(LR)
    # copies: jnp.asarray may alias a numpy buffer that the port updates in place
    jparams = {n: jnp.array(_to_jax(p.detach().numpy().copy())) for n, p in net.named_parameters()}
    state = tx.init(jparams)
    moved = 0.0
    for _ in range(STEPS):
        jgrads = {n: rng.standard_normal(p.shape).astype(np.float32)
                  for n, p in jparams.items()}
        jgrads[frozen] = np.zeros_like(jgrads[frozen])
        for n, p in net.named_parameters():
            p.grad = None if n == frozen else torch.from_numpy(_to_torch(jgrads[n]).copy())
        opt.step()
        updates, state = tx.update({n: jnp.asarray(g) for n, g in jgrads.items()}, state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in net.named_parameters():
            want = _to_torch(np.asarray(jparams[n]))
            got = p.detach().numpy()
            err = np.abs(got - want).max()
            assert err <= BAR * np.abs(want).max(), (name, n, err)
            moved = max(moved, float(np.abs(updates[n]).max()))
    assert moved > 100 * BAR  # the steps did move the weights


def test_factored_dims_follow_the_jax_layout():
    """Adafactor factors the same two dims as optax on the JAX layout."""
    net = _Net()
    opt = PO.adafactor(LR)(net)
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    dims = {n: opt.state[p]["dims"] for n, p in net.named_parameters()}
    assert dims["conv.weight"] == (2, 3)  # I then O of HWIO
    assert dims["square.weight"] == (2, 3)
    assert dims["proj.weight"] == (1, 0)  # out (128) then in (192) of [in, out]
    assert dims["small.weight"] is None and dims["conv.bias"] is None
    assert opt.state[net.conv.weight]["v_row"].shape == (3, 3, 128)
    assert opt.state[net.conv.weight]["v_col"].shape == (3, 3, 256)


def test_adamw_defaults_are_optax_not_torch():
    net = _Net()
    assert PO.adamw(LR)(net).defaults["weight_decay"] == 1e-4
    assert torch.optim.AdamW(net.parameters()).defaults["weight_decay"] == 0.01
    assert PO.adam(LR)(net).defaults["weight_decay"] == 0.0
