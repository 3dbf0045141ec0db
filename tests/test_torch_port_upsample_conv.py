"""The port's fused nearest-2x upsample + 3x3 conv
(``models/layers.py::upsample_conv2d``) against the JAX package's and
against the port's naive path (``upsample_nearest2d`` then the conv), fp32
on the CPU, at the shapes of ``tests/test_models.py``'s case, a non-zero
bias, ``f32_out`` both ways.  Bar: JAX's own, 2e-5 absolute (the same
additions re-associated)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from videosd_tpu.models import layers as JL
from videosd_tpu_torch.models.layers import upsample_conv2d, upsample_nearest2d

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

ATOL = 2e-5


def _conv(rng, c):
    conv = nn.Conv2d(c, c, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            (rng.standard_normal((c, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(
            (rng.standard_normal(c) * 0.1 + 0.1).astype(np.float32)))
    params = {"kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0)),
              "bias": jnp.asarray(conv.bias.detach().numpy())}
    return conv.eval(), params


@pytest.mark.parametrize("f32_out", [True, False])
@pytest.mark.parametrize("h,w,c", [(5, 7, 8), (8, 8, 16)])
def test_upsample_conv2d_matches_jax_and_naive(h, w, c, f32_out):
    rng = np.random.default_rng(h * 100 + c)
    conv, params = _conv(rng, c)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    want = np.asarray(JL.upsample_conv2d(params, jnp.asarray(x), f32_out=f32_out))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = upsample_conv2d(conv, xt, f32_out=f32_out)
        naive = conv(upsample_nearest2d(xt))
    assert got.shape == naive.shape == (2, c, 2 * h, 2 * w) and got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, naive.permute(0, 2, 3, 1).numpy(), atol=ATOL, rtol=0)
    # every phase and edge is live: the bias alone would not be
    assert np.abs(got - params["bias"]).max() > 0.1


def test_upsample_conv2d_keeps_the_input_dtype():
    """bf16 in, bf16 out, on both ``f32_out`` settings, within a bf16
    rounding of the fp32 result at the output's scale."""
    rng = np.random.default_rng(3)
    conv, _ = _conv(rng, 8)
    x = torch.from_numpy(rng.standard_normal((1, 8, 6, 6)).astype(np.float32))
    with torch.no_grad():
        ref = upsample_conv2d(conv, x)
        for f32_out in (True, False):
            got = upsample_conv2d(conv.to(torch.bfloat16), x.to(torch.bfloat16), f32_out=f32_out)
            conv.float()
            assert got.dtype == torch.bfloat16
            assert (got.float() - ref).abs().max() <= 2 ** -5 * ref.abs().max()
