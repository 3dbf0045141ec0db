"""The port's layers against ``videosd_tpu.models.layers`` (fp32, CPU).

Same numpy inputs through both; the port is NCHW inside, so NHWC tensors
are permuted at the boundary.  The port's convs and linears are torch's
own (``F.conv2d``/``F.linear``), held here against the JAX ops with the
weights crossed as ``state_dict_from_jax`` crosses them.  fp32 on both
sides: the bar is reduction order, 1e-5 absolute on O(1) values unless
stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from videosd_tpu.models import layers as JL
from videosd_tpu_torch.models import layers as PL

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 3), (1, 0, 1)])
def test_conv2d(rng, stride, padding, k):
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w = (rng.standard_normal((k, k, 6, 5)) * 0.2).astype(np.float32)  # HWIO
    b = rng.standard_normal((5,)).astype(np.float32)
    want = JL.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x),
                     stride=stride, padding=[(padding, padding)] * 2)
    got = F.conv2d(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b),
                   stride=stride, padding=padding)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_linear(rng):
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 24)) * 0.2).astype(np.float32)  # [in, out]
    b = rng.standard_normal((24,)).astype(np.float32)
    want = JL.linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = F.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("groups,eps,offset", [(4, 1e-5, 0.0), (8, 1e-6, 3.0)])
def test_group_norm(rng, groups, eps, offset):
    """offset: a large common mean exercises the E[x^2]-E[x]^2 form."""
    x = (rng.standard_normal((2, 5, 5, 16)) + offset).astype(np.float32)
    g = rng.standard_normal((16,)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    want = JL.group_norm({"scale": jnp.asarray(g), "bias": jnp.asarray(b)}, jnp.asarray(x),
                         groups=groups, eps=eps)
    got = PL.group_norm(_nchw(x), torch.from_numpy(g), torch.from_numpy(b), groups=groups,
                        eps=eps)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=5e-5, rtol=1e-5)


def test_layer_norm(rng):
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    g = rng.standard_normal((16,)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    want = JL.layer_norm({"scale": jnp.asarray(g), "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = PL.layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "causal"])
def test_attention_plain_route(rng, masked):
    """Shapes outside the flash rule (77-token cross-attention, CLIP's
    causal attention) take the plain ``_attention_xla`` math."""
    q = rng.standard_normal((2, 77, 32)).astype(np.float32)
    k = rng.standard_normal((2, 77, 32)).astype(np.float32)
    v = rng.standard_normal((2, 77, 32)).astype(np.float32)
    mask = np.triu(np.full((77, 77), -np.inf, np.float32), 1)[None, None] if masked else None
    want = JL._attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                             None if mask is None else jnp.asarray(mask))
    got = PL.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       num_heads=2, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim", [32, 256, 33])
def test_timestep_and_guidance_embeddings(dim):
    t = np.array([0, 1, 259, 999], np.int32)
    w = np.array([1.0, 5.0, 8.5, 0.0], np.float32)
    # fp32 sin/cos of arguments up to t = 999 rad differ by a few ulp of the
    # argument (~6e-5 each) between libraries
    np.testing.assert_allclose(
        PL.timestep_embedding(torch.from_numpy(t), dim).numpy(),
        np.asarray(JL.timestep_embedding(jnp.asarray(t), dim)), atol=1e-4, rtol=1e-5,
    )
    np.testing.assert_allclose(
        PL.timestep_embedding(torch.from_numpy(t), dim, flip_sin_to_cos=False,
                              downscale_freq_shift=1.0).numpy(),
        np.asarray(JL.timestep_embedding(jnp.asarray(t), dim, flip_sin_to_cos=False,
                                         downscale_freq_shift=1.0)),
        atol=1e-4, rtol=1e-5,
    )
    # the guidance arguments reach 1000 * 8.5 rad, where an ulp is ~5e-4
    np.testing.assert_allclose(
        PL.guidance_embedding(torch.from_numpy(w), dim).numpy(),
        np.asarray(JL.guidance_embedding(jnp.asarray(w), dim)), atol=2e-3, rtol=0,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu(rng, dtype):
    """erf gelu in fp32, tanh gelu in bf16 (compared at bf16 resolution)."""
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    wp = (rng.standard_normal((8, 32)) * 0.3).astype(np.float32)
    bp = rng.standard_normal((32,)).astype(np.float32)
    wo = (rng.standard_normal((16, 8)) * 0.3).astype(np.float32)
    bo = rng.standard_normal((8,)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = JL.geglu(
        {"proj": {"kernel": jnp.asarray(wp, jd), "bias": jnp.asarray(bp)},
         "out": {"kernel": jnp.asarray(wo, jd), "bias": jnp.asarray(bo)}},
        jnp.asarray(x, jd),
    )
    proj, out = nn.Linear(8, 32).to(td), nn.Linear(16, 8).to(td)
    with torch.no_grad():
        proj.weight.copy_(torch.from_numpy(wp.T.copy()))
        proj.bias.copy_(torch.from_numpy(bp))
        out.weight.copy_(torch.from_numpy(wo.T.copy()))
        out.bias.copy_(torch.from_numpy(bo))
        got = PL.geglu(torch.from_numpy(x).to(td), proj, out)
    tol = 1e-5 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_pool_and_upsample(rng):
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(PL.avg_pool2d(_nchw(x))),
                               np.asarray(JL.avg_pool2d(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(_nhwc(PL.upsample_nearest2d(_nchw(x))),
                                  np.asarray(JL.upsample_nearest2d(jnp.asarray(x))))
