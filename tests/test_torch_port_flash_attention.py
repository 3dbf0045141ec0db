"""Kernel K1's module (``ops/cuda/flash_attention.py``) against the JAX one.

On the CPU the wrapper takes its plain version, which is held against
``_attention_xla`` (1e-5: the same fp32 math) and against the Pallas TPU
kernel run in interpret mode as ``tests/test_flash_attention.py`` runs it
(2e-3, that test's bar: online-softmax reassociation).  The CUDA kernel
itself runs only on the card: the test marked ``cuda`` skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videosd_tpu.models.layers import _attention_xla
from videosd_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from videosd_tpu_torch.models import layers as PL
from videosd_tpu_torch.ops.cuda import flash_attention as FA

# (batch, sq, sk, heads, d_head): the three head dims of sd15's UNet
_SHAPES = [(1, 256, 256, 2, 40), (1, 256, 512, 2, 80), (1, 256, 256, 1, 160)]


def _qkv(rng, b, sq, sk, h, dh):
    q = rng.standard_normal((b, sq, h * dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, h * dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, h * dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("shape", _SHAPES, ids=["d40", "kv512_d80", "d160"])
def test_port_attention_matches_jax(rng, shape):
    b, sq, sk, h, dh = shape
    assert PL.routes_to_flash(sq, sk, masked=False)
    q, k, v = _qkv(rng, *shape)
    launches = FA.launches
    got = PL.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       num_heads=h).numpy()
    assert FA.launches == launches  # CPU tensors never launch the kernel
    want = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    with pltpu.force_tpu_interpret_mode():
        kernel = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h)
    assert np.abs(got - np.asarray(kernel)).max() < 2e-3


@pytest.mark.parametrize(
    "sq,sk,masked,routed",
    [
        (4096, 4096, False, True),  # sd15 512^2 down0/up3 self-attention
        (1024, 1024, False, True),
        (256, 256, False, True),
        (256, 512, False, True),  # banked K/V of the reference-attention read
        (64, 64, False, False),  # sd15 mid block at 8x8
        (4096, 77, False, False),  # cross-attention over the text context
        (77, 77, True, False),  # CLIP causal attention
        (128, 128, False, False),  # fewer than 256 keys
        (192, 256, False, False),  # q not a multiple of 128
    ],
)
def test_routing_rule(sq, sk, masked, routed):
    assert PL.routes_to_flash(sq, sk, masked) is routed


def test_sd15_frame_routes_84_attentions():
    """One batch-1 sd15 512^2 4-step frame: per step 15 UNet + 6 ControlNet
    self-attentions at 64^2, 32^2 and 16^2 latents route to K1; the 8^2
    mid blocks and all cross-attention do not."""
    from videosd_tpu_torch.models.unet import UNET_PRESETS

    cfg = UNET_PRESETS["sd15"]
    side = 512 // 8
    unet = cn = 0
    for i, has_attn in enumerate(cfg.attn_down):
        s = (side >> i) ** 2
        if has_attn and PL.routes_to_flash(s, s, False):
            unet += cfg.layers_per_block
            cn += cfg.layers_per_block
    for i, has_attn in enumerate(cfg.attn_up):
        s = (side >> (len(cfg.attn_up) - 1 - i)) ** 2
        if has_attn and PL.routes_to_flash(s, s, False):
            unet += cfg.layers_per_block + 1
    mid = (side >> (len(cfg.attn_down) - 1)) ** 2
    assert not PL.routes_to_flash(mid, mid, False)
    assert (unet, cn, 4 * (unet + cn)) == (15, 6, 84)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 128, 40, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bhsd(x, x, x, 0.1)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for bh, sq, sk, d in [(8, 1024, 1024, 40), (4, 256, 512, 80), (8, 256, 256, 160)]:
        q, k, v = (torch.randn(bh, s, d, generator=g, device="cuda").bfloat16()
                   for s in (sq, sk, sk))
        before = FA.launches
        out = FA.flash_attention_bhsd(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        assert FA.launches == before + 1
        ref = FA.flash_attention_reference(q, k, v, d ** -0.5)
        err = (out.float() - ref.float()).abs()
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
    with pytest.raises(ValueError, match="bfloat16"):
        FA.flash_attention_bhsd(q.float(), k.float(), v.float(), 0.1)
