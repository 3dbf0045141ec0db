"""Kernel K1's module (``ops/cuda/flash_attention.py``) against the JAX one.

On the CPU the wrapper takes its plain version, which is held against
``_attention_xla`` (1e-5: the same fp32 math) and against the Pallas TPU
kernel run in interpret mode as ``tests/test_flash_attention.py`` runs it
(2e-3, that test's bar: online-softmax reassociation).  The CUDA kernel
itself runs only on the card, in ``tests/test_torch_port_kernels_cuda.py``.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videosd_tpu.models.layers import _attention_xla
from videosd_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from videosd_tpu_torch.models import layers as PL
from videosd_tpu_torch.ops.cuda import flash_attention as FA

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

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


@pytest.mark.parametrize("shape", _SHAPES, ids=["d40", "kv512_d80", "d160"])
def test_in_place_entry_matches_jax(rng, shape):
    """``flash_attention`` on ``[B, S, H*D]`` tensors cut out of one fused
    q|k|v buffer (row stride 3*H*D: nothing is folded or made contiguous)."""
    b, sq, sk, h, dh = shape
    s = max(sq, sk)
    fused = rng.standard_normal((b, s, 3 * h * dh)).astype(np.float32)
    q, k, v = (fused[:, :n, i * h * dh:(i + 1) * h * dh] for i, n in enumerate((sq, sk, sk)))
    tq, tk, tv = (torch.from_numpy(fused)[:, :n, i * h * dh:(i + 1) * h * dh]
                  for i, n in enumerate((sq, sk, sk)))
    assert not tq.is_contiguous()
    got = FA.flash_attention(tq, tk, tv, num_heads=h).numpy()
    want = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        kernel = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h)
    assert np.abs(got - np.asarray(kernel)).max() < 2e-3
    # the folded entry is the same function with one head
    fold = lambda x, n: x.reshape(b, n, h, dh).transpose(1, 2).reshape(b * h, n, dh)
    folded = FA.flash_attention_bhsd(fold(tq, sq), fold(tk, sk), fold(tv, sk), dh ** -0.5)
    assert torch.equal(folded.reshape(b, h, sq, dh).transpose(1, 2).reshape(b, sq, h * dh),
                       torch.from_numpy(got))


@pytest.mark.parametrize(
    "sq,d,plans",
    [
        (4096, 40, (256, 128, 64)),  # four warpgroups fit the register file at d = 40 only
        (4096, 80, (128, 64)),
        (128, 40, (128, 64)),
        (192, 160, (64,)),  # a multiple of 64 only
        (320, 40, (64,)),
    ],
)
def test_row_plans(sq, d, plans):
    assert FA.row_plans(sq, d) == plans
    assert all(sq % rows == 0 and rows % FA.KEY_TILE == 0 for rows in plans)


@pytest.mark.parametrize(
    "sq,bh,d,rows,blocks",
    [
        (4096, 8, 40, 256, 128),  # sd15 512^2 down0/up3: four warpgroups
        (1024, 8, 80, 64, 128),  # 128 rows would leave half the card idle
        (256, 8, 160, 64, 32),  # 32 blocks is the most this shape gives
        (4096, 16, 40, 256, 256),  # batch 2
        (1024, 16, 80, 128, 128),  # batch 2: 128 rows cover the card
        (1024, 8, 64, 64, 128),
        (4096, 8, 80, 128, 256),  # 256 rows only at d = 40
        (2048, 8, 40, 128, 128),  # 256 rows would give 64 blocks
        (256, 8, 40, 64, 32),
        (1024, 2, 64, 64, 32),
        (192, 8, 80, 64, 24),  # not a multiple of 128
    ],
)
def test_block_rows(sq, bh, d, rows, blocks):
    """The launcher's choice of query rows per block is a pure function of
    the shape; the two long main-path shapes of sd15 at 512x512 get a grid
    that covers the card's 132 SMs once (128 blocks)."""
    assert FA.block_rows(sq, bh, d) == rows
    assert rows in FA.row_plans(sq, d)
    assert sq // rows * bh == blocks
    # a larger block is taken only where the grid still covers the card
    assert rows == FA.KEY_TILE or blocks >= FA.FULL_GRID


@pytest.mark.parametrize("sq,bh", [(100, 8), (0, 8), (256, 0)], ids=["ragged", "empty", "no_heads"])
def test_block_rows_rejects(sq, bh):
    with pytest.raises(ValueError):
        FA.block_rows(sq, bh, 40)


def _smoke():
    """``chip_smoke.py`` at the repository root, loaded as a module (its
    phases run only under ``__main__``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "b,h,sq,sk,d,us,by",
    [
        (1, 8, 4096, 4096, 40, 21.71, "operations"),
        (1, 8, 1024, 1024, 80, 2.71, "operations"),
        (1, 8, 256, 256, 160, 0.78, "bytes"),
    ],
)
def test_smoke_bound_of_k1(b, h, sq, sk, d, us, by):
    """The bound ``chip_smoke.py`` prints beside K1's time: the larger of
    4 Sq Sk d flops per head over 989 TFLOP/s and the bf16 bytes of q, k, v
    and o over 3.35 TB/s."""
    ms, which = _smoke().k1_bound(b, h, sq, sk, d)
    assert which == by and round(ms * 1e3, 2) == us


def test_smoke_bar_of_k1_catches_a_dropped_key_tile(rng):
    """The bar ``chip_smoke.py`` holds K1 to (two bf16 ulps of the largest
    output; mean |d| within 2^-7 of mean |out|) passes a second bf16 rounding
    of the same math and fails an attention that skipped one key tile in 64."""
    smoke = _smoke()
    sq, sk, d = 256, 4096, 40
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, d)).astype(np.float32)).bfloat16()
               for n in (sq, sk, sk))
    ref = FA.flash_attention_reference(q, k, v, d ** -0.5)
    # the same attention with the normalization after P V, as the kernel has it
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    late = (torch.matmul(p.bfloat16().float(), v.float()) / p.sum(-1, keepdim=True)).bfloat16()
    dropped = FA.flash_attention_reference(q, k[:, 64:], v[:, 64:], d ** -0.5)
    assert smoke.k1_within_bar(late, ref)[0]
    ok, mx, mean, max_bar, mean_bar = smoke.k1_within_bar(dropped, ref)
    assert not ok and mean > mean_bar


def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize(
    "q,k,v,heads,match",
    [
        (_meta(1, 128, 80, dtype=torch.float32), _meta(1, 128, 80), _meta(1, 128, 80), 2,
         "bfloat16"),
        (_meta(1, 128, 96), _meta(1, 128, 96), _meta(1, 128, 96), 2, "head dim 48"),
        (_meta(1, 100, 80), _meta(1, 128, 80), _meta(1, 128, 80), 2, "multiples of 64"),
        (_meta(1, 128, 80), _meta(1, 96, 80), _meta(1, 96, 80), 2, "multiples of 64"),
        (_meta(1, 128, 80), _meta(1, 128, 80), _meta(1, 256, 80), 2, "3-D q/k/v"),
        (_meta(1, 128, 80), _meta(2, 128, 80), _meta(2, 128, 80), 2, "disagree"),
        (_meta(1, 128, 160)[:, :, ::2], _meta(1, 128, 80), _meta(1, 128, 80), 2,
         "unit inner stride"),
        (_meta(1, 128, 84)[:, :, 4:], _meta(1, 128, 80), _meta(1, 128, 80), 2, "16-byte"),
        (_meta(1, 128, 84)[:, :, :80], _meta(1, 128, 80), _meta(1, 128, 80), 2, "16-byte"),
        (_meta(1, 128, 80), torch.zeros(1, 128, 80, dtype=torch.bfloat16),
         _meta(1, 128, 80), 2, "one CUDA device"),
        (_meta(1, 128, 80), _meta(1, 128, 80), _meta(1, 128, 80), 2, "one CUDA device"),
    ],
    ids=["dtype", "head_dim", "sq", "sk", "kv_shapes", "batch", "inner_stride", "offset",
         "row_stride", "device_mix", "not_cuda"],
)
def test_wrapper_refusals(q, k, v, heads, match):
    launches = FA.launches
    with pytest.raises(ValueError, match=match):
        FA.flash_attention(q, k, v, num_heads=heads)
    assert FA.launches == launches
