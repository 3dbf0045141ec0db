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
        (4096, 8, (256, 128, 64)),  # the tiny family's heads: four warpgroups too
        (1024, 16, (256, 128, 64)),
        (4096, 24, (256, 128, 64)),  # on the 40-wide instance
        (4096, 72, (128, 64)),  # on the 80-wide instance
        (4096, 200, (64,)),  # on the 256-wide instance: two Q tiles leave no ring
        (4096, 256, (64,)),
        (256, 20, (256, 128, 64)),  # padded to 24 by the wrapper
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
    "b,h,sq,sk,d,dtype,us,by,term",
    [
        # the exponentials, not the tensor cores, bound the main path's longest
        # shape: 8 * 4096^2 ex2 at 16 per clock on 132 SMs
        (1, 8, 4096, 4096, 40, "bf16", 32.10, "operations", "ex2"),
        (1, 8, 1024, 1024, 80, "bf16", 2.71, "operations", "bf16 flops"),
        (1, 8, 256, 256, 160, "bf16", 0.78, "bytes", "bytes"),
        (1, 4, 1024, 1024, 8, "bf16", 1.00, "operations", "ex2"),  # the tiny family
        (1, 4, 256, 256, 16, "bf16", 0.06, "operations", "ex2"),
        # fp32 products at the faster of FFMA (66.9 TFLOP/s at 1.98 GHz) and
        # 3xTF32 on the tensor cores (494.7 / 3 = 164.9 TFLOP/s)
        (1, 8, 4096, 4096, 40, "fp32", 130.23, "operations", "fp32 flops"),
        (1, 4, 1024, 1024, 8, "fp32", 1.00, "operations", "ex2"),
        (1, 1, 4096, 4096, 512, "fp32", 208.37, "operations", "fp32 flops"),  # the KL VAE
    ],
)
def test_smoke_bound_of_k1(b, h, sq, sk, d, dtype, us, by, term):
    """The bound ``chip_smoke.py`` prints beside K1's time, at an SM clock of
    1.98 GHz: the largest of 4 Sq Sk d flops per head over the peak of their
    type (989 TFLOP/s in bf16; in fp32 the faster of 132 SMs x 128 FFMA lanes
    x 2 x the clock and 3xTF32, 494.7 / 3 TFLOP/s), Sq Sk exponentials per
    head over 16 per clock per SM, and the bytes of q, k, v and o over 3.35
    TB/s."""
    ms, which, what = _smoke().k1_bound(b, h, sq, sk, d, 1.98e9, dtype)
    assert (which, what) == (by, term) and round(ms * 1e3, 2) == us


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


_F16 = torch.float16


@pytest.mark.parametrize(
    "q,k,v,heads,match",
    [
        (_meta(1, 128, 80, dtype=_F16), _meta(1, 128, 80, dtype=_F16),
         _meta(1, 128, 80, dtype=_F16), 2, "got torch.float16"),
        (_meta(1, 128, 528, dtype=_F16), _meta(1, 128, 528, dtype=_F16),
         _meta(1, 128, 528, dtype=_F16), 2, "got torch.float16"),
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
        (_meta(1, 100, 1024), _meta(1, 128, 1024), _meta(1, 128, 1024), 2, "multiples of 64"),
        (_meta(1, 128, 80, dtype=torch.float32), _meta(1, 128, 80), _meta(1, 128, 80), 2,
         "like q"),
        (_meta(1, 128, 84, dtype=torch.float32)[:, :, 2:82], _meta(1, 128, 80, dtype=torch.float32),
         _meta(1, 128, 80, dtype=torch.float32), 2, "16-byte"),
    ],
    ids=["dtype", "head_dim", "sq", "sk", "kv_shapes", "batch", "inner_stride", "offset",
         "row_stride", "device_mix", "not_cuda", "head_dim_512", "dtype_mix", "fp32_offset"],
)
def test_wrapper_refusals(q, k, v, heads, match):
    launches = FA.launches
    with pytest.raises(ValueError, match=match):
        FA.flash_attention(q, k, v, num_heads=heads)
    assert FA.launches == launches


def _within_k1_bar(got, want):
    """The bar ``chip_smoke.py`` holds K1 to in bf16: max |d| within two bf16
    ulps of the largest output, mean |d| within 2^-7 of the mean |output|."""
    err = np.abs(got - want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return err.max() <= 2 * ulp and err.mean() <= np.abs(want).mean() / 128


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,h,dh", [(1, 256, 256, 4, 8), (2, 128, 256, 4, 16),
                                          (1, 128, 256, 2, 24), (1, 256, 512, 2, 64)],
                         ids=["d8", "b2_d16", "d24", "kv512_d64"])
def test_plain_version_matches_jax_at_every_head_dim(rng, b, sq, sk, h, dh, dtype):
    """The plain version, which the CUDA kernels are held to on the card,
    against ``_attention_xla`` at the tiny family's head dims, at a d below
    its kernel instance's width and at d = 64, with Sk = 2 Sq, in fp32 (1e-5:
    the same math) and bf16 (chip_smoke's K1 bar: both round P and the
    output to bf16 after fp32 math)."""
    q, k, v = _qkv(rng, b, sq, sk, h, dh)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    if dtype == "bf16":
        tq, tk, tv = (x.bfloat16() for x in (tq, tk, tv))
        jq, jk, jv = (x.astype(jnp.bfloat16) for x in (jq, jk, jv))
    got = FA.flash_attention(tq, tk, tv, num_heads=h)
    assert got.dtype == tq.dtype
    want = np.asarray(_attention_xla(jq, jk, jv, h).astype(jnp.float32))
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        assert _within_k1_bar(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,h,dh", [(1, 128, 256, 2, 264), (1, 256, 256, 1, 512)],
                         ids=["d264", "vae_d512"])
def test_plain_version_matches_jax_above_256(rng, b, sq, sk, h, dh, dtype):
    """Above d = 256 (the wide kernel's range; the KL VAE's mid attention is
    one head of 512): the plain version against ``_attention_xla`` at the
    same bars as below, through the routed ``layers.attention``."""
    assert PL.routes_to_flash(sq, sk, masked=False)
    q, k, v = _qkv(rng, b, sq, sk, h, dh)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    if dtype == "bf16":
        tq, tk, tv = (x.bfloat16() for x in (tq, tk, tv))
        jq, jk, jv = (x.astype(jnp.bfloat16) for x in (jq, jk, jv))
    launches = FA.launches_wide, FA.launches_wide_fp32
    got = PL.attention(tq, tk, tv, num_heads=h)
    assert (FA.launches_wide, FA.launches_wide_fp32) == launches  # the CPU never launches
    want = np.asarray(_attention_xla(jq, jk, jv, h).astype(jnp.float32))
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        assert _within_k1_bar(got.float().numpy(), want)


# (sq, d) -> (cluster_slices, grid_slices, share, q_resident, ring_slots); the
# plan is d's alone, sq gives the grid's query tiles
_WIDE_PLANS = {
    (4096, 512): (2, 2, 4, True, 4),  # the KL VAE at 512x512: 64 tiles, clusters of 2 slices
    (192, 512): (2, 2, 4, True, 4),  # 3 query tiles
    (64, 520): (3, 3, 3, True, 4),  # one query tile, 9 panels over 3 slices
    (256, 264): (2, 2, 3, True, 4),  # 5 panels: shares of 2 and 3
    (320, 257): (2, 2, 3, True, 4),  # 5 query tiles
    (256, 640): (3, 3, 4, True, 4),  # a cluster of 3
    (256, 1600): (7, 7, 4, True, 4),  # 7 slices
    (128, 2048): (8, 8, 4, True, 4),  # the widest head one cluster takes
    (128, 2568): (6, 12, 7, True, 3),  # 11 slices in two clusters of 6, one block without columns
    (128, 4096): (8, 16, 8, True, 3),  # the widest share kept resident (2 clusters of 8)
    (128, 8200): (7, 35, 19, False, 5),  # a share past the resident limit: Q streams
}


@pytest.mark.parametrize("sq, d", list(_WIDE_PLANS), ids=lambda x: str(x))
def test_wide_plan(sq, d):
    """The bf16 wide kernel's plan: a block per 64 query rows and 256 output
    columns; the slices of a query tile in one cluster of at most 8 (more
    slices in clusters of equal size, padded with blocks that own no
    columns), whose blocks split the depth panels of Q K^T (every block a
    share, the shares covering the depth); the grid (Sq / 64, grid_slices)
    a multiple of the cluster (1, cluster_slices) at any count of query
    tiles; Q's share resident beside a ring of at least 3 slots of 4 panels,
    else streamed through a ring of 5, all within the block's shared memory;
    the d <= 256 kernels' range and ragged lengths refused."""
    plan = FA.wide_plan(d)
    assert tuple(plan[:5]) == _WIDE_PLANS[sq, d]
    cs, grid_y = plan.cluster_slices, plan.grid_slices
    assert 2 <= cs <= FA.WIDE_MAX_CLUSTER
    assert grid_y % cs == 0
    slices = FA.wide_slices(d)
    assert slices <= grid_y < slices + grid_y // cs  # each cluster pads by less than a block
    panels = -(-d // 64)
    shares = [(r + 1) * panels // cs - r * panels // cs for r in range(cs)]
    assert sum(shares) == panels and min(shares) >= 1 and max(shares) == plan.share
    held = plan.share if plan.q_resident else 0
    assert held + plan.ring_slots * FA.WIDE_GROUP <= FA.WIDE_PANELS
    # a slot per S group and P V's, and one to fill: 3 resident, 4 streamed (Q's beside K's)
    assert plan.ring_slots >= (FA.WIDE_MIN_SLOTS if plan.q_resident else 4)
    static = (2 * FA.WIDE_PANELS // FA.WIDE_GROUP + 3) * 8  # the kernel's mbarriers
    assert plan.smem == 1024 + 4 * 64 * 64 * 4 + FA.WIDE_PANELS * 8192
    assert plan.smem + static <= FA.SMEM_LIMIT
    with pytest.raises(ValueError, match="d <= 256"):
        FA.wide_plan(256)
    ragged = torch.zeros(1, sq + 32, d, dtype=torch.bfloat16)
    keys = torch.zeros(1, 64, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 64"):
        FA._launch(ragged, keys, keys, 1, d ** -0.5)


@pytest.mark.parametrize("d, slices, resident", [(257, 1, True), (264, 1, True), (512, 1, True),
                                                 (516, 2, True), (576, 2, True), (580, 2, False),
                                                 (640, 2, False), (1024, 2, False),
                                                 (1600, 4, False)])
def test_wide_fp32_plan(d, slices, resident):
    """The fp32 wide kernel's plan: one block per 512 output columns of each
    32-row query tile (one at the KL VAE's d = 512: the logits formed once);
    Q's 32 rows resident in shared memory (at a stride of d rounded up to 32,
    plus 16) beside a ring of at least 4 K chunks up to d = 576, streamed in
    a ring of 4 beside K's above, within the block's shared memory."""
    assert FA.wide_slices(d, torch.float32) == slices
    assert FA.wide_fp32_q_resident(d) is resident
    stride = -(-d // 32) * 32 + 16
    q_bytes = 4 * FA.WIDE_ROWS_FP32 * stride if resident else 0
    slot = FA.WIDE_FP32_CHUNK_BYTES * (1 if resident else 2)  # a K chunk, and Q's if it streams
    slots = (FA.SMEM_LIMIT - 1024 - FA.WIDE_FP32_FIXED_SMEM - q_bytes) // slot
    assert slots >= FA.WIDE_FP32_MIN_SLOTS
    assert stride % 32 == 16  # Q's float4 fragment loads: a quarter warp on distinct banks
    with pytest.raises(ValueError, match="d <= 256"):
        FA.wide_slices(256, torch.float32)


@pytest.mark.parametrize("d,dp", [(20, 24), (5, 8), (6, 8), (250, 256)])
def test_padded_heads_change_nothing(rng, d, dp):
    """The wrapper's path for a d off the 16-byte rows: heads folded into a
    zero-padded [B*H, S, dp] copy, the kernel's math at the real d's scale,
    the padded columns cut off.  On the CPU, with the plain version in the
    kernel's place, it equals the attention of the unpadded heads."""
    b, sq, sk, h = 2, 64, 128, 3
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, b, sq, sk, h, d))
    folded = [FA._fold_padded(x, h, dp) for x in (q, k, v)]
    assert folded[0].shape == (b * h, sq, dp) and (folded[0][..., d:] == 0).all()
    out = FA._unfold_cut(FA.flash_attention_reference(*folded, d ** -0.5), b, h, d)
    np.testing.assert_allclose(out.numpy(), FA.flash_attention(q, k, v, num_heads=h).numpy(),
                               atol=1e-6, rtol=0)


def test_every_head_dim_has_an_instance_and_a_plan():
    """Every d from 1 to 256 (padded to a multiple of 8 where the wrapper
    pads it) runs on an instance at least as wide, whose Q K^T depth is a
    multiple of wgmma's k16, and every plan row_plans offers fits the
    register budget, a three-stage ring and the shared memory; 257 and 0
    are refused."""
    for d in range(1, FA.MAX_HEAD_DIM + 1):
        dp = -(-d // 8) * 8
        w = FA.instance_width(dp)
        assert w == FA.instance_width(d) and w in FA.INSTANCE_WIDTHS and w >= dp >= d
        assert FA.depth(w) % 16 == 0 and FA.depth(w) >= w
        plans = FA.row_plans(4096, d)
        assert plans[-1] == FA.KEY_TILE
        for rows in plans:
            nwg = rows // FA.KEY_TILE
            assert w // 2 + 48 + 44 <= FA.CONSUMER_REGISTERS[nwg]
            stages = FA.ring_stages(w, nwg)
            assert 3 <= stages <= 8
            assert (nwg + 2 * stages) * FA._tile_bytes(w) + 1024 <= FA.SMEM_LIMIT
    for d in (0, FA.MAX_HEAD_DIM + 1):
        with pytest.raises(ValueError, match="head dim"):
            FA.instance_width(d)


@pytest.mark.parametrize("d, width, rows, stages", [
    (8, 8, 64, 8), (16, 16, 64, 8),  # the tiny family's heads: a deep ring, two blocks an SM
    (20, 40, 64, 3), (40, 40, 64, 3),  # sd15 down0/up3: two blocks an SM
    (64, 64, 64, 6), (72, 80, 64, 4), (80, 80, 64, 4), (128, 128, 64, 5),
    (160, 160, 16, 5), (200, 256, 16, 3), (256, 256, 16, 3),
])
def test_fp32_plan(d, width, rows, stages):
    """The fp32 kernel's plan (``flash_attention_fp32.cu::Shape``): the
    instance, query rows per block (64 up to the 128-wide instance, 16
    above) and the K/V stages beside the resident Q, at least 3 within the
    shared memory of the blocks an SM holds (two up to 40 wide).  At sd15's
    [8, 256, 160] the grid is 128 blocks; ``_launch`` takes no other plan."""
    assert FA.fp32_instance_width(d) == width
    assert FA.fp32_block_rows(d) == rows
    assert FA.fp32_stages(d) == stages
    keys = 32 if width >= 128 else 64
    stage = 4 * keys * (16 * -(-width // 16) + 32 * -(-width // 32))
    smem = 1024 + stages * stage + 4 * 16 * -(-width // 16) * rows
    blocks = 2 if width <= 40 else 1
    assert FA.FP32_MIN_STAGES <= stages <= FA.FP32_MAX_STAGES
    assert blocks * (smem + 3072 + 1024) <= FA.SMEM_PER_SM and smem + 3072 <= FA.SMEM_LIMIT
    if d == 160:
        assert 256 // rows * 8 == 128
    with pytest.raises(ValueError, match="head dim"):
        FA.fp32_instance_width(257)


def test_every_head_dim_has_an_fp32_instance():
    """Every d from 1 to 256 (padded to a multiple of 4 where the wrapper
    pads it) runs on an fp32 instance at least as wide, with a ring of at
    least 3 stages."""
    for d in range(1, FA.MAX_HEAD_DIM + 1):
        dp = -(-d // 4) * 4
        w = FA.fp32_instance_width(dp)
        assert w in FA.FP32_WIDTHS and w >= dp
        assert FA.fp32_stages(dp) >= FA.FP32_MIN_STAGES
        assert FA.fp32_block_rows(dp) in (16, 64)
