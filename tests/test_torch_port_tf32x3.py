"""The numerics of K1's fp32 wide kernel (``csrc/flash_attention_wide_fp32.cu``),
emulated on the CPU.

The kernel runs both products of attention on the tensor cores in 3xTF32:
each fp32 operand x splits into big = tf32(x), rounded to nearest with ties
away from zero at a 10-bit mantissa (as ``cvt.rna.tf32.f32``), and small =
x - big (exact), which the mma reads truncated to TF32; each product is
small*big + big*small + big*big, the small*small term dropped.  Here that
arithmetic runs in fp32
on the CPU (a product of two TF32 values is exact in fp32) at the VAE's
head dim, and is held to ``chip_smoke.py``'s fp32 bars (2^-13 of max |out|,
2^-16 of mean |out|) against the port's plain version and JAX's
``_attention_xla``.  One TF32 product per product must miss the same bars:
the bars tell the two apart before any card runs the kernel.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.models.layers import _attention_xla
from videosd_tpu_torch.ops.cuda import flash_attention as FA

# one torch thread per process (see test_torch_port_flash_attention.py)
torch.set_num_threads(1)


def _smoke():
    """``chip_smoke.py`` at the repository root, loaded as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tf32(x):
    """x rounded to TF32 (10-bit mantissa), to nearest with ties away from
    zero, on the int32 view: the kernel's ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(x):
    """x truncated to TF32: what the mma reads of an fp32 register."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a, b):
    """a @ b as the kernel forms it: small terms first, then big*big."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = truncated(a - a_big), truncated(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def matmul_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def attention(q, k, v, matmul):
    """The kernel's math: fp32 logits, probabilities relative to the row
    maximum, P V on the unnormalized probabilities, one division at the end."""
    s = matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return matmul(p, v) / p.sum(-1, keepdim=True)


def _within(out, ref, max_rel, mean_rel):
    err = (out - ref).abs()
    return (err.max().item() <= max_rel * ref.abs().max().item()
            and err.mean().item() <= mean_rel * ref.abs().mean().item())


@pytest.mark.parametrize("x, want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),  # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),  # below the tie: down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),  # a tie on an odd mantissa: away, not to even
    (2.0 - 2.0 ** -23, 2.0),  # the carry reaches the exponent
    (3.0, 3.0),
])
def test_tf32_rounds_to_nearest_ties_away(x, want):
    assert tf32(torch.tensor([x], dtype=torch.float32)).item() == want


def test_big_plus_small_is_x_to_21_bits():
    """big + small carries 21 of fp32's 24 bits: |x - big - small| <=
    2^-21 |x| for every x, where big alone is off by up to 2^-11 |x|."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1 << 16).astype(np.float32))
    big = tf32(x)
    small = truncated(x - big)
    assert torch.equal(x - big, x.double().sub(big.double()).float())  # the remainder is exact
    assert ((x - big).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((x - big - small).abs() <= 2.0 ** -21 * x.abs()).all()
    assert ((x - big).abs() > 2.0 ** -13 * x.abs()).any()


@pytest.mark.parametrize("loud", [1.0, 8.0], ids=["randn", "loud"])
def test_3xtf32_attention_holds_the_fp32_bar(loud):
    """[1, 512, 512] (the VAE's head dim, 512 keys): 3xTF32 within the fp32
    bars of the plain version and of JAX's ``_attention_xla``, 1xTF32 not.
    ``loud`` scales q and k by 8 and v by 1/8 (as the card tests' loud
    heads): logits 64x larger, a peaked softmax that amplifies errors in
    the logits."""
    smoke = _smoke()
    bars = smoke.FP32_MAX_REL, smoke.FP32_MEAN_REL
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 512, 512)).astype(np.float32) for _ in range(3))
    q, k, v = q * loud, k * loud, v / loud
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = FA.flash_attention_reference(tq, tk, tv, 512 ** -0.5)
    jax_out = torch.from_numpy(np.array(_attention_xla(*(jnp.asarray(x) for x in (q, k, v)), 1)))
    three = attention(tq, tk, tv, matmul_3xtf32)
    one = attention(tq, tk, tv, matmul_1xtf32)
    assert torch.isfinite(three).all() and three.shape == plain.shape
    for ref in (plain, jax_out):
        assert _within(three, ref, *bars)
        assert not _within(one, ref, *bars)
