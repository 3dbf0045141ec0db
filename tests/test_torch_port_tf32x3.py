"""The numerics of K1's fp32 kernels (``csrc/flash_attention_fp32.cu``, d <=
256, and ``csrc/flash_attention_wide_fp32.cu``), emulated on the CPU.

Both kernels run both products of attention on the tensor cores in 3xTF32:
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

The d <= 256 kernel is also emulated in its own accumulation order
(:func:`kernel_attention`): each mma adds one k-step's exact products to its
accumulator and truncates the sum to fp32, as the tensor cores do; a key
tile's logits are summed per depth chunk of 32 and the chunks added in fp32;
P V is summed per key tile into a partial that one fp32 fma adds to O; up to
the 128-wide instance each half of a key tile feeds its own softmax state,
and the two merge at the end.
"""

import importlib.util
import math
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


def _rz(x):
    """fp64 ``x`` to fp32, rounded toward zero: how the tensor cores round
    the fp32 sum an mma adds into its accumulator."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _mma_chain(acc, a, b, products):
    """``acc`` += a @ b over one k-step of 8 as the kernel issues it: three
    mma (small*big, big*small, big*big) or, with ``products`` 1, big*big
    alone; each mma's sum truncated to fp32."""
    ab, bb = tf32(a), tf32(b)
    terms = [(ab, bb)] if products == 1 else [
        (truncated(a - ab), bb), (ab, truncated(b - bb)), (ab, bb)]
    for x, y in terms:
        acc = _rz(acc.double() + x.double() @ y.double())
    return acc


def _fma(a, b, c):
    """fp32 a * b + c with one rounding (fmaf)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_attention(q, k, v, products=3):
    """softmax(q k^T d^-1/2) v on ``[H, S, d]`` fp32 tensors in the d <= 256
    kernel's order: key tiles of 64 (32 from the 128-wide instance), whose
    two halves go to two softmax states up to the 128-wide instance (one
    state over whole tiles above); depth padded to 8 with zeros; a state's
    logits summed per depth chunk of 32 and the chunks added in fp32, the
    online softmax in the log2 domain, and P V summed over the state's keys
    of a tile before O = fma(O, alpha, P V); the two states rescaled to the
    larger max and added at the end."""
    d = q.shape[-1]
    w = FA.fp32_instance_width(d)
    halves = 1 if w > 128 else 2
    step = (32 if w >= 128 else 64) // halves  # keys a state takes from each tile
    dp = -(-d // 8) * 8
    q, k = (torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k))
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    h, sq = q.shape[:2]
    states = [[torch.full((h, sq, 1), -math.inf), torch.zeros(h, sq, 1), torch.zeros(h, sq, d)]
              for _ in range(halves)]
    for i, j in enumerate(range(0, k.shape[1], step)):
        state = states[i % halves]
        m, l, o = state
        kt, vt = k[:, j:j + step], v[:, j:j + step]
        s = torch.zeros(h, sq, step)
        for c in range(0, dp, 32):
            part = torch.zeros(h, sq, step)
            for ks in range(c, min(c + 32, dp), 8):
                part = _mma_chain(part, q[..., ks:ks + 8], kt[..., ks:ks + 8].transpose(1, 2),
                                  products)
            s = s + part
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(_fma(s, scale_log2, -m_new))
        pv = torch.zeros(h, sq, d)
        for ks in range(0, step, 8):
            pv = _mma_chain(pv, p[..., ks:ks + 8], vt[:, ks:ks + 8], products)
        state[:] = m_new, _fma(l, alpha, p.sum(-1, keepdim=True)), _fma(o, alpha, pv)
    m, l, o = states[0]
    if halves == 2:
        m2, l2, o2 = states[1]
        top = torch.maximum(m, m2)
        mine, theirs = torch.exp2(m - top), torch.exp2(m2 - top)
        l, o = _fma(l2, theirs, l * mine), _fma(o2, theirs, o * mine)
    return o * torch.where(l == 0, 1.0, 1.0 / l)


@pytest.mark.parametrize("d", [8, 16, 40, 80, 160, 256])
def test_kernel_order_holds_the_fp32_bar(d):
    """Two heads of [64 queries, 256 keys] at each head dim the sd15 and
    tiny families send the d <= 256 fp32 kernel (and the widest), the second
    head loud (q and k 8x, v / 8: a peaked softmax), emulated in the
    kernel's accumulation order: 3xTF32 within chip_smoke.py's fp32 bars of
    the plain version computed in fp64 and of JAX's ``_attention_xla``, one
    TF32 product per product not."""
    smoke = _smoke()
    bars = smoke.FP32_MAX_REL, smoke.FP32_MEAN_REL
    rng = np.random.default_rng(d)
    h, sq, sk = 2, 64, 256
    q, k, v = (rng.standard_normal((1, n, h, d)).astype(np.float32) for n in (sq, sk, sk))
    q[:, :, 1] *= 8.0
    k[:, :, 1] *= 8.0
    v[:, :, 1] /= 8.0
    heads = [torch.from_numpy(np.ascontiguousarray(x[0].transpose(1, 0, 2))) for x in (q, k, v)]
    exact = torch.softmax(heads[0].double() @ heads[1].double().transpose(1, 2) * d ** -0.5,
                          dim=-1) @ heads[2].double()
    jax_out = np.array(_attention_xla(*(jnp.asarray(x.reshape(1, x.shape[1], h * d))
                                        for x in (q, k, v)), h))
    jax_heads = torch.from_numpy(jax_out.reshape(sq, h, d).transpose(1, 0, 2).copy())
    three = kernel_attention(*heads)
    one = kernel_attention(*heads, products=1)
    assert torch.isfinite(three).all() and three.shape == (h, sq, d)
    for ref in (exact.float(), jax_heads):
        assert _within(three, ref, *bars)
        assert not _within(one, ref, *bars)
