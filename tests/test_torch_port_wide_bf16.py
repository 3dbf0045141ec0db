"""The order of sums of K1's wide bf16 kernel (``csrc/flash_attention_wide.cu``)
emulated on the CPU, against JAX's ``_attention_xla`` and the port's plain
version.

The kernel runs only on the card (``tests/test_torch_port_kernels_cuda.py``).
Here its arithmetic is replayed block by block from its plan
(``ops/cuda/flash_attention.py::wide_plan``): each block of a cluster forms
an fp32 partial of the 64 x 64 logits over its share of the depth panels,
as the sum of its two warpgroups' partials over the two halves of the
share; every block adds the cluster's partials in the same order (own +
peer for a pair, rank order for more), so all hold the same logits bit for
bit; then the online softmax per 64-key tile in the log2 domain, P rounded
to bf16 unnormalized, O kept in fp32 and divided by the row sum at the end.  The
emulation is held to K1's bf16 bar (two bf16 ulps of the largest output,
mean |d| within 2^-7 of the mean |output|), and a copy with the cluster's
exchange of partials dropped is held to miss it.  That the emulation meets
the bar does not single out the kernel's order from other blockwise orders
that meet it too (the full-depth logits in every slice, say); its order is
held bit for bit on the card, against the folded entry.  Change the
kernel's order, change this emulation with it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.models.layers import _attention_xla
from videosd_tpu_torch.ops.cuda import flash_attention as FA

torch.set_num_threads(1)  # see tests/test_torch_port_flash_attention.py


def _within_k1_bar(got, want):
    err = np.abs(got - want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return err.max() <= 2 * ulp and err.mean() <= np.abs(want).mean() / 128


def _logits(parts, cy):
    """The sum of a cluster's partials as block ``cy`` forms it."""
    if len(parts) == 2:
        return parts[cy] + parts[1 - cy]  # own + peer
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def kernel_attention(q, k, v, exchange=True):
    """One head as the wide kernel computes it: q ``[Sq, d]``, k and v
    ``[Sk, d]``, fp32 tensors holding bf16 values; returns fp32 ``[Sq, d]``
    (the kernel rounds it to bf16).  Without ``exchange`` each block keeps
    its own partial of the logits: the kernel with the cluster's exchange
    dropped, which the test must see."""
    sq, d = q.shape
    plan = FA.wide_plan(d)
    panels, cs = -(-d // 64), plan.cluster_slices
    pad = panels * 64 - d  # TMA reads the columns past d as zeros
    q, k, v = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    # each block's share of the depth panels, split between its two warpgroups
    shares = []
    for r in range(cs):
        lo, hi = r * panels // cs, (r + 1) * panels // cs
        mid = lo + (hi - lo) // 2
        shares.append(((lo * 64, mid * 64), (mid * 64, hi * 64)))
    scale = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                      dtype=torch.float32)
    out = torch.zeros(sq, panels * 64)
    for m0 in range(0, sq, 64):
        qt = q[m0:m0 + 64]
        for y in range(plan.grid_slices):
            c0 = y * FA.WIDE_SLICE
            cols = slice(c0, min(c0 + FA.WIDE_SLICE, panels * 64))
            m = torch.full((64, 1), -math.inf)
            l = torch.zeros(64, 1)
            acc = torch.zeros(64, cols.stop - cols.start if c0 < d else 0)
            for t in range(0, k.shape[0], 64):
                kt = k[t:t + 64]
                parts = [qt[:, a:b] @ kt[:, a:b].T + qt[:, c:e] @ kt[:, c:e].T
                         for (a, b), (c, e) in shares]
                s = _logits(parts, y % cs) if exchange else parts[y % cs]
                m_new = torch.maximum(m, s.max(1, keepdim=True).values * scale)
                alpha = torch.exp2(m - m_new)
                # one rounding, as the kernel's fmaf
                p = torch.exp2((s.double() * scale.double() - m_new.double()).float())
                m, l = m_new, l * alpha + p.sum(1, keepdim=True)
                if c0 < d:
                    acc = acc * alpha + p.bfloat16().float() @ v[t:t + 64, cols]
            if c0 < d:
                out[m0:m0 + 64, cols] = acc / torch.where(l == 0, 1.0, l)
    return out[:, :d]


def _heads(rng, b, s, h, d, loud):
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    if loud:
        x[:, :, 1::2] *= loud
    return x.reshape(b, s, h * d)


# (batch, sq, sk, heads, d, loud): the KL VAE's d = 512 on 8 key tiles; d = 264
# (5 panels: shares of 2 and 3, a second slice of one panel) with loud odd
# heads (q and k 8x, v / 8); d = 520 on one query and one key tile (3 slices:
# the rank-order sum)
_CASES = [(1, 512, 512, 1, 512, None), (1, 128, 256, 2, 264, 8.0), (1, 64, 64, 1, 520, None)]


@pytest.mark.parametrize("b,sq,sk,h,d,loud", _CASES, ids=["d512", "d264_loud", "d520_one_tile"])
def test_kernel_order_within_the_k1_bar(rng, b, sq, sk, h, d, loud):
    q = _heads(rng, b, sq, h, d, loud)
    k = _heads(rng, b, sk, h, d, loud)
    v = _heads(rng, b, sk, h, d, 1 / loud if loud else None)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))

    def split(x):
        return x.float().reshape(b, x.shape[1], h, d).transpose(1, 2)

    def emulate(exchange):
        out = torch.stack([torch.stack([kernel_attention(qq, kk, vv, exchange)
                                        for qq, kk, vv in zip(*hs)])
                           for hs in zip(split(tq), split(tk), split(tv))])
        return out.transpose(1, 2).reshape(b, sq, h * d).bfloat16().float().numpy()

    got = emulate(True)
    plain = FA.flash_attention(tq, tk, tv, num_heads=h).float().numpy()
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(_attention_xla(jq, jk, jv, h).astype(jnp.float32))
    assert np.isfinite(got).all()
    assert _within_k1_bar(got, want)
    assert _within_k1_bar(got, plain)
    assert not _within_k1_bar(emulate(False), want)
