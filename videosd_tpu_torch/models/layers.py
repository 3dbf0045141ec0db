"""Core layer library of the port: NCHW torch ops with the JAX numerics.

Counterpart of ``videosd_tpu/models/layers.py``.  Each op keeps the
reference's precision points:

* convs and linears are torch's own modules: cuDNN and cuBLAS run bf16
  products with fp32 accumulation and add the bias in their fp32 epilogue
  before the one cast to bf16, as the JAX ops do,
* group_norm: fp32 E[x^2] - E[x]^2 statistics clamped at 0,
* layer_norm and softmax in fp32,
* attention routes exactly the shapes the JAX package sends to its Pallas
  flash kernel to kernel K1 (``ops/cuda/flash_attention.py``); the rest is
  the plain ``_attention_xla`` math.  Under autograd a routed attention
  goes through :class:`FlashAttentionRecompute` (K1 forward, the backward
  kernels that recompute the logits tile by tile: the JAX
  ``_attention_pallas_diff``),
* the int8 w8a8 linear (:func:`quantize_linear`, :func:`linear_w8a8`,
  :class:`LinearW8A8`, chosen per layer by ``ops/quant.py``) follows JAX's
  ``quantize_linear``/``linear_w8a8`` operation for operation, with the
  int8 x int8 -> int32 product on ``torch._int_mm`` (cuBLASLt on the card),
  as JAX ran it with ``lax.dot_general`` outside any Pallas kernel.

``GroupNorm`` and ``LayerNorm`` are torch's modules with these forwards, so
state-dict keys stay diffusers' own.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from videosd_tpu_torch.ops.cuda.flash_attention import (
    MAX_HEAD_DIM,
    flash_attention,
    flash_attention_bwd,
    flash_attention_lse,
    flash_attention_reference,
)
from videosd_tpu_torch.ops.sobel import div_rn

__all__ = [
    "FlashAttentionRecompute",
    "GroupNorm",
    "LayerNorm",
    "LinearW8A8",
    "attention",
    "avg_pool2d",
    "geglu",
    "group_norm",
    "guidance_embedding",
    "layer_norm",
    "linear_w8a8",
    "quantize_linear",
    "routes_to_flash",
    "timestep_embedding",
    "upsample_conv2d",
    "upsample_nearest2d",
]


# ---------------------------------------------------------------- norms


def group_norm(x, weight, bias, *, groups: int = 32, eps: float = 1e-5):
    """GroupNorm over the channel axis (dim 1) of NCHW, fp32 statistics."""
    b, c = x.shape[:2]
    xf = x.float()
    xg = xf.reshape(b, groups, -1)
    mean = xg.mean(-1, keepdim=True)
    var = torch.clamp((xg * xg).mean(-1, keepdim=True) - mean * mean, min=0.0)
    xf = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.ndim - 2)
    xf = xf * weight.float().reshape(cshape) + bias.float().reshape(cshape)
    return xf.to(x.dtype)


def layer_norm(x, weight, bias, *, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps).to(
        x.dtype
    )


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return group_norm(x, self.weight, self.bias, groups=self.num_groups, eps=self.eps)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


# ---------------------------------------------------------------- attention


def routes_to_flash(sq: int, sk: int, masked: bool) -> bool:
    """The JAX package's rule for sending an attention to its flash kernel
    (``videosd_tpu/models/layers.py:attention``): unmasked, both sequence
    lengths multiples of 128, at least 128 queries and 256 keys."""
    return not masked and sq % 128 == 0 and sk % 128 == 0 and sk >= 256 and sq >= 128


def attention(q, k, v, *, num_heads: int, mask=None):
    """Multi-head scaled-dot-product attention on ``[B, S, H*D]`` tensors.

    Routed shapes (:func:`routes_to_flash`) go to kernel K1; the 77-token
    cross-attention, CLIP's causal attention and short self-attention use
    the plain math, as XLA ran them in the JAX package.  Where a gradient
    is wanted (grad mode on and q, k or v requiring grad), a routed shape
    goes through :class:`FlashAttentionRecompute`, since the kernel's
    output carries no autograd history; otherwise (inference, graph
    capture) the wrapper is called as it is.
    """
    if routes_to_flash(q.shape[1], k.shape[1], mask is not None):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttentionRecompute.apply(q, k, v, num_heads)
        return flash_attention(q, k, v, num_heads=num_heads)
    return _attention_plain(q, k, v, num_heads, mask)


class FlashAttentionRecompute(torch.autograd.Function):
    """K1 forward with a backward that recomputes the logits.

    The port's counterpart of ``videosd_tpu/models/layers.py::
    _attention_pallas_diff`` (a ``jax.custom_vjp`` whose backward runs
    ``jax.vjp`` of ``_attention_xla``, recomputed).  The forward is
    :func:`flash_attention_lse` (K1 on CUDA, the plain version on the CPU),
    which also gives each row's log-sum-exp; q, k, v, the output and that
    lse are saved.  The backward is :func:`flash_attention_bwd`: on CUDA the
    backward kernels (``csrc/flash_attention_bwd.cu`` in bf16,
    ``csrc/flash_attention_bwd_fp32.cu`` in fp32), which recompute the
    logits tile by tile from lse and never hold them whole, on the CPU the
    same formula in plain PyTorch.  The gradients are the plain function's
    up to the order of sums and where P and dS round to the input dtype.

    Above :data:`MAX_HEAD_DIM` (only the KL VAE's attention, which no train
    step trains) there is no backward kernel: by the head dim, q, k and v
    alone are saved and the backward differentiates :func:`_attention_plain`
    on them, recomputed.
    """

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        if q.shape[-1] // num_heads > MAX_HEAD_DIM:
            ctx.save_for_backward(q, k, v)
            return flash_attention(q, k, v, num_heads=num_heads)
        out, lse = flash_attention_lse(q, k, v, num_heads=num_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        if len(ctx.saved_tensors) == 3:  # d > MAX_HEAD_DIM: the plain math, recomputed
            with torch.enable_grad():
                qkv = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
                out = _attention_plain(*qkv, ctx.num_heads)
                grads = iter(torch.autograd.grad(out, [x for x in qkv if x.requires_grad],
                                                 grad_out))
            return (*(next(grads) if n else None for n in need), None)
        q, k, v, out, lse = ctx.saved_tensors
        scale = 1.0 / math.sqrt(q.shape[-1] // ctx.num_heads)
        grads = flash_attention_bwd(q, k, v, out, lse, grad_out.contiguous(), ctx.num_heads, scale)
        return (*(g if n else None for g, n in zip(grads, need)), None)


def _attention_plain(q, k, v, num_heads: int, mask=None):
    b, sq, d = q.shape
    sk = k.shape[1]
    h = num_heads
    dh = d // h

    def split(x, s):
        return x.reshape(b, s, h, dh).transpose(1, 2)

    out = flash_attention_reference(
        split(q, sq), split(k, sk), split(v, sk), 1.0 / math.sqrt(dh), mask
    )
    return out.transpose(1, 2).reshape(b, sq, d)


# ---------------------------------------------------------------- int8 linears

# calls of torch._int_mm on a CUDA tensor (the int8 product of linear_w8a8)
int_mm_launches = 0


def quantize_linear(weight, bias=None) -> dict:
    """A linear's torch-layout ``weight`` [out, in] (and ``bias``) in int8
    w8a8 form, as JAX's ``quantize_linear``: symmetric per-output-channel
    scales ``sw = max(max|weight[n, :]|, 1e-8) / 127`` (fp32 [out]) and
    ``w8 = round(weight / sw)`` clipped to +-127 (int8 [out, in]); the bias
    stays, in fp32.  Every division is a true one on any device
    (:func:`div_rn`)."""
    k = weight.detach().float()
    sw = div_rn(torch.clamp_min(k.abs().amax(dim=1), 1e-8), 127.0)
    w8 = torch.clamp(torch.round(k / sw[:, None]), -127, 127).to(torch.int8)
    q = {"w8": w8, "sw": sw}
    if bias is not None:
        q["bias"] = bias.detach().float()
    return q


def linear_w8a8(x, w8, sw, bias=None):
    """int8 x int8 -> int32 linear with a dynamic per-tensor activation
    scale, JAX's ``linear_w8a8`` step for step: ``sx = max(max|x|, 1e-6) /
    127`` over the whole tensor (a 0-dim tensor on x's device), the codes
    ``round(x / sx)`` clipped to +-127, their product with ``w8`` in int32,
    then ``y * (sw * sx) + bias`` in fp32 and one cast to x's dtype.

    On the card the product is ``torch._int_mm``, which wants more than 16
    rows and K, N multiples of 8: fewer rows are padded with zero rows
    (exact: they move neither the scale nor the kept rows); a K or N off
    the multiple raises."""
    global int_mm_launches
    n, k = w8.shape
    if x.shape[-1] != k:
        raise ValueError(f"linear_w8a8: input width {x.shape[-1]} != the weight's {k}")
    xf = x.float()
    sx = div_rn(torch.clamp_min(xf.abs().amax(), 1e-6), 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8).reshape(-1, k)
    m = xq.shape[0]
    if x.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"the int8 product on the card needs K and N multiples of 8, "
                             f"got K = {k}, N = {n}")
        if m <= 16:
            xq = torch.cat([xq, xq.new_zeros(32 - m, k)])
        int_mm_launches += 1
    y = torch._int_mm(xq, w8.t())[:m]
    y = y.float() * (sw * sx)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], n)


class LinearW8A8(nn.Module):
    """A linear in int8 w8a8 form: buffers ``w8`` (int8 [out, in]), ``sw``
    (fp32 [out]) and, where the linear had one, ``bias`` (fp32 [out]); its
    forward is :func:`linear_w8a8`.  The state-dict keys are the linear's
    own prefix with ``w8``/``sw``/``bias``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w8", torch.zeros(out_features, in_features, dtype=torch.int8,
                                               device=device))
        self.register_buffer("sw", torch.zeros(out_features, device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device) if bias else None)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "LinearW8A8":
        q = quantize_linear(linear.weight, linear.bias)
        mod = cls(linear.in_features, linear.out_features, linear.bias is not None,
                  device=linear.weight.device)
        for name, value in q.items():
            setattr(mod, name, value)
        return mod

    def forward(self, x):
        return linear_w8a8(x, self.w8, self.sw, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


# ---------------------------------------------------------------- embeddings


def timestep_embedding(
    timesteps,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
):
    """Sinusoidal timestep embedding (diffusers ``get_timestep_embedding``):
    [B] -> [B, dim] fp32."""
    t = torch.as_tensor(timesteps).float()
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = t[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def guidance_embedding(w, dim: int = 256):
    """LCM guidance-scale Fourier embedding: scaled by 1000, sin first, and
    log(10000)/(half-1) frequencies -- not the timestep convention."""
    w = torch.as_tensor(w).float() * 1000.0
    half = dim // 2
    step = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device) * -step)
    emb = w[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


# ---------------------------------------------------------------- ffn


def geglu(x, proj: nn.Module, out: nn.Module):
    """GEGLU feed-forward: exact erf gelu in fp32 compute, the tanh form in
    bf16 (the two differ below bf16 resolution)."""
    a, gate = proj(x).chunk(2, dim=-1)
    approx = "tanh" if x.dtype == torch.bfloat16 else "none"
    h = a * F.gelu(gate.float(), approximate=approx).to(x.dtype)
    return out(h)


# ---------------------------------------------------------------- resize


def avg_pool2d(x, window: int = 2):
    return F.avg_pool2d(x, window)


def upsample_nearest2d(x, factor: int = 2):
    return F.interpolate(x, scale_factor=factor, mode="nearest")


# phase (a, b) of the 2x grid reads source rows (i-1+a, i+a) and columns
# (j-1+b, j+b): F.pad's (left, right, top, bottom) for each
_PHASE_PADS = ((1, 0, 1, 0), (0, 1, 1, 0), (1, 0, 0, 1), (0, 1, 0, 1))


def upsample_conv2d(conv: nn.Conv2d, x, *, f32_out: bool = True):
    """``conv(upsample_nearest2d(x))`` for a 3x3 SAME conv, as four 2x2 convs
    at the source resolution whose outputs interleave into the 2x grid.
    Counterpart of ``videosd_tpu/models/layers.py::upsample_conv2d``.

    ``x``: NCHW; ``conv``'s weight OIHW.  Under nearest upsampling the 3x3
    window at output phase (a, b) covers a 2x2 patch of source pixels, so
    its kernel is the sum of the taps landing on each (rows: a=0 -> [k0,
    k1+k2], a=1 -> [k0+k1, k2]; columns likewise), summed in ``x``'s dtype
    as JAX sums them.  2.25x fewer MACs than the conv at the upsampled
    size; the same additions re-associated.  ``f32_out``: the convs give
    fp32 (JAX's ``preferred_element_type``) and the bias adds in fp32
    before the cast to ``x``'s dtype; else both stay in ``x``'s dtype.
    Library convs (``F.conv2d``), as JAX's are ``lax.conv``; not wired into
    the UNet, as JAX does not wire it (it measured neutral on the TPU)."""
    k = conv.weight.to(x.dtype)
    kernels = []
    for kr in (torch.stack([k[:, :, 0], k[:, :, 1] + k[:, :, 2]], dim=2),
               torch.stack([k[:, :, 0] + k[:, :, 1], k[:, :, 2]], dim=2)):
        kernels.append(torch.stack([kr[..., 0], kr[..., 1] + kr[..., 2]], dim=-1))
        kernels.append(torch.stack([kr[..., 0] + kr[..., 1], kr[..., 2]], dim=-1))
    acc = torch.float32 if f32_out else x.dtype
    xa = x.to(acc)
    outs = []
    for kk, pad in zip(kernels, _PHASE_PADS):
        y = F.conv2d(F.pad(xa, pad), kk.to(acc))
        if conv.bias is not None:
            y = y + conv.bias.to(acc)[:, None, None]
        outs.append(y.to(x.dtype))
    b, c, h, w = outs[0].shape
    y = torch.stack([torch.stack(outs[:2], dim=-1), torch.stack(outs[2:], dim=-1)], dim=3)
    return y.reshape(b, c, 2 * h, 2 * w)  # [B, C, h, 2, w, 2] -> the 2x grid
