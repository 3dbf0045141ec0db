"""Flash attention (kernel K1) for the UNet and ControlNet self-attention.

Replaces ``videosd_tpu/ops/pallas/flash_attention.py::mha_flash`` (the TPU
kernel) and its head-split wrapper ``flash_attention``.  The CUDA source is
``videosd_tpu_torch/csrc/flash_attention.cu``; it is built on first launch
by :mod:`videosd_tpu_torch._build`.

* :func:`flash_attention_reference` is the plain PyTorch version: the
  ``_attention_xla`` math of the JAX package (fp32 logits and softmax, the
  probabilities cast to the input dtype before P.V).
* :func:`flash_attention_bhsd` is the kernel's wrapper on folded
  ``[B*H, S, D]`` tensors.  A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel or raises.  Each launch adds one to
  :data:`launches`.
* :func:`flash_attention` splits heads of ``[B, S, H*D]`` tensors, folds
  batch and heads, and unfolds the result, like the JAX wrapper minus its
  padding of D to 128 lanes.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "SUPPORTED_HEAD_DIMS",
    "flash_attention",
    "flash_attention_bhsd",
    "flash_attention_reference",
    "launches",
]

SUPPORTED_HEAD_DIMS = (40, 64, 80, 160)

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0


def flash_attention_reference(q, k, v, sm_scale: float, mask=None):
    """softmax(q k^T * sm_scale [+ mask]) v on ``[..., S, D]`` tensors.

    Logits and softmax in fp32; the probabilities are cast to ``q.dtype``
    and multiplied with ``v`` in fp32, then the result is cast back: the
    precision points of ``videosd_tpu.models.layers._attention_xla``.
    """
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def flash_attention_bhsd(q, k, v, sm_scale: float):
    """q ``[BH, Sq, D]``, k/v ``[BH, Sk, D]`` -> ``[BH, Sq, D]``."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sm_scale)
    return _launch(q, k, v, sm_scale)


def _launch(q, k, v, sm_scale: float):
    global launches
    from videosd_tpu_torch._build import load_library

    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel needs CUDA tensors, got {q.device}")
    lib = load_library()
    bm, bn = lib.videosd_flash_block_m(), lib.videosd_flash_block_n()
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3:
        raise ValueError(f"expected [BH,S,D] q/k/v, got {q.shape} {k.shape} {v.shape}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if sq % bm or sk % bn:
        raise ValueError(f"sequence lengths {sq}/{sk} must be multiples of {bm}/{bn}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.videosd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, sq, sk, d, float(sm_scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: cudaError {err}")
    launches += 1
    return out


def flash_attention(q, k, v, *, num_heads: int):
    """Multi-head attention on ``[B, S, H*D]`` tensors through the kernel."""
    b, sq, dm = q.shape
    sk = k.shape[1]
    h = num_heads
    dh = dm // h

    def fold(x, s):
        return x.reshape(b, s, h, dh).transpose(1, 2).reshape(b * h, s, dh).contiguous()

    out = flash_attention_bhsd(fold(q, sq), fold(k, sk), fold(v, sk), 1.0 / math.sqrt(dh))
    return out.reshape(b, h, sq, dh).transpose(1, 2).reshape(b, sq, dm)
