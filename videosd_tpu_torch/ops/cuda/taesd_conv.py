"""The TAESD residual-block 3x3 conv with its fused epilogue (kernel K3).

Replaces ``videosd_tpu/ops/pallas/taesd_conv.py::packed_conv3x3`` (the TPU
kernel).  The CUDA source is ``videosd_tpu_torch/csrc/taesd_conv.cu``; it is
built on first launch by :mod:`videosd_tpu_torch._build`.

Activations keep the TPU kernel's pixel-pair-packed signature
``[B, H, W/2, 2C]``, which is the same memory as NHWC ``[B, H, W, C]``; the
kernel reads them as NHWC and runs the dense ``[C, C]`` taps (the packed
taps only filled the TPU's 128 lanes).

* :func:`supports` is the routing rule: C == 64, the TPU kernel's lane
  condition, and any H >= 1 and W/2 >= 1 (its strip conditions belonged to
  the TPU's tiling).
* :func:`packed_conv3x3_reference` is the plain PyTorch version, with the
  TPU kernel's precision points: fp32 accumulation, the bias, ReLU and skip
  epilogue in fp32, one cast to the input dtype at the end.
* :func:`packed_conv3x3` is the kernel's wrapper.  A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel (bf16 only) or raises.
  Each launch adds one to :data:`launches`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["launches", "packed_conv3x3", "packed_conv3x3_reference", "supports"]

CHANNELS = 64

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0


def supports(xp_shape) -> bool:
    """Whether the kernel takes this packed activation shape."""
    return len(xp_shape) == 4 and xp_shape[-1] == 2 * CHANNELS and min(xp_shape[:3]) >= 1


def _nchw(xp):
    """Packed ``[B, H, W/2, 2C]`` -> an NCHW view ``[B, C, H, W]`` of the
    same NHWC memory (channels_last)."""
    b, h, wp, c2 = xp.shape
    return xp.reshape(b, h, 2 * wp, c2 // 2).permute(0, 3, 1, 2)


def _packed(y):
    b, c, h, w = y.shape
    return y.permute(0, 2, 3, 1).reshape(b, h, w // 2, 2 * c)


def packed_conv3x3_reference(weight, bias, xp, *, relu: bool, skip=None):
    """3x3 SAME conv of packed ``xp`` with a ``[C, C, 3, 3]`` ``weight``,
    then +``bias``, then ReLU, or +``skip`` then ReLU (``relu=False`` drops
    the ReLU), all in fp32; returns packed ``xp.dtype``."""
    y = F.conv2d(_nchw(xp).float(), weight.float(), padding=1)
    if bias is not None:
        y = y + bias.float()[:, None, None]
    if skip is not None:
        y = y + _nchw(skip).float()
    if relu:
        y = F.relu(y)
    return _packed(y.to(xp.dtype))


def packed_conv3x3(weight, bias, xp, *, relu: bool, skip=None):
    """Kernel K3's wrapper; see :func:`packed_conv3x3_reference`."""
    if xp.device.type == "cpu":
        return packed_conv3x3_reference(weight, bias, xp, relu=relu, skip=skip)
    return _launch(weight, bias, xp, relu, skip)


def _cached(t, name: str, make):
    """``make(t)``, kept on ``t`` itself (so outside any state dict) until
    ``t`` is written in place or its storage changes (inference tensors
    keep no version count)."""
    key = (0 if t.is_inference() else t._version, t.data_ptr(), t.dtype)
    hit = getattr(t, name, None)
    if hit is None or hit[0] != key:
        hit = (key, make(t.detach()))
        setattr(t, name, hit)
    return hit[1]


def _taps(weight):
    """``[Co, Ci, 3, 3]`` -> ``[9, Co, Ci]`` bf16, tap = 3 * dy + dx: the
    kernel's B operand with the input channels contiguous."""
    co, ci = weight.shape[:2]
    return weight.permute(2, 3, 0, 1).reshape(9, co, ci).to(torch.bfloat16).contiguous()


def _launch(weight, bias, xp, relu: bool, skip):
    global launches
    from videosd_tpu_torch._build import load_library

    if xp.device.type != "cuda":
        raise ValueError(f"the TAESD conv kernel needs CUDA tensors, got {xp.device}")
    if not supports(xp.shape):
        raise ValueError(f"packed shape {tuple(xp.shape)} is not [B, H, W/2, {2 * CHANNELS}]")
    if tuple(weight.shape) != (CHANNELS, CHANNELS, 3, 3):
        raise ValueError(f"weight must be [{CHANNELS}, {CHANNELS}, 3, 3], got {tuple(weight.shape)}")
    for name, t in (("xp", xp), ("skip", skip)):
        if t is None:
            continue
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if t.shape != xp.shape or t.device != xp.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not match xp")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != xp.device:
            raise ValueError(f"{name} on {t.device}, xp on {xp.device}")
    lib = load_library()
    taps = _cached(weight, "_k3_taps", _taps)
    if bias is None:
        bias32 = torch.zeros(CHANNELS, dtype=torch.float32, device=xp.device)
    else:
        bias32 = _cached(bias, "_k3_bias", lambda b: b.float().contiguous())
    b, h, wp, _ = xp.shape
    out = torch.empty_like(xp)  # never xp: neighbouring tiles still read it
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.videosd_taesd_conv3x3(
            xp.data_ptr(), taps.data_ptr(), bias32.data_ptr(),
            None if skip is None else skip.data_ptr(), out.data_ptr(),
            b, h, 2 * wp, int(relu), stream,
        )
    if err != 0:
        raise RuntimeError(f"TAESD conv launch failed: cudaError {err}")
    launches += 1
    return out
