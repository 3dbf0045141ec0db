"""The fused preprocess entry with its Sobel stencil (kernel K2).

Replaces ``videosd_tpu/ops/pallas/preprocess_kernel.py``: the TPU kernel
``sobel_magnitude_pallas`` and its wrapper ``fused_preprocess``.  The CUDA
source is ``videosd_tpu_torch/csrc/preprocess.cu``, built on first launch by
:mod:`videosd_tpu_torch._build`.  The frame program does not call this
entry (the JAX one does not either); it is the one-call preprocess for a
caller that wants the model input and the edge map of a frame together.

* :func:`fused_preprocess_reference` and :func:`sobel_magnitude_reference`
  are the plain PyTorch versions, built from ``ops/sobel.py`` and the
  ``u8 / 255`` of ``ops/preprocess.py``.
* :func:`fused_preprocess` and :func:`sobel_magnitude` are the kernel's
  wrappers.  A CPU tensor takes the plain version; a CUDA tensor launches
  the kernel or raises.  Each launch adds one to :data:`launches`.  Any
  H and W are taken (the TPU kernel needed multiples of 128).
"""

from __future__ import annotations

import torch

from videosd_tpu_torch.ops.sobel import div_rn, rgb_to_gray, sobel_edges
from videosd_tpu_torch.ops.sobel import sobel_magnitude as sobel_magnitude_reference

__all__ = [
    "fused_preprocess",
    "fused_preprocess_reference",
    "launches",
    "sobel_magnitude",
    "sobel_magnitude_reference",
]

# output dtypes of the kernel's img, by the flag the C entry takes
_IMG_BF16 = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0


def fused_preprocess_reference(frame_u8, low=0.11, high=0.8, *, out_dtype=torch.bfloat16):
    """``[H, W, 3]`` uint8 -> (img in [-1, 1] ``[H, W, 3]`` ``out_dtype``,
    edge ``[H, W]`` fp32), the semantics of the JAX ``fused_preprocess``."""
    x01 = div_rn(frame_u8.float(), 255.0)
    img = (x01 * 2.0 - 1.0).to(out_dtype)
    return img, sobel_edges(rgb_to_gray(x01), float(low), float(high))


def fused_preprocess(frame_u8, low=0.11, high=0.8, *, out_dtype=torch.bfloat16):
    """Kernel K2's wrapper; see :func:`fused_preprocess_reference`."""
    if frame_u8.device.type == "cpu":
        return fused_preprocess_reference(frame_u8, low, high, out_dtype=out_dtype)
    if frame_u8.dtype != torch.uint8 or frame_u8.ndim != 3 or frame_u8.shape[-1] != 3:
        raise ValueError(f"expected a [H, W, 3] uint8 frame, got {frame_u8.dtype} "
                         f"{tuple(frame_u8.shape)}")
    if out_dtype not in _IMG_BF16:
        raise ValueError(f"out_dtype must be one of {list(_IMG_BF16)}, got {out_dtype}")
    frame_u8 = _cuda_contiguous(frame_u8, "frame_u8")
    h, w, _ = frame_u8.shape
    img = torch.empty((h, w, 3), dtype=out_dtype, device=frame_u8.device)
    edge = torch.empty((h, w), dtype=torch.float32, device=frame_u8.device)
    mx_bits = torch.empty((1,), dtype=torch.int32, device=frame_u8.device)
    _call(frame_u8, "videosd_fused_preprocess", frame_u8.data_ptr(), img.data_ptr(),
          _IMG_BF16[out_dtype], edge.data_ptr(), mx_bits.data_ptr(), h, w, float(low),
          float(high))
    return img, edge


def sobel_magnitude(gray):
    """``[H, W]`` fp32 luma -> ``[H, W]`` fp32 zero-padded 3x3 Sobel
    magnitude (the TPU kernel's own output)."""
    if gray.device.type == "cpu":
        return sobel_magnitude_reference(gray)
    if gray.dtype != torch.float32 or gray.ndim != 2:
        raise ValueError(f"expected a [H, W] float32 plane, got {gray.dtype} {tuple(gray.shape)}")
    gray = _cuda_contiguous(gray, "gray")
    mag = torch.empty_like(gray)
    _call(gray, "videosd_sobel_magnitude", gray.data_ptr(), mag.data_ptr(), *gray.shape)
    return mag


def _cuda_contiguous(x, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"the preprocess kernel needs CUDA tensors, got {name} on {x.device}")
    return x.contiguous()


def _call(x, entry: str, *args):
    global launches
    from videosd_tpu_torch._build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches += 1
