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
* ``fused_preprocess`` is one cooperative launch over a persistent grid
  (:func:`cooperative_grid`, :func:`tile_walk`, :func:`launch_plan`): img
  and the blocks' maxima of |grad|, a grid barrier, then the edge, from
  |grad| held in shared memory for a block's first :data:`HELD_TILES` tiles
  and recomputed out of the frame past them.  Its scratch holds one slot per
  block, every one written before it is read, so nothing is zeroed.
"""

from __future__ import annotations

import ctypes

import torch

from videosd_tpu_torch.ops.sobel import div_rn, rgb_to_gray, sobel_edges
from videosd_tpu_torch.ops.sobel import sobel_magnitude as sobel_magnitude_reference

__all__ = [
    "HELD_TILES",
    "MAX_BLOCKS_PER_SM",
    "TILE",
    "cooperative_grid",
    "fused_preprocess",
    "fused_preprocess_reference",
    "launch_plan",
    "launches",
    "recomputed_tiles",
    "sobel_magnitude",
    "sobel_magnitude_reference",
    "tile_walk",
]

TILE = (16, 32)  # rows and columns of a tile (preprocess.cu: kTileH, kTileW)
MAX_BLOCKS_PER_SM = 8  # co-resident blocks of the cooperative grid, at most
HELD_TILES = 8  # tiles per block whose |grad| stays in shared memory (kHeld)

# output dtypes of the kernel's img, by the flag the C entry takes
_IMG_BF16 = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0
_SMS = {}  # streaming multiprocessors per device


def fused_preprocess_reference(frame_u8, low=0.11, high=0.8, *, out_dtype=torch.bfloat16):
    """``[H, W, 3]`` uint8 -> (img in [-1, 1] ``[H, W, 3]`` ``out_dtype``,
    edge ``[H, W]`` fp32), the semantics of the JAX ``fused_preprocess``."""
    x01 = div_rn(frame_u8.float(), 255.0)
    img = (x01 * 2.0 - 1.0).to(out_dtype)
    return img, sobel_edges(rgb_to_gray(x01), float(low), float(high))


def cooperative_grid(h: int, w: int, sms: int, resident: int) -> int:
    """Blocks of the fused kernel's cooperative launch on ``sms`` SMs where
    ``resident`` of its blocks fit on one SM at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): one per tile, at
    most ``min(resident, 8)`` per SM, so the grid is always co-resident
    (``preprocess.cu::fused_grid``)."""
    if min(h, w, sms, resident) < 1:
        raise ValueError(f"need a frame and a resident block, got {(h, w, sms, resident)}")
    tiles = -(-h // TILE[0]) * -(-w // TILE[1])
    return min(tiles, sms * min(resident, MAX_BLOCKS_PER_SM))


def tile_walk(h: int, w: int, grid: int, block: int) -> list:
    """(y0, x0) of the tiles block ``block`` of ``grid`` walks, in order, in
    each phase of the fused kernel (the two phases walk the same tiles)."""
    tiles_x = -(-w // TILE[1])
    n_tiles = tiles_x * -(-h // TILE[0])
    return [(t // tiles_x * TILE[0], t % tiles_x * TILE[1]) for t in range(block, n_tiles, grid)]


def recomputed_tiles(h: int, w: int, grid: int) -> int:
    """Tiles whose |grad| the fused kernel recomputes after the barrier:
    those past each block's first :data:`HELD_TILES`."""
    return sum(max(0, len(tile_walk(h, w, grid, b)) - HELD_TILES) for b in range(grid))


def launch_plan(h: int, w: int, device, out_dtype=torch.bfloat16) -> tuple[int, int]:
    """(blocks, co-resident blocks per SM) of the fused kernel's launch for an
    ``h`` x ``w`` frame on a CUDA ``device``, as the kernel computes them."""
    from videosd_tpu_torch._build import load_library

    grid, per_sm = ctypes.c_int(), ctypes.c_int()
    device = torch.device(device)
    with torch.cuda.device(device):
        index = torch.cuda.current_device()
        err = load_library().videosd_fused_preprocess_grid(
            h, w, _IMG_BF16[out_dtype], index, ctypes.byref(grid), ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"videosd_fused_preprocess_grid failed: cudaError {err}")
    return grid.value, per_sm.value


def fused_preprocess(frame_u8, low=0.11, high=0.8, *, out_dtype=torch.bfloat16):
    """Kernel K2's wrapper; see :func:`fused_preprocess_reference`."""
    _refuse_grad(frame_u8)
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
    n_slots = MAX_BLOCKS_PER_SM * _sms(frame_u8.device)
    slots = torch.empty((n_slots,), dtype=torch.float32, device=frame_u8.device)
    _call(frame_u8, "videosd_fused_preprocess", frame_u8.data_ptr(), img.data_ptr(),
          _IMG_BF16[out_dtype], edge.data_ptr(), slots.data_ptr(), n_slots, h, w, float(low),
          float(high), frame_u8.device.index)
    return img, edge


def _sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def sobel_magnitude(gray):
    """``[H, W]`` fp32 luma -> ``[H, W]`` fp32 zero-padded 3x3 Sobel
    magnitude (the TPU kernel's own output)."""
    _refuse_grad(gray)
    if gray.device.type == "cpu":
        return sobel_magnitude_reference(gray)
    if gray.dtype != torch.float32 or gray.ndim != 2:
        raise ValueError(f"expected a [H, W] float32 plane, got {gray.dtype} {tuple(gray.shape)}")
    gray = _cuda_contiguous(gray, "gray")
    mag = torch.empty_like(gray)
    _call(gray, "videosd_sobel_magnitude", gray.data_ptr(), mag.data_ptr(), *gray.shape)
    return mag


def _refuse_grad(x):
    """K2 has no backward: under grad mode an input that requires grad raises,
    on the CPU as on the card."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the preprocess kernel (K2) has no backward, as the TPU kernel's "
                           "pallas_call has no autodiff rule: call it under torch.no_grad()")


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
