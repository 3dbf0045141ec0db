"""The TAESD residual-block 3x3 conv with its fused epilogue (kernel K3).

Replaces ``videosd_tpu/ops/pallas/taesd_conv.py::packed_conv3x3`` (the TPU
kernel), which keeps its input's dtype.  Two CUDA sources, built on first
launch by :mod:`videosd_tpu_torch._build`: ``videosd_tpu_torch/csrc/
taesd_conv.cu`` for bf16 (wgmma with the output channels on M and the pixels
on N, the nine taps resident in shared memory, a ring of TMA halo stages, a
persistent grid) and ``videosd_tpu_torch/csrc/taesd_conv_fp32.cu`` for fp32
(FFMA over resident fp32 taps and a cp.async halo, tiles of
:data:`FP32_TILE_ROWS` rows x 64 pixels, no TF32).

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
* :func:`packed_conv3x3` is the kernels' wrapper.  A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel of its dtype (bf16 or
  fp32: xp, skip and weight alike) or raises.  Each launch adds one to
  :data:`launches` (bf16) or :data:`launches_fp32`.
* :func:`tile_width` picks the bf16 kernel's tile, one output row of WT
  pixels, from the shape, among :data:`TILE_WIDTHS`; :func:`smem_bytes` and
  :func:`tile_origins` mirror the kernel's shared memory and tile order;
  :func:`fp32_tile_rows` picks the fp32 kernel's tile height, and
  :func:`fp32_smem_bytes` and :func:`fp32_tile_origins` mirror it.
* The taps are laid out once per weight and kernel dtype (:func:`taps_for`)
  and kept on the weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "FP32_TILE_ROWS",
    "TILE_WIDTHS",
    "fp32_smem_bytes",
    "fp32_tile_origins",
    "fp32_tile_rows",
    "launches",
    "launches_fp32",
    "packed_conv3x3",
    "packed_conv3x3_reference",
    "smem_bytes",
    "supports",
    "taps_for",
    "tile_origins",
    "tile_width",
]

CHANNELS = 64
NUM_SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448  # bytes of shared memory a block may use
# The kernel's tiles: one output row of WT pixels, widest first.  WT is the N
# of each wgmma.
TILE_WIDTHS = (128, 64, 32)
_PIXEL_BYTES = 2 * CHANNELS
_TAPS_BYTES = 9 * CHANNELS * _PIXEL_BYTES
_CONSUMERS = 2  # consumer warpgroups per block, each with its own output tile
_MAX_STAGES = 4
# The fp32 kernel's tiles: rows of 64 output pixels, most rows first
# (taesd_conv_fp32.cu: TR, kTW); a halo stage holds 16 input channels of a
# pixel at 20 floats
FP32_TILE_ROWS = (4, 2, 1)
FP32_TILE_W = 64
_FP32_PIXEL_FLOATS = 20

# launches of the bf16 and of the fp32 kernel since the count was last set
# to 0 (read by chip_smoke.py)
launches = 0
launches_fp32 = 0


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


def _round1k(n: int) -> int:
    return (n + 1023) // 1024 * 1024


def _stage_bytes(wt: int) -> int:
    return _round1k(3 * (wt + 2) * _PIXEL_BYTES)  # one TMA box of halo


def halo_stages(wt: int) -> int:
    """Halo stages in the kernel's ring for tiles of ``wt`` pixels: as many
    as fit beside the taps and the output tiles, at most 4
    (``Plan::kStages``)."""
    fit = (SMEM_LIMIT - 2048 - _TAPS_BYTES - _CONSUMERS * wt * _PIXEL_BYTES) // _stage_bytes(wt)
    return min(_MAX_STAGES, fit)


def smem_bytes(wt: int) -> int:
    """Dynamic shared memory of one block for tiles of ``wt`` pixels
    (``Plan::kSmem``): 1024 bytes to align it to the swizzle atom, the taps,
    the halo ring and one output tile per consumer warpgroup."""
    return (1024 + _TAPS_BYTES + halo_stages(wt) * _stage_bytes(wt)
            + _CONSUMERS * wt * _PIXEL_BYTES)


def tile_origins(b: int, h: int, w: int, wt: int) -> list:
    """(image, row, x0) of every tile in the kernel's order, x fastest."""
    tx = -(-w // wt)
    return [(t // (tx * h), t // tx % h, t % tx * wt) for t in range(b * h * tx)]


def tile_width(b: int, h: int, w: int) -> int:
    """The tile for ``b`` images of ``h`` x ``w`` pixels: the widest of
    :data:`TILE_WIDTHS` that still gives every SM a tile (``NUM_SMS``),
    else the narrowest.

    On an H100 at 700 W (``chip_smoke.py`` times every width at the 512^2
    frame's four TAESD sizes): 128 pixels is fastest at 512^2 and 256^2
    (2048 and 512 tiles), 64 at 128^2 (256 tiles, where 128 leaves 4 of 132
    SMs idle and 32 halves each product), and 32 at 64^2.
    """
    if min(b, h, w) < 1:
        raise ValueError(f"empty shape {(b, h, w)}")
    return next((wt for wt in TILE_WIDTHS if b * h * -(-w // wt) >= NUM_SMS), TILE_WIDTHS[-1])


def fp32_smem_bytes(rows: int) -> int:
    """Dynamic shared memory of one block of the fp32 kernel with tiles of
    ``rows`` rows (``taesd_conv_fp32.cu::Plan::kSmem``): the fp32 taps and
    two halo stages of (rows + 2) x 66 pixels of 16 channels."""
    halo = (rows + 2) * (FP32_TILE_W + 2) * _FP32_PIXEL_FLOATS
    return 4 * (9 * CHANNELS * CHANNELS + 2 * halo)


def fp32_tile_origins(b: int, h: int, w: int, rows: int) -> list:
    """(image, y0, x0) of every tile of the fp32 kernel in its order, x
    fastest; a tile covers ``rows`` x 64 pixels from there."""
    tx, ty = -(-w // FP32_TILE_W), -(-h // rows)
    return [(t // (tx * ty), t // tx % ty * rows, t % tx * FP32_TILE_W)
            for t in range(b * ty * tx)]


def fp32_tile_rows(b: int, h: int, w: int) -> int:
    """The fp32 kernel's tile height for ``b`` images of ``h`` x ``w``: the
    one of :data:`FP32_TILE_ROWS` with the fewest tile rows per SM in the
    busiest SM (rounds of tiles x rows), the tallest on a tie.

    A tile row is 2.4 MFMA on one SM, so rows on idle SMs are lost, and a
    taller tile reads its taps and halo for more rows.  On an H100 at 700 W
    (``chip_smoke.py`` times every height at the 512^2 frame's TAESD sizes):
    4 rows at 512^2 and 256^2, 2 at 128^2 (128 tiles on 132 SMs, where 1 row
    takes two rounds), 1 at 64^2 (4 rows: 16 SMs busy, twice cuDNN's time).
    """
    if min(b, h, w) < 1:
        raise ValueError(f"empty shape {(b, h, w)}")
    tiles_x = -(-w // FP32_TILE_W)

    def cost(rows):
        return -(-(b * -(-h // rows) * tiles_x) // NUM_SMS) * rows

    return min(FP32_TILE_ROWS, key=lambda r: (cost(r), -r))


def _cached(t, name: str, dtype, make):
    """``make(t)`` for the kernel of ``dtype``, kept on ``t`` itself (so
    outside any state dict) under ``(name, dtype)`` until ``t`` is written in
    place or its storage changes (inference tensors keep no version count)."""
    key = (0 if t.is_inference() else t._version, t.data_ptr(), t.dtype)
    store = getattr(t, "_k3_cache", None)
    if store is None:
        store = {}
        t._k3_cache = store
    hit = store.get((name, dtype))
    if hit is None or hit[0] != key:
        hit = store[(name, dtype)] = (key, make(t.detach()))
    return hit[1]


def _swizzle_index(co: int, ci: int, device):
    """Chunk c of row r -> chunk c ^ (r % 8), as a gather index over
    ``[9, co, ci / 8, 8]``; the map is its own inverse."""
    rows = torch.arange(co, device=device)[:, None] % 8
    chunks = torch.arange(ci // 8, device=device)[None, :]
    return (chunks ^ rows)[None, :, :, None]


def _taps(weight):
    """``[Co, Ci, 3, 3]`` -> ``[9, Co, Ci]`` bf16, tap = 3 * dy + dx: the
    kernel's A operand, one 128-byte row per output channel in the 128-byte
    swizzle (the 16-byte chunk c of row co stored at chunk c ^ (co % 8))."""
    co, ci = weight.shape[:2]
    t = weight.permute(2, 3, 0, 1).reshape(9, co, ci // 8, 8).to(torch.bfloat16)
    return t.gather(2, _swizzle_index(co, ci, t.device).expand_as(t)).reshape(9, co, ci)


def _taps_fp32(weight):
    """``[Co, Ci, 3, 3]`` -> ``[9, Ci, Co]`` fp32, tap = 3 * dy + dx: one
    row of the 64 output channels per input channel, as the fp32 kernel
    reads them."""
    co, ci = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9, ci, co).float().contiguous()


def taps_for(weight, dtype):
    """The taps of ``weight`` laid out for the kernel of ``dtype``, made once
    per weight and dtype: bf16 and fp32 layouts never share a cache entry."""
    if dtype == torch.bfloat16:
        return _cached(weight, "taps", dtype, _taps)
    if dtype == torch.float32:
        return _cached(weight, "taps", dtype, _taps_fp32)
    raise ValueError(f"no TAESD conv kernel for {dtype}")


def _check(weight, bias, xp, skip) -> None:
    """Raise on what the kernels do not take, the device type aside."""
    if not supports(xp.shape):
        raise ValueError(f"packed shape {tuple(xp.shape)} is not [B, H, W/2, {2 * CHANNELS}]")
    if tuple(weight.shape) != (CHANNELS, CHANNELS, 3, 3):
        raise ValueError(f"weight must be [{CHANNELS}, {CHANNELS}, 3, 3], got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (CHANNELS,):
        raise ValueError(f"bias must be [{CHANNELS}], got {tuple(bias.shape)}")
    if xp.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"xp must be bfloat16 or float32, got {xp.dtype}")
    for name, t in (("skip", skip), ("weight", weight)):
        if t is not None and t.dtype != xp.dtype:
            raise ValueError(f"{name} must be {xp.dtype} like xp, got {t.dtype}")
    for name, t in (("xp", xp), ("skip", skip)):
        if t is None:
            continue
        if t.shape != xp.shape or t.device != xp.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not match xp")
        # torch allocates storage at 16-byte multiples, so the offset decides
        if not t.is_contiguous() or t.storage_offset() * t.element_size() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != xp.device:
            raise ValueError(f"{name} on {t.device}, xp on {xp.device}")


def _launch(weight, bias, xp, relu: bool, skip, tile_w=None, tile_rows=None):
    """Launches the kernel of xp's dtype; ``tile_w`` overrides the bf16
    kernel's :func:`tile_width` with another of :data:`TILE_WIDTHS`, and
    ``tile_rows`` the fp32 kernel's :func:`fp32_tile_rows` with another of
    :data:`FP32_TILE_ROWS` (``chip_smoke.py`` times them all)."""
    global launches, launches_fp32
    from videosd_tpu_torch._build import load_library

    if xp.device.type != "cuda":
        raise ValueError(f"the TAESD conv kernel needs CUDA tensors, got {xp.device}")
    _check(weight, bias, xp, skip)
    fp32 = xp.dtype == torch.float32
    b, h, wp, _ = xp.shape
    if (tile_w, tile_rows)[not fp32] is not None:
        raise ValueError(f"{'tile width' if fp32 else 'tile rows'} is for the "
                         f"{'bf16' if fp32 else 'fp32'} kernel")
    if fp32:
        tile = fp32_tile_rows(b, h, 2 * wp) if tile_rows is None else tile_rows
        if tile not in FP32_TILE_ROWS:
            raise ValueError(f"tile rows {tile} not in {FP32_TILE_ROWS}")
    else:
        tile = tile_width(b, h, 2 * wp) if tile_w is None else tile_w
        if tile not in TILE_WIDTHS:
            raise ValueError(f"tile width {tile} not in {TILE_WIDTHS}")
    lib = load_library()
    taps = taps_for(weight, xp.dtype)
    bias32 = None if bias is None else _cached(bias, "bias", torch.float32,
                                               lambda t: t.float().contiguous())
    out = torch.empty_like(xp)  # never xp: neighbouring tiles still read it
    dev = xp.device.index
    args = (
        xp.data_ptr(), taps.data_ptr(), None if bias32 is None else bias32.data_ptr(),
        None if skip is None else skip.data_ptr(), out.data_ptr(), b, h, 2 * wp, int(relu),
        tile, dev, torch.cuda.current_stream(xp.device).cuda_stream,
    )
    fn = lib.videosd_taesd_conv3x3_fp32 if fp32 else lib.videosd_taesd_conv3x3
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(xp.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"TAESD conv launch failed: cudaError {err}")
    if fp32:
        launches_fp32 += 1
    else:
        launches += 1
    return out
