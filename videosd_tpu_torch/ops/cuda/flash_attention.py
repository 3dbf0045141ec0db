"""Flash attention (kernel K1) for the UNet and ControlNet self-attention.

Replaces ``videosd_tpu/ops/pallas/flash_attention.py::mha_flash`` (the TPU
kernel) and its head-split wrapper ``flash_attention``.  The CUDA source is
``videosd_tpu_torch/csrc/flash_attention.cu`` (wgmma for both products, a
ring of K/V stages filled by TMA or cp.async, heads read in place); it is built on first
launch by :mod:`videosd_tpu_torch._build`.

* :func:`flash_attention_reference` is the plain PyTorch version: the
  ``_attention_xla`` math of the JAX package (fp32 logits and softmax, the
  probabilities cast to the input dtype before P.V).
* :func:`flash_attention` takes ``[B, S, H*D]`` tensors and reads the heads
  in place: no fold or unfold copy.  Any batch and row strides with a unit
  inner stride are taken as they are (a slice of a fused projection works).
* :func:`flash_attention_bhsd` takes folded ``[B*H, S, D]`` tensors: the
  same kernel with one head.
* A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
  raises.  Each attention that launches the kernel adds one to
  :data:`launches`.
* :func:`block_rows` picks the query rows per block from the shape, among
  :func:`row_plans`; the keys of one query tile are never split over blocks.

Supported on CUDA: bfloat16, head dim in :data:`SUPPORTED_HEAD_DIMS`, both
sequence lengths multiples of 64 (Sk may differ from Sq), no mask.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = [
    "KEY_TILE",
    "NUM_SMS",
    "SUPPORTED_HEAD_DIMS",
    "block_rows",
    "flash_attention",
    "flash_attention_bhsd",
    "flash_attention_reference",
    "launches",
    "row_plans",
]

SUPPORTED_HEAD_DIMS = (40, 64, 80, 160)
KEY_TILE = 64  # keys per K/V tile, and the smallest query tile
NUM_SMS = 132  # streaming multiprocessors of an H100 SXM
FULL_GRID = NUM_SMS - NUM_SMS // 8  # 116 blocks: a grid that covers the card

# attentions sent to the kernel since the count was last set to 0 (read by
# chip_smoke.py)
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


def row_plans(sq: int, d: int) -> tuple[int, ...]:
    """The query rows per block the kernel can run ``sq`` queries of head
    width ``d`` with: 64 per consumer warpgroup, one, two or (d = 40 only:
    wider heads do not fit the register file) four warpgroups per block."""
    if sq <= 0 or sq % KEY_TILE:
        raise ValueError(f"sequence length {sq} must be a multiple of {KEY_TILE}")
    return tuple(rows for rows in (256, 128, 64) if sq % rows == 0 and (rows < 256 or d == 40))


def block_rows(sq: int, bh: int, d: int) -> int:
    """Query rows per block for one attention of ``bh`` heads of width ``d``:
    the largest of :func:`row_plans` that still gives :data:`FULL_GRID`
    blocks, else 64.

    Every warpgroup of a block shares its K/V tiles, so a larger block reads
    less from L2 and hides one warpgroup's serial chain per tile (logits,
    softmax, P V) behind the others', but only a grid that covers the card
    pays for it.  On an H100 at 700 W (``chip_smoke.py`` times every plan at
    the sd15 512x512 shapes): [8,4096,40] at 256 rows (128 blocks) takes about
    0.75 of its time at 128 rows and 0.43 of its time at 64, while [8,1024,80]
    on 128 blocks of 64 rows takes about 0.8 of its time on 64 blocks of 128,
    and [8,256,160] on 32 blocks of 64 rows 0.65 of its time on 16 of 128.
    Splitting the 4 key tiles of [8,256,160] over more blocks, with a second
    pass to merge the partial results, was slower than leaving SMs idle.
    """
    plans = row_plans(sq, d)
    if bh <= 0:
        raise ValueError(f"need at least one head, got {bh}")
    return next((rows for rows in plans if sq // rows * bh >= FULL_GRID), KEY_TILE)


def flash_attention_bhsd(q, k, v, sm_scale: float):
    """q ``[BH, Sq, D]``, k/v ``[BH, Sk, D]`` -> ``[BH, Sq, D]``."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_reference(q, k, v, sm_scale)
    return _launch(q, k, v, 1, sm_scale)


def flash_attention(q, k, v, *, num_heads: int):
    """Multi-head attention on ``[B, S, H*D]`` tensors, scale ``D ** -0.5``."""
    if q.ndim != 3 or q.shape[-1] % num_heads:
        raise ValueError(f"expected [B,S,H*D] with H = {num_heads}, got {tuple(q.shape)}")
    dh = q.shape[-1] // num_heads
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        b, sq, dm = q.shape

        def split(x):
            return x.reshape(b, x.shape[1], num_heads, dh).transpose(1, 2)

        out = flash_attention_reference(split(q), split(k), split(v), 1.0 / math.sqrt(dh))
        return out.transpose(1, 2).reshape(b, sq, dm)
    return _launch(q, k, v, num_heads, 1.0 / math.sqrt(dh))


def _check(q, k, v, heads: int):
    """Raise on what the kernel does not take; returns (B, Sq, Sk, D)."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"expected 3-D q/k/v, got {q.shape} {k.shape} {v.shape}")
    b, sq, dm = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != dm or dm % heads:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    d = dm // heads
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if sq % KEY_TILE or sk % KEY_TILE or not sq or not sk or not b:
        raise ValueError(f"sequence lengths {sq}/{sk} must be multiples of {KEY_TILE}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if t.stride(2) != 1:
            raise ValueError(f"{name} must have a unit inner stride, got {t.stride()}")
        # torch allocates storage at 16-byte multiples, so the offset decides
        if t.stride(0) % 8 or t.stride(1) % 8 or t.storage_offset() % 8:
            raise ValueError(f"{name} must be 16-byte aligned in every row: strides "
                             f"{t.stride()}, storage offset {t.storage_offset()}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash attention kernel needs q/k/v on one CUDA device, "
                             f"got {name} on {t.device} and q on {q.device}")
    return b, sq, sk, d


def _launch(q, k, v, heads: int, sm_scale: float, block_m: int | None = None):
    """Launches the kernel; ``block_m`` overrides :func:`block_rows` with
    another of :func:`row_plans` (``chip_smoke.py`` times them all)."""
    global launches
    from videosd_tpu_torch._build import load_library

    b, sq, sk, d = _check(q, k, v, heads)
    if block_m is None:
        block_m = block_rows(sq, b * heads, d)
    elif block_m not in row_plans(sq, d):
        raise ValueError(f"{block_m} rows per block not in {row_plans(sq, d)} for "
                         f"{sq} queries of head dim {d}")
    out = torch.empty((b, sq, heads * d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
    )
    lib = load_library()
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, heads, sq, sk, d, strides, float(sm_scale), block_m,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if q.device.index == torch.cuda.current_device():
        err = lib.videosd_flash_attention_fwd(*args)
    else:
        with torch.cuda.device(q.device):
            err = lib.videosd_flash_attention_fwd(*args)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: cudaError {err}")
    launches += 1
    return out
