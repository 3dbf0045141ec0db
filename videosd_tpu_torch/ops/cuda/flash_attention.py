"""Flash attention (kernel K1) for the UNet and ControlNet self-attention.

Replaces ``videosd_tpu/ops/pallas/flash_attention.py::mha_flash`` (the TPU
kernel) and its head-split wrapper ``flash_attention``.  Four CUDA sources,
built on first launch by :mod:`videosd_tpu_torch._build`:
``videosd_tpu_torch/csrc/flash_attention.cu`` for bf16 up to d = 256 (wgmma
for both products, a ring of K/V stages filled by TMA or cp.async, heads
read in place), ``videosd_tpu_torch/csrc/flash_attention_fp32.cu`` for fp32
up to d = 256 (both products in 3xTF32 on ``mma.sync``, K and V through a
TMA ring; :func:`fp32_block_rows` and :func:`fp32_stages` mirror its plan),
``videosd_tpu_torch/csrc/flash_attention_wide.cu`` for bf16 above d = 256
(the KL VAE's d = 512: 64 query rows and one slice of at most 256 output
columns per block, the slices of a query tile in one thread-block cluster
that forms the logits once, each block over its share of the depth;
:func:`wide_plan` mirrors the launch), and
``videosd_tpu_torch/csrc/flash_attention_wide_fp32.cu`` for fp32 above
d = 256 (32 query rows and up to 512 output columns per block, so at
d = 512 the logits are formed once; both products on the tensor cores in
3xTF32, three TF32 ``mma.sync`` products of split operands, near fp32
rounding).  :func:`wide_slices` gives the column slices per query tile.  The
kernels' own TF32 arithmetic does not read torch's TF32 flags.

* :func:`flash_attention_reference` is the plain PyTorch version: the
  ``_attention_xla`` math of the JAX package (fp32 logits and softmax, the
  probabilities cast to the input dtype before P.V).
* :func:`flash_attention` takes ``[B, S, H*D]`` tensors and reads the heads
  in place: no fold or unfold copy.  Any batch and row strides with a unit
  inner stride are taken as they are (a slice of a fused projection works).
* :func:`flash_attention_bhsd` takes folded ``[B*H, S, D]`` tensors: the
  same kernels with one head.
* A CPU tensor takes the plain version; a CUDA tensor launches a kernel or
  raises.  Each attention that launches the bf16 kernel adds one to
  :data:`launches`, each that launches the fp32 kernel to
  :data:`launches_fp32`, and above d = 256 to :data:`launches_wide` and
  :data:`launches_wide_fp32`.
* :func:`block_rows` picks the bf16 kernel's query rows per block from the
  shape, among :func:`row_plans`; the keys of one query tile are never split
  over blocks.  :func:`instance_width` is the kernel instance a head dim
  runs on.

Taken on CUDA: bfloat16 or float32 (q, k and v alike), any head dim, both
sequence lengths multiples of 64 (Sk may differ from Sq), no mask.  Heads
are read in place where their rows are 16-byte aligned (d a multiple of 8 in
bf16, of 4 in fp32); any other d is copied into a folded, zero-padded
``[B*H, S, D]`` buffer first, as the TPU kernel's wrapper pads d to 128
lanes.  float16 raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

__all__ = [
    "INSTANCE_WIDTHS",
    "KEY_TILE",
    "MAX_HEAD_DIM",
    "NUM_SMS",
    "WidePlan",
    "block_rows",
    "flash_attention",
    "flash_attention_bhsd",
    "flash_attention_reference",
    "fp32_block_rows",
    "fp32_instance_width",
    "fp32_stages",
    "instance_width",
    "launches",
    "launches_fp32",
    "launches_wide",
    "launches_wide_fp32",
    "plan_fits",
    "row_plans",
    "wide_fp32_q_resident",
    "wide_plan",
    "wide_slices",
]

# the bf16 kernel's template instances: a head dim d runs on the narrowest
# width W >= d, whose columns past d are zeros in shared memory
INSTANCE_WIDTHS = (8, 16, 40, 64, 80, 160, 256)
MAX_HEAD_DIM = INSTANCE_WIDTHS[-1]
KEY_TILE = 64  # keys per K/V tile, and the smallest query tile
NUM_SMS = 132  # streaming multiprocessors of an H100 SXM
FULL_GRID = NUM_SMS - NUM_SMS // 8  # 116 blocks: a grid that covers the card
SMEM_LIMIT = 232448  # bytes of shared memory a block may use
# registers a consumer thread of the bf16 kernel may hold, by consumer
# warpgroups per block (what setmaxnreg gives it), and what one holds beside
# the O accumulator (W / 2): the S tile (32), bf16 P (16) and 44 for
# addresses, statistics and loop state (flash_attention.cu::plan_fits)
CONSUMER_REGISTERS = {4: 112, 2: 224, 1: 255}
_FIXED_REGISTERS = 48 + 44
# rows of 16 bytes: the element alignment of a head read in place
_ALIGN = {torch.bfloat16: 8, torch.float32: 4}

# the bf16 wide kernel (d > 256, flash_attention_wide.cu::make_plan): output
# columns per block; the portable cluster size; the panels of 64 columns a block's shared memory holds (Q's share
# resident beside a ring of at least 3 slots of 4 panels), beside four fp32
# 64 x 64 tiles of S (its two warpgroups' partials, the cluster's exchange
# buffers) and 1 KB of alignment
WIDE_SLICE = 256
WIDE_MAX_CLUSTER = 8
WIDE_PANELS, WIDE_GROUP, WIDE_MIN_SLOTS = 20, 4, 3
WIDE_SMEM = 1024 + 4 * 64 * 64 * 4 + WIDE_PANELS * 8192
# the fp32 wide kernel: output columns and query rows per block; the bytes of
# shared memory beside Q and the ring (1 KB of alignment slack, a V tile of
# 32 x 512 floats, the S partials of 4 x 32 x 40, which P aliases) and of one
# ring slot (a K chunk of 32 x 128 floats); Q resident while a ring of 4 slots
# fits beside it within the block's limit less 1 KB of static arrays
# (flash_attention_wide_fp32.cu::plan)
WIDE_SLICE_FP32, WIDE_ROWS_FP32 = 512, 32
WIDE_FP32_FIXED_SMEM, WIDE_FP32_CHUNK_BYTES, WIDE_FP32_MIN_SLOTS = (
    1024 + 4 * (32 * 512 + 4 * 32 * 40), 4 * 32 * 128, 4)

# the fp32 kernel (d <= 256, flash_attention_fp32.cu::Shape): its instances;
# up to 128 wide a block of 64 query rows, one warp per 16 rows over every
# column, above it 16 rows with the 4 warps splitting keys and columns; key
# tiles of 64 (32 from 128 wide); a ring of K and V stages sized for 2
# blocks an SM up to 40 wide, else 1, beside 1 KB of alignment, 3 KB of
# static arrays and the resident Q
FP32_WIDTHS = (8, 16, 40, 64, 80, 128, 160, 256)
FP32_MIN_STAGES, FP32_MAX_STAGES = 3, 8
SMEM_PER_SM = 233472  # bytes of an SM's shared memory, 1 KB of it reserved per block

# attentions sent to the bf16 kernel, to the fp32 one, and to the wide
# kernel's two dtypes, since the count was last set to 0 (read by chip_smoke.py)
launches = 0
launches_fp32 = 0
launches_wide = 0
launches_wide_fp32 = 0


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


def instance_width(d: int) -> int:
    """The bf16 kernel's instance for head dim ``d``: the narrowest of
    :data:`INSTANCE_WIDTHS` that holds it."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not in 1..{MAX_HEAD_DIM}")
    return next(w for w in INSTANCE_WIDTHS if w >= d)


def depth(w: int) -> int:
    """The depth of Q K^T at instance width ``w``: padded to wgmma's k16."""
    return -(-w // 16) * 16


def _tile_bytes(w: int) -> int:
    """Shared memory of a 64-row tile (``Tile::kBytes``): 64-column panels
    of 8 KB (TMA, w >= 64), else 64 rows of the padded depth in bf16."""
    return -(-w // 64) * 8192 if w >= 64 else 64 * depth(w) * 2


def ring_stages(w: int, nwg: int) -> int:
    """K/V stages that fit beside ``nwg`` Q tiles, at most 8 (``Tile::stages``)."""
    return min(8, (SMEM_LIMIT - 2048 - nwg * _tile_bytes(w)) // (2 * _tile_bytes(w)))


def plan_fits(w: int, nwg: int) -> bool:
    """Whether instance ``w`` runs with ``nwg`` consumer warpgroups: its
    registers within :data:`CONSUMER_REGISTERS` and a ring of three stages."""
    return w // 2 + _FIXED_REGISTERS <= CONSUMER_REGISTERS[nwg] and ring_stages(w, nwg) >= 3


def row_plans(sq: int, d: int) -> tuple[int, ...]:
    """The query rows per block the bf16 kernel can run ``sq`` queries of
    head dim ``d`` with: 64 per consumer warpgroup, one, two (instances up
    to 160 wide) or four (up to 40 wide) warpgroups per block, as
    :func:`plan_fits` allows."""
    if sq <= 0 or sq % KEY_TILE:
        raise ValueError(f"sequence length {sq} must be a multiple of {KEY_TILE}")
    w = instance_width(d)
    return tuple(rows for rows, nwg in ((256, 4), (128, 2), (64, 1))
                 if sq % rows == 0 and plan_fits(w, nwg))


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


def fp32_instance_width(d: int) -> int:
    """The fp32 kernel's instance for head dim ``d``: the narrowest of
    :data:`FP32_WIDTHS` that holds it (depth and columns pad to 8 inside)."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not in 1..{MAX_HEAD_DIM}")
    return next(w for w in FP32_WIDTHS if w >= d)


def fp32_block_rows(d: int) -> int:
    """Query rows per block of the fp32 kernel at head dim ``d``: 64 (a
    warp's 16 rows over every column) up to the 128-wide instance, 16 above
    (four warps split one row group's keys and columns: at sd15's
    [8, 256, 160] 128 blocks, where 64 rows would give 32)."""
    return 64 if fp32_instance_width(d) <= 128 else 16


def fp32_stages(d: int) -> int:
    """K/V stages in the fp32 kernel's ring at head dim ``d``: what fits
    beside the resident Q in the shared memory of one block (two per SM up
    to the 40-wide instance), at most :data:`FP32_MAX_STAGES`."""
    w = fp32_instance_width(d)
    keys, rows = (32 if w >= 128 else 64), fp32_block_rows(d)
    boxes_k, boxes_v = -(-w // 16), -(-w // 32)
    stage = 4 * keys * (16 * boxes_k + 32 * boxes_v)
    limit = SMEM_PER_SM // 2 - 1024 if w <= 40 else SMEM_LIMIT
    return min(FP32_MAX_STAGES, (limit - 1024 - 3072 - 4 * 16 * boxes_k * rows) // stage)


def wide_slices(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Slices of output columns per query tile of the wide kernel of
    ``dtype`` at head dim ``d`` > 256: one block per :data:`WIDE_SLICE`
    (bf16) or :data:`WIDE_SLICE_FP32` (fp32) columns.  An fp32 block forms
    the logits over the whole depth; the bf16 slices of a query tile split
    it in a cluster (:func:`wide_plan`)."""
    if d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} runs on the d <= {MAX_HEAD_DIM} kernels")
    return -(-d // (WIDE_SLICE_FP32 if dtype == torch.float32 else WIDE_SLICE))


class WidePlan(NamedTuple):
    """A launch of the bf16 wide kernel (``flash_attention_wide.cu::make_plan``)."""

    cluster_slices: int  # slice blocks a cluster spans, splitting the depth of Q K^T
    grid_slices: int  # slice blocks per query tile, a multiple of cluster_slices
    share: int  # the most 64-column depth panels of Q K^T one block forms
    q_resident: bool  # Q's share kept in shared memory (else streamed beside K)
    ring_slots: int  # slots of the K/V ring, each 4 panels of 64 rows x 64 columns (32 KB)
    smem: int  # bytes of dynamic shared memory a block asks for


def wide_plan(d: int) -> WidePlan:
    """The bf16 wide kernel's cluster at head dim ``d`` > 256: a block per 64
    query rows and :data:`WIDE_SLICE` output columns (the grid is
    ``(Sq / 64, grid_slices, B * H)``); the slices of a query tile in one
    cluster (at most :data:`WIDE_MAX_CLUSTER`; more slices split into
    clusters of equal size, padded with blocks that own no columns), which
    forms the logits once, each block over its share of the depth panels."""
    if d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} runs on the d <= {MAX_HEAD_DIM} kernels")
    slices = wide_slices(d)
    clusters = -(-slices // WIDE_MAX_CLUSTER)
    cs = -(-slices // clusters)
    panels = -(-d // 64)
    share = -(-panels // cs)
    resident = share + WIDE_GROUP * WIDE_MIN_SLOTS <= WIDE_PANELS
    slots = (WIDE_PANELS - share if resident else WIDE_PANELS) // WIDE_GROUP
    return WidePlan(cs, clusters * cs, share, resident, slots, WIDE_SMEM)


def wide_fp32_q_resident(d: int) -> bool:
    """Whether the fp32 wide kernel keeps Q's 32 rows resident in shared
    memory (at a row stride of ``d`` rounded up to 32, plus 16) beside a ring
    of :data:`WIDE_FP32_MIN_SLOTS` K chunks, or streams them through the ring
    beside K's: resident up to d = 576."""
    stride = -(-d // 32) * 32 + 16
    return (WIDE_FP32_FIXED_SMEM + 4 * WIDE_ROWS_FP32 * stride
            + WIDE_FP32_MIN_SLOTS * WIDE_FP32_CHUNK_BYTES <= SMEM_LIMIT - 1024)


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
    """Raise on what the kernels do not take, strides aside; returns
    (B, Sq, Sk, D)."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"expected 3-D q/k/v, got {q.shape} {k.shape} {v.shape}")
    b, sq, dm = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != dm or dm % heads:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    d = dm // heads
    if d <= 0:
        raise ValueError(f"head dim {d} is empty")
    if sq % KEY_TILE or sk % KEY_TILE or not sq or not sk or not b:
        raise ValueError(f"sequence lengths {sq}/{sk} must be multiples of {KEY_TILE}")
    if q.dtype not in _ALIGN:
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype} (no bundle of the port "
                         f"is float16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} like q, got {t.dtype}")
        if t.stride(2) != 1:
            raise ValueError(f"{name} must have a unit inner stride, got {t.stride()}")
    if d % _ALIGN[q.dtype] == 0:  # read in place (any other d goes through a padded copy)
        _check_aligned(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash attention kernel needs q/k/v on one CUDA device, "
                             f"got {name} on {t.device} and q on {q.device}")
    return b, sq, sk, d


def _check_aligned(q, k, v):
    """Raise unless every row of q, k and v starts 16 bytes aligned."""
    align = _ALIGN[q.dtype]
    for name, t in (("q", q), ("k", k), ("v", v)):
        # torch allocates storage at 16-byte multiples, so the offset decides
        if t.stride(0) % align or t.stride(1) % align or t.storage_offset() % align:
            raise ValueError(f"{name} must be 16-byte aligned in every row: strides "
                             f"{t.stride()}, storage offset {t.storage_offset()}")


def _fold_padded(x, heads: int, dp: int):
    """``[B, S, H*d]`` -> a zero-padded ``[B*H, S, dp]`` copy."""
    b, s, dm = x.shape
    d = dm // heads
    out = x.new_zeros(b * heads, s, dp)
    out[..., :d] = x.reshape(b, s, heads, d).transpose(1, 2).reshape(b * heads, s, d)
    return out


def _unfold_cut(out, b: int, heads: int, d: int):
    """The inverse of :func:`_fold_padded` on an output: ``[B*H, S, dp]`` ->
    ``[B, S, H*d]``, the padded columns dropped."""
    sq = out.shape[1]
    return out[..., :d].reshape(b, heads, sq, d).transpose(1, 2).reshape(b, sq, heads * d)


def _launch(q, k, v, heads: int, sm_scale: float, block_m: int | None = None):
    """Launches the kernel of q's dtype and head dim; ``block_m`` overrides
    :func:`block_rows` with another of :func:`row_plans` (``chip_smoke.py``
    times them all; the fp32 kernel runs :func:`fp32_block_rows`, the bf16
    wide kernel 64 rows per block, the fp32 wide kernel 32)."""
    b, sq, sk, d = _check(q, k, v, heads)
    align = _ALIGN[q.dtype]
    if d % align:
        # rows of d elements are not 16-byte aligned: pad d as the TPU wrapper does
        dp = -(-d // align) * align
        out = _launch(*(_fold_padded(x, heads, dp) for x in (q, k, v)), 1, sm_scale, block_m)
        return _unfold_cut(out, b, heads, d)
    fp32 = q.dtype == torch.float32
    wide = d > MAX_HEAD_DIM
    if fp32:
        plans = (WIDE_ROWS_FP32,) if wide else (fp32_block_rows(d),)
    else:
        plans = (KEY_TILE,) if wide else row_plans(sq, d)
    if block_m is None:
        block_m = plans[0] if fp32 or wide else block_rows(sq, b * heads, d)
    elif block_m not in plans:
        raise ValueError(f"{block_m} rows per block not in {plans} for {sq} queries of head "
                         f"dim {d} in {q.dtype}")
    if (wide or fp32) and b * heads > 65535:
        raise ValueError(f"{b * heads} heads exceed the kernel's grid (65535)")
    return _run(q, k, v, heads, d, sm_scale, block_m, fp32, wide)


def _run(q, k, v, heads, d, sm_scale, block_m, fp32, wide):
    global launches, launches_fp32, launches_wide, launches_wide_fp32
    from videosd_tpu_torch._build import load_library

    b, sq, _ = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, heads * d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
    )
    lib = load_library()
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, heads, sq, sk, d, strides, float(sm_scale)]
    if not (fp32 or wide):
        args.append(block_m)
    args += [q.device.index, torch.cuda.current_stream(q.device).cuda_stream]
    fn = {(False, False): lib.videosd_flash_attention_fwd,
          (True, False): lib.videosd_flash_attention_fp32_fwd,
          (False, True): lib.videosd_flash_attention_wide_fwd,
          (True, True): lib.videosd_flash_attention_wide_fp32_fwd}[fp32, wide]
    if q.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: cudaError {err}")
    if wide and fp32:
        launches_wide_fp32 += 1
    elif wide:
        launches_wide += 1
    elif fp32:
        launches_fp32 += 1
    else:
        launches += 1
    return out
