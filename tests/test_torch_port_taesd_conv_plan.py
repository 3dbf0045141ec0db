"""Kernel K3's host side (``ops/cuda/taesd_conv.py``), on the CPU.

The CUDA kernel runs only on the card (``test_torch_port_kernels_cuda.py``
and ``chip_smoke.py``); what surrounds it is plain Python and is held here:
the swizzled tap layout the wrapper makes once per weight, the tile plans
(every output pixel covered once, the shared memory within the card's
232,448 bytes per block), the wrapper's refusals and its routing rule; and
for the fp32 kernel its tap layout (pre-split into TF32 big and small
planes), its work items and their channel halves, its shared memory, and
the tap cache that keeps the two layouts apart.
Imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from videosd_tpu_torch.ops.cuda import taesd_conv as K3

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

# the main path's images (512^2 frame: TAESD at 512, 256, 128 and 64 pixels),
# batch 2, and ragged sizes off every tile
SIZES = [(1, 512, 512), (1, 256, 256), (1, 128, 128), (1, 64, 64), (2, 64, 96), (1, 13, 14),
         (1, 1, 2), (1, 3, 258), (3, 5, 130), (1, 7, 66)]


def _weight(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((64, 64, 3, 3))
                            .astype(np.float32)).bfloat16()


def test_taps_follow_the_swizzle_formula():
    """taps[3 dy + dx, co, 8 c + e] = weight[co, 8 (c ^ co % 8) + e, dy, dx]."""
    w = _weight()
    taps = K3._taps(w)
    assert taps.shape == (9, 64, 64) and taps.dtype == torch.bfloat16 and taps.is_contiguous()
    tap, co, c, e = np.meshgrid(np.arange(9), np.arange(64), np.arange(8), np.arange(8),
                                indexing="ij")
    want = w.float().numpy()[co, 8 * (c ^ (co % 8)) + e, tap // 3, tap % 3]
    np.testing.assert_array_equal(taps.float().numpy()[tap, co, 8 * c + e], want)


def test_taps_invert_back_to_the_weight():
    """The swizzle is its own inverse: undoing it on the taps and undoing
    the tap order gives the weight back."""
    w = _weight(1)
    taps = K3._taps(w).reshape(9, 64, 8, 8)
    rows = torch.arange(64)[:, None] % 8
    unswizzled = taps.gather(2, (torch.arange(8)[None, :] ^ rows)[None, :, :, None].expand_as(taps))
    assert torch.equal(unswizzled.reshape(3, 3, 64, 64).permute(2, 3, 0, 1), w)
    # the row order of a tap is the output channel: no swizzle at row 0 mod 8
    assert torch.equal(K3._taps(w)[4, 0], w[0, :, 1, 1])


@pytest.mark.parametrize("wt", K3.TILE_WIDTHS)
def test_tiles_cover_every_pixel_once(wt):
    for b, h, w in SIZES:
        hits = np.zeros((b, h, w), np.int32)
        for img, y, x0 in K3.tile_origins(b, h, w, wt):
            assert 0 <= img < b and 0 <= y < h and 0 <= x0 < w
            hits[img, y, x0:x0 + wt] += 1
        assert (hits == 1).all(), (wt, b, h, w)


@pytest.mark.parametrize("wt", K3.TILE_WIDTHS)
def test_tile_fits_the_shared_memory(wt):
    stages = K3.halo_stages(wt)
    assert 2 <= stages <= 4
    assert K3.smem_bytes(wt) <= K3.SMEM_LIMIT
    # one more stage would not fit, unless the ring is at its cap
    assert stages == 4 or K3.smem_bytes(wt) + K3._stage_bytes(wt) > K3.SMEM_LIMIT - 1024
    # the TMA box (WT + 2 pixels) and the wgmma N (a multiple of 8, <= 256)
    assert wt % 8 == 0 and wt + 2 <= 256


@pytest.mark.parametrize("size, wt", [
    ((1, 512, 512), 128), ((1, 256, 256), 128), ((1, 128, 128), 64), ((1, 64, 64), 32),
    ((2, 64, 96), 64), ((1, 13, 14), 32), ((1, 1, 2), 32), ((1, 3, 258), 32),
    ((3, 5, 130), 32), ((4, 33, 1), 128), ((1, 132, 100), 128),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_tile_width_keeps_every_sm_busy(size, wt):
    """The widest tile that still gives each of the 132 SMs a tile."""
    assert K3.tile_width(*size) == wt
    tiles = len(K3.tile_origins(*size, wt))
    assert tiles >= K3.NUM_SMS or wt == K3.TILE_WIDTHS[-1]
    wider = [w for w in K3.TILE_WIDTHS if w > wt]
    assert all(len(K3.tile_origins(*size, w)) < K3.NUM_SMS for w in wider)


def test_tile_width_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="empty"):
        K3.tile_width(1, 0, 64)


def _args(**kw):
    args = dict(weight=torch.zeros(64, 64, 3, 3, dtype=torch.bfloat16),
                bias=torch.zeros(64), xp=torch.zeros(1, 8, 4, 128, dtype=torch.bfloat16),
                skip=None)
    args.update(kw)
    return args


@pytest.mark.parametrize("bad, match", [
    (dict(xp=torch.zeros(1, 8, 4, 128)), "weight must be torch.float32"),
    (dict(skip=torch.zeros(1, 8, 4, 128, dtype=torch.float16)), "bfloat16"),
    (dict(xp=torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)), "packed shape"),
    (dict(xp=torch.zeros(8, 4, 128, dtype=torch.bfloat16)), "packed shape"),
    (dict(skip=torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)), "does not match"),
    (dict(weight=torch.zeros(64, 64, 1, 1, dtype=torch.bfloat16)), "weight must be"),
    (dict(bias=torch.zeros(32)), "bias must be"),
    (dict(xp=torch.zeros(1, 4, 8, 128, dtype=torch.bfloat16).transpose(1, 2)), "contiguous"),
    (dict(xp=torch.zeros(4200, dtype=torch.bfloat16)[4:4100].view(1, 8, 4, 128)), "aligned"),
    (dict(weight=torch.zeros(64, 64, 3, 3, dtype=torch.bfloat16, device="meta")), "weight on"),
    (dict(bias=torch.zeros(64, device="meta")), "bias on"),
    (dict(weight=torch.zeros(64, 64, 3, 3)), "weight must be torch.bfloat16"),
    (dict(xp=torch.zeros(1, 8, 4, 128), weight=torch.zeros(64, 64, 3, 3),
          skip=torch.zeros(1, 8, 4, 128, dtype=torch.bfloat16)), "skip must be torch.float32"),
    (dict(xp=torch.zeros(1028)[2:1026].view(1, 2, 4, 128), weight=torch.zeros(64, 64, 3, 3)),
     "aligned"),
    (dict(xp=torch.zeros(1, 8, 4, 128, dtype=torch.float16),
          weight=torch.zeros(64, 64, 3, 3, dtype=torch.float16)), "got torch.float16"),
], ids=["xp-fp32", "skip-fp16", "channels", "rank", "skip-shape", "weight-shape", "bias-shape",
        "strided", "misaligned", "weight-device", "bias-device", "weight-dtype", "skip-dtype",
        "misaligned-fp32", "xp-fp16"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        K3._check(**_args(**bad))


def test_wrapper_takes_what_the_kernel_takes():
    K3._check(**_args())
    K3._check(**_args(bias=None, skip=torch.zeros(1, 8, 4, 128, dtype=torch.bfloat16)))


@pytest.mark.parametrize("bias", [torch.zeros(64), None], ids=["bias", "no-bias"])
def test_wrapper_takes_fp32_like_the_tpu_kernel(bias):
    """The TPU kernel keeps xp's dtype: fp32 xp, skip and weight are taken
    (the bias is cast to fp32 for either kernel)."""
    xp = torch.zeros(1, 8, 4, 128)
    K3._check(torch.zeros(64, 64, 3, 3), bias, xp, None)
    K3._check(torch.zeros(64, 64, 3, 3), bias, xp, torch.zeros(1, 8, 4, 128))


def _fp32_taps_index():
    """(half, tap, chunk, n8 tile, lane, e) grids and the weight's (co, ci)
    at each: lane 4 g + t holds co = 32 half + 8 n + g, ci = 16 c + 4 t + e."""
    h, tap, c, n, lane, e = np.meshgrid(np.arange(2), np.arange(9), np.arange(4), np.arange(4),
                                        np.arange(32), np.arange(4), indexing="ij")
    return (h, tap, c, n, lane, e), 32 * h + 8 * n + lane // 4, 16 * c + 4 * (lane % 4) + e


def test_fp32_taps_are_ci_rows_of_co():
    """The fp32 kernel's taps, pre-split for 3xTF32 in its fragment order:
    taps[half, 3 dy + dx, c, n, plane, 4 g + t, e] splits weight[32 half + 8 n
    + g, 16 c + 4 t + e, dy, dx] into a TF32 big part (plane 0: 10 mantissa
    bits, the weight rounded to nearest) and the exact rest (plane 1)."""
    w = _weight(2).float() * torch.linspace(0.01, 100.0, 64)[None, :, None, None]
    taps = K3.taps_for(w, torch.float32)
    assert taps.shape == (2, 9, 4, 4, 2, 32, 4) and taps.dtype == torch.float32
    assert taps.is_contiguous() and taps.numel() * 4 == 2 * 147456
    (h, tap, c, n, lane, e), co, ci = _fp32_taps_index()
    want = w.numpy()[co, ci, tap // 3, tap % 3]
    big, small = taps.numpy()[h, tap, c, n, 0, lane, e], taps.numpy()[h, tap, c, n, 1, lane, e]
    assert (big.view(np.int32) & 0x1FFF == 0).all()  # a TF32 value
    assert (np.abs(want - big) <= 2.0 ** -11 * np.abs(want)).all()  # rounded to nearest
    np.testing.assert_array_equal(small, want - big)  # the rest, exact
    assert (np.abs(small) > 2.0 ** -13 * np.abs(want)).any()


def test_fp32_tap_planes_invert_back_to_the_weight():
    """big + small is the fp32 tap bit for bit, and undoing the fragment
    order on it gives the weight back."""
    w = _weight(4).float()
    taps = K3._taps_fp32(w)
    whole = taps[:, :, :, :, 0] + taps[:, :, :, :, 1]  # [half, tap, c, n, lane, e]
    back = whole.reshape(2, 9, 4, 4, 8, 4, 4).permute(1, 0, 3, 4, 2, 5, 6).reshape(3, 3, 64, 64)
    assert torch.equal(back.permute(2, 3, 0, 1), w)


def test_tap_cache_is_keyed_by_dtype():
    """Each kernel's layout is made once per weight and kept under its own
    dtype: the bf16 (swizzled) and fp32 layouts of one weight never stand in
    for each other, and a write to the weight rebuilds both."""
    w = _weight(3).float()
    t32, t16 = K3.taps_for(w, torch.float32), K3.taps_for(w, torch.bfloat16)
    assert (t32.dtype, t16.dtype) == (torch.float32, torch.bfloat16)
    assert torch.equal(t16, K3._taps(w)) and torch.equal(t32, K3._taps_fp32(w))
    assert K3.taps_for(w, torch.float32) is t32 and K3.taps_for(w, torch.bfloat16) is t16
    w.add_(1.0)  # an in-place write: both layouts are made again
    assert K3.taps_for(w, torch.float32) is not t32 and K3.taps_for(w, torch.bfloat16) is not t16
    with pytest.raises(ValueError, match="float16"):
        K3.taps_for(w, torch.float16)


@pytest.mark.parametrize("rows", K3.FP32_TILE_ROWS)
def test_fp32_tiles_cover_every_pixel_once(rows):
    """Every output pixel and channel half in exactly one work item, the two
    halves of a tile next to each other."""
    for b, h, w in SIZES:
        hits = np.zeros((b, h, w, 2), np.int32)
        items = K3.fp32_tile_origins(b, h, w, rows)
        for img, y0, x0, co0 in items:
            assert 0 <= img < b and 0 <= y0 < h and 0 <= x0 < w and co0 in (0, K3.FP32_HALF)
            hits[img, y0:y0 + rows, x0:x0 + K3.FP32_TILE_W, co0 // K3.FP32_HALF] += 1
        assert (hits == 1).all(), (rows, b, h, w)
        assert all(items[i][:3] == items[i + 1][:3] and items[i][3] == 0
                   for i in range(0, len(items), 2))


@pytest.mark.parametrize("rows", K3.FP32_TILE_ROWS)
def test_fp32_blocks_keep_one_half(rows):
    """The persistent grid is even (the SM count, even, or fewer items), so
    the items block i takes (i, i + grid, ...) all have one channel half:
    its taps are loaded once."""
    for b, h, w in SIZES:
        items = K3.fp32_tile_origins(b, h, w, rows)
        grid = min(len(items), K3.NUM_SMS & ~1)
        assert grid % 2 == 0
        for block in range(grid):
            assert len({co0 for *_, co0 in items[block::grid]}) == 1


@pytest.mark.parametrize("rows", K3.FP32_TILE_ROWS)
def test_fp32_kernel_fits_the_shared_memory(rows):
    """One half's taps in big and small planes (147,456 bytes) and a ring of
    halo stages of 16 channels x 66 pixels x (rows + 2) rows, as many as fit
    (2 to 4), with 1 KB of alignment slack and the static mbarriers."""
    stages = K3.fp32_stages(rows)
    stage = (rows + 2) * 66 * 16 * 4
    assert 2 <= stages <= 4 and stage % 128 == 0  # TMA writes 128-byte-aligned boxes
    assert K3.fp32_smem_bytes(rows) == 1024 + 9 * 64 * 32 * 2 * 4 + stages * stage
    assert K3.fp32_smem_bytes(4) == 224512
    assert K3.fp32_smem_bytes(rows) + 8 * 9 <= K3.SMEM_LIMIT
    # one more stage would not fit, unless the ring is at its cap
    assert stages == 4 or K3.fp32_smem_bytes(rows) + stage > K3.SMEM_LIMIT


@pytest.mark.parametrize("size, rows", [
    ((1, 512, 512), 4), ((1, 256, 256), 4), ((1, 128, 128), 4), ((1, 64, 64), 2),
    ((2, 64, 96), 4), ((1, 13, 14), 2), ((1, 264, 64), 4), ((4, 264, 64), 4),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_fp32_tile_rows_keep_every_sm_busy(size, rows):
    """The fp32 tile height whose busiest SM finishes first: rounds of work
    items on 132 SMs times the warps a scheduler (2 x rows warps on 4
    schedulers, at least one each), the tallest on a tie."""
    assert K3.fp32_tile_rows(*size) == rows

    def busiest(r):
        return -(-len(K3.fp32_tile_origins(*size, r)) // K3.NUM_SMS) * max(2 * r, 4)

    assert all(busiest(rows) < busiest(r) or (busiest(rows) == busiest(r) and rows > r)
               for r in K3.FP32_TILE_ROWS if r != rows)


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_fp32_tile_heights_without_an_instance_are_refused(rows):
    """The kernel is instantiated for :data:`FP32_TILE_ROWS` alone (4 and 2:
    1 row never wins the picker's cost), so any other height is refused
    before a launch, on every device."""
    assert rows not in K3.FP32_TILE_ROWS
    args = _args(weight=torch.zeros(64, 64, 3, 3), xp=torch.zeros(1, 8, 4, 128))
    with pytest.raises(ValueError, match=f"tile rows {rows} not in"):
        K3._launch(args["weight"], args["bias"], args["xp"], True, None, tile_rows=rows)


def test_a_cpu_tensor_never_reaches_the_launcher():
    args = _args()
    with pytest.raises(ValueError, match="CUDA"):
        K3._launch(args["weight"], args["bias"], args["xp"], True, None)
    launches = K3.launches
    out = K3.packed_conv3x3(args["weight"], args["bias"], args["xp"], relu=True)
    assert K3.launches == launches and out.shape == args["xp"].shape


@pytest.mark.parametrize("shape, routed", [
    ((1, 512, 256, 128), True), ((1, 64, 32, 128), True), ((2, 13, 7, 128), True),
    ((1, 1, 1, 128), True), ((1, 32, 16, 32), False), ((1, 0, 16, 128), False),
    ((16, 32, 128), False), ((1, 8, 8, 64), False),
])
def test_supports_is_unchanged(shape, routed):
    assert K3.supports(shape) is routed
