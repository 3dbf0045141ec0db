"""Kernel K2's cooperative plan (``ops/cuda/preprocess_kernel.py``), on the CPU.

The fused preprocess is one cooperative launch: a persistent grid of every
block that fits on the card at once (at most 8 per SM) walks the frame's
16 x 32 pixel tiles twice, once for img and the blocks' maxima of |grad|,
and, after a grid barrier, once for the edge, from |grad| held in shared
memory for each block's first 8 tiles and recomputed past them.  The kernel runs only on the card
(``test_torch_port_kernels_cuda.py`` and ``chip_smoke.py``); its grid and
its tile walk are plain Python, mirrored from ``csrc/preprocess.cu``, and
are held here: every pixel covered once in each phase, and a grid that
never exceeds what can be resident at once (a cooperative grid that could
not all be resident would deadlock at the barrier).  Imports neither JAX
nor the JAX package.
"""

import numpy as np
import pytest
import torch

from videosd_tpu_torch.ops.cuda import preprocess_kernel as K2

torch.set_num_threads(1)

# the main path's frame, the engine's mailbox, a camera frame off the TPU's
# 128-tiling, a 1080p camera frame, one pixel, and a frame smaller than a tile
SIZES = [(512, 512), (768, 768), (480, 640), (1080, 1920), (1, 1), (3, 5)]


@pytest.mark.parametrize("resident", [1, 2, 8])
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_every_pixel_once_per_phase_on_a_resident_grid(hw, resident):
    h, w = hw
    sms = 132
    grid = K2.cooperative_grid(h, w, sms, resident)
    tiles = -(-h // K2.TILE[0]) * -(-w // K2.TILE[1])
    assert 1 <= grid <= min(tiles, sms * min(resident, K2.MAX_BLOCKS_PER_SM))
    for _phase in ("img and maxima", "edge"):  # the kernel's two loops walk the same tiles
        hits = np.zeros((h, w), np.int32)
        for block in range(grid):
            walk = K2.tile_walk(h, w, grid, block)
            assert walk, f"block {block} of {grid} has no tile: its slot would hold nothing"
            for y0, x0 in walk:
                assert 0 <= y0 < h and 0 <= x0 < w
                hits[y0:y0 + K2.TILE[0], x0:x0 + K2.TILE[1]] += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("resident, grid, per_block", [(2, 264, {1, 2}), (5, 512, {1}),
                                                     (8, 512, {1})])
def test_the_grid_at_the_main_path_frame(resident, grid, per_block):
    """512^2 has 512 tiles: one block each where 4 or more blocks fit on an
    SM, else the SMs' blocks take one or two each."""
    assert K2.cooperative_grid(512, 512, 132, resident) == grid
    assert {len(K2.tile_walk(512, 512, grid, b)) for b in range(grid)} == per_block


@pytest.mark.parametrize("hw, recomputed", [((512, 512), False), ((768, 768), False),
                                            ((480, 640), False), ((1080, 1920), False),
                                            ((2160, 3840), True)],
                         ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
def test_held_grad_up_to_1080p(hw, recomputed):
    """With 6 blocks per SM (792 blocks, what an H100 fits) every tile's |grad| stays in shared
    memory through the barrier up to 1080 x 1920 (4080 tiles, at most 7 a
    block); a 2160 x 3840 frame (16200 tiles) recomputes the tiles past each
    block's first 8."""
    h, w = hw
    grid = K2.cooperative_grid(h, w, 132, 6)
    assert (K2.recomputed_tiles(h, w, grid) > 0) is recomputed


def test_cooperative_grid_refuses_an_empty_frame():
    with pytest.raises(ValueError, match="resident block"):
        K2.cooperative_grid(0, 512, 132, 2)
    with pytest.raises(ValueError, match="resident block"):
        K2.cooperative_grid(512, 512, 132, 0)
