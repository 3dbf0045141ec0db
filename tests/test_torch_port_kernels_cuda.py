"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 (flash attention), K2 (fused preprocess with its Sobel stencil) and K3
(the TAESD 3x3 conv) have no CPU or interpret mode, so every test here is
marked ``cuda`` and skips without a card.  The file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels_cuda.py

Bars: K1 max |d| within two bf16 ulps of the largest output and mean |d|
within 2^-7 of the mean |output| (both round the output to bf16, and they
round P at different points; measured: one ulp, and 0.6 * 2^-8); K2 equal bit
for bit; K3 within one
bf16 ulp of the largest output and mean |d| <= 1e-5 (both round fp32 sums of
exact bf16 products once, in different summation orders).  The fp32 kernels
of K1 and K3 within 2^-13 of the largest output and 2^-16 of the mean
|output| of their plain versions computed in fp64 (all three run their
products in 3xTF32, which rounds unlike cuBLAS's and cuDNN's fp32; TF32
products would be ~1e-3 off).
"""

import pytest
import torch

from videosd_tpu_torch.ops.cuda import flash_attention as FA
from videosd_tpu_torch.ops.cuda import preprocess_kernel as K2
from videosd_tpu_torch.ops.cuda import taesd_conv as K3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_k1_close(out, ref):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    assert torch.isfinite(out).all()
    assert err.max().item() <= 2 * ulp <= 2e-2
    assert err.mean().item() <= ref.abs().mean().item() / 128 <= 2e-3


@pytest.mark.cuda
def test_k1_matches_plain_on_card(gen):
    for bh, sq, sk, d in [(8, 1024, 1024, 40), (4, 256, 512, 80), (8, 256, 256, 160)]:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").bfloat16()
                   for s in (sq, sk, sk))
        before = FA.launches
        out = FA.flash_attention_bhsd(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        assert FA.launches == before + 1
        ref = FA.flash_attention_reference(q, k, v, d ** -0.5)
        _assert_k1_close(out, ref)
    with pytest.raises(ValueError, match="float16"):
        FA.flash_attention_bhsd(q.half(), k.half(), v.half(), 0.1)


# (batch, heads, sq, sk, d_head): the 256-row blocks of d = 40, keys != queries,
# batch 2, d = 64, few queries on many keys, and lengths that are multiples of 64 only
_K1_IN_PLACE = [(1, 8, 4096, 4096, 40), (1, 8, 4096, 8192, 40), (2, 8, 1024, 1024, 80),
                (1, 8, 1024, 1024, 64), (1, 8, 256, 4096, 160), (2, 3, 192, 320, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _K1_IN_PLACE, ids=lambda s: "x".join(map(str, s)))
def test_k1_in_place_heads_on_card(gen, shape):
    """The ``[B, S, H*D]`` entry on slices of one fused q|k|v buffer (nothing
    contiguous, nothing folded) against the plain version and, bit for bit,
    against the folded entry on copies of the same data."""
    b, h, sq, sk, d = shape
    fused = torch.randn(b, max(sq, sk), 3 * h * d, generator=gen, device="cuda").bfloat16()
    q, k, v = (fused[:, :n, i * h * d:(i + 1) * h * d] for i, n in enumerate((sq, sk, sk)))

    def fold(x):
        return x.reshape(b, x.shape[1], h, d).transpose(1, 2).reshape(b * h, x.shape[1], d)

    before = FA.launches
    out = FA.flash_attention(q, k, v, num_heads=h)
    torch.cuda.synchronize()
    assert FA.launches == before + 1 and out.shape == (b, sq, h * d) and out.is_contiguous()
    ref = FA.flash_attention_reference(fold(q), fold(k), fold(v), d ** -0.5)
    ref = ref.reshape(b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d)
    _assert_k1_close(out, ref)
    folded = FA.flash_attention_bhsd(fold(q).contiguous(), fold(k).contiguous(),
                                     fold(v).contiguous(), d ** -0.5)
    assert torch.equal(folded.reshape(b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d), out)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4096, 40), (8, 1024, 80), (8, 256, 160)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_every_row_plan_on_card(gen, shape):
    """Every number of rows per block the kernel can run a shape with gives
    the plain version's result; one outside :func:`row_plans` is refused."""
    bh, s, d = shape
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    ref = FA.flash_attention_reference(q, k, v, d ** -0.5)
    for rows in FA.row_plans(s, d):
        _assert_k1_close(FA._launch(q, k, v, 1, d ** -0.5, block_m=rows), ref)
    with pytest.raises(ValueError, match="rows per block"):
        FA._launch(q, k, v, 1, d ** -0.5, block_m=512)


@pytest.mark.cuda
def test_k2_matches_plain_on_card(gen):
    for hw in [(480, 640), (37, 5), (512, 512), (1080, 1920), (2160, 3840)]:
        frame = torch.randint(0, 256, (*hw, 3), generator=gen, device="cuda", dtype=torch.uint8)
        for dtype in (torch.bfloat16, torch.float32):
            before = K2.launches
            img, edge = K2.fused_preprocess(frame, 0.11, 0.8, out_dtype=dtype)
            torch.cuda.synchronize()
            assert K2.launches == before + 1
            ref_img, ref_edge = K2.fused_preprocess_reference(frame, 0.11, 0.8, out_dtype=dtype)
            assert torch.equal(img, ref_img) and torch.equal(edge, ref_edge)
        gray = torch.rand(hw, generator=gen, device="cuda")
        assert torch.equal(K2.sobel_magnitude(gray), K2.sobel_magnitude_reference(gray))
    # a frame whose first byte is not 4-byte aligned (a slice of a larger buffer)
    buf = torch.randint(0, 256, (1 + 96 * 64 * 3,), generator=gen, device="cuda",
                        dtype=torch.uint8)
    frame = buf[1:].view(96, 64, 3)
    img, edge = K2.fused_preprocess(frame)
    ref_img, ref_edge = K2.fused_preprocess_reference(frame)
    assert torch.equal(img, ref_img) and torch.equal(edge, ref_edge)
    with pytest.raises(ValueError, match="uint8"):
        K2.fused_preprocess(frame.float())


@pytest.mark.cuda
def test_k3_matches_plain_on_card(gen):
    w = (torch.rand(64, 64, 3, 3, generator=gen, device="cuda") * 2 - 1).div(24).bfloat16()
    bias = torch.randn(64, generator=gen, device="cuda") * 0.1
    for shape in [(2, 64, 48, 128), (1, 13, 7, 128), (1, 256, 128, 128)]:
        xp = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        for skip in (None, torch.randn(shape, generator=gen, device="cuda").bfloat16()):
            before = K3.launches
            out = K3.packed_conv3x3(w, bias, xp, relu=True, skip=skip)
            torch.cuda.synchronize()
            assert K3.launches == before + 1
            ref = K3.packed_conv3x3_reference(w, bias, xp, relu=True, skip=skip)
            ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().max())) - 7)
            assert (out.float() - ref.float()).abs().max().item() <= ulp.item()
    with pytest.raises(ValueError, match="float16"):
        K3.packed_conv3x3(w.half(), bias, xp.half(), relu=True)


# K3: the main path's shapes, batch 2, and heights and widths off every tile
_K3_SHAPES = [(1, 512, 256, 128), (1, 256, 128, 128), (1, 128, 64, 128), (1, 64, 32, 128),
              (2, 64, 48, 128), (1, 13, 7, 128), (1, 1, 1, 128), (1, 3, 129, 128)]
# (relu, skip, bias): the block's first two convs, its third, and the two
# the wrapper also takes
_K3_EPILOGUES = {"relu": (True, False, True), "skip-relu": (True, True, True),
                 "plain": (False, False, False), "skip": (False, True, True)}


def _k3_inputs(gen, shape):
    w = (torch.rand(64, 64, 3, 3, generator=gen, device="cuda") * 2 - 1).div(24).bfloat16()
    bias = torch.randn(64, generator=gen, device="cuda") * 0.1
    xp = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    skip = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    return w, bias, xp, skip


def _assert_k3_close(out, ref):
    err = (out.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    ulp = 2.0 ** (torch.floor(torch.log2(torch.tensor(top))).item() - 7) if top else 0.0
    assert torch.isfinite(out).all()
    assert err.max().item() <= ulp and err.mean().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", _K3_EPILOGUES)
@pytest.mark.parametrize("shape", _K3_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k3_every_shape_and_epilogue_on_card(gen, shape, epilogue):
    """One launch per call, a fresh output (never xp or skip), within one
    bf16 ulp of the plain version."""
    w, bias, xp, skip = _k3_inputs(gen, shape)
    relu, has_skip, has_bias = _K3_EPILOGUES[epilogue]
    args = (w, bias if has_bias else None, xp)
    kw = {"relu": relu, "skip": skip if has_skip else None}
    before = K3.launches
    out = K3.packed_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert K3.launches == before + 1 and out.shape == xp.shape and out.dtype == torch.bfloat16
    assert out.data_ptr() not in (xp.data_ptr(), skip.data_ptr())
    _assert_k3_close(out, K3.packed_conv3x3_reference(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _K3_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k3_every_tile_width_on_card(gen, shape):
    """Every tile the kernel can run gives the plain version's result, with
    and without the skip; a width outside :data:`TILE_WIDTHS` is refused."""
    w, bias, xp, skip = _k3_inputs(gen, shape)
    for sk in (None, skip):
        ref = K3.packed_conv3x3_reference(w, bias, xp, relu=True, skip=sk)
        for wt in K3.TILE_WIDTHS:
            _assert_k3_close(K3._launch(w, bias, xp, True, sk, tile_w=wt), ref)
    with pytest.raises(ValueError, match="tile width"):
        K3._launch(w, bias, xp, True, None, tile_w=256)


@pytest.fixture
def no_tf32():
    """fp32 products in full fp32, for the fp32 kernels' plain versions."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _assert_fp32_close(out, ref):
    err = (out - ref).abs()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert err.max().item() <= 2.0 ** -13 * ref.abs().max().item()
    assert err.mean().item() <= 2.0 ** -16 * ref.abs().mean().item()


def _loud_heads(gen, b, h, sq, sk, d, dtype):
    """q, k, v as slices of one fused buffer, the odd heads' q and k 8x
    larger and v 8x smaller: a head that took a neighbour's columns into its
    padded depth would be far off."""
    fused = torch.randn(b, max(sq, sk), 3, h, d, generator=gen, device="cuda")
    fused[:, :, :2, 1::2] *= 8.0
    fused[:, :, 2, 1::2] /= 8.0
    fused = fused.reshape(b, max(sq, sk), 3 * h * d).to(dtype)
    return [fused[:, :n, i * h * d:(i + 1) * h * d] for i, n in enumerate((sq, sk, sk))]


def _folded_reference(q, k, v, h, exact=False):
    """The plain version on the folded heads; with ``exact``, its function
    computed in fp64 and rounded to q's dtype."""
    b, sq, _ = q.shape
    d = q.shape[-1] // h

    def fold(x):
        return x.reshape(b, x.shape[1], h, d).transpose(1, 2).reshape(b * h, x.shape[1], d)

    if exact:
        logits = torch.matmul(fold(q).double(), fold(k).double().transpose(-1, -2)) * d ** -0.5
        ref = torch.matmul(torch.softmax(logits, dim=-1), fold(v).double()).to(q.dtype)
    else:
        ref = FA.flash_attention_reference(fold(q), fold(k), fold(v), d ** -0.5)
    return ref.reshape(b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d)


# (batch, heads, sq, sk, d): the tiny family's 8 and 16, d below its instance's
# width (24 on 40, 72 on 80), d off the 16-byte rows (20: a padded copy), 64,
# and the widest instance
_K1_HEAD_DIMS = [(1, 4, 1024, 1024, 8), (1, 4, 256, 512, 16), (1, 8, 1024, 1024, 24),
                 (2, 4, 256, 256, 20), (1, 8, 1024, 1024, 64), (1, 8, 1024, 2048, 72),
                 (1, 2, 256, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _K1_HEAD_DIMS, ids=lambda s: "x".join(map(str, s)))
def test_k1_every_head_dim_on_card(gen, shape):
    """bf16 at every kind of head dim, heads in place beside loud neighbours,
    one launch per attention, under every rows-per-block plan."""
    b, h, sq, sk, d = shape
    q, k, v = _loud_heads(gen, b, h, sq, sk, d, torch.bfloat16)
    ref = _folded_reference(q, k, v, h)
    before = FA.launches
    out = FA.flash_attention(q, k, v, num_heads=h)
    torch.cuda.synchronize()
    assert FA.launches == before + 1 and out.shape == (b, sq, h * d)
    _assert_k1_close(out, ref)
    for rows in FA.row_plans(sq, d):
        _assert_k1_close(FA._launch(q, k, v, h, d ** -0.5, block_m=rows), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 4096, 4096, 40), (1, 8, 1024, 1024, 80),
                                   (1, 8, 256, 256, 160), (1, 4, 1024, 1024, 8),
                                   (1, 4, 256, 512, 16), (2, 4, 256, 256, 20),
                                   (1, 8, 1024, 2048, 72), (1, 2, 256, 256, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_fp32_on_card(gen, no_tf32, shape):
    """K1's fp32 kernel (3xTF32) at the sd15 frame's three shapes and every
    kind of head dim, heads in place beside loud neighbours, one launch per
    attention, within the fp32 bars of the plain version computed in fp64
    (on loud heads the fp32 plain version is itself up to a bar off),
    equal bit for bit to the folded entry; its rows per block the only
    plan taken."""
    b, h, sq, sk, d = shape
    q, k, v = _loud_heads(gen, b, h, sq, sk, d, torch.float32)
    before = FA.launches_fp32, FA.launches
    out = FA.flash_attention(q, k, v, num_heads=h)
    torch.cuda.synchronize()
    assert (FA.launches_fp32, FA.launches) == (before[0] + 1, before[1])
    _assert_fp32_close(out, _folded_reference(q, k, v, h, exact=True))

    def fold(x):
        return x.reshape(b, x.shape[1], h, d).transpose(1, 2).reshape(b * h, x.shape[1], d)

    folded = FA.flash_attention_bhsd(fold(q).contiguous(), fold(k).contiguous(),
                                     fold(v).contiguous(), d ** -0.5)
    assert torch.equal(folded.reshape(b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d), out)
    rows = FA.fp32_block_rows(d)
    assert torch.equal(FA._launch(q, k, v, h, d ** -0.5, block_m=rows), out)
    with pytest.raises(ValueError, match="rows per block"):
        FA._launch(q, k, v, h, d ** -0.5, block_m=128)


# (batch, heads, sq, sk, d) above d = 256, for the wide kernels: in bf16 two
# slices of 256 columns (264, 320, 512), three (640) and more (1024, 1600), in
# fp32 one slice of 512 up to 512 and two at 516, 640 and 1024; keys !=
# queries, the KL VAE's [1, 4096, 512] at 512x512, a d whose Q streams (1600
# in bf16: past the ring's resident limit; 640 and up in fp32: past 576), and
# d off the 16-byte rows in bf16 (260 and 516: padded copies)
_K1_WIDE = [(1, 2, 256, 256, 264), (1, 2, 512, 256, 320), (1, 1, 4096, 4096, 512),
            (2, 2, 256, 512, 640), (1, 1, 256, 192, 1600), (1, 2, 128, 192, 260),
            (1, 2, 256, 256, 516), (1, 1, 256, 512, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", _K1_WIDE, ids=lambda s: "x".join(map(str, s)))
def test_k1_wide_on_card(gen, no_tf32, shape, dtype):
    """K1 above d = 256, heads in place beside loud neighbours: one launch of
    the wide kernel per attention, within the dtype's bar of the plain
    version, equal bit for bit to the folded entry; the kernel's query rows
    per block (64 in bf16, 32 in fp32) the only plan taken."""
    b, h, sq, sk, d = shape
    q, k, v = _loud_heads(gen, b, h, sq, sk, d, dtype)
    counts = ("launches_wide_fp32" if dtype == torch.float32 else "launches_wide",
              "launches", "launches_fp32")
    before = [getattr(FA, name) for name in counts]
    out = FA.flash_attention(q, k, v, num_heads=h)
    torch.cuda.synchronize()
    assert [getattr(FA, name) for name in counts] == [before[0] + 1, *before[1:]]
    # the 3xTF32 kernel against the plain version computed exactly: on loud
    # heads the fp32 plain version's own logits are off by up to a bar
    # (chip_smoke.py's note at FP32_MAX_REL)
    ref = _folded_reference(q, k, v, h, exact=dtype == torch.float32)
    if dtype == torch.float32:
        _assert_fp32_close(out, ref)
    else:
        _assert_k1_close(out, ref)

    def fold(x):
        return x.reshape(b, x.shape[1], h, d).transpose(1, 2).reshape(b * h, x.shape[1], d)

    folded = FA.flash_attention_bhsd(fold(q).contiguous(), fold(k).contiguous(),
                                     fold(v).contiguous(), d ** -0.5)
    assert torch.equal(folded.reshape(b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d), out)
    rows = FA.WIDE_ROWS_FP32 if dtype == torch.float32 else FA.KEY_TILE
    assert torch.equal(FA._launch(q, k, v, h, d ** -0.5, block_m=rows), out)
    with pytest.raises(ValueError, match="rows per block"):
        FA._launch(q, k, v, h, d ** -0.5, block_m=2 * rows)


@pytest.mark.cuda
def test_k2_graph_replay_on_card(gen):
    """One cooperative launch captured in a CUDA graph replays bit for bit
    on new frames written into its input."""
    frames = [torch.randint(0, 256, (480, 640, 3), generator=gen, device="cuda",
                            dtype=torch.uint8) for _ in range(2)]
    static = frames[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K2.fused_preprocess(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        img, edge = K2.fused_preprocess(static)
    for frame in frames[::-1]:
        static.copy_(frame)
        graph.replay()
        torch.cuda.synchronize()
        ref_img, ref_edge = K2.fused_preprocess_reference(frame)
        assert torch.equal(img, ref_img) and torch.equal(edge, ref_edge)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", _K3_EPILOGUES)
@pytest.mark.parametrize("shape", _K3_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k3_fp32_every_shape_and_epilogue_on_card(gen, no_tf32, shape, epilogue):
    """K3's fp32 kernel: one launch per call, a fresh fp32 output, within
    the fp32 bars of the plain version computed in fp64."""
    w, bias, xp, skip = (t.float() for t in _k3_inputs(gen, shape))
    xp, skip = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    relu, has_skip, has_bias = _K3_EPILOGUES[epilogue]
    args = (w, bias if has_bias else None, xp)
    kw = {"relu": relu, "skip": skip if has_skip else None}
    before = K3.launches_fp32, K3.launches
    out = K3.packed_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert (K3.launches_fp32, K3.launches) == (before[0] + 1, before[1])
    assert out.shape == xp.shape and out.data_ptr() not in (xp.data_ptr(), skip.data_ptr())
    _assert_fp32_close(out, K3.packed_conv3x3_reference(w, args[1], xp.double(), **kw).float())


@pytest.mark.cuda
@pytest.mark.parametrize("hw, recomputed", [((1080, 1920), False), ((2160, 3840), True)],
                         ids=["1080p-held", "2160p-recomputed"])
def test_k2_both_sides_of_the_held_size_on_card(gen, hw, recomputed):
    """Up to 1080p every tile's |grad| stays in shared memory through the
    barrier; at 2160p the tiles past each block's first 8 are recomputed.
    Both match the plain version bit for bit, on a grid that fits at once."""
    grid, per_sm = K2.launch_plan(*hw, "cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert grid == K2.cooperative_grid(*hw, sms, per_sm) and 1 <= per_sm <= K2.MAX_BLOCKS_PER_SM
    assert (K2.recomputed_tiles(*hw, grid) > 0) is recomputed
    frame = torch.randint(0, 256, (*hw, 3), generator=gen, device="cuda", dtype=torch.uint8)
    img, edge = K2.fused_preprocess(frame)
    ref_img, ref_edge = K2.fused_preprocess_reference(frame)
    assert torch.equal(img, ref_img) and torch.equal(edge, ref_edge)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _K3_SHAPES[:4], ids=lambda s: "x".join(map(str, s)))
def test_k3_fp32_every_tile_height_on_card(gen, no_tf32, shape):
    """Every tile height the fp32 kernel can run gives the plain version's
    result computed in fp64; a height outside :data:`FP32_TILE_ROWS`, or a
    bf16 tile width on fp32, is refused."""
    w, bias = (t.float() for t in _k3_inputs(gen, shape)[:2])
    xp, skip = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    for sk in (None, skip):
        ref = K3.packed_conv3x3_reference(w, bias, xp.double(), relu=True, skip=sk).float()
        for rows in K3.FP32_TILE_ROWS:
            _assert_fp32_close(K3._launch(w, bias, xp, True, sk, tile_rows=rows), ref)
    for rows in (1, 3):
        with pytest.raises(ValueError, match="tile rows"):
            K3._launch(w, bias, xp, True, None, tile_rows=rows)
    with pytest.raises(ValueError, match="bf16"):
        K3._launch(w, bias, xp, True, None, tile_w=128)
