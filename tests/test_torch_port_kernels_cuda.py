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
exact bf16 products once, in different summation orders).
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
    with pytest.raises(ValueError, match="bfloat16"):
        FA.flash_attention_bhsd(q.float(), k.float(), v.float(), 0.1)


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
    for hw in [(480, 640), (37, 5), (512, 512)]:
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
    with pytest.raises(ValueError, match="bfloat16"):
        K3.packed_conv3x3(w, bias, xp.float(), relu=True)


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
