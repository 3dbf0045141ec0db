"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 (flash attention), K2 (fused preprocess with its Sobel stencil) and K3
(the TAESD 3x3 conv) have no CPU or interpret mode, so every test here is
marked ``cuda`` and skips without a card.  The file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels_cuda.py

Bars: K1 max |d| <= 2e-2 and mean <= 2e-3 in bf16 (the plain math and the
kernel round P at different points); K2 equal bit for bit; K3 within one
bf16 ulp of the largest output (both round fp32 sums of exact bf16
products once, in different summation orders).
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
        err = (out.float() - ref.float()).abs()
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
    with pytest.raises(ValueError, match="bfloat16"):
        FA.flash_attention_bhsd(q.float(), k.float(), v.float(), 0.1)


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
