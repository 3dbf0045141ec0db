"""The int8 w8a8 linears and LoRA fusion on the card.

Every test here is marked ``cuda`` and skips without a card; the file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m cuda tests/test_torch_port_quant_cuda.py

* ``linear_w8a8`` on the card against the CPU on the same input: the
  activation codes and ``torch._int_mm``'s int32 product bit for bit
  (fewer than 17 rows padded with zero rows), the fp32 output bit for bit,
  one ``_int_mm`` launch counted per call, and a K or N off a multiple of
  8 refused.
* A tiny int8 bundle's frame program: its CUDA graph's replay equal to the
  eager frame bit for bit, with the ``_int_mm`` launches of one frame
  counted at capture.
* LoRA fused into a tiny bundle on the card equal to the same fusion on
  the CPU, bit for bit.
"""

import numpy as np
import pytest
import torch
from torch import nn

from videosd_tpu_torch.io.lora import fuse_bundle_loras
from videosd_tpu_torch.io.safetensors import write_safetensors
from videosd_tpu_torch.models import layers as PL
from videosd_tpu_torch.ops.quant import quantize_bundle_params
from videosd_tpu_torch.pipelines import lcm_img2img as P


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm's int8 path runs on cuBLASLt there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 16, 17, 4096])
def test_linear_w8a8_on_card_equals_cpu(card, rows):
    gen = torch.Generator().manual_seed(rows)
    lin = nn.Linear(320, 1280)
    x = torch.randn(rows, 320, generator=gen)
    q = PL.quantize_linear(lin.weight, lin.bias)
    qc = PL.quantize_linear(lin.weight.cuda(), lin.bias.cuda())
    assert all(torch.equal(qc[k].cpu(), v) for k, v in q.items())
    before = PL.int_mm_launches
    y = PL.linear_w8a8(x.cuda(), qc["w8"], qc["sw"], qc["bias"])
    assert PL.int_mm_launches == before + 1
    assert torch.equal(y.cpu(), PL.linear_w8a8(x, q["w8"], q["sw"], q["bias"]))
    with pytest.raises(ValueError, match="multiples of 8"):
        PL.linear_w8a8(x[:, :300].cuda(), qc["w8"][:, :300], qc["sw"])


@pytest.mark.cuda
def test_int8_frame_replays_equal_to_eager(card):
    bundle = P.ModelBundle.random("tiny", dtype=torch.float32, device="cuda")
    quantize_bundle_params(bundle, min_attn_dim=0)
    embeds, _ = P.build_prompt_encoder(bundle)(bundle.tokenizer(["a fox"]))
    spec = P.FrameSpec(batch=1, height=128, width=128, steps=2)
    frame = np.random.default_rng(0).integers(0, 256, (1, 128, 128, 3), dtype=np.uint8)
    program = P.build_frame_program(bundle, spec)
    got = program(frame, embeds, [0.6], [5.0], [2.0], [23])
    want = P.frame_program(bundle, spec, frame, embeds, [0.6], [5.0], [2.0], [23])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # 2 steps x (the UNet's 4 transformer blocks and the ControlNet's 2) x 6
    # calls (fused qkv, to_out, the cross-attention's to_q and to_out, ff x 2)
    assert program.last_launches["int_mm"] == 2 * (4 + 2) * 6


@pytest.mark.cuda
def test_lora_fused_on_card_equals_cpu(card, tmp_path):
    cpu = P.ModelBundle.random("tiny", dtype=torch.bfloat16, device="cpu")
    cuda = P.ModelBundle.from_state_dicts(
        "tiny", {n: m.state_dict() for n, m in cpu.models.items()}, dtype=torch.bfloat16,
        device="cuda")
    rng = np.random.default_rng(1)
    tensors = {}
    for key, w in cpu.models["unet"].state_dict().items():
        if key.endswith(("to_q.weight", "ff.net.2.weight")) or key == "conv_in.weight":
            m = key[: -len(".weight")]
            down_shape = (4, *w.shape[1:]) if w.ndim == 4 else (4, w.shape[1])
            up_shape = (w.shape[0], 4, 1, 1) if w.ndim == 4 else (w.shape[0], 4)
            tensors[f"unet.{m}.lora_A.weight"] = rng.standard_normal(down_shape).astype(np.float32)
            tensors[f"unet.{m}.lora_B.weight"] = rng.standard_normal(up_shape).astype(np.float32)
    path = str(tmp_path / "lora.safetensors")
    write_safetensors(path, tensors)
    stats = [fuse_bundle_loras(b, [(path, 0.3)], strict=True) for b in (cpu, cuda)]
    assert stats[0] == stats[1] and stats[0]["unet"] == len(tensors) // 2
    for k, v in cuda.models["unet"].state_dict().items():
        assert torch.equal(v.cpu(), cpu.models["unet"].state_dict()[k]), k
