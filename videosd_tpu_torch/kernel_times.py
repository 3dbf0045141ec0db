"""Device time per call of kernels K1, K2 and K3's fp32 kernel, and the fp32
parity frame's replayed time, in one checkout of the port.

    python3 videosd_tpu_torch/kernel_times.py [--root DIR]

Imports ``videosd_tpu_torch`` from DIR (default: the checkout this file is
in), so that an older tree unpacked beside this one can be timed with the
same code: run it for the old tree and this one in turns (old, new, new,
old) in one call on one card, since cards and their power limits differ
between calls.  It times, with torch.profiler (the device time of every
kernel and memset a call issues, median of three sessions of 20 calls):

* first, before any profiler session (one slows the host's later
  launches): the sd15 512x512 4-step ControlNet + KL frame in fp32 (the
  configuration of ``videosd_tpu/tools/parity.py``, TF32 off) and in bf16
  (the production dtype), random weights from seed 0, replayed from its
  CUDA graph: the median ms of FRAMES blocking frames (host clock);
* K1, ``flash_attention`` on ``[1, S, 8*d]`` tensors at the sd15 512x512
  main path's three shapes in bf16 and in fp32 (the d <= 256 fp32 kernel),
  and on one head of d = 512 at the KL VAE's [1, 4096, 512] and
  [4, 4096, 512] in bf16 and in fp32 (the wide kernels);
* the sd15 KL VAE (``models/vae.py``, published widths, weights from torch's
  default init under seed 0) in bf16 and in fp32 (TF32 off): one encode of
  a 512x512 frame and one decode of its 64x64 latent, all its kernels (two
  of them the wide kernel of the dtype);
* K2, ``fused_preprocess`` of a uint8 frame at 512x512, 768x768, 480x640
  and 1080x1920, with its device operations per call;
* K3's fp32 kernel, ``packed_conv3x3`` on fp32 ``[1, H, W/2, 128]`` at the
  four sizes of TAESD's residual blocks in a 512x512 encode + decode, with
  ReLU and with the skip (the JAX init rule's weights, bias 0.1 randn);
  then a TAESD (``models/taesd.py``, default widths, weights from torch's
  default init under seed 0) in fp32, TF32 off: one encode of a 512x512
  frame and one decode of its 64x64 latent, on the ``pallas_convs`` route
  (60 launches of K3's fp32 kernel) and on the default route (cuDNN).

Prints one JSON line per kernel and shape, then the card's name and power
limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

K1_SHAPES = [(8, 4096, 40), (8, 1024, 80), (8, 256, 160)]
K1_WIDE = [(1, 4096, 512), (4, 4096, 512)]  # (batch, S, d), one head
K2_SHAPES = [(512, 512), (768, 768), (480, 640), (1080, 1920)]
K3_SHAPES = [(1, 512, 256, 128), (1, 256, 128, 128), (1, 128, 64, 128), (1, 64, 32, 128)]
CALLS, SESSIONS = 20, 3
FRAMES = 10


def _device(torch, fn) -> tuple[float, float]:
    """(device ms per call, device operations per call): medians over
    sessions of CALLS calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    ms, ops = [], []
    for _ in range(SESSIONS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        ms.append(sum(e.self_device_time_total for e in events) / CALLS / 1e3)
        ops.append(sum(e.count for e in events) / CALLS)
    return statistics.median(ms), statistics.median(ops)


def _frame_ms(torch, dtype) -> float:
    """Median ms of FRAMES blocking replays of the sd15 CN + KL frame."""
    import time

    import numpy as np

    from videosd_tpu_torch.pipelines.lcm_img2img import (
        FrameSpec,
        ModelBundle,
        build_frame_program,
        build_prompt_encoder,
    )

    bundle = ModelBundle.random("sd15", dtype=dtype, device="cuda", with_kl_vae=True)
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    program = build_frame_program(bundle, FrameSpec(batch=1, height=512, width=512, steps=4,
                                                    vae="kl"))
    frame = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3),
                                                               dtype=np.uint8)).cuda()
    program(frame, embeds, [0.6], [5.0], [2.0], [23])  # warm-up and capture
    ms = []
    for i in range(FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program(frame, embeds, [0.6], [5.0], [2.0], [24 + i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def _k3(torch, tree: str) -> None:
    """K3's fp32 kernel at K3_SHAPES, then the fp32 TAESD on both routes."""
    import dataclasses

    from videosd_tpu_torch.models.taesd import (
        AutoencoderTiny,
        TAESDConfig,
        taesd_decode,
        taesd_encode,
    )
    from videosd_tpu_torch.ops.cuda import taesd_conv as k3

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = (torch.rand(64, 64, 3, 3, generator=gen, device="cuda") * 2 - 1) / 24.0
    bias = torch.randn(64, generator=gen, device="cuda") * 0.1
    for shape in K3_SHAPES:
        xp, skip = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
        for epi, sk in (("relu", None), ("skip+relu", skip)):
            ms, ops = _device(torch, lambda: k3.packed_conv3x3(w, bias, xp, relu=True, skip=sk))
            print(json.dumps({"tree": tree, "kernel": "K3 fp32", "shape": list(shape),
                              "epilogue": epi, "device_ms": ms, "device_ops_per_call": ops}))
    torch.manual_seed(0)
    cfg = TAESDConfig()
    ae = AutoencoderTiny(cfg).cuda().float().eval()
    x = torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
    z = torch.randn(1, 64, 64, 4, generator=gen, device="cuda")
    for route, c in (("pallas_convs", dataclasses.replace(cfg, pallas_convs=True)),
                     ("default", cfg)):
        with torch.inference_mode():
            ms, ops = _device(torch, lambda: (taesd_encode(ae, x, c), taesd_decode(ae, z, c)))
        print(json.dumps({"tree": tree, "kernel": f"TAESD fp32 encode + decode, {route}",
                          "shape": [1, 512, 512, 3], "device_ms": ms,
                          "device_ops_per_call": ops}))


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=here, help="checkout to import the port from")
    root = os.path.abspath(parser.parse_args().root)
    sys.path.insert(0, root)
    import torch

    from videosd_tpu_torch.models.vae import VAE_PRESETS, AutoencoderKL, vae_decode, vae_encode
    from videosd_tpu_torch.ops.cuda import flash_attention as fa
    from videosd_tpu_torch.ops.cuda import preprocess_kernel as k2

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    tree = os.path.relpath(root, here)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        print(json.dumps({"tree": tree, "kernel": f"{name} sd15 CN+KL frame, replayed",
                          "shape": [1, 512, 512, 3], "ms_per_frame": _frame_ms(torch, dtype)}))
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, name in ((torch.bfloat16, "K1"), (torch.float32, "K1 fp32")):
        for h, s, d in K1_SHAPES:
            q, k, v = (torch.randn(1, s, h * d, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            ms, ops = _device(torch, lambda: fa.flash_attention(q, k, v, num_heads=h))
            print(json.dumps({"tree": tree, "kernel": name, "shape": [h, s, d],
                              "device_ms": ms, "device_ops_per_call": ops}))
    for dtype, name in ((torch.bfloat16, "K1 wide"), (torch.float32, "K1 wide fp32")):
        for b, s, d in K1_WIDE:
            q, k, v = (torch.randn(b, s, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            ms, ops = _device(torch, lambda: fa.flash_attention(q, k, v, num_heads=1))
            print(json.dumps({"tree": tree, "kernel": name, "shape": [b, s, d],
                              "device_ms": ms, "device_ops_per_call": ops}))
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        torch.manual_seed(0)
        vae = AutoencoderKL(VAE_PRESETS["sd15"]).cuda().to(dtype).eval()
        x = (torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1).to(dtype)
        z = torch.randn(1, 64, 64, 4, generator=gen, device="cuda").to(dtype)
        with torch.inference_mode():
            ms, ops = _device(torch, lambda: (vae_encode(vae, x), vae_decode(vae, z)))
        print(json.dumps({"tree": tree, "kernel": f"KL VAE {name} encode + decode",
                          "shape": [1, 512, 512, 3], "device_ms": ms,
                          "device_ops_per_call": ops}))
        del vae
    for hw in K2_SHAPES:
        frame = torch.randint(0, 256, (*hw, 3), generator=gen, device="cuda", dtype=torch.uint8)
        ms, ops = _device(torch, lambda: k2.fused_preprocess(frame))
        print(json.dumps({"tree": tree, "kernel": "K2", "shape": [*hw, 3],
                          "device_ms": ms, "device_ops_per_call": ops}))
    _k3(torch, tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")


if __name__ == "__main__":
    main()
