#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``videosd_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit from nvidia-smi;
2. build: compile the package's CUDA kernels from ``videosd_tpu_torch/csrc``;
3. kernel K1 (flash attention) against its plain PyTorch version in bf16 at
   the main path's shapes, with both times;
4. the committed trained tiny checkpoint (``examples/toy_tiny_ckpt``) runs
   its 2-step frame program on CUDA and on the CPU in fp32, with TF32 off,
   from the same inputs and noise; the outputs must agree;
5. the main path: a random-weight sd15 bundle in bf16, the prompt encoder,
   and the 512x512 4-step ControlNet + TAESD frame program for a few
   frames; K1's launch count over those frames must be 84 per frame.

The line before the last is a JSON object of per-kernel results; the last
line is ``{"ok": true, "device": {...}}``.  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from videosd_tpu_torch import _build  # noqa: E402
from videosd_tpu_torch.models import layers  # noqa: E402
from videosd_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from videosd_tpu_torch.pipelines.lcm_img2img import (  # noqa: E402
    FrameSpec,
    ModelBundle,
    build_frame_program,
    build_prompt_encoder,
)

# K1's shapes on the main path, [B*H, S, d_head]: sd15 at 512x512 has 8 heads
# over 64^2, 32^2 and 16^2 latents
K1_SHAPES = [(8, 4096, 40), (8, 1024, 80), (8, 256, 160)]
# bf16 tolerance of K1 against its plain version: both round the output to
# bf16 (half an ulp, 2^-9 relative) and they round P at different points
# (unnormalized in the kernel, normalized in the plain math), so they differ
# by a few bf16 ulps of |o| <~ 4; the bound allows ~5 ulps at |o| = 1
K1_MAX_ABS, K1_MEAN_ABS = 2e-2, 2e-3
# routed self-attentions per sd15 512^2 4-step frame: per step 15 in the UNet
# (down 0-2 x 2, up 1-3 x 3) and 6 in the ControlNet (down 0-2 x 2)
K1_PER_FRAME = 84
# tiny fp32 checkpoint, CUDA against CPU: cuDNN and the CPU sum in other
# orders (fp32, TF32 off); latents are O(1), so 1e-3 absolute is ~1e4 ulps
# of drift over two denoise steps, and images may move by one level
TINY_LAT_ATOL, TINY_IMG_LEVELS = 1e-3, 1
# one sd15 UNet call in bf16 with K1 against the same call with the plain
# attention: relative L2 difference of the noise prediction
# (bf16 rounding, 2^-8 relative, of each attention output compounds through
# the 16 transformer blocks; 5e-2 leaves room over the measured ~1.1e-2)
UNET_REL_L2 = 5e-2
MAIN_FRAMES = 5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path, log = _build.build()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.2f} s -> {os.path.relpath(path)}")
    entry = r"Compiling entry function '\w*?(\w{6})ILi(\d+)E.*?(\d+) bytes spill stores.*?Used (\d+) registers"
    for name, d, spill, regs in re.findall(entry, log, re.S):  # ptxas -v, one per kernel
        print(f"  ptxas ...{name}<{d}>: {regs} registers, {spill} bytes spilled")
    _build.load_library()


def phase_k1(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for bh, s, d in K1_SHAPES:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").bfloat16() for _ in "qkv")
        scale = d ** -0.5
        out = fa.flash_attention_bhsd(q, k, v, scale)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, scale)
        err = (out.float() - ref.float()).abs()
        mx, mean = err.max().item(), err.mean().item()
        t_k = cuda_ms(lambda: fa.flash_attention_bhsd(q, k, v, scale))
        t_p = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, scale))
        print(f"K1 [{bh},{s},{d}] bf16: max|d| {mx:.3e} mean|d| {mean:.3e} "
              f"(bounds {K1_MAX_ABS:g}/{K1_MEAN_ABS:g}); kernel {t_k:.4f} ms, plain {t_p:.4f} ms "
              f"({card})")
        if not (torch.isfinite(out).all() and mx <= K1_MAX_ABS and mean <= K1_MEAN_ABS):
            fail(f"K1 disagrees with its plain version at [{bh},{s},{d}]")
        worst, ms, plain_ms = max(worst, mx), ms + t_k, plain_ms + t_p
    print(f"K1 one call at each main-path shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_tiny() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "toy_tiny_ckpt")
    spec = FrameSpec(batch=2, height=64, width=64, steps=2)
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    noise = rng.standard_normal((3, 2, 8, 8, 4)).astype(np.float32)
    args = ([0.6, 0.02], [5.0, 3.0], [2.0, 0.5], [23, 7])  # 0.02: one valid step
    outs = {}
    for dev in ("cuda", "cpu"):
        b = ModelBundle.from_dir(ckpt, device=dev)
        emb, _ = build_prompt_encoder(b)(b.tokenizer(["a portrait", "a landscape"]))
        img, lat = build_frame_program(b, spec)(frame, emb, *args, noise=noise)
        outs[dev] = (img.cpu().numpy().astype(int), lat.float().cpu().numpy())
    dlat = np.abs(outs["cuda"][1] - outs["cpu"][1]).max()
    dimg = np.abs(outs["cuda"][0] - outs["cpu"][0]).max()
    print(f"tiny fp32 2-step 64x64 batch 2, CUDA vs CPU: latents max|d| {dlat:.3e} "
          f"(bound {TINY_LAT_ATOL:g}), image max|d| {dimg} levels (bound {TINY_IMG_LEVELS})")
    if not (np.isfinite(outs["cuda"][1]).all() and dlat <= TINY_LAT_ATOL
            and dimg <= TINY_IMG_LEVELS):
        fail("the tiny program on CUDA disagrees with the CPU")


def phase_main(card: str) -> int:
    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd15", dtype=torch.bfloat16, device="cuda")
    encoder = build_prompt_encoder(bundle)
    embeds, _ = encoder(bundle.tokenizer(["portrait, pixar, cg"]))
    spec = FrameSpec(batch=1, height=512, width=512, steps=4)
    program = build_frame_program(bundle, spec)
    frame = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    ).cuda()
    args = ([0.6], [5.0], [2.0], [23])
    torch.cuda.synchronize()
    print(f"sd15 bundle + prompt: {time.perf_counter() - t0:.1f} s")

    # K1 inside the path: one UNet call with K1 against the plain attention
    unet = bundle.models["unet"]
    x = torch.randn(1, 4, 64, 64, generator=torch.Generator("cuda").manual_seed(3),
                    device="cuda").bfloat16()
    t = torch.tensor([519], device="cuda")
    with torch.inference_mode():
        eps = unet(x, t, embeds, timestep_cond=layers.guidance_embedding(
            torch.tensor([5.0], device="cuda"), 256).bfloat16())
        routed = layers.flash_attention
        layers.flash_attention = lambda q, k, v, *, num_heads: layers._attention_plain(
            q, k, v, num_heads)
        try:
            eps_plain = unet(x, t, embeds, timestep_cond=layers.guidance_embedding(
                torch.tensor([5.0], device="cuda"), 256).bfloat16())
        finally:
            layers.flash_attention = routed
    rel = ((eps.float() - eps_plain.float()).norm() / eps_plain.float().norm()).item()
    print(f"sd15 UNet call, K1 vs plain attention: rel L2 {rel:.3e} (bound {UNET_REL_L2:g})")
    if not (torch.isfinite(eps).all() and rel <= UNET_REL_L2):
        fail("the UNet with K1 disagrees with the plain attention")

    img, lat = program(frame, embeds, *args)  # warm-up: cuDNN/cuBLAS plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    times = []
    for _ in range(MAIN_FRAMES):
        t0 = time.perf_counter()
        img, lat = program(frame, embeds, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if img.shape != (1, 512, 512, 3) or img.dtype != torch.uint8:
        fail(f"image {tuple(img.shape)} {img.dtype}")
    if lat.shape != (1, 64, 64, 4) or lat.dtype != torch.bfloat16 or not torch.isfinite(lat).all():
        fail(f"latents {tuple(lat.shape)} {lat.dtype} or not finite")
    if launches != K1_PER_FRAME * MAIN_FRAMES:
        fail(f"K1 launched {launches} times over {MAIN_FRAMES} frames, "
             f"expected {K1_PER_FRAME} per frame")
    print(f"sd15 512x512 4-step CN+TAESD bf16 batch 1 on {card}: median "
          f"{statistics.median(times):.2f} ms/frame over {MAIN_FRAMES} frames "
          f"(min {min(times):.2f}, max {max(times):.2f}), peak allocated {peak:.2f} GiB, "
          f"K1 launches {launches // MAIN_FRAMES}/frame")
    return launches


def main() -> None:
    card = phase_card()
    phase_build()
    k1 = phase_k1(card)
    phase_tiny()
    launches = phase_main(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "videosd_tpu_torch/csrc/flash_attention.cu",
        "replaces": "videosd_tpu/ops/pallas/flash_attention.py:83",
        "launches": launches,
        **k1,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
