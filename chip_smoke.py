#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``videosd_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit from nvidia-smi;
2. build: compile the package's CUDA kernels from ``videosd_tpu_torch/csrc``;
3. kernel K1 (flash attention) against its plain PyTorch version in bf16 at
   the main path's shapes and at further ones (keys != queries, batch 2,
   d = 64), and the in-place ``[B, S, H*D]`` entry against the folded one;
4. the committed trained tiny checkpoint (``examples/toy_tiny_ckpt``) runs
   its 2-step frame program on CUDA and on the CPU in fp32, with TF32 off,
   from the same inputs and noise; the outputs must agree;
5. the main path: a random-weight sd15 bundle in bf16, the prompt encoder,
   and the 512x512 4-step ControlNet + TAESD frame program for a few
   frames; K1's launch count over those frames must be 84 per frame;
6. the ``taesd_pallas`` path: the phase-5 frame program with
   ``TAESDConfig(pallas_convs=True)``, timed right after phase 5; K3 must
   launch 60 times and K1 84 times per frame, and the image must stay
   close to phase 5's;
6b. production: the phase-5 bundle through the five FrameSpec variants
   that ``bench.py`` measures (ControlNet and DeepCache intervals,
   temporal DeepCache produce/reuse), each with its exact K1 launch count
   per frame, peak memory, and ms/frame beside parity frames timed in
   turn with it (the host's speed drifts within a call); then the
   engine-shaped call (an
   I420 768x768 mailbox holding a 480x640 camera frame, its ``src_box``,
   temporal DeepCache, warm start): uint8 image and finite latents,
   ``warm_alpha=0`` equal to no warm start bit for bit, reuse of the same
   frame's caches close to the parity frame, and ``crop_resize`` on the
   card equal to the CPU's;
6c. K1's device time per shape beside its bound, the plain version's time
   and one ``scaled_dot_product_attention`` call's (timed here, used
   nowhere in the port), and at the main path's shapes under every number
   of query rows per block the kernel can run: the first profiler sessions
   of the run, after every frame timing;
7. kernel K2 (the fused preprocess with its Sobel stencil) against its
   plain version at three frame sizes: equal bit for bit, with both times;
8. kernel K3 (the TAESD 3x3 conv) against its plain version at the main
   path's shapes, both epilogues, with its time beside the plain version's
   and a cuDNN bf16 conv's;
9. the ``fused_preprocess`` entry on the main path's frame (K2's path);
10. TAESD encode + decode at 512x512 through K3 against an fp32 copy and
    the packed library route, and the device time of encode + decode on
    every route;
11. last, one torch.profiler pass over two main-path frames: kernel
    launches and device-busy time per frame, K1's share, and the copy
    kernels (K1 reads the heads in place, so no fold copies remain).

Each kernel's launch count is set to 0 just before the path that runs it
and read just after; launches that compare a kernel with its plain version
are not counted.  The line before the last is a JSON object of per-kernel
results (each with its bound, computed from the shapes: the larger of its
bytes over 3.35 TB/s and its operations over 989 TFLOP/s); the last line is
``{"ok": true, "device": {...}}``.  Nothing here imports JAX.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from videosd_tpu_torch import _build  # noqa: E402
from videosd_tpu_torch.models import layers  # noqa: E402
from videosd_tpu_torch.models.taesd import taesd_decode, taesd_encode  # noqa: E402
from videosd_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from videosd_tpu_torch.ops.cuda import preprocess_kernel as k2  # noqa: E402
from videosd_tpu_torch.ops.cuda import taesd_conv as k3  # noqa: E402
from videosd_tpu_torch.ops.preprocess import (  # noqa: E402
    center_crop_box,
    crop_resize,
    i420_to_rgb255,
    rgb_to_i420_host,
)
from videosd_tpu_torch.pipelines.lcm_img2img import (  # noqa: E402
    FrameSpec,
    ModelBundle,
    build_frame_program,
    build_prompt_encoder,
)

# K1's shapes on the main path, [B*H, S, d_head]: sd15 at 512x512 has 8 heads
# over 64^2, 32^2 and 16^2 latents
K1_SHAPES = [(8, 4096, 40), (8, 1024, 80), (8, 256, 160)]
# further K1 shapes held against plain, as (B, H, Sq, Sk, d): the
# reference-attention read (twice the keys), batch 2 (at d = 80 the grid then
# takes 128 rows per block), d = 64, and few queries on many keys at d = 160
K1_EXTRA = [(1, 8, 4096, 8192, 40), (2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80),
            (1, 8, 1024, 1024, 64), (1, 8, 256, 4096, 160)]
# the card's published peaks (H100 SXM): dense bf16 tensor-core rate, HBM rate
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# bf16 bar of K1 against its plain version, relative to the outputs (with
# randn inputs |o| shrinks as the keys grow: ~0.02 at 4096 keys): both round
# the output to bf16 (half an ulp, 2^-9 relative, each) and they round P at
# different points (unnormalized in the kernel, normalized in the plain math).
# Measured: max |d| one bf16 ulp of the largest output, mean |d| 0.6 * 2^-8 of
# mean |o|, at every shape.  The bar is two ulps and 2^-7: an attention that
# skips one key tile in 64 is ~25x over the mean bar.  Never above the old
# absolute bounds 2e-2 / 2e-3.
K1_MAX_ULPS, K1_MEAN_REL = 2, 2.0 ** -7
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
# K2's frame sizes: the main path's, the engine's mailbox frame_hw, and a
# camera size off the TPU kernel's 128-tiling
K2_SHAPES = [(512, 512), (768, 768), (480, 640)]
# K3's shapes on the main path as packed [B, H, W/2, 128], with the number of
# convs per 512^2 frame at each: TAESD's 20 residual blocks x 3 convs, the
# third of each with the skip epilogue
K3_SHAPES = {(1, 512, 256, 128): 6, (1, 256, 128, 128): 18, (1, 128, 64, 128): 18,
             (1, 64, 32, 128): 18}
K3_EXTRA = (2, 64, 48, 128)  # batch 2, a width off the 16-column tile
K3_PER_FRAME = sum(K3_SHAPES.values())  # 60
# K3 against its plain version in bf16: both take fp32 sums of the same exact
# bf16 products (in different orders, ~1e-6 relative apart) and round once to
# bf16, so an output differs only where the two sums straddle a rounding
# boundary, by one bf16 ulp of its own size: max |d| may be one ulp of the
# largest output, and such outputs are rare (mean |d| measured ~6e-8)
K3_MEAN_ABS = 1e-5
# TAESD at 512^2 in bf16 against an fp32 copy: the K3 route may be no
# further from fp32 than the default cuDNN route is (it rounds once per conv,
# the library routes before and after bias, ReLU and skip; measured rel L2
# 1.5e-2 / 2.4e-2 for encode / decode against the default route's 2.0e-2 /
# 3.1e-2).  The K3 route against the packed library route adds two such
# errors (measured 2.4e-2 / 3.8e-2): bound 5e-2
TAESD_REL_L2 = 5e-2
# PSNR of the taesd_pallas frame's image against the default route's: the
# two TAESD routes round differently, so some pixels move by one level
# (measured 64.92 dB, an MSE of 0.021 levels^2); 50 dB allows 30x that MSE,
# while a wrong conv gives noise far below 30 dB
FRAME_PSNR_DB = 50.0
# The five production variants bench.py measures, as FrameSpec fields of the
# phase-5 program, with K1 launches per frame: a full UNet pass routes 15
# attentions, a shallow DeepCache pass 5 (2 in down0, 3 in up3) and a
# ControlNet call 6.  Temporal variants run the N=2 cadence (produce, reuse,
# ...) and give (produce, reuse) counts.
PRODUCTION = {
    "cn_interval4_turbo": ({"controlnet_interval": 4}, 66),  # CN at s=0
    "dc_interval2_turbo": ({"deepcache_interval": 2}, 64),  # full at s=0,2
    "production_turbo_cn2_dc3_last": (  # CN at s=0,2,3; full at s=0,3
        {"controlnet_interval": 2, "deepcache_interval": 3, "interval_refresh_last": True}, 58),
    "production_temporal2_cn1": ({"deepcache_temporal": True}, (84, 44)),
    "production_temporal2_cn2_last": (  # CN at s=0,2,3
        {"deepcache_temporal": True, "controlnet_interval": 2, "interval_refresh_last": True},
        (78, 38)),
}
PRODUCTION_FRAMES = 8
# the serving engine's geometry: its 768x768 mailbox (config frame_hw) holding
# a 480x640 camera frame, uploaded as packed I420
MAILBOX_HW, CAMERA_HW = (768, 768), (480, 640)
# crop_resize on the card against the CPU, fp32 at the mailbox geometry: the
# taps land on the same pixels (positions are exact fp32 arithmetic); only
# sin and the order of the tap sums differ, a few fp32 ulps of [0, 1]
CROP_ATOL = 1e-5


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


KernelTime = collections.namedtuple("KernelTime", "key count device_us")


def _profiled(fn, iters: int) -> list:
    """Kernel events of ``iters`` calls of ``fn`` under torch.profiler, as
    (kernel name, launches, device microseconds) over all the calls.

    A session now and then loses events: all of them, one whole call's,
    every event of one kernel, or a few in ten thousand of a long session.
    So sessions are taken until two in a row saw the same kernel names and
    total launches within a thousandth of each other (equal, for a session
    of fewer than 1000); of those two, each kernel is read from the session
    that saw more of it, since a loss only lowers a count.  Every session
    that does not pair with the one before is printed, and six sessions
    without a pair fail the run."""
    fn()
    torch.cuda.synchronize()
    last = None
    for session in range(6):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: KernelTime(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages() if e.self_device_time_total > 0}
        total = sum(k.count for k in seen.values())
        if last is not None:
            last_total = sum(k.count for k in last.values())
            if seen and seen.keys() == last.keys() and abs(total - last_total) * 1000 <= total:
                if total != last_total:
                    print(f"  profiler sessions {session - 1} and {session}: {last_total} and "
                          f"{total} launches over {iters} calls; each kernel read from the "
                          f"session that saw more of it")
                return [max(seen[key], last[key], key=lambda k: k.count) for key in seen]
            print(f"  profiler session {session - 1} set aside: {last_total} launches of "
                  f"{len(last)} kernels over {iters} calls, session {session} saw {total} of "
                  f"{len(seen)}")
        last = seen
    fail("torch.profiler gave no two sessions in a row that agree, in six")


def device_ms(fn, iters: int = 5) -> float:
    """Device time of ``fn``'s kernels per call, summed by torch.profiler
    (the host's enqueue time, which CUDA events would include, is not)."""
    return sum(k.device_us for k in _profiled(fn, iters)) / iters / 1e3


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over the
    bf16 peak and bytes (each input read once, each output written once)
    over the memory rate; and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_bound(b: int, h: int, sq: int, sk: int, d: int) -> tuple[float, str]:
    """K1's bound: 4 Sq Sk d flops per head; q, k, v read and o written once
    in bf16."""
    return bound_ms(4.0 * b * h * sq * sk * d, 2.0 * b * h * d * (2 * sq + 2 * sk))


def k1_within_bar(out, ref) -> tuple[bool, float, float, float, float]:
    """(K1's output is finite and within its bar of the plain version's,
    max |d|, mean |d|, the bar on the max, the bar on the mean)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    mx, mean = err.max().item(), err.mean().item()
    ulp = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
    max_bar = min(K1_MAX_ULPS * ulp, K1_MAX_ABS)
    mean_bar = min(K1_MEAN_REL * ref.abs().mean().item(), K1_MEAN_ABS)
    ok = bool(torch.isfinite(out).all()) and mx <= max_bar and mean <= mean_bar
    return ok, mx, mean, max_bar, mean_bar


def timed(fn) -> tuple[float, float]:
    """(CUDA-event ms per call, device ms per call)."""
    return cuda_ms(fn), device_ms(fn)


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
    # ptxas -v reports each kernel entry: its properties (spills), then its registers
    for block in log.split("Compiling entry function '")[1:]:
        spill = re.search(r"(\d+) bytes spill stores", block)
        regs = re.search(r"Used (\d+) registers", block)
        print(f"  ptxas {_demangle(block.split(chr(39))[0])}: {regs and regs.group(1)} registers, "
              f"{spill.group(1) if spill else 0} bytes spilled")
    _build.load_library()


def _demangle(name: str) -> str:
    if shutil.which("c++filt"):
        name = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()
    return name.replace("(anonymous namespace)::", "").split("(")[0]


def _k1_case(gen, b, h, sq, sk, d):
    """K1 on [b, s, h*d] tensors through the in-place entry, held against
    the plain version on the folded heads and against the folded entry;
    returns the largest |d| from the plain version."""
    q, k, v = (torch.randn(b, n, h * d, generator=gen, device="cuda").bfloat16()
               for n in (sq, sk, sk))

    def fold(x):
        return x.reshape(b, x.shape[1], h, d).transpose(1, 2).reshape(b * h, x.shape[1], d)

    def unfold(x):
        return x.reshape(b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d)

    qf, kf, vf = fold(q).contiguous(), fold(k).contiguous(), fold(v).contiguous()
    scale = d ** -0.5
    out = fa.flash_attention(q, k, v, num_heads=h)
    folded = fa.flash_attention_bhsd(qf, kf, vf, scale)
    torch.cuda.synchronize()
    ref = unfold(fa.flash_attention_reference(qf, kf, vf, scale))
    ok, mx, mean, max_bar, mean_bar = k1_within_bar(out, ref)
    name = f"[{b},{h},{sq},{sk},{d}]"
    same = torch.equal(unfold(folded), out)
    print(f"K1 {name} bf16, {fa.block_rows(sq, b * h, d)} rows/block: max|d| {mx:.3e} (bar "
          f"{max_bar:.3e}: {K1_MAX_ULPS} ulps of the largest output) mean|d| {mean:.3e} (bar "
          f"{mean_bar:.3e}: 2^-7 of mean|o| {ref.float().abs().mean().item():.3e}); in-place "
          f"entry equals the folded one bit for bit: {same}")
    if not ok:
        fail(f"K1 disagrees with its plain version at {name}")
    if not same:  # one kernel, one plan, one order of sums
        fail(f"K1's in-place entry differs from the folded one at {name}")
    return mx


def _k1_cases():
    return [(1, s[0], s[1], s[1], s[2]) for s in K1_SHAPES] + K1_EXTRA


def phase_k1() -> float:
    """K1 against its plain version at every shape; the largest |d|."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    return max(_k1_case(gen, *case) for case in _k1_cases())


def phase_k1_times(card: str) -> dict:
    """K1's time per shape beside its bound, one scaled_dot_product_attention
    call and the plain version.  Run after every frame timing: it opens the
    first profiler sessions of the process."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    sdpa = torch.nn.functional.scaled_dot_product_attention  # the yardstick only
    total = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    per_shape, by_resource = [], {"operations": 0.0, "bytes": 0.0}
    for b, h, sq, sk, d in _k1_cases():
        q, k, v = (torch.randn(b, n, h * d, generator=gen, device="cuda").bfloat16()
                   for n in (sq, sk, sk))
        q4, k4, v4 = (x.reshape(b, x.shape[1], h, d).transpose(1, 2) for x in (q, k, v))
        qf, kf, vf = (x.reshape(b * h, x.shape[2], d) for x in (q4, k4, v4))
        t_k = timed(lambda: fa.flash_attention(q, k, v, num_heads=h))
        # heads in place: one attention is one kernel
        kernels = sum(e.count for e in _profiled(
            lambda: fa.flash_attention(q, k, v, num_heads=h), 5)) / 5
        if kernels != 1:
            fail(f"K1 at [{b},{h},{sq},{sk},{d}] ran {kernels:g} kernels per attention: a copy?")
        t_l = timed(lambda: sdpa(q4, k4, v4))
        t_p = cuda_ms(lambda: fa.flash_attention_reference(qf, kf, vf, d ** -0.5), iters=5)
        flops = 4.0 * b * h * sq * sk * d
        bound, by = k1_bound(b, h, sq, sk, d)
        print(f"K1 [{b},{h},{sq},{sk},{d}]: device {t_k[1]:.4f} ms ({flops / t_k[1] / 1e9:.0f} "
              f"TFLOP/s; CUDA events {t_k[0]:.4f}; {kernels:g} kernel(s) per attention), bound {bound * 1e3:.2f} us by {by} "
              f"(reached {bound / t_k[1]:.1%}), library SDPA device {t_l[1]:.4f} ms (events "
              f"{t_l[0]:.4f}), plain {t_p:.4f} ms ({card})")
        if sq == sk and b == 1 and (h, sq, d) in K1_SHAPES:  # one call at each main-path shape
            for key, val in (("ms", t_k[0]), ("device_ms", t_k[1]), ("plain_ms", t_p),
                             ("library_ms", t_l[1]), ("bound_ms", bound)):
                total[key] += val
            by_resource[by] += bound
            # every number of rows per block the kernel can run this shape with, held
            # to the bar and timed: what block_rows' rule rests on
            ref = fa.flash_attention_reference(qf, kf, vf, d ** -0.5).reshape(
                b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d)
            picked, plans = fa.block_rows(sq, b * h, d), {}
            for rows in fa.row_plans(sq, d):
                def plan(rows=rows):
                    return fa._launch(q, k, v, h, d ** -0.5, block_m=rows)
                if not k1_within_bar(plan(), ref)[0]:
                    fail(f"K1 at [{b},{h},{sq},{sk},{d}] with {rows} rows per block disagrees "
                         f"with its plain version")
                plans[rows] = t_k[1] if rows == picked else device_ms(plan)
            print(f"   rows per block -> device ms ({sq // picked * b * h} blocks at the {picked} "
                  f"picked): " + ", ".join(f"{r}: {t:.4f}" for r, t in plans.items()))
            per_shape.append({"shape": [h, sq, d], "device_ms": t_k[1], "ms": t_k[0],
                              "library_ms": t_l[1], "bound_ms": bound, "bound_by": by,
                              "rows_per_block": picked,
                              "device_ms_by_rows": {str(r): t for r, t in plans.items()}})
    print("K1 one call at each main-path shape: "
          + ", ".join(f"{k} {v:.4f}" for k, v in total.items()))
    return {**total, "bound_by": max(by_resource, key=by_resource.get), "per_shape": per_shape}


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
    fa.launches = k2.launches = k3.launches = 0
    times = []
    for _ in range(MAIN_FRAMES):
        t0 = time.perf_counter()
        img, lat = program(frame, embeds, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = fa.launches
    if k2.launches or k3.launches:
        fail(f"the default route launched K2 {k2.launches} and K3 {k3.launches} times")
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
    return launches, (bundle, embeds, frame, args, img)


def phase_k2(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4321)
    ms = plain_ms = dev_ms = bound = 0.0
    for hw in K2_SHAPES:
        frame = torch.randint(0, 256, (*hw, 3), generator=gen, device="cuda", dtype=torch.uint8)
        img, edge = k2.fused_preprocess(frame)
        torch.cuda.synchronize()
        ref_img, ref_edge = k2.fused_preprocess_reference(frame)
        if not (torch.equal(img, ref_img) and torch.equal(edge, ref_edge)):
            fail(f"K2 differs from its plain version at {hw}: "
                 f"{int((img != ref_img).sum())} img and {int((edge != ref_edge).sum())} edge values")
        t_k = timed(lambda: k2.fused_preprocess(frame))
        t_p = timed(lambda: k2.fused_preprocess_reference(frame))
        # u8 RGB in; bf16 RGB and fp32 edge out; ~40 flops per pixel, far under the ridge
        b_ms, by = bound_ms(40.0 * hw[0] * hw[1], hw[0] * hw[1] * (3 + 6 + 4))
        print(f"K2 [{hw[0]},{hw[1]},3] u8 -> bf16 img + fp32 edge: equal to plain bit for bit; "
              f"kernel {t_k[0]:.4f} ms (device {t_k[1]:.4f}), bound {b_ms * 1e3:.2f} us by {by} "
              f"(reached {b_ms / t_k[1]:.1%}), plain {t_p[0]:.4f} ms (device {t_p[1]:.4f}); no "
              f"single library call computes it ({card})")
        ms, plain_ms, dev_ms, bound = ms + t_k[0], plain_ms + t_p[0], dev_ms + t_k[1], bound + b_ms
    print(f"K2 one call at each frame size: kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, bound {bound:.5f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def _cudnn_block_conv(w_cl, bias, xp, skip):
    """The default route's way of doing one block conv: a cuDNN bf16 conv on
    channels_last views, then the eager epilogue."""
    y = torch.nn.functional.conv2d(k3._nchw(xp), w_cl, bias, padding=1)
    return torch.relu(y if skip is None else y + k3._nchw(skip))


def phase_k3(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5678)
    # the JAX init rule's bound +-1/sqrt(fan_in), and a bias on every block conv
    w = ((torch.rand(64, 64, 3, 3, generator=gen, device="cuda") * 2 - 1) / 24.0).bfloat16()
    bias = torch.randn(64, generator=gen, device="cuda") * 0.1
    w_cl, bias_bf = w.to(memory_format=torch.channels_last), bias.bfloat16()
    worst, per_frame = 0.0, {"kernel": [0.0, 0.0], "plain fp32": [0.0, 0.0],
                             "cuDNN bf16": [0.0, 0.0]}
    frame_bound, by_resource = 0.0, {"operations": 0.0, "bytes": 0.0}
    for shape in [*K3_SHAPES, K3_EXTRA]:
        xp = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        times = {}
        for epi, skip in (("relu", None),
                          ("skip+relu", torch.randn(shape, generator=gen, device="cuda").bfloat16())):
            out = k3.packed_conv3x3(w, bias, xp, relu=True, skip=skip)
            torch.cuda.synchronize()
            ref = k3.packed_conv3x3_reference(w, bias, xp, relu=True, skip=skip)
            err = (out.float() - ref.float()).abs()
            mx, mean = err.max().item(), err.mean().item()
            ulp = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
            t = times[epi] = (  # each (CUDA events, device) ms
                timed(lambda: k3.packed_conv3x3(w, bias, xp, relu=True, skip=skip)),
                timed(lambda: k3.packed_conv3x3_reference(w, bias, xp, relu=True, skip=skip)),
                timed(lambda: _cudnn_block_conv(w_cl, bias_bf, xp, skip)),
            )
            gflop = 2 * 9 * 64 * 64 * shape[0] * shape[1] * shape[2] * 2 / 1e9
            (k_ev, k_dev), (p_ev, p_dev), (c_ev, c_dev) = t
            # bf16 input, output and (third conv of a block) skip, and the taps
            b_ms, by = bound_ms(gflop * 1e9, 2.0 * xp.numel() * (2 if skip is None else 3)
                                + 2.0 * w.numel())
            frame_bound += K3_SHAPES.get(shape, 0) / 3 * (2 if skip is None else 1) * b_ms
            by_resource[by] += K3_SHAPES.get(shape, 0) / 3 * (2 if skip is None else 1) * b_ms
            print(f"K3 {list(shape)} {epi} bf16: max|d| {mx:.3e} (bound one ulp {ulp:g}) "
                  f"mean|d| {mean:.3e} (bound {K3_MEAN_ABS:g}); kernel {k_ev:.4f} ms "
                  f"(device {k_dev:.4f}, {gflop / k_dev:.1f} TFLOP/s; bound {b_ms * 1e3:.2f} us "
                  f"by {by}, reached {b_ms / k_dev:.1%}), plain fp32 {p_ev:.4f} ms "
                  f"(device {p_dev:.4f}), cuDNN bf16 + eager epilogue {c_ev:.4f} ms "
                  f"(device {c_dev:.4f}) ({card})")
            if not (torch.isfinite(out).all() and mx <= ulp and mean <= K3_MEAN_ABS):
                fail(f"K3 disagrees with its plain version at {list(shape)} {epi}")
            worst = max(worst, mx)
        for i, name in enumerate(per_frame):  # two relu-only convs and one skip conv per block
            for j in range(2):
                per_frame[name][j] += K3_SHAPES.get(shape, 0) / 3 * (
                    2 * times["relu"][i][j] + times["skip+relu"][i][j])
    print("K3 per 512x512 frame ({} convs), CUDA events / device: ".format(K3_PER_FRAME)
          + ", ".join(f"{n} {ev:.4f} / {dev:.4f} ms" for n, (ev, dev) in per_frame.items()))
    print(f"K3 per 512x512 frame: bound {frame_bound:.4f} ms, reached "
          f"{frame_bound / per_frame['kernel'][1]:.1%} by device time")
    return {"max_abs_err": worst, "ms": per_frame["kernel"][0],
            "plain_ms": per_frame["plain fp32"][0], "device_ms": per_frame["kernel"][1],
            "bound_ms": frame_bound, "bound_by": max(by_resource, key=by_resource.get),
            "library_ms": per_frame["cuDNN bf16"][1]}


def phase_k2_path(frame) -> int:
    """The fused_preprocess entry on the main path's frame."""
    k2.launches = 0
    img, edge = k2.fused_preprocess(frame[0])
    torch.cuda.synchronize()
    launches = k2.launches
    if img.shape != (512, 512, 3) or img.dtype != torch.bfloat16 or edge.shape != (512, 512):
        fail(f"fused_preprocess gave {tuple(img.shape)} {img.dtype} and {tuple(edge.shape)}")
    if not (edge.min() >= 0 and edge.max() == 1 and img.float().abs().max() <= 1):
        fail("fused_preprocess left [-1, 1] or [0, 1]")
    if launches < 1:
        fail("the fused_preprocess entry did not launch K2")
    print(f"fused_preprocess on the main path's 512x512 frame: K2 launches {launches}, "
          f"edge pixels at 1: {(edge == 1).float().mean().item():.4f}")
    return launches


def _psnr(a, b) -> float:
    mse = ((a.float() - b.float()) ** 2).mean().item()
    return math.inf if mse == 0 else 10 * math.log10(255.0**2 / mse)


def phase_taesd_pallas(card: str, main) -> int:
    """The phase-5 frame program on the taesd_pallas path, timed right after
    phase 5 and before any profiler session."""
    bundle, embeds, frame, args, img_default = main
    pallas = dataclasses.replace(bundle, taesd_cfg=_taesd_routes(bundle)["pallas"])
    program = build_frame_program(pallas, FrameSpec(batch=1, height=512, width=512, steps=4))
    img, lat = program(frame, embeds, *args)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = k2.launches = k3.launches = 0
    times = []
    for _ in range(MAIN_FRAMES):
        t0 = time.perf_counter()
        img, lat = program(frame, embeds, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    k1_launches, k3_launches = fa.launches, k3.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if img.shape != (1, 512, 512, 3) or img.dtype != torch.uint8 or not torch.isfinite(lat).all():
        fail(f"taesd_pallas image {tuple(img.shape)} {img.dtype} or latents not finite")
    if (k3_launches, k1_launches) != (K3_PER_FRAME * MAIN_FRAMES, K1_PER_FRAME * MAIN_FRAMES):
        fail(f"taesd_pallas launched K3 {k3_launches} and K1 {k1_launches} times over "
             f"{MAIN_FRAMES} frames, expected {K3_PER_FRAME} and {K1_PER_FRAME} per frame")
    psnr = _psnr(img, img_default)
    print(f"sd15 512x512 4-step CN+TAESD bf16 batch 1, taesd_pallas, on {card}: median "
          f"{statistics.median(times):.2f} ms/frame over {MAIN_FRAMES} frames "
          f"(min {min(times):.2f}, max {max(times):.2f}), peak allocated {peak:.2f} GiB, "
          f"K3 {k3_launches // MAIN_FRAMES}/frame, K1 {k1_launches // MAIN_FRAMES}/frame; "
          f"image PSNR vs the default route {psnr:.2f} dB (bound {FRAME_PSNR_DB:g})")
    if psnr < FRAME_PSNR_DB:
        fail("the taesd_pallas image drifted from the default route's")
    return k3_launches


def _timed_frame(program, *a, **kw):
    """One frame program call: (outputs, host ms to the synchronize, K1
    launches)."""
    fa.launches = 0
    t0 = time.perf_counter()
    out = program(*a, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, fa.launches


def _check_frame(name: str, out) -> None:
    img, lat = out[0], out[1]
    if img.shape != (1, 512, 512, 3) or img.dtype != torch.uint8:
        fail(f"{name}: image {tuple(img.shape)} {img.dtype}")
    if lat.shape != (1, 64, 64, 4) or not all(torch.isfinite(t).all() for t in out[1:]):
        fail(f"{name}: latents {tuple(lat.shape)} or caches not finite")


def phase_production(card: str, main) -> None:
    """The five production variants on the phase-5 bundle and frame, timed
    before any profiler session; each frame's K1 launches must be exact.
    The host's speed drifts within a call, so each variant frame is timed
    in turn with a parity frame and reported as a ratio to it."""
    bundle, embeds, frame, args, _ = main
    spec = FrameSpec(batch=1, height=512, width=512, steps=4)
    parity = build_frame_program(bundle, spec)
    for name, (fields, want) in PRODUCTION.items():
        program = build_frame_program(bundle, dataclasses.replace(spec, **fields))
        temporal = fields.get("deepcache_temporal", False)
        kinds = ("produce", "reuse") if temporal else ("frame",)
        want = dict(zip(kinds, want if temporal else (want,)))
        caches = None
        out = program(frame, embeds, *args)  # warm-up
        if temporal:
            caches = out[2]
            program(frame, embeds, *args, deep_caches=caches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = {k: [] for k in kinds}
        par_times = []
        for i in range(PRODUCTION_FRAMES):
            kind = kinds[i % len(kinds)]
            par_times.append(_timed_frame(parity, frame, embeds, *args)[1])
            kw = {"deep_caches": caches} if kind == "reuse" else {}
            out, ms, k1 = _timed_frame(program, frame, embeds, *args, **kw)
            _check_frame(name, out)
            if k1 != want[kind]:
                fail(f"{name}: a {kind} frame launched K1 {k1} times, expected {want[kind]}")
            if kind == "produce":
                caches = out[2]
            times[kind].append(ms)
        peak = torch.cuda.max_memory_allocated() / 2**30
        every = [t for ts in times.values() for t in ts]
        par = statistics.median(par_times)
        detail = ""
        if temporal:
            mb = caches.numel() * caches.element_size() / 1e6
            detail = "; " + ", ".join(
                f"{k} {statistics.median(times[k]):.2f} ms ({statistics.median(times[k]) / par:.3f}x)"
                for k in kinds) + f"; cache {list(caches.shape)} {caches.dtype} = {mb:.1f} MB per stream"
        print(f"{name}: sd15 512x512 4-step CN+TAESD bf16 batch 1 on {card}: median "
              f"{statistics.median(every):.2f} ms/frame over {PRODUCTION_FRAMES} frames (min "
              f"{min(every):.2f}, max {max(every):.2f}); parity frames in turn {par:.2f} ms, ratio "
              f"{statistics.median(every) / par:.3f}; peak allocated {peak:.2f} GiB, K1 "
              + "/".join(f"{want[k]} per {k}" for k in kinds) + detail)


def _i420_mailbox(camera_rgb):
    """The serving engine's I420 mailbox fit of a camera frame smaller than
    the mailbox (runtime/engine_framing.py): each plane top-left, Y padding
    0, chroma padding 128."""
    (h, w), (ch, cw) = MAILBOX_HW, camera_rgb.shape[:2]
    packed = rgb_to_i420_host(camera_rgb)
    out = np.full((h * 3 // 2, w), 128, np.uint8)
    out[:h] = 0
    out[:ch, :cw] = packed[:ch]
    for src, dst in ((packed[ch:ch + ch // 4], out[h:h + h // 4]),
                     (packed[ch + ch // 4:], out[h + h // 4:])):
        dst.reshape(h // 2, w // 2)[:ch // 2, :cw // 2] = src.reshape(ch // 2, cw // 2)
    return out


def phase_engine_call(card: str, main) -> None:
    """The call the serving engine makes: an I420 mailbox with the camera's
    center-crop box, temporal DeepCache N=2 with the ControlNet every step,
    and the previous frame's latents as warm start."""
    bundle, embeds, _, args, _ = main
    want_produce, want_reuse = PRODUCTION["production_temporal2_cn1"][1]
    rng = np.random.default_rng(1)
    mail = [torch.from_numpy(_i420_mailbox(rng.integers(0, 256, (*CAMERA_HW, 3), dtype=np.uint8))
                             )[None].cuda() for _ in range(2)]
    left, top, right, bottom = center_crop_box(CAMERA_HW[1], CAMERA_HW[0], 512, 512)
    box = torch.tensor([[top, left, bottom - top, right - left]], dtype=torch.int32, device="cuda")

    got = crop_resize(i420_to_rgb255(mail[1]), box, 512, 512)
    want = crop_resize(i420_to_rgb255(mail[1].cpu()), box.cpu(), 512, 512)
    err = (got.cpu() - want).abs().max().item()
    print(f"crop_resize of the {CAMERA_HW[0]}x{CAMERA_HW[1]} camera box {box.tolist()[0]} in the "
          f"{MAILBOX_HW[0]}x{MAILBOX_HW[1]} I420 mailbox -> 512x512, card vs CPU fp32: max|d| "
          f"{err:.3e} (bound {CROP_ATOL:g})")
    if not err <= CROP_ATOL:
        fail("crop_resize on the card disagrees with the CPU")

    spec_kw = dict(batch=1, height=512, width=512, in_height=MAILBOX_HW[0],
                   in_width=MAILBOX_HW[1], in_format="i420", steps=4)
    parity = build_frame_program(bundle, FrameSpec(**spec_kw))
    program = build_frame_program(bundle, FrameSpec(**spec_kw, deepcache_temporal=True))
    prev = program(mail[0], embeds, *args, src_box=box)  # the previous frame, and warm-up
    program(mail[1], embeds, *args, src_box=box, deep_caches=prev[2])
    img_par, _ = parity(mail[1], embeds, *args, src_box=box)
    outs = {}
    for key, kw in (("cold", {}), ("warm 0", {"warm_alpha": [0.0]}),
                    ("warm 0.3", {"warm_alpha": [0.3]})):
        if kw:
            kw["warm_latents"] = prev[1]
        outs[key], _, k1 = _timed_frame(program, mail[1], embeds, *args, src_box=box, **kw)
        _check_frame(f"engine-shaped {key}", outs[key])
        if k1 != want_produce:
            fail(f"engine-shaped produce frame launched K1 {k1} times, expected {want_produce}")
    reuse, _, k1 = _timed_frame(program, mail[1], embeds, *args, src_box=box,
                                deep_caches=outs["cold"][2])
    _check_frame("engine-shaped reuse", reuse)
    if k1 != want_reuse:
        fail(f"engine-shaped reuse frame launched K1 {k1} times, expected {want_reuse}")
    same = all(torch.equal(a, b) for a, b in zip(outs["cold"], outs["warm 0"]))
    moved = (outs["warm 0.3"][1].float() - outs["cold"][1].float()).abs().mean().item()
    psnr = _psnr(reuse[0], img_par)
    print(f"engine-shaped call: warm_alpha=0 equals no warm start bit for bit: {same}; "
          f"warm_alpha=0.3 moves the latents by mean|d| {moved:.4f}; produce equals the parity "
          f"frame: {torch.equal(outs['cold'][0], img_par)}; reuse of the same frame's caches vs "
          f"the parity frame: PSNR {psnr:.2f} dB (bound {FRAME_PSNR_DB:g})")
    if not same or moved == 0.0 or psnr < FRAME_PSNR_DB:
        fail("the engine-shaped call's warm start or temporal reuse is wrong")

    torch.cuda.reset_peak_memory_stats()
    main_program = build_frame_program(bundle, FrameSpec(batch=1, height=512, width=512, steps=4))
    times, par_times, lat, caches = {"produce": [], "reuse": []}, [], prev[1], None
    for i in range(PRODUCTION_FRAMES):  # the N=2 cadence with a warm start, frames alternating
        par_times.append(_timed_frame(main_program, main[2], embeds, *args)[1])
        kw = {"deep_caches": caches} if i % 2 else {}
        out, ms, _ = _timed_frame(program, mail[i % 2], embeds, *args, src_box=box,
                                  warm_latents=lat, warm_alpha=[0.3], **kw)
        _check_frame("engine-shaped cadence", out)
        lat = out[1]
        if not i % 2:
            caches = out[2]
        times["reuse" if i % 2 else "produce"].append(ms)
    every = times["produce"] + times["reuse"]
    par = statistics.median(par_times)
    print(f"engine-shaped call (I420 {MAILBOX_HW[0]}x{MAILBOX_HW[1]} mailbox, src_box, temporal "
          f"N=2 cn1, warm_alpha 0.3) on {card}: median {statistics.median(every):.2f} ms/frame "
          f"over {PRODUCTION_FRAMES} frames (min {min(every):.2f}, max {max(every):.2f}); "
          + ", ".join(f"{k} {statistics.median(v):.2f} ms ({statistics.median(v) / par:.3f}x)"
                      for k, v in times.items())
          + f" of the parity frames in turn ({par:.2f} ms); peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _taesd_routes(bundle) -> dict:
    return {name: dataclasses.replace(bundle.taesd_cfg, **kw) for name, kw in (
        ("default", {}), ("packed", {"packed_convs": True}), ("pallas", {"pallas_convs": True}))}


def phase_taesd_routes(card: str, bundle) -> None:
    """TAESD at 512x512 on each route: K3 against an fp32 copy and the
    packed library route, and the device time of encode + decode."""
    routes = _taesd_routes(bundle)
    # the JAX init rule shrinks TAESD's activations ~60x by the decoder's
    # output, where bf16 then rounds the image to a constant; a copy with
    # He-scaled weights and random biases keeps them O(1), so the two
    # routes' difference is visible
    ae = copy.deepcopy(bundle.models["taesd"])
    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.no_grad():
        for mod in ae.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.weight.mul_(6.0**0.5)
                if mod.bias is not None:
                    mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen, device="cuda") * 0.1)
    x = (torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1).bfloat16()
    z = torch.randn(1, 64, 64, 4, generator=gen, device="cuda").bfloat16()
    torch.backends.cudnn.allow_tf32 = False  # the fp32 reference is fp32
    with torch.inference_mode():
        ae32 = copy.deepcopy(ae).float()
        ref = (taesd_encode(ae32, x.float()), taesd_decode(ae32, z.float()))
        outs = {n: (taesd_encode(ae, x, c), taesd_decode(ae, z, c)) for n, c in routes.items()}
        torch.cuda.synchronize()

        def rel(got, want):
            return [((a.float() - b.float()).norm() / b.float().norm()).item()
                    for a, b in zip(got, want)]

        vs_ref = {name: rel(out, ref) for name, out in outs.items()}
        for name, (e, d) in vs_ref.items():
            print(f"TAESD 512x512 bf16 (He-scaled copy), {name} route vs the fp32 default "
                  f"route: rel L2 encode {e:.3e}, decode {d:.3e}")
        vs_packed = rel(outs["pallas"], outs["packed"])
        print(f"TAESD K3 route vs packed library route: rel L2 encode {vs_packed[0]:.3e}, "
              f"decode {vs_packed[1]:.3e} (bound {TAESD_REL_L2:g}); K3 route vs fp32 bounded "
              f"by the default route's")
        if not (all(torch.isfinite(t).all() for t in outs["pallas"])
                and all(k <= d for k, d in zip(vs_ref["pallas"], vs_ref["default"]))
                and max(vs_packed) <= TAESD_REL_L2):
            fail("the K3 TAESD route is further from fp32 than the default route, "
                 "or disagrees with the packed route")
        for name, cfg in routes.items():  # the bundle's own TAESD, as the frame program runs it
            def codec(cfg=cfg):
                return taesd_decode(bundle.models["taesd"], taesd_encode(
                    bundle.models["taesd"], x, cfg), cfg)
            print(f"TAESD encode + decode 512x512 bf16, {name} route: device "
                  f"{device_ms(codec):.4f} ms, CUDA events {cuda_ms(codec, iters=10):.4f} ms "
                  f"({card})")


def phase_profile(card: str, main) -> None:
    """One profiler pass over two main-path frames, after every frame timing
    (a profiler session slows the host's later launches)."""
    bundle, embeds, frame, args, _ = main
    program = build_frame_program(bundle, FrameSpec(batch=1, height=512, width=512, steps=4))
    frames = 2
    events = _profiled(lambda: program(frame, embeds, *args), frames)

    def per_frame(pred):
        picked = [e for e in events if pred(e.key)]
        return (sum(e.count for e in picked) / frames,
                sum(e.device_us for e in picked) / frames / 1e3)

    n_all, ms_all = per_frame(lambda key: True)
    n_k1, ms_k1 = per_frame(lambda key: "flash_fwd_kernel" in key)
    n_copy, ms_copy = per_frame(lambda key: "copy" in key.lower())
    print(f"profile of {frames} main-path frames on {card}: {n_all:.0f} kernel launches/frame, "
          f"device busy {ms_all:.2f} ms/frame; K1 {n_k1:.0f} launches and {ms_k1:.3f} ms/frame; "
          f"copy and cast kernels "
          f"{n_copy:.0f} launches and {ms_copy:.2f} ms/frame")
    if n_k1 != K1_PER_FRAME:
        fail(f"the profiler saw {n_k1} K1 kernels per frame, expected {K1_PER_FRAME}")


def main() -> None:
    card = phase_card()
    phase_build()
    k1_err = phase_k1()
    phase_tiny()
    k1_launches, main = phase_main(card)
    k3_launches = phase_taesd_pallas(card, main)
    phase_production(card, main)
    phase_engine_call(card, main)
    k1 = {"max_abs_err": k1_err, **phase_k1_times(card)}
    k2_res = phase_k2(card)
    k3_res = phase_k3(card)
    k2_launches = phase_k2_path(main[2])
    phase_taesd_routes(card, main[0])
    phase_profile(card, main)
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention.cu",
         "replaces": "videosd_tpu/ops/pallas/flash_attention.py:83",
         "launches": k1_launches, **k1},
        {"name": "fused_preprocess_sobel", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/preprocess.cu",
         "replaces": "videosd_tpu/ops/pallas/preprocess_kernel.py:64",
         "launches": k2_launches, **k2_res},
        {"name": "taesd_conv3x3", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/taesd_conv.cu",
         "replaces": "videosd_tpu/ops/pallas/taesd_conv.py:231",
         "launches": k3_launches, **k3_res},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
