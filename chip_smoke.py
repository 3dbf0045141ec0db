#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``videosd_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit from nvidia-smi;
2. build: compile the package's CUDA kernels from ``videosd_tpu_torch/csrc``;
3. kernel K1 (flash attention) against its plain PyTorch version in bf16 at
   the main path's shapes and at further ones (keys != queries, batch 2,
   d = 64), at every kind of head dim up to 256 (the tiny family's 8 and
   16, d below its instance's width, d off the 16-byte rows, the widest),
   with the heads read in place beside heads of large values, and the
   in-place ``[B, S, H*D]`` entry against the folded one; then its fp32
   kernel (3xTF32, ``csrc/flash_attention_fp32.cu``) at the fp32 sd15
   frame's three shapes and every kind of head dim, against the plain
   version computed in fp64; then K1 above d = 256 (the
   wide kernel, ``csrc/flash_attention_wide.cu``) at d = 264, 320, 512
   (the KL VAE's [1, 4096, 512] and [4, 4096, 512]) and 640 in bf16 and
   fp32 (the fp32 heads on ``csrc/flash_attention_wide_fp32.cu``, whose
   3xTF32 products are its own arithmetic, not torch's TF32), keys !=
   queries included;
4. the committed trained tiny checkpoint (``examples/toy_tiny_ckpt``) runs
   its 2-step frame program on CUDA and on the CPU in fp32, with TF32 off,
   from the same inputs and noise, at 64x64, 128x128 and 256x256; the
   outputs must agree, and at 128x128 and 256x256 the routed attentions
   (d = 8 and 16) must launch K1's fp32 kernel: the path of that kernel;
   then a random fp32 tiny bundle with a KL VAE (``vae="kl"``), CUDA
   against the CPU at 128x128 and 256x256, with exactly 10 and 14 fp32 K1
   launches per frame (the UNet's 8 and 12, and the VAE's mid attention in
   encode and decode);
5. the main path: a random-weight sd15 bundle in bf16, the prompt encoder,
   and the 512x512 4-step ControlNet + TAESD frame program of
   ``build_frame_program``, whose first call captures one CUDA graph that
   the further frames replay; the graph must hold 84 K1 launches per frame
   (counted by the wrapper while it was captured);
6. the ``taesd_pallas`` path: the phase-5 frame program with
   ``TAESDConfig(pallas_convs=True)``, timed right after phase 5; its graph
   must hold 60 K3 and 84 K1 launches per frame, and the image must stay
   close to phase 5's;
6a. the graphs: in every bucket (parity at batch 1 and 4, the five
   production variants, the engine-shaped call, the ``taesd_pallas``
   bundle) two calls in a row with other seeds, each replayed from the
   captured graph and equal bit for bit to the eager ``frame_program`` of
   the same inputs (images, latents, caches), eager first held against
   itself; each graph's kernel launches per frame as captured; the eager
   and the replayed parity frame timed in alternating turns (the replay
   must be faster in each); the peak memory with every graph held; then
   the port bench's code (``videosd_tpu_torch/bench.py``) once with short
   windows;
6a'. the KL path: a random sd15 bundle with the KL VAE (``with_kl_vae``),
   the 512x512 4-step ControlNet + KL frame in bf16 through
   ``build_frame_program`` (``FrameSpec(vae="kl")``): two replayed calls
   equal to the eager ``frame_program`` bit for bit, exactly 86 K1
   launches per frame at capture (84 in the UNet and ControlNet, 2 of the
   wide kernel in the VAE at d = 512), eager and replayed frames timed in
   turns, FLOPs per frame (``ops/flops.py``) and peak memory; the fp32 copy
   of its VAE at 512x512 through the wide fp32 kernel against the plain
   attention; one ``tiled_decode`` of a 128x128 latent grid (nine 64-latent
   tiles, one wide launch each);
6a''. the fp32 parity frame: a random sd15 bundle in fp32 with ControlNet
   and the KL VAE (the configuration of ``videosd_tpu/tools/parity.py``),
   the 512x512 4-step frame through ``build_frame_program``: two replayed
   calls equal to the eager ``frame_program`` bit for bit, exactly 86 fp32
   K1 launches per frame at capture (84 on K1's fp32 kernel, 2 on the wide
   fp32 kernel), replayed ms/frame and peak memory;
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
6b'. reference mode: the phase-5 bundle's sd15 512x512 4-step TAESD bf16
   reference frame (no ControlNet, two UNet passes a step) through
   ``build_reference_program``: two replayed calls equal to the eager
   ``reference_frame_program`` bit for bit, 180 K1 launches per frame at
   capture (60 of them banked, on twice the keys), style fidelity 0 equal
   to the plain frame program on the same noise, the median replayed
   ms/frame and ``ref_mode_fps`` as the bench measures it;
6b''. the serving engine (``videosd_tpu_torch/runtime``): four streams of
   512x512 camera frames into one ``Engine`` (max_batch 4) on the phase-5
   bundle, one switched to reference mode partway: the batches formed,
   frames/s, each stream's p50 latency, the graphs held and the card's
   memory; the reference bucket's warm-up and capture on a background
   thread while the dispatch thread serves the other streams; one
   dispatched batch run again through ``build_frame_program`` equal bit
   for bit; no error logged by the engine;
6c. K1's device time per shape beside its bound, the plain version's time
   and one ``scaled_dot_product_attention`` call's (timed here, used
   nowhere in the port; the reference mode's banked shapes among them),
   and at the main path's shapes under every number
   of query rows per block the kernel can run: the first profiler sessions
   of the run, after every frame timing;
7. kernel K2 (the fused preprocess with its Sobel stencil) against its
   plain version at four frame sizes: equal bit for bit, one device kernel
   per call, with both times; and captured in a CUDA graph, whose replay on
   a new frame is equal bit for bit too;
8. kernel K3 (the TAESD 3x3 conv) against its plain version at the main
   path's shapes and at ragged ones, all four epilogues, with each shape's
   tile width; at the main path's shapes one kernel per call, its device
   time beside its bound, the plain version's and a cuDNN bf16 conv's, and
   every tile width held to the bar and timed; then its fp32 kernel
   (3xTF32) at the same shapes, every epilogue and every tile height,
   held to the fp32 bars of its plain version computed in fp64 (the fp32
   plain version's own distance printed beside), timed likewise (cuDNN in
   fp32, TF32 off);
9. the ``fused_preprocess`` entry on the main path's frame (K2's path);
10. TAESD encode + decode at 512x512 through K3 against an fp32 copy and
    the packed library route, the fp32 copy through K3's fp32 kernel
    against the fp32 default route (the path of that kernel), and the
    device time of encode + decode on every route;
11. last, one torch.profiler pass over two replayed main-path frames:
    kernel launches and device-busy time per frame, the card's idle share
    of the replayed frame, and device time by class of operation (K1,
    GEMMs, convolutions, layout transposes, copies and casts, elementwise,
    reductions, norms, softmax); then the same over two replayed KL
    frames, over two replayed fp32 parity frames (K1's fp32 device ms
    per frame), and over two replayed reference frames.

Each kernel's launch count is set to 0 just before the path that runs it
and read just after; launches that compare a kernel with its plain version
are not counted.  A graph replay calls no wrapper: a path's count is what
its wrappers launched while the program warmed up and captured its graph,
and the graph's launches per frame are those of the capture.  The line
before the last is a JSON object of per-kernel
results (each with its bound, computed from the shapes: the largest of its
bytes over 3.35 TB/s, its flops over the peak of their type (989 TFLOP/s in
bf16; in fp32 the faster of FFMA, 132 SMs x 128 lanes x 2 at the SM clock,
and 3xTF32 on the tensor cores, 494.7 / 3 TFLOP/s) and, for K1, its
exponentials over the exp unit's 16 per clock per SM; the clock is the
card's maximum SM clock, read from nvidia-smi); the last line is
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
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from videosd_tpu_torch import _build, bench  # noqa: E402
from videosd_tpu_torch.models import layers  # noqa: E402
from videosd_tpu_torch.models.taesd import taesd_decode, taesd_encode  # noqa: E402
from videosd_tpu_torch.models.vae import vae_decode, vae_encode  # noqa: E402
from videosd_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from videosd_tpu_torch.ops.cuda import preprocess_kernel as k2  # noqa: E402
from videosd_tpu_torch.ops.cuda import taesd_conv as k3  # noqa: E402
from videosd_tpu_torch.ops.flops import frame_flops  # noqa: E402
from videosd_tpu_torch.ops.preprocess import (  # noqa: E402
    center_crop_box,
    crop_resize,
    i420_to_rgb255,
    rgb_to_i420_host,
)
from videosd_tpu_torch.ops.tiling import tiled_decode  # noqa: E402
from videosd_tpu_torch.pipelines.lcm_img2img import (  # noqa: E402
    FrameSpec,
    ModelBundle,
    build_frame_program,
    build_prompt_encoder,
    frame_program,
    kernel_launches,
)
from videosd_tpu_torch.pipelines.reference_attn import (  # noqa: E402
    build_reference_program,
    reference_frame_program,
)

# K1's shapes on the main path, [B*H, S, d_head]: sd15 at 512x512 has 8 heads
# over 64^2, 32^2 and 16^2 latents
K1_SHAPES = [(8, 4096, 40), (8, 1024, 80), (8, 256, 160)]
# the reference-attention READ pass's banked self-attentions at sd15 512^2
# (twice the keys), as (B, H, Sq, Sk, d): 20 launches of each per 4-step
# reference frame, beside 40 of each square shape
K1_BANKED = [(1, 8, 4096, 8192, 40), (1, 8, 1024, 2048, 80), (1, 8, 256, 512, 160)]
# further K1 shapes held against plain, as (B, H, Sq, Sk, d): the banked ones,
# batch 2 (at d = 80 the grid then takes 128 rows per block), d = 64, and few
# queries on many keys at d = 160
K1_EXTRA = K1_BANKED + [(2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80),
                        (1, 8, 1024, 1024, 64), (1, 8, 256, 4096, 160)]
# K1 in bf16 at every kind of head dim, as (B, H, Sq, Sk, d): the tiny
# family's 8 (256^2: 1024 tokens) and 16 (keys != queries), 24 and 72 (below
# their instance's width, 40 and 80), 20 (off the 16-byte rows: a padded
# copy), 64, and 256 (the widest instance); heads read in place beside heads
# of large values (_k1_case)
K1_HEAD_DIMS = [(1, 4, 1024, 1024, 8), (1, 4, 256, 512, 16), (1, 8, 1024, 1024, 24),
                (1, 4, 256, 256, 20), (1, 8, 1024, 1024, 64), (1, 8, 1024, 2048, 72),
                (1, 2, 256, 256, 256)]
# K1's fp32 kernel: the fp32 sd15 frame's three shapes, the tiny family's
# shapes at 256^2, and the same kinds of head dim as above
K1_FP32 = [(1, 8, 4096, 4096, 40), (1, 8, 1024, 1024, 80), (1, 8, 256, 256, 160),
           (1, 4, 1024, 1024, 8), (1, 4, 256, 256, 16), (1, 4, 256, 512, 20),
           (1, 8, 1024, 2048, 72), (1, 2, 256, 256, 256)]
# the shapes timed beside their bounds: the main path's three, and the tiny
# family's two at 256^2 (d = 8 and 16), in each dtype
K1_TIMED = {kind: [(1, 8, 4096, 4096, 40), (1, 8, 1024, 1024, 80), (1, 8, 256, 256, 160),
                   (1, 4, 1024, 1024, 8), (1, 4, 256, 256, 16)] for kind in ("bf16", "fp32")}
# K1 above d = 256 (the wide kernels), as (B, H, Sq, Sk, d), in bf16 and fp32
# with loud neighbours where H = 2: in bf16 a cluster of two column slices
# (264, 320, 512), three (640) and eight (2048, the widest one cluster
# takes), two clusters of 6 past the cluster limit (2568), in fp32 one slice
# (up to 512) and more (Q streamed); keys != queries, the KL VAE's mid
# attention at 512x512 (one head of 512 over 64^2 latents) at batch 1 and 4,
# an odd number of query tiles (192 rows), one query tile on one key tile
K1_WIDE = [(1, 2, 256, 256, 264), (1, 2, 512, 256, 320), (1, 1, 4096, 4096, 512),
           (4, 1, 4096, 4096, 512), (2, 2, 256, 512, 640), (1, 2, 192, 256, 512),
           (1, 1, 64, 64, 520), (1, 2, 128, 192, 2048), (1, 1, 128, 128, 2568)]
K1_WIDE_TIMED = {"bf16": [(1, 1, 4096, 4096, 512), (4, 1, 4096, 4096, 512)],
                 "fp32": [(1, 1, 4096, 4096, 512), (4, 1, 4096, 4096, 512)]}
# the tiny KL frame sizes, with K1's fp32 launches per frame: the UNet's 8 and
# 12 (as the checkpoint's) and the VAE's 2 (d = 16 at 256 and 1024 tokens)
TINY_KL = {128: 10, 256: 14}
# the fp32 KL VAE at 512^2, wide fp32 kernel against the plain attention (both
# fp32, TF32 off: ~1e-6 relative apart in the attention, carried through the
# decoder's convs; a wrong attention is O(1e-2) off)
KL_FP32_REL_L2 = 1e-4
# tiled_decode of a 128^2 latent grid in 64-latent tiles overlapping by 8
KL_TILED_GRID, KL_TILES = 128, 9
# eager and replayed KL frames in alternating turns
KL_TURNS, KL_TURN_FRAMES = 3, 3
# the card's published peaks (H100 SXM): dense bf16 tensor-core rate, HBM rate,
# and fp32 products as 3xTF32 (three products at the dense TF32 rate, half the
# bf16 one); and the rates that scale with the SM clock: FFMA lanes and ex2 per SM
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PEAK_3XTF32_FLOPS = 494.7e12 / 3
NUM_SMS, FFMA_LANES_PER_SM, EXP_PER_CLOCK_PER_SM = 132, 128, 16
# fp32 kernels (K1 and K3) against their plain versions, which are fp32 too
# (TF32 off): both sum fp32 products in other orders (~1e-6 relative apart)
# and cuDNN may run an fp32 conv as Winograd (~1e-5); max |d| within 2^-13
# of the largest output, mean |d| within 2^-16 of the mean |output|.  A
# kernel that ran its products in TF32 (10-bit mantissa) is ~1e-3 relative
# off, 60x over the mean bar
FP32_MAX_REL, FP32_MEAN_REL = 2.0 ** -13, 2.0 ** -16
# ... except the 3xTF32 kernels (K1's two fp32 kernels and K3's fp32
# kernel), held to the same bars from the plain version computed in fp64
# and rounded to fp32: their 3xTF32 products round unlike cuBLAS's and
# cuDNN's fp32 ones, and on loud heads (logits 64x larger, a peaked
# softmax) the fp32 plain version is itself up to a bar off the exact
# result (phase 3 prints both: at [2,2,256,512,640] on an H100 the fp32
# plain version was 1.08 bars from fp64, the wide kernel 0.08)
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
# per sd15 512^2 4-step reference frame (no ControlNet): per step the WRITE
# pass's 15, and the READ pass's 15 plain and 15 banked (the mid block's 64
# tokens stay on the plain route)
K1_REF_PER_FRAME = 4 * 45
# the reference frame with style fidelity 0 against the plain frame program
# (no ControlNet) on the same inputs and noise: the blends then return the
# plain branches exactly (0 * x + 1 * y in fp32), so the two run the same
# kernels on the same values; the bar, one image level and one bf16 ulp of
# the largest latent, only allows a library that picks another algorithm
REF_SF0_LEVELS = 1
REF_FRAMES = 10
# the engine phase: streams of 512^2 camera frames into one Engine (max_batch
# 4, sd15 CN + TAESD bf16, the phase-5 bundle), frames per stream, and the
# frame after which one stream switches to reference mode (its first ref
# frames pass through while the ref bucket warms up and captures on a
# background thread)
ENGINE_STREAMS, ENGINE_FRAMES, ENGINE_REF_AFTER, ENGINE_REF_S = 4, 40, 12, 180
ENGINE_SIDE = 512
# K1 launches per sd15 512^2 4-step CN + KL frame: the 84 routed attentions of
# the UNet and ControlNet, and the VAE's mid attention (d = 512) in encode and
# decode on the wide kernel
K1_KL_PER_FRAME = {"flash_attention": K1_PER_FRAME, "flash_attention_wide": 2}
# the same frame from an fp32 bundle (the configuration of
# videosd_tpu/tools/parity.py): the 84 on K1's fp32 kernel, the VAE's 2 on
# the wide fp32 kernel
K1_FP32_PER_FRAME = {"flash_attention_fp32": K1_PER_FRAME, "flash_attention_wide_fp32": 2}
FP32_FRAMES = 5
# tiny fp32 checkpoint, CUDA against CPU: cuDNN and the CPU sum in other
# orders (fp32, TF32 off); latents are O(1), so 1e-3 absolute is ~1e4 ulps
# of drift over two denoise steps, and images may move by one level
TINY_LAT_ATOL, TINY_IMG_LEVELS = 1e-3, 1
# its frame sizes: at 64^2 no attention routes to K1; at 128^2 the 256-token
# down and up attentions (d = 8) do, and at 256^2 those at 1024 tokens and
# the 256-token mid block (d = 16)
TINY_SIZES = (64, 128, 256)
# one sd15 UNet call in bf16 with K1 against the same call with the plain
# attention: relative L2 difference of the noise prediction
# (bf16 rounding, 2^-8 relative, of each attention output compounds through
# the 16 transformer blocks; 5e-2 leaves room over the measured ~1.1e-2)
UNET_REL_L2 = 5e-2
MAIN_FRAMES = 5
# K2's frame sizes: the main path's, the engine's mailbox frame_hw, a camera
# size off the TPU kernel's 128-tiling, a 1080p camera frame (the largest whose
# |grad| the kernel holds through its barrier), and a 2160p one (recomputed)
K2_SHAPES = [(512, 512), (768, 768), (480, 640), (1080, 1920), (2160, 3840)]
# K3's shapes on the main path as packed [B, H, W/2, 128], with the number of
# convs per 512^2 frame at each: TAESD's 20 residual blocks x 3 convs, the
# third of each with the skip epilogue
K3_SHAPES = {(1, 512, 256, 128): 6, (1, 256, 128, 128): 18, (1, 128, 64, 128): 18,
             (1, 64, 32, 128): 18}
# further K3 shapes held against plain: batch 2, and heights and widths off
# every tile (one pixel; 3 rows of 258 pixels)
K3_EXTRA = [(2, 64, 48, 128), (1, 13, 7, 128), (1, 1, 1, 128), (1, 3, 129, 128)]
# K3's epilogues as (relu, skip, bias): the block's first two convs, its
# third, and the two the wrapper also takes (no ReLU; no bias)
K3_EPILOGUES = {"relu": (True, False, True), "skip+relu": (True, True, True),
                "plain": (False, False, False), "skip": (False, True, True)}
K3_PER_FRAME = sum(K3_SHAPES.values())  # 60
# K3 against its plain version in bf16: both take fp32 sums of the same exact
# bf16 products (in different orders, ~1e-6 relative apart) and round once to
# bf16, so an output differs only where the two sums straddle a rounding
# boundary, by one bf16 ulp of its own size: max |d| may be one ulp of the
# largest output, and such outputs are rare (mean |d| measured ~6e-8)
K3_MEAN_ABS = 1e-5
# TAESD at 512^2 in fp32 through K3's fp32 kernel against the fp32 default
# route (cuDNN, TF32 off): 60 convs of ~1e-6 relative each, compounded
# through the blocks; a wrong conv is O(1) off
TAESD_FP32_REL_L2 = 1e-4
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
# the eager and the replayed parity frame, timed in alternating turns of
# GRAPH_TURN_FRAMES blocking frames each
GRAPH_TURNS, GRAPH_TURN_FRAMES = 4, 5


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
    every event of one kernel, or a few in ten thousand of a long session;
    on one card several sessions in a row lost some.  So sessions are taken
    until one saw the same kernel names as an earlier session and total
    launches within a thousandth of it (equal, for a session of fewer than
    1000); of those two, each kernel is read from the session that saw more
    of it, since a loss only lowers a count.  Every session that pairs with
    no earlier one is printed, and ten sessions without a pair fail the
    run."""
    fn()
    torch.cuda.synchronize()
    earlier = []
    for session in range(10):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: KernelTime(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages() if e.self_device_time_total > 0}
        total = sum(k.count for k in seen.values())
        for i, old in enumerate(earlier):
            old_total = sum(k.count for k in old.values())
            if seen and seen.keys() == old.keys() and abs(total - old_total) * 1000 <= total:
                if total != old_total:
                    print(f"  profiler sessions {i} and {session}: {old_total} and {total} "
                          f"launches over {iters} calls; each kernel read from the session "
                          f"that saw more of it")
                return [max(seen[key], old[key], key=lambda k: k.count) for key in seen]
        if earlier:
            print(f"  profiler session {session}: {total} launches of {len(seen)} kernels over "
                  f"{iters} calls pair with no earlier session")
        earlier.append(seen)
    fail("torch.profiler gave no two sessions that agree, in ten")


def device_ms(fn, iters: int = 5) -> float:
    """Device time of ``fn``'s kernels per call, summed by torch.profiler
    (the host's enqueue time, which CUDA events would include, is not)."""
    return sum(k.device_us for k in _profiled(fn, iters)) / iters / 1e3


def bound_ms(nbytes: float, flops: float, dtype: str, sm_clock_hz: float,
             exps: float = 0.0) -> tuple[float, str, str]:
    """The least time the card could take: the largest of the bytes (each
    input read once, each output written once) over the memory rate, the
    flops over the peak of their type (``dtype`` "bf16": the tensor cores'
    989 TFLOP/s; "fp32": the faster of the FFMA lanes, 132 SMs x 128 x 2 at
    the SM clock, and fp32 products as 3xTF32 on the tensor cores, 494.7 / 3
    TFLOP/s) and the exponentials over the exp unit (16 per clock per SM).
    Returns (ms, "bytes" or "operations", the term that sets it)."""
    peak = (PEAK_BF16_FLOPS if dtype == "bf16" else
            max(NUM_SMS * FFMA_LANES_PER_SM * 2 * sm_clock_hz, PEAK_3XTF32_FLOPS))
    terms = {"bytes": nbytes / PEAK_BYTES, f"{dtype} flops": flops / peak,
             "ex2": exps / (NUM_SMS * EXP_PER_CLOCK_PER_SM * sm_clock_hz)}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def k1_bound(b: int, h: int, sq: int, sk: int, d: int, sm_clock_hz: float,
             dtype: str = "bf16") -> tuple[float, str, str]:
    """K1's bound: 4 Sq Sk d flops and Sq Sk exponentials per head; q, k, v
    read and o written once."""
    elem = 2.0 if dtype == "bf16" else 4.0
    return bound_ms(elem * b * h * d * (2 * sq + 2 * sk), 4.0 * b * h * sq * sk * d, dtype,
                    sm_clock_hz, exps=1.0 * b * h * sq * sk)


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


def fp32_within_bar(out, ref) -> tuple[bool, float, float, float, float]:
    """(an fp32 kernel's output is finite and within FP32_MAX_REL of the
    largest plain output and FP32_MEAN_REL of the mean, max |d|, mean |d|,
    the bar on the max, the bar on the mean)."""
    err = (out - ref).abs()
    mx, mean = err.max().item(), err.mean().item()
    max_bar = FP32_MAX_REL * ref.abs().max().item()
    mean_bar = FP32_MEAN_REL * ref.abs().mean().item()
    ok = bool(torch.isfinite(out).all()) and mx <= max_bar and mean <= mean_bar
    return ok, mx, mean, max_bar, mean_bar


def timed(fn) -> tuple[float, float]:
    """(CUDA-event ms per call, device ms per call)."""
    return cuda_ms(fn), device_ms(fn)


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_card() -> tuple[str, float]:
    """The card's name and power limit, and its maximum SM clock in Hz (the
    clock the fp32 and exp terms of the bounds take)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA card")
    smi = _smi("name,power.limit")
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    print(f"card: {smi}")
    print(f"max SM clock {clock_mhz:g} MHz (the bounds' fp32 flop and exp terms); torch "
          f"{torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return smi, clock_mhz * 1e6


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
    for line in sorted({line for line in log.splitlines() if "Performance Loss" in line}):
        print(f"  {line.strip()}")  # e.g. wgmma serialized by the compiler
    _build.load_library()


def _demangle(name: str) -> str:
    if shutil.which("c++filt"):
        name = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()
    return name.replace("(anonymous namespace)::", "").split("(")[0]


def _attention_fp64(q, k, v, scale):
    """The plain version's function, softmax(q k^T * scale) v, computed in
    fp64 and rounded to fp32."""
    logits = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), v.double()).float()


def _k1_case(gen, b, h, sq, sk, d, dtype=torch.bfloat16, loud=False):
    """K1 on [b, s, h*d] slices of one fused q|k|v buffer (the heads read in
    place), held against the plain version on the folded heads and, bit for
    bit, against the folded entry; returns the largest |d| from the plain
    version.  With ``loud`` the odd heads' q and k are 8x larger and their v
    8x smaller (outputs keep their size): a kernel that read a neighbour's
    columns into a head's padded depth would be far off."""
    s = max(sq, sk)
    fused = torch.randn(b, s, 3, h, d, generator=gen, device="cuda")
    if loud:
        fused[:, :, :2, 1::2] *= 8.0
        fused[:, :, 2, 1::2] /= 8.0
    fused = fused.reshape(b, s, 3 * h * d).to(dtype)
    q, k, v = (fused[:, :n, i * h * d:(i + 1) * h * d] for i, n in enumerate((sq, sk, sk)))

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
    name = f"[{b},{h},{sq},{sk},{d}]"
    same = torch.equal(unfold(folded), out)
    if dtype == torch.float32:
        # the 3xTF32 kernels against the plain version computed exactly (fp64,
        # then rounded): on loud heads the fp32 plain version's own logits
        # are off by up to a bar (the note at FP32_MAX_REL); its distance is printed
        exact = unfold(_attention_fp64(qf, kf, vf, scale))
        ok, mx, mean, max_bar, mean_bar = fp32_within_bar(out, exact)
        off = fp32_within_bar(out, ref)
        bars = (f"max|d| {mx:.3e} (bar {max_bar:.3e}: 2^-13 of max|o|) mean|d| {mean:.3e} (bar "
                f"{mean_bar:.3e}: 2^-16 of mean|o|) from the plain version in fp64; from the "
                f"fp32 plain version max|d| {off[1]:.3e}, mean|d| {off[2]:.3e}, which is "
                f"max|d| {fp32_within_bar(ref, exact)[1]:.3e} from fp64")
        plan = (("fp32, the wide kernel, 3xTF32, Q "
                 f"{'resident' if fa.wide_fp32_q_resident(d) else 'streamed'}")
                if d > fa.MAX_HEAD_DIM else
                (f"fp32, 3xTF32, {fa.fp32_block_rows(d)} rows/block on the "
                 f"{fa.fp32_instance_width(d)}-wide instance, {fa.fp32_stages(d)} stages"))
    else:
        ok, mx, mean, max_bar, mean_bar = k1_within_bar(out, ref)
        bars = (f"max|d| {mx:.3e} (bar {max_bar:.3e}: {K1_MAX_ULPS} ulps of the largest output) "
                f"mean|d| {mean:.3e} (bar {mean_bar:.3e}: 2^-7 of mean|o| "
                f"{ref.float().abs().mean().item():.3e})")
        wide = fa.wide_plan(d) if d > fa.MAX_HEAD_DIM else None
        plan = (f"bf16, the wide kernel, {wide.grid_slices // wide.cluster_slices} cluster(s) "
                f"of {wide.cluster_slices} blocks per query tile, depth "
                f"shares of up to {wide.share} panels, Q "
                f"{'resident' if wide.q_resident else 'streamed'}"
                if wide else
                f"bf16, {fa.block_rows(sq, b * h, d)} rows/block on the {fa.instance_width(d)}-wide "
                f"instance")
    if d > fa.MAX_HEAD_DIM:
        fp32 = dtype == torch.float32
        plan += (f", {fa.wide_slices(d, dtype)} slices of "
                 f"{fa.WIDE_SLICE_FP32 if fp32 else fa.WIDE_SLICE} columns x "
                 f"{fa.WIDE_ROWS_FP32 if fp32 else 64} rows per query tile")
    print(f"K1 {name} {plan}{', loud neighbours' if loud else ''}: {bars}; in-place entry "
          f"equals the folded one bit for bit: {same}")
    if not ok:
        fail(f"K1 disagrees with its plain version at {name} {dtype}")
    if not same:  # one kernel, one plan, one order of sums
        fail(f"K1's in-place entry differs from the folded one at {name} {dtype}")
    return mx


def _k1_cases():
    return [(1, s[0], s[1], s[1], s[2]) for s in K1_SHAPES] + K1_EXTRA


def phase_k1() -> tuple[float, float, float, float]:
    """K1 against its plain version at every shape: the largest |d| of the
    bf16 kernel, the fp32 kernel, and the wide kernel in bf16 and fp32."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf16 = max(_k1_case(gen, *case) for case in _k1_cases())
    bf16 = max([bf16] + [_k1_case(gen, *case, loud=True) for case in K1_HEAD_DIMS])
    fp32 = max(_k1_case(gen, *case, dtype=torch.float32, loud=True) for case in K1_FP32)
    wide = max(_k1_case(gen, *case, loud=True) for case in K1_WIDE)
    wide_fp32 = max(_k1_case(gen, *case, dtype=torch.float32, loud=True) for case in K1_WIDE)
    x = torch.zeros(1, 64, 1024, dtype=torch.float16, device="cuda")  # what K1 still refuses
    try:
        fa.flash_attention(x, x, x, num_heads=2)
    except ValueError as err:
        print(f"K1 refuses float16 (d = 512): {err}")
    else:
        fail("K1 took float16")
    return bf16, fp32, wide, wide_fp32


def _k1_time(gen, b, h, sq, sk, d, dtype, card, clock) -> dict:
    """K1's time at one shape beside its bound, one scaled_dot_product_attention
    call (the yardstick, used nowhere in the port) and the plain version."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (torch.randn(b, n, h * d, generator=gen, device="cuda").to(dtype)
               for n in (sq, sk, sk))
    q4, k4, v4 = (x.reshape(b, x.shape[1], h, d).transpose(1, 2) for x in (q, k, v))
    qf, kf, vf = (x.reshape(b * h, x.shape[2], d) for x in (q4, k4, v4))
    t_k = timed(lambda: fa.flash_attention(q, k, v, num_heads=h))
    # heads in place: one attention is one kernel
    kernels = sum(e.count for e in _profiled(
        lambda: fa.flash_attention(q, k, v, num_heads=h), 5)) / 5
    if kernels != 1:
        fail(f"K1 at [{b},{h},{sq},{sk},{d}] {dtype} ran {kernels:g} kernels per attention: a copy?")
    t_l = timed(lambda: sdpa(q4, k4, v4))
    backend = ""
    if d > fa.MAX_HEAD_DIM:  # which of PyTorch's SDPA backends take this head dim, and ran
        from torch.nn.attention import SDPBackend, sdpa_kernel

        takes = []
        for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                   SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel([be]):
                    sdpa(q4, k4, v4)
                takes.append(be.name)
            except RuntimeError:
                pass
        ran = sorted({_demangle(e.key)[:48] for e in _profiled(lambda: sdpa(q4, k4, v4), 2)})
        backend = f" (backends that take d = {d}: {takes}; the default ran {ran})"
    t_p = cuda_ms(lambda: fa.flash_attention_reference(qf, kf, vf, d ** -0.5), iters=5)
    flops = 4.0 * b * h * sq * sk * d
    kind = "bf16" if dtype == torch.bfloat16 else "fp32"
    bound, by, term = k1_bound(b, h, sq, sk, d, clock, kind)
    print(f"K1 [{b},{h},{sq},{sk},{d}] {kind}: device {t_k[1]:.4f} ms ({flops / t_k[1] / 1e9:.1f} "
          f"TFLOP/s; CUDA events {t_k[0]:.4f}; {kernels:g} kernel(s) per attention), bound "
          f"{bound * 1e3:.2f} us by {term} (reached {bound / t_k[1]:.1%}), library SDPA "
          f"{kind} device {t_l[1]:.4f} ms (events {t_l[0]:.4f}){backend}, plain {t_p:.4f} ms "
          f"({card})")
    return {"shape": [h, sq, d] if b == 1 and sq == sk else [b, h, sq, sk, d],
            "device_ms": t_k[1], "ms": t_k[0], "plain_ms": t_p, "library_ms": t_l[1],
            "bound_ms": bound, "bound_by": by, "bound_term": term,
            "q": q, "k": k, "v": v, "qf": qf, "kf": kf, "vf": vf}


def _k1_totals(rows) -> dict:
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
    by = collections.Counter()
    for r in rows:
        by[r["bound_by"]] += r["bound_ms"]
    return {**total, "bound_by": by.most_common(1)[0][0]}


def phase_k1_times(card: str, clock: float) -> tuple[dict, dict]:
    """K1's time per shape beside its bound, one scaled_dot_product_attention
    call and the plain version, for the bf16 kernel (every phase-3 shape, the
    tiny family's two, and every rows-per-block plan at the main path's
    shapes) and the fp32 kernel.  Run after every frame timing: it opens the
    first profiler sessions of the process."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    result = {}
    for kind, dtype, cases in (("bf16", torch.bfloat16, _k1_cases() + K1_TIMED["bf16"][3:]),
                               ("fp32", torch.float32, K1_TIMED["fp32"])):
        main_rows, per_shape, banked = [], [], []
        for b, h, sq, sk, d in cases:
            row = _k1_time(gen, b, h, sq, sk, d, dtype, card, clock)
            tensors = {key: row.pop(key) for key in ("q", "k", "v", "qf", "kf", "vf")}
            if (b, h, sq, sk, d) in K1_TIMED[kind]:
                per_shape.append(row)
            if kind == "bf16" and (b, h, sq, sk, d) in K1_BANKED:
                banked.append(row)
            if sq == sk and b == 1 and (h, sq, d) in K1_SHAPES:
                main_rows.append(row)
            if kind == "bf16" and (h, sq, d) in K1_SHAPES and sq == sk and b == 1:
                # every number of rows per block the kernel can run this shape with,
                # held to the bar and timed: what block_rows' rule rests on
                q, k, v, qf, kf, vf = tensors.values()
                ref = fa.flash_attention_reference(qf, kf, vf, d ** -0.5).reshape(
                    b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d)
                picked, plans = fa.block_rows(sq, b * h, d), {}
                for rows in fa.row_plans(sq, d):
                    def plan(rows=rows):
                        return fa._launch(q, k, v, h, d ** -0.5, block_m=rows)
                    if not k1_within_bar(plan(), ref)[0]:
                        fail(f"K1 at [{b},{h},{sq},{sk},{d}] with {rows} rows per block "
                             f"disagrees with its plain version")
                    plans[rows] = row["device_ms"] if rows == picked else device_ms(plan)
                print(f"   rows per block -> device ms ({sq // picked * b * h} blocks at the "
                      f"{picked} picked): " + ", ".join(f"{r}: {t:.4f}" for r, t in plans.items()))
                row.update(rows_per_block=picked,
                           device_ms_by_rows={str(r): t for r, t in plans.items()})
        total = _k1_totals(main_rows)
        print(f"K1 {kind}, one call at each of its {len(main_rows)} timed main shapes: "
              + ", ".join(f"{k} {v:.4f}" for k, v in total.items() if k != "bound_by"))
        result[kind] = {**total, "per_shape": per_shape}
        if banked:  # the reference mode's READ pass, 20 launches of each per frame
            result[kind]["banked_per_shape"] = banked
        # the wide kernel: the KL VAE's [1, 4096, 512] (its main-path shape, twice
        # per KL frame) carries the entry's numbers
        rows = []
        for case in K1_WIDE_TIMED[kind]:
            rows.append(_k1_time(gen, *case, dtype, card, clock))
            for key in ("q", "k", "v", "qf", "kf", "vf"):
                rows[-1].pop(key)
        main_row = {k: v for k, v in rows[0].items() if k != "shape"}
        result[f"wide_{kind}"] = {**main_row, "per_shape": rows}
    return result["bf16"], result["fp32"], result["wide_bf16"], result["wide_fp32"]


def phase_tiny() -> int:
    """The tiny checkpoint's fp32 2-step program, CUDA against the CPU, at
    every TINY_SIZES side; returns the launches of K1's fp32 kernel over the
    CUDA runs at 128^2 and 256^2 (its path: the warm-up and the capture of
    each graph), counted from 0 just before."""
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "toy_tiny_ckpt")
    bundles = {dev: ModelBundle.from_dir(ckpt, device=dev) for dev in ("cuda", "cpu")}
    embeds = {dev: build_prompt_encoder(b)(b.tokenizer(["a portrait", "a landscape"]))[0]
              for dev, b in bundles.items()}
    args = ([0.6, 0.02], [5.0, 3.0], [2.0, 0.5], [23, 7])  # 0.02: one valid step
    fp32_launches = 0
    for side in TINY_SIZES:
        spec = FrameSpec(batch=2, height=side, width=side, steps=2)
        rng = np.random.default_rng(7)
        frame = rng.integers(0, 256, (2, side, side, 3), dtype=np.uint8)
        noise = rng.standard_normal((3, 2, side // 8, side // 8, 4)).astype(np.float32)
        outs = {}
        for dev, b in bundles.items():
            fa.launches = fa.launches_fp32 = 0
            program = build_frame_program(b, spec)
            img, lat = program(frame, embeds[dev], *args, noise=noise)
            outs[dev] = (img.cpu().numpy().astype(int), lat.float().cpu().numpy())
            if dev == "cuda":
                torch.cuda.synchronize()
                per_frame = program.last_launches
                launched = (per_frame["flash_attention"], per_frame["flash_attention_fp32"])
                fp32_launches += fa.launches_fp32
        dlat = np.abs(outs["cuda"][1] - outs["cpu"][1]).max()
        dimg = np.abs(outs["cuda"][0] - outs["cpu"][0]).max()
        print(f"tiny fp32 2-step {side}x{side} batch 2, CUDA vs CPU: latents max|d| {dlat:.3e} "
              f"(bound {TINY_LAT_ATOL:g}), image max|d| {dimg} levels (bound {TINY_IMG_LEVELS}); "
              f"K1 launches per frame in the CUDA graph: fp32 {launched[1]}, bf16 {launched[0]}")
        if not (np.isfinite(outs["cuda"][1]).all() and dlat <= TINY_LAT_ATOL
                and dimg <= TINY_IMG_LEVELS):
            fail(f"the tiny program on CUDA disagrees with the CPU at {side}x{side}")
        if launched[0] or (side > 64) != (launched[1] > 0):
            fail(f"the tiny fp32 program at {side}x{side} launched K1 {launched}, expected the "
                 f"fp32 kernel {'> 0' if side > 64 else '0'} times and the bf16 one 0")
    return fp32_launches


def _zero_counts() -> None:
    """Sets every kernel wrapper's launch count to 0."""
    fa.launches = fa.launches_fp32 = fa.launches_wide = fa.launches_wide_fp32 = 0
    k2.launches = k3.launches = k3.launches_fp32 = 0


def phase_tiny_kl() -> int:
    """A random fp32 tiny bundle with a KL VAE (drawn on the CPU, loaded on
    the card through ``from_state_dicts``) runs its 2-step ``vae="kl"``
    frame program on CUDA and on the CPU at every TINY_KL side, within the
    tiny checkpoint's bars; the graph must hold exactly TINY_KL fp32 K1
    launches per frame.  Returns the fp32 kernel's launches over the CUDA
    runs (warm-up and capture), counted from 0 just before each."""
    cpu = ModelBundle.random("tiny", dtype=torch.float32, device="cpu", with_kl_vae=True)
    cuda = ModelBundle.from_state_dicts(
        "tiny", {name: m.state_dict() for name, m in cpu.models.items()}, dtype=torch.float32,
        device="cuda")
    bundles = {"cuda": cuda, "cpu": cpu}
    embeds = {dev: build_prompt_encoder(b)(b.tokenizer(["a portrait", "a landscape"]))[0]
              for dev, b in bundles.items()}
    args = ([0.6, 0.02], [5.0, 3.0], [2.0, 0.5], [23, 7])
    fp32_launches = 0
    for side, want in TINY_KL.items():
        spec = FrameSpec(batch=2, height=side, width=side, steps=2, vae="kl")
        rng = np.random.default_rng(17)
        frame = rng.integers(0, 256, (2, side, side, 3), dtype=np.uint8)
        noise = rng.standard_normal((3, 2, side // 8, side // 8, 4)).astype(np.float32)
        outs = {}
        for dev, b in bundles.items():
            _zero_counts()
            program = build_frame_program(b, spec)
            img, lat = program(frame, embeds[dev], *args, noise=noise)
            outs[dev] = (img.cpu().numpy().astype(int), lat.float().cpu().numpy())
            if dev == "cuda":
                torch.cuda.synchronize()
                per_frame = {k: n for k, n in program.last_launches.items() if n}
                fp32_launches += fa.launches_fp32
        dlat = np.abs(outs["cuda"][1] - outs["cpu"][1]).max()
        dimg = np.abs(outs["cuda"][0] - outs["cpu"][0]).max()
        print(f"tiny fp32 KL 2-step {side}x{side} batch 2, CUDA vs CPU: latents max|d| {dlat:.3e} "
              f"(bound {TINY_LAT_ATOL:g}), image max|d| {dimg} levels (bound {TINY_IMG_LEVELS}); "
              f"kernel launches per frame in the CUDA graph: {per_frame}")
        if not (np.isfinite(outs["cuda"][1]).all() and dlat <= TINY_LAT_ATOL
                and dimg <= TINY_IMG_LEVELS):
            fail(f"the tiny KL program on CUDA disagrees with the CPU at {side}x{side}")
        if per_frame != {"flash_attention_fp32": want}:
            fail(f"the tiny KL program at {side}x{side} launched {per_frame} per frame, expected "
                 f"{want} of K1's fp32 kernel and nothing else")
    return fp32_launches


def phase_main(card: str) -> int:
    """The main path through the entry points: its first frame captures the
    graph, the timed frames replay it."""
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_fp32 = k2.launches = k3.launches = k3.launches_fp32 = 0
    img, lat = program(frame, embeds, *args)  # warm-up and capture
    torch.cuda.synchronize()
    (bucket,) = program.buckets.values()
    times = []
    for _ in range(MAIN_FRAMES):
        t0 = time.perf_counter()
        img, lat = program(frame, embeds, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches, per_frame = fa.launches, program.last_launches
    if k2.launches or k3.launches or fa.launches_fp32 or k3.launches_fp32:
        fail(f"the default bf16 route launched K2 {k2.launches}, K3 {k3.launches}, K1 fp32 "
             f"{fa.launches_fp32} and K3 fp32 {k3.launches_fp32} times")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if img.shape != (1, 512, 512, 3) or img.dtype != torch.uint8:
        fail(f"image {tuple(img.shape)} {img.dtype}")
    if lat.shape != (1, 64, 64, 4) or lat.dtype != torch.bfloat16 or not torch.isfinite(lat).all():
        fail(f"latents {tuple(lat.shape)} {lat.dtype} or not finite")
    if per_frame["flash_attention"] != K1_PER_FRAME or launches != 2 * K1_PER_FRAME:
        fail(f"K1 launched {per_frame['flash_attention']} times in the captured frame and "
             f"{launches} times in the warm-up and the capture, expected {K1_PER_FRAME} per frame")
    print(f"sd15 512x512 4-step CN+TAESD bf16 batch 1 on {card}, CUDA graph replays: median "
          f"{statistics.median(times):.2f} ms/frame over {MAIN_FRAMES} frames "
          f"(min {min(times):.2f}, max {max(times):.2f}), peak allocated {peak:.2f} GiB, "
          f"K1 launches {per_frame['flash_attention']}/frame in the graph ({launches} by the "
          f"wrapper: warm-up and capture); warm-up + capture {bucket.capture_s:.2f} s")
    return launches, (bundle, embeds, frame, args, img, program)


def phase_k2(card: str, clock: float) -> dict:
    """K2 against its plain version at every K2_SHAPES size, bit for bit, one
    device kernel per call, with both times; then a CUDA graph captured
    around one call replays bit for bit on a new frame."""
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
        kernels = sum(e.count for e in _profiled(lambda: k2.fused_preprocess(frame), 5)) / 5
        if kernels != 1:
            fail(f"K2 at {hw} ran {kernels:g} device kernels per call, expected one")
        t_k = timed(lambda: k2.fused_preprocess(frame))
        t_p = timed(lambda: k2.fused_preprocess_reference(frame))
        grid, per_sm = k2.launch_plan(*hw, frame.device)
        recomputed = k2.recomputed_tiles(*hw, grid)
        # u8 RGB in; bf16 RGB and fp32 edge out; ~40 fp32 operations per pixel, far under the ridge
        b_ms, by, term = bound_ms(hw[0] * hw[1] * (3 + 6 + 4), 40.0 * hw[0] * hw[1], "fp32", clock)
        print(f"K2 [{hw[0]},{hw[1]},3] u8 -> bf16 img + fp32 edge: equal to plain bit for bit; "
              f"{kernels:g} device kernel per call ({grid} blocks, {per_sm} per SM, |grad| of "
              f"{recomputed} tiles recomputed); kernel {t_k[0]:.4f} ms (device {t_k[1]:.4f}), "
              f"bound {b_ms * 1e3:.2f} us by {term} (reached {b_ms / t_k[1]:.1%}), plain "
              f"{t_p[0]:.4f} ms (device {t_p[1]:.4f}); no single library call computes it ({card})")
        if hw in K2_SHAPES[:3]:  # the sizes of earlier runs' totals
            ms, plain_ms = ms + t_k[0], plain_ms + t_p[0]
            dev_ms, bound = dev_ms + t_k[1], bound + b_ms
    # one call captured in a CUDA graph, replayed on another frame
    frames = [torch.randint(0, 256, (*K2_SHAPES[0], 3), generator=gen, device="cuda",
                            dtype=torch.uint8) for _ in range(2)]
    static = frames[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k2.fused_preprocess(static)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_img, g_edge = k2.fused_preprocess(static)
    replays = []
    for frame in frames[::-1]:
        static.copy_(frame)
        graph.replay()
        torch.cuda.synchronize()
        ref_img, ref_edge = k2.fused_preprocess_reference(frame)
        replays.append(torch.equal(g_img, ref_img) and torch.equal(g_edge, ref_edge))
    print(f"K2 captured in a CUDA graph (one cooperative launch) at {list(K2_SHAPES[0])}: replays "
          f"on two frames equal to plain bit for bit: {replays}")
    if not all(replays):
        fail("K2's CUDA graph replay differs from its plain version")
    print(f"K2 one call at each of the first three frame sizes: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound:.5f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def _cudnn_block_conv(w_cl, bias, xp, skip):
    """The default route's way of doing one block conv: a cuDNN bf16 conv on
    channels_last views, then the eager epilogue."""
    y = torch.nn.functional.conv2d(k3._nchw(xp), w_cl, bias, padding=1)
    return torch.relu(y if skip is None else y + k3._nchw(skip))


def _k3_within_bar(out, ref) -> tuple[bool, float, float, float]:
    """(K3's output is finite and within one bf16 ulp of the largest plain
    output with mean |d| <= K3_MEAN_ABS, max |d|, mean |d|, that ulp)."""
    err = (out.float() - ref.float()).abs()
    mx, mean = err.max().item(), err.mean().item()
    top = ref.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return bool(torch.isfinite(out).all()) and mx <= ulp and mean <= K3_MEAN_ABS, mx, mean, ulp


def phase_k3(card: str, clock: float) -> dict:
    """K3 against its plain version at every shape and epilogue; at the main
    path's shapes its device time beside its bound, a cuDNN bf16 conv + the
    eager epilogue (timed here, used nowhere in the port) and the plain
    version, one kernel per call, and every tile width held to the bar and
    timed."""
    gen = torch.Generator(device="cuda").manual_seed(5678)
    # the JAX init rule's bound +-1/sqrt(fan_in), and a bias on every block conv
    w = ((torch.rand(64, 64, 3, 3, generator=gen, device="cuda") * 2 - 1) / 24.0).bfloat16()
    bias = torch.randn(64, generator=gen, device="cuda") * 0.1
    w_cl, bias_bf = w.to(memory_format=torch.channels_last), bias.bfloat16()
    worst, per_frame = 0.0, {"kernel": [0.0, 0.0], "plain fp32": [0.0, 0.0],
                             "cuDNN bf16": [0.0, 0.0]}
    frame_bound, by_resource, per_shape = 0.0, {"operations": 0.0, "bytes": 0.0}, []
    for shape in [*K3_SHAPES, *K3_EXTRA]:
        xp = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        sk = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        tile_w = k3.tile_width(shape[0], shape[1], 2 * shape[2])
        n_tiles = len(k3.tile_origins(shape[0], shape[1], 2 * shape[2], tile_w))
        errs = []
        for epi, (relu, has_skip, has_bias) in K3_EPILOGUES.items():
            args = (w, bias if has_bias else None, xp)
            kw = {"relu": relu, "skip": sk if has_skip else None}
            out = k3.packed_conv3x3(*args, **kw)
            torch.cuda.synchronize()
            ok, mx, mean, ulp = _k3_within_bar(out, k3.packed_conv3x3_reference(*args, **kw))
            errs.append(f"{epi} {mx:.3e} / {mean:.1e} (ulp {ulp:g})")
            if not ok:
                fail(f"K3 disagrees with its plain version at {list(shape)} {epi}: max|d| {mx:.3e} "
                     f"(one ulp {ulp:g}), mean|d| {mean:.3e} (bound {K3_MEAN_ABS:g})")
            worst = max(worst, mx)
        print(f"K3 {list(shape)} bf16, tiles of {tile_w} pixels ({n_tiles}): max|d| / mean|d| "
              f"{'; '.join(errs)}")
        if shape not in K3_SHAPES:
            continue
        times = {}
        for epi, skip in (("relu", None), ("skip+relu", sk)):
            kernels = sum(e.count for e in _profiled(
                lambda: k3.packed_conv3x3(w, bias, xp, relu=True, skip=skip), 5)) / 5
            if kernels != 1:
                fail(f"K3 at {list(shape)} {epi} ran {kernels:g} kernels per call: a copy?")
            t = times[epi] = (  # each (CUDA events, device) ms
                timed(lambda: k3.packed_conv3x3(w, bias, xp, relu=True, skip=skip)),
                timed(lambda: k3.packed_conv3x3_reference(w, bias, xp, relu=True, skip=skip)),
                timed(lambda: _cudnn_block_conv(w_cl, bias_bf, xp, skip)),
            )
            gflop = 2 * 9 * 64 * 64 * shape[0] * shape[1] * shape[2] * 2 / 1e9
            (k_ev, k_dev), (p_ev, p_dev), (c_ev, c_dev) = t
            # bf16 input, output and (third conv of a block) skip, and the taps
            b_ms, by, _ = bound_ms(2.0 * xp.numel() * (2 if skip is None else 3)
                                   + 2.0 * w.numel(), gflop * 1e9, "bf16", clock)
            frame_bound += K3_SHAPES[shape] / 3 * (2 if skip is None else 1) * b_ms
            by_resource[by] += K3_SHAPES[shape] / 3 * (2 if skip is None else 1) * b_ms
            print(f"K3 {list(shape)} {epi} bf16: kernel {k_ev:.4f} ms (device {k_dev:.4f}, "
                  f"{gflop / k_dev:.1f} TFLOP/s; {kernels:g} kernel per call; bound "
                  f"{b_ms * 1e3:.2f} us by {by}, reached {b_ms / k_dev:.1%}), plain fp32 "
                  f"{p_ev:.4f} ms (device {p_dev:.4f}), cuDNN bf16 + eager epilogue {c_ev:.4f} "
                  f"ms (device {c_dev:.4f}) ({card})")
            per_shape.append({"shape": list(shape), "epilogue": epi, "device_ms": k_dev,
                              "ms": k_ev, "plain_ms": p_ev, "library_ms": c_dev,
                              "bound_ms": b_ms, "bound_by": by, "tile_w": tile_w})
        for i, name in enumerate(per_frame):  # two relu-only convs and one skip conv per block
            for j in range(2):
                per_frame[name][j] += K3_SHAPES[shape] / 3 * (
                    2 * times["relu"][i][j] + times["skip+relu"][i][j])
        # every tile width the kernel can run, held to the bar and timed
        # (relu): what tile_width's rule rests on
        ref = k3.packed_conv3x3_reference(w, bias, xp, relu=True)
        widths = {}
        for wt in k3.TILE_WIDTHS:
            def run(wt=wt):
                return k3._launch(w, bias, xp, True, None, tile_w=wt)
            if not _k3_within_bar(run(), ref)[0]:
                fail(f"K3 at {list(shape)} with tiles of {wt} pixels disagrees with its plain "
                     f"version")
            widths[wt] = times["relu"][0][1] if wt == tile_w else device_ms(run)
        print(f"   tile width -> device ms (relu; {tile_w} picked): "
              + ", ".join(f"{wt}: {t:.4f}" for wt, t in widths.items()))
        per_shape[-2]["device_ms_by_tile_w"] = {str(wt): t for wt, t in widths.items()}
    print("K3 per 512x512 frame ({} convs), CUDA events / device: ".format(K3_PER_FRAME)
          + ", ".join(f"{n} {ev:.4f} / {dev:.4f} ms" for n, (ev, dev) in per_frame.items()))
    print(f"K3 per 512x512 frame: bound {frame_bound:.4f} ms, reached "
          f"{frame_bound / per_frame['kernel'][1]:.1%} by device time")
    return {"max_abs_err": worst, "ms": per_frame["kernel"][0],
            "plain_ms": per_frame["plain fp32"][0], "device_ms": per_frame["kernel"][1],
            "bound_ms": frame_bound, "bound_by": max(by_resource, key=by_resource.get),
            "library_ms": per_frame["cuDNN bf16"][1], "per_shape": per_shape}


def phase_k3_fp32(card: str, clock: float) -> dict:
    """K3's fp32 kernel (3xTF32) against its plain version computed in fp64
    at the main path's shapes and the ragged ones, every epilogue and every
    tile height, printing the fp32 plain version's own distance beside; at
    the main path's shapes one kernel per call, its device time beside its
    fp32 bound, the plain version's and a cuDNN fp32 conv's (TF32 off) with
    the eager epilogue."""
    gen = torch.Generator(device="cuda").manual_seed(8765)
    w = (torch.rand(64, 64, 3, 3, generator=gen, device="cuda") * 2 - 1) / 24.0
    bias = torch.randn(64, generator=gen, device="cuda") * 0.1
    w_cl = w.to(memory_format=torch.channels_last)
    worst, per_frame = 0.0, {"kernel": [0.0, 0.0], "plain fp32": [0.0, 0.0],
                             "cuDNN fp32": [0.0, 0.0]}
    frame_bound, by_resource, per_shape = 0.0, {"operations": 0.0, "bytes": 0.0}, []
    for shape in [*K3_SHAPES, *K3_EXTRA]:
        xp = torch.randn(shape, generator=gen, device="cuda")
        sk = torch.randn(shape, generator=gen, device="cuda")
        rows = k3.fp32_tile_rows(shape[0], shape[1], 2 * shape[2])
        errs = []
        for epi, (relu, has_skip, has_bias) in K3_EPILOGUES.items():
            b, skip = bias if has_bias else None, sk if has_skip else None
            exact = k3.packed_conv3x3_reference(w, b, xp.double(), relu=relu, skip=skip).float()
            plain = fp32_within_bar(k3.packed_conv3x3_reference(w, b, xp, relu=relu, skip=skip),
                                    exact)
            out = k3.packed_conv3x3(w, b, xp, relu=relu, skip=skip)
            torch.cuda.synchronize()
            ok, mx, mean, max_bar, mean_bar = fp32_within_bar(out, exact)
            errs.append(f"{epi} {mx:.3e} / {mean:.1e} (bars {max_bar:.1e} / {mean_bar:.1e}; "
                        f"plain fp32 {plain[1]:.3e} / {plain[2]:.1e})")
            if not ok or out.dtype != torch.float32:
                fail(f"K3's fp32 kernel disagrees with its plain version in fp64 at {list(shape)} "
                     f"{epi}: max|d| {mx:.3e} (bar {max_bar:.3e}), mean|d| {mean:.3e} (bar "
                     f"{mean_bar:.3e})")
            worst = max(worst, mx)
            for r in k3.FP32_TILE_ROWS:  # every tile height, held to the same bars
                if r != rows and not fp32_within_bar(
                        k3._launch(w, b, xp, relu, skip, tile_rows=r), exact)[0]:
                    fail(f"K3 fp32 at {list(shape)} {epi} with tiles of {r} rows disagrees with "
                         f"its plain version in fp64")
        print(f"K3 {list(shape)} fp32 3xTF32 against plain in fp64, tiles of {rows} rows (every "
              f"height within the bars): max|d| / mean|d| {'; '.join(errs)}")
        if shape not in K3_SHAPES:
            continue
        times = {}
        for epi, skip in (("relu", None), ("skip+relu", sk)):
            kernels = sum(e.count for e in _profiled(
                lambda: k3.packed_conv3x3(w, bias, xp, relu=True, skip=skip), 5)) / 5
            if kernels != 1:
                fail(f"K3 fp32 at {list(shape)} {epi} ran {kernels:g} kernels per call")
            t = times[epi] = (
                timed(lambda: k3.packed_conv3x3(w, bias, xp, relu=True, skip=skip)),
                timed(lambda: k3.packed_conv3x3_reference(w, bias, xp, relu=True, skip=skip)),
                timed(lambda: _cudnn_block_conv(w_cl, bias, xp, skip)),
            )
            gflop = 2 * 9 * 64 * 64 * shape[0] * shape[1] * shape[2] * 2 / 1e9
            (k_ev, k_dev), (p_ev, p_dev), (c_ev, c_dev) = t
            b_ms, by, term = bound_ms(4.0 * xp.numel() * (2 if skip is None else 3)
                                      + 4.0 * w.numel(), gflop * 1e9, "fp32", clock)
            frame_bound += K3_SHAPES[shape] / 3 * (2 if skip is None else 1) * b_ms
            by_resource[by] += K3_SHAPES[shape] / 3 * (2 if skip is None else 1) * b_ms
            print(f"K3 {list(shape)} {epi} fp32: kernel {k_ev:.4f} ms (device {k_dev:.4f}, "
                  f"{gflop / k_dev:.1f} TFLOP/s; {kernels:g} kernel per call; bound "
                  f"{b_ms * 1e3:.2f} us by {term}, reached {b_ms / k_dev:.1%}), plain fp32 "
                  f"{p_ev:.4f} ms (device {p_dev:.4f}), cuDNN fp32 + eager epilogue {c_ev:.4f} "
                  f"ms (device {c_dev:.4f}) ({card})")
            per_shape.append({"shape": list(shape), "epilogue": epi, "device_ms": k_dev,
                              "ms": k_ev, "plain_ms": p_ev, "library_ms": c_dev,
                              "bound_ms": b_ms, "bound_by": by, "tile_rows": rows})
        for i, name in enumerate(per_frame):  # two relu-only convs and one skip conv per block
            for j in range(2):
                per_frame[name][j] += K3_SHAPES[shape] / 3 * (
                    2 * times["relu"][i][j] + times["skip+relu"][i][j])
        # every tile height the kernel can run, timed (relu; held to the bars above)
        heights = {}
        for r in k3.FP32_TILE_ROWS:
            def run(r=r):
                return k3._launch(w, bias, xp, True, None, tile_rows=r)
            heights[r] = times["relu"][0][1] if r == rows else device_ms(run)
        print(f"   tile rows -> device ms (relu; {rows} picked): "
              + ", ".join(f"{r}: {t:.4f}" for r, t in heights.items()))
        per_shape[-2]["device_ms_by_tile_rows"] = {str(r): t for r, t in heights.items()}
    print(f"K3 fp32 per 512x512 frame ({K3_PER_FRAME} convs), CUDA events / device: "
          + ", ".join(f"{n} {ev:.4f} / {dev:.4f} ms" for n, (ev, dev) in per_frame.items()))
    print(f"K3 fp32 per 512x512 frame: bound {frame_bound:.4f} ms, reached "
          f"{frame_bound / per_frame['kernel'][1]:.1%} by device time")
    return {"max_abs_err": worst, "ms": per_frame["kernel"][0],
            "plain_ms": per_frame["plain fp32"][0], "device_ms": per_frame["kernel"][1],
            "bound_ms": frame_bound, "bound_by": max(by_resource, key=by_resource.get),
            "library_ms": per_frame["cuDNN fp32"][1], "per_shape": per_shape}


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


def phase_taesd_pallas(card: str, main) -> tuple:
    """The phase-5 frame program on the taesd_pallas path, timed right after
    phase 5 and before any profiler session; returns K3's launches on the
    path (warm-up and capture) and the program."""
    bundle, embeds, frame, args, img_default, _ = main
    pallas = dataclasses.replace(bundle, taesd_cfg=_taesd_routes(bundle)["pallas"])
    program = build_frame_program(pallas, FrameSpec(batch=1, height=512, width=512, steps=4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = k2.launches = k3.launches = 0
    img, lat = program(frame, embeds, *args)  # warm-up and capture
    times = []
    for _ in range(MAIN_FRAMES):
        t0 = time.perf_counter()
        img, lat = program(frame, embeds, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    k3_launches, per_frame = k3.launches, program.last_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if img.shape != (1, 512, 512, 3) or img.dtype != torch.uint8 or not torch.isfinite(lat).all():
        fail(f"taesd_pallas image {tuple(img.shape)} {img.dtype} or latents not finite")
    got = (per_frame["taesd_conv3x3"], per_frame["flash_attention"])
    if got != (K3_PER_FRAME, K1_PER_FRAME) or k3_launches != 2 * K3_PER_FRAME:
        fail(f"the taesd_pallas graph holds K3 {got[0]} and K1 {got[1]} launches per frame (K3 "
             f"{k3_launches} in warm-up and capture), expected {K3_PER_FRAME} and {K1_PER_FRAME}")
    psnr = _psnr(img, img_default)
    print(f"sd15 512x512 4-step CN+TAESD bf16 batch 1, taesd_pallas, on {card}, CUDA graph "
          f"replays: median {statistics.median(times):.2f} ms/frame over {MAIN_FRAMES} frames "
          f"(min {min(times):.2f}, max {max(times):.2f}), peak allocated {peak:.2f} GiB, "
          f"K3 {got[0]}/frame, K1 {got[1]}/frame in the graph; "
          f"image PSNR vs the default route {psnr:.2f} dB (bound {FRAME_PSNR_DB:g})")
    if psnr < FRAME_PSNR_DB:
        fail("the taesd_pallas image drifted from the default route's")
    return k3_launches, program


def _timed_frame(program, *a, **kw):
    """One frame program call: (outputs, host ms to the synchronize, K1
    launches per frame in the graph it replayed)."""
    t0 = time.perf_counter()
    out = program(*a, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, program.last_launches["flash_attention"]


def _check_frame(name: str, out) -> None:
    img, lat = out[0], out[1]
    if img.shape != (1, 512, 512, 3) or img.dtype != torch.uint8:
        fail(f"{name}: image {tuple(img.shape)} {img.dtype}")
    if lat.shape != (1, 64, 64, 4) or not all(torch.isfinite(t).all() for t in out[1:]):
        fail(f"{name}: latents {tuple(lat.shape)} or caches not finite")


def phase_production(card: str, main, programs: dict) -> None:
    """The five production variants on the phase-5 bundle and frame (their
    graphs from phase 6a), timed before any profiler session; each frame's
    K1 launches must be exact.  Each variant frame is timed in turn with a
    parity frame and reported as a ratio to it."""
    bundle, embeds, frame, args, _, parity = main
    for name, (fields, want) in PRODUCTION.items():
        program = programs[name]
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
    bundle, embeds, _, args, _, main_program = main
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

    # the cadence's two signatures (produce and reuse, each with a warm start),
    # captured before the timing
    warm_kw = {"src_box": box, "warm_latents": prev[1], "warm_alpha": [0.3]}
    program(mail[0], embeds, *args, deep_caches=prev[2], **warm_kw)
    torch.cuda.reset_peak_memory_stats()
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


def phase_reference(card: str, main) -> tuple[int, dict]:
    """Reference mode on the phase-5 bundle: the sd15 512x512 4-step TAESD
    bf16 reference frame (no ControlNet) through ``build_reference_program``,
    two replayed calls equal to the eager ``reference_frame_program`` bit
    for bit, K1_REF_PER_FRAME K1 launches per frame at capture; style
    fidelity 0 against the plain frame program on the same noise; the
    median ms of blocking replays and frames/s as the bench measures
    ``ref_mode_fps``.  Returns (K1 launches of its warm-up and capture, what
    ``phase_ref_profile`` profiles)."""
    bundle, embeds, frame, args, _, _ = main
    spec = FrameSpec(batch=1, height=512, width=512, steps=4, use_controlnet=False)
    program = build_reference_program(bundle, spec)
    rng = np.random.default_rng(11)
    ref = torch.from_numpy(rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)).cuda()
    sf = torch.ones((1, 2), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    counted = {}
    _replay_vs_eager("reference mode", program,
                     [((frame, ref, embeds, *args[:2], sf, [23 + i]), {}) for i in range(2)],
                     {"flash_attention": K1_REF_PER_FRAME}, counted,
                     eager_program=reference_frame_program)
    launches = counted["flash_attention"]
    if launches != 2 * K1_REF_PER_FRAME or any(
            n for k, n in counted.items() if k != "flash_attention"):
        fail(f"the reference path launched {counted} in its warm-up and capture, expected "
             f"{2 * K1_REF_PER_FRAME} of K1 and nothing else")
    peak = torch.cuda.max_memory_allocated() / 2**30

    noise = torch.from_numpy(rng.standard_normal((5, 1, 64, 64, 4)).astype(np.float32)).cuda()
    ref_noise = torch.from_numpy(rng.standard_normal((1, 64, 64, 4)).astype(np.float32)).cuda()
    sf0 = program(frame, ref, embeds, *args[:2], torch.zeros((1, 2), device="cuda"), [23],
                  noise, ref_noise)
    plain = build_frame_program(bundle, spec)(frame, embeds, *args[:3], [23], noise=noise)
    d_img = (sf0[0].int() - plain[0].int()).abs().max().item()
    d_lat = (sf0[1].float() - plain[1].float()).abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(plain[1].float().abs().max().item())) - 7)
    full = program(frame, ref, embeds, *args[:2], sf, [23], noise, ref_noise)
    moved = (full[0].float() - plain[0].float()).abs().mean().item()
    print(f"reference mode, style fidelity 0 vs the plain frame program (no ControlNet, same "
          f"noise): equal bit for bit {_same(sf0, plain)}, image max|d| {d_img} levels (bar "
          f"{REF_SF0_LEVELS}), latents max|d| {d_lat:.3e} (bar {ulp:.3e}: one bf16 ulp of the "
          f"largest latent); fidelity 1 moves the image by mean|d| {moved:.2f} levels")
    if d_img > REF_SF0_LEVELS or d_lat > ulp or moved == 0.0:
        fail("the reference program at style fidelity 0 is not the plain program, or at 1 the "
             "reference does not move the image")

    times = []
    for i in range(REF_FRAMES):
        out, ms, _ = _timed_frame(program, frame, ref, embeds, *args[:2], sf, [30 + i])
        _check_frame("reference mode", out)
        times.append(ms)

    def call(i):
        return program(frame, frame, embeds, *args[:2], sf, [23 + i])

    fps = max(bench._fps(call, 20) for _ in range(3))  # the bench's ref_mode_fps
    (bucket,) = program.buckets.values()
    median = statistics.median(times)
    print(f"sd15 512x512 4-step TAESD bf16 reference mode batch 1 on {card}, CUDA graph "
          f"replays: median {median:.2f} ms/frame over {REF_FRAMES} blocking frames (min "
          f"{min(times):.2f}, max {max(times):.2f}); ref_mode_fps {fps:.3f} frames/s (best of 3 "
          f"windows of 20 frames, two in flight); K1 {program.last_launches['flash_attention']} "
          f"launches/frame in the graph ({launches} by the wrapper: warm-up and capture); "
          f"warm-up + capture {bucket.capture_s:.2f} s; peak allocated {peak:.2f} GiB")
    return launches, {"call": lambda: call(0), "replay_ms": median}


def phase_engine(card: str, main) -> None:
    """The serving engine over the port: ENGINE_STREAMS synchronous streams
    of 512x512 camera frames into one ``Engine`` (max_batch 4) on the
    phase-5 bundle, one stream switched to reference mode after
    ENGINE_REF_AFTER frames; the batches formed, frames/s, each stream's
    p50 latency, the graphs held and the card's memory; a batch the engine
    dispatched, run again through ``build_frame_program`` with the same
    inputs, equal bit for bit; and the reference bucket's warm-up and
    capture on a background thread while the dispatch thread keeps
    replaying the other streams' graphs.  Any error the engine logs (it
    keeps serving past a failed batch) fails the phase."""
    import asyncio
    import logging
    import threading

    from videosd_tpu_torch.runtime.engine import Engine

    bundle = main[0]
    errors = []

    class _Errors(logging.Handler):
        def emit(self, record):
            errors.append(self.format(record))

    handler = _Errors(level=logging.ERROR)
    logging.getLogger("videosd_tpu_torch.engine").addHandler(handler)
    try:
        side = ENGINE_SIDE
        eng = Engine(bundle=bundle, max_streams=ENGINE_STREAMS, max_batch=4, frame_hw=(side, side))
        t0 = time.perf_counter()
        eng.warmup(batch_sizes=(1, 2, 4), steps=(4,), height=side, width=side)
        warm_s = time.perf_counter() - t0
        dispatches, batches, last_call = [], collections.Counter(), {}
        dispatch, get_program = eng._dispatch_bucket, eng._get_program
        record_generation = eng.telemetry.record_generation

        def timed_dispatch(spec, ref_mode, *a, **kw):
            t = time.perf_counter()
            raw = dispatch(spec, ref_mode, *a, **kw)
            dispatches.append((threading.current_thread().name, t, time.perf_counter(), ref_mode))
            return raw

        def spy_program(spec, *, ref_mode=False):
            program = get_program(spec, ref_mode=ref_mode)

            def call(*a, **kw):
                out = program(*a, **kw)
                if not ref_mode and threading.current_thread().name == "tpu-dispatch":
                    last_call.update(spec=spec, args=a, kwargs=kw, out=out)
                return out

            return call

        def count_batch(seconds, batch=1, fill=1.0):
            batches[batch] += 1
            record_generation(seconds, batch=batch, fill=fill)

        eng._dispatch_bucket, eng._get_program = timed_dispatch, spy_program
        eng.telemetry.record_generation = count_batch
        rng = np.random.default_rng(21)
        cams = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
                for _ in range(ENGINE_STREAMS)]
        lat = [[] for _ in range(ENGINE_STREAMS)]
        ref_sid = ENGINE_STREAMS - 1
        finished = []  # (time, frames generated) as each stream ends

        def ref_batches():
            return sum(rm for th, _, _, rm in dispatches if th == "tpu-dispatch")

        async def client(st, i):
            # the reference stream goes on until 8 reference-mode batches were
            # served (its first frames in that mode pass through while the
            # bucket warms up), within ENGINE_REF_S seconds
            n, deadline = 0, time.monotonic() + ENGINE_REF_S
            while n < ENGINE_FRAMES or (i == ref_sid and ref_batches() < 8):
                if n == ENGINE_REF_AFTER and i == ref_sid:
                    eng.update_options(st.stream_id, {"ref": True})
                if time.monotonic() > deadline:
                    fail(f"stream {i}: fewer than 8 reference-mode batches in {ENGINE_REF_S} s")
                t = time.perf_counter()
                await asyncio.wait_for(eng.submit_frame(st.stream_id, np.roll(cams[i], 8 * n, 1)),
                                       300)
                lat[i].append((time.perf_counter() - t) * 1e3)
                n += 1
                await asyncio.sleep(0.02)  # the client's turnaround (a 50 frames/s camera)
            finished.append((time.perf_counter(), eng.telemetry.frames_out))

        async def run():
            eng.start()
            try:
                sts = [eng.open_stream({"prompt": f"stream {i}", "seed": 100 + i, "height": side,
                                        "width": side, "warm_alpha": 0.3 if i == 1 else 0.0})
                       for i in range(ENGINE_STREAMS)]
                before, t = eng.telemetry.frames_out, time.perf_counter()
                await asyncio.gather(*[client(st, i) for i, st in enumerate(sts)])
                wall = time.perf_counter() - t
                # while every stream still ran: up to the first stream's end
                steady = (finished[0][1] - before) / (finished[0][0] - t)
                return (eng.telemetry.frames_out - before) / wall, steady, wall, eng.stats()
            finally:
                await eng.stop()

        fps, steady, wall, stats = asyncio.run(run())
    finally:
        logging.getLogger("videosd_tpu_torch.engine").removeHandler(handler)
    if errors:
        fail(f"the engine logged {len(errors)} error(s); the first: {errors[0]}")
    bg = [(t0, t1) for th, t0, t1, rm in dispatches if th == "bucket-compile" and rm]
    if len(bg) != 1:
        fail(f"expected one background warm-up of the reference bucket, saw {len(bg)}")
    served = sum(1 for th, a, b, rm in dispatches
                 if th == "tpu-dispatch" and bg[0][0] <= a and b <= bg[0][1])
    print(f"engine, {ENGINE_STREAMS} streams of {side}x{side} frames, sd15 CN+TAESD bf16, max_batch 4, "
          f"stream {ref_sid} in reference mode from its frame {ENGINE_REF_AFTER}, on {card}: "
          f"warmup of batch 1/2/4 {warm_s:.1f} s; frames per batch formed {dict(batches)}; "
          f"{steady:.2f} frames/s generated while all {ENGINE_STREAMS} streams ran, {fps:.2f} over "
          f"the whole {wall:.1f} s; p50 latency per stream (ms) "
          + ", ".join(f"{statistics.median(v):.1f}" for v in lat)
          + f" (stream {ref_sid}'s with its passthrough frames); graphs held {stats['graphs']}; {stats['memory_gib']['allocated']:.2f} GiB "
          f"allocated, {stats['memory_gib']['reserved']:.2f} GiB reserved; dispatch threads "
          f"{stats['dispatch_threads']}")
    print(f"engine: the reference bucket warmed up and captured on the background thread in "
          f"{bg[0][1] - bg[0][0]:.2f} s, while the dispatch thread dispatched {served} batches "
          f"of the other streams; {ref_batches()} reference-mode batches served after it")
    if served < 1:
        fail("no batch was served while the reference bucket captured in the background")
    if batches[4] + batches[3] < 1 or ref_batches() < 8:
        fail(f"the engine formed no batch of 3 or 4 streams ({dict(batches)}) or served fewer than "
             f"8 reference-mode batches")
    again = build_frame_program(bundle, last_call["spec"])(*last_call["args"],
                                                           **last_call["kwargs"])
    same = _same(again, last_call["out"])
    print(f"engine: its last dispatched batch ({last_call['spec'].batch} rows), run again "
          f"through build_frame_program with the same inputs and seeds, equal bit for bit: "
          f"{same}")
    if not same:
        fail("a batch the engine dispatched differs from build_frame_program on its inputs")


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _spread(a, b) -> list:
    return [(x.float() - y.float()).abs().max().item() for x, y in zip(a, b)]


def _replay_vs_eager(name: str, program, calls: list, want: dict,
                     counted: dict | None = None, eager_program=frame_program) -> list:
    """Two calls in a row of one signature of ``program`` (replays of the
    graph its first call captured), each against the eager frame_program of
    the same inputs bit for bit, after eager against itself; the graph's
    launches per frame must be ``want``.  ``counted`` receives the wrappers'
    counts right after the program's calls.  Returns the replays' outputs."""
    before = set(program.buckets)
    got = [program(*a, **kw) for a, kw in calls]
    if counted is not None:
        torch.cuda.synchronize()
        counted.update(kernel_launches())
    launches = program.last_launches
    captured = [b.capture_s for k, b in program.buckets.items() if k not in before]
    torch.cuda.synchronize()
    eager = [eager_program(program.bundle, program.spec, *a, **kw) for a, kw in calls]
    again = eager_program(program.bundle, program.spec, *calls[0][0], **calls[0][1])
    stable = _same(eager[0], again)
    bar = [0.0] * len(again) if stable else _spread(eager[0], again)
    diffs = [_spread(g, e) for g, e in zip(got, eager)]
    same = [_same(g, e) for g, e in zip(got, eager)]
    wrong = {k: launches[k] for k, n in want.items() if launches[k] != n}
    print(f"graph {name}: two calls replayed, equal to eager frame_program bit for bit: {same}"
          + ("" if all(same) else f" (max|d| per output {diffs})")
          + f"; eager equal to itself: {stable}"
          + ("" if stable else f" (spread {bar}, the bar)")
          + f"; launches per frame in the graph {launches}"
          + (f"; warm-up + capture {captured[0]:.2f} s" if captured else ""))
    if not all(d <= b for diff in diffs for d, b in zip(diff, bar)):
        fail(f"graph {name}: the replay differs from eager frame_program")
    if wrong:
        fail(f"graph {name}: the graph holds {wrong} launches per frame, expected {want}")
    return got


def phase_graph(card: str, main, pallas_program) -> tuple[dict, float]:
    """Every bucket's graph against eager frame_program, eager and replayed
    parity frames timed in turns, and the peak memory with every graph
    held; returns the programs by name and the replayed parity ms/frame."""
    bundle, embeds, frame, args, img, parity = main
    spec = parity.spec
    programs = {"parity": parity, "taesd_pallas": pallas_program}

    def calls(frames, b=1, **kw):  # two calls in a row, other seeds and frames
        return [((frames[i], embeds.expand(b, -1, -1), [0.6] * b, [5.0] * b, [2.0] * b,
                  [23 + b * i + j for j in range(b)]), dict(kw)) for i in range(2)]

    rng = np.random.default_rng(2)
    frames = [frame, torch.from_numpy(rng.integers(0, 256, frame.shape, dtype=np.uint8)).cuda()]
    k1 = {"flash_attention": K1_PER_FRAME}
    _replay_vs_eager("parity batch 1", parity, calls(frames), {**k1, "taesd_conv3x3": 0})
    _replay_vs_eager("taesd_pallas", pallas_program, calls(frames),
                     {**k1, "taesd_conv3x3": K3_PER_FRAME})
    programs["parity_b4"] = build_frame_program(bundle, dataclasses.replace(spec, batch=4))
    frames4 = [torch.from_numpy(rng.integers(0, 256, (4, 512, 512, 3), dtype=np.uint8)).cuda()
               for _ in range(2)]
    _replay_vs_eager("parity batch 4", programs["parity_b4"], calls(frames4, 4), k1)
    for name, (fields, want) in PRODUCTION.items():
        program = programs[name] = build_frame_program(bundle, dataclasses.replace(spec, **fields))
        if not fields.get("deepcache_temporal"):
            _replay_vs_eager(name, program, calls(frames), {"flash_attention": want})
            continue
        produced = _replay_vs_eager(f"{name} produce", program, calls(frames),
                                    {"flash_attention": want[0]})
        reuse = calls(frames)
        for (_, kw), out in zip(reuse, produced):
            kw["deep_caches"] = out[2]
        _replay_vs_eager(f"{name} reuse", program, reuse, {"flash_attention": want[1]})

    # the engine-shaped call: I420 mailbox, camera box, warm start, temporal N=2 cn1
    mail = [torch.from_numpy(_i420_mailbox(rng.integers(0, 256, (*CAMERA_HW, 3), dtype=np.uint8))
                             )[None].cuda() for _ in range(2)]
    left, top, right, bottom = center_crop_box(CAMERA_HW[1], CAMERA_HW[0], 512, 512)
    box = torch.tensor([[top, left, bottom - top, right - left]], dtype=torch.int32, device="cuda")
    engine = programs["engine"] = build_frame_program(bundle, dataclasses.replace(
        spec, in_height=MAILBOX_HW[0], in_width=MAILBOX_HW[1], in_format="i420",
        deepcache_temporal=True))
    warm = {"src_box": box, "warm_latents": parity(frame, embeds, *args)[1], "warm_alpha": [0.3]}
    want_produce, want_reuse = PRODUCTION["production_temporal2_cn1"][1]
    produced = _replay_vs_eager("engine-shaped produce", engine, calls(mail, **warm),
                                {"flash_attention": want_produce})
    reuse = calls(mail, **warm)
    for (_, kw), out in zip(reuse, produced):
        kw["deep_caches"] = out[2]
    _replay_vs_eager("engine-shaped reuse", engine, reuse, {"flash_attention": want_reuse})
    held = torch.cuda.memory_allocated() / 2**30
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30
    graphs = sum(len(p.buckets) for p in programs.values())
    print(f"graphs held: {graphs} in {len(programs)} programs, {held:.2f} GiB allocated with "
          f"the bundle's weights, peak allocated {peak:.2f} GiB, reserved {reserved:.2f} GiB "
          f"(the graphs share one pool, which keeps the blocks their captures freed) ({card})")

    # eager and replayed parity frames in alternating turns (before any profiler session)
    turns = []
    for turn in range(GRAPH_TURNS):
        row = {}
        for kind in ("eager", "replay"):
            ms = []
            for i in range(GRAPH_TURN_FRAMES):
                a = (frame, embeds, *args[:3], [23 + i])
                t0 = time.perf_counter()
                if kind == "eager":
                    frame_program(bundle, spec, *a)
                else:
                    parity(*a)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            row[kind] = statistics.median(ms)
        turns.append(row)
        print(f"turn {turn}: eager frame_program {row['eager']:.2f} ms/frame, CUDA graph replay "
              f"{row['replay']:.2f} ms/frame (median of {GRAPH_TURN_FRAMES} blocking frames; "
              f"{row['eager'] / row['replay']:.2f}x) ({card})")
    if any(row["replay"] >= row["eager"] for row in turns):
        fail("a turn's replayed frame was not faster than the eager one")
    return programs, statistics.median(row["replay"] for row in turns)


def _turns(eager, replay, turns: int, frames: int) -> list:
    """Blocking frames of ``eager`` and ``replay`` (functions of the frame
    index) in alternating turns: the median ms of each per turn."""
    rows = []
    for _ in range(turns):
        row = {}
        for kind, fn in (("eager", eager), ("replay", replay)):
            ms = []
            for i in range(frames):
                t0 = time.perf_counter()
                fn(i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            row[kind] = statistics.median(ms)
        rows.append(row)
    return rows


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def phase_kl(card: str) -> dict:
    """The KL path at full width: a random sd15 bundle with the KL VAE, the
    512x512 4-step CN + KL bf16 frame through build_frame_program (two
    replayed calls bit for bit the eager frame_program, K1_KL_PER_FRAME
    launches per frame at capture, eager and replayed frames in turns, the
    FLOPs per frame and the memory); the fp32 copy of its VAE through the
    wide fp32 kernel against the plain attention; one tiled_decode.  Each
    path's counts are set to 0 just before it and read just after."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30  # the earlier phases' bundles and graphs
    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd15", dtype=torch.bfloat16, device="cuda", with_kl_vae=True)
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    spec = FrameSpec(batch=1, height=512, width=512, steps=4, vae="kl")
    program = build_frame_program(bundle, spec)
    rng = np.random.default_rng(8)
    frames = [torch.from_numpy(rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)).cuda()
              for _ in range(2)]
    args = ([0.6], [5.0], [2.0])
    calls = [((frames[i], embeds, *args, [23 + i]), {}) for i in range(2)]
    torch.cuda.synchronize()
    print(f"sd15 bundle with the KL VAE + prompt: {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    counted = {}
    got = _replay_vs_eager("sd15 512x512 4-step CN+KL bf16", program, calls, K1_KL_PER_FRAME,
                           counted)
    _check_frame("KL frame", got[-1])
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    want = {k: 2 * n for k, n in K1_KL_PER_FRAME.items()}  # warm-up and capture
    if {k: n for k, n in counted.items() if n} != want:
        fail(f"the KL path launched {counted} in its warm-up and capture, expected {want}")
    (bucket,) = program.buckets.values()
    print(f"KL graph: warm-up + capture {bucket.capture_s:.2f} s; peak allocated {peak:.2f} GiB "
          f"({peak - held:.2f} above the {held:.2f} GiB the earlier phases hold: this bundle, its "
          f"warm-up, capture and two calls), peak reserved {reserved:.2f} GiB ({card})")

    turns = _turns(lambda i: frame_program(bundle, spec, frames[i % 2], embeds, *args, [23 + i]),
                   lambda i: program(frames[i % 2], embeds, *args, [23 + i]),
                   KL_TURNS, KL_TURN_FRAMES)
    for i, row in enumerate(turns):
        print(f"KL turn {i}: eager frame_program {row['eager']:.2f} ms/frame, CUDA graph replay "
              f"{row['replay']:.2f} ms/frame (median of {KL_TURN_FRAMES} blocking frames; "
              f"{row['eager'] / row['replay']:.2f}x) ({card})")
    if any(row["replay"] >= row["eager"] for row in turns):
        fail("a turn's replayed KL frame was not faster than the eager one")
    replay_ms = statistics.median(row["replay"] for row in turns)
    count = frame_flops(bundle, spec)
    print(f"KL frame FLOPs (ops/flops.py): {count['logical'] / 1e12:.3f} TFLOP logical, "
          f"{count['padded'] / 1e12:.3f} padded; at the replayed {replay_ms:.2f} ms/frame "
          f"{count['logical'] / (replay_ms / 1e3) / 1e12:.1f} TFLOP/s, MFU "
          f"{count['logical'] / (replay_ms / 1e3) / PEAK_BF16_FLOPS:.4f} (padded "
          f"{count['padded'] / (replay_ms / 1e3) / PEAK_BF16_FLOPS:.4f}) of 989 TFLOP/s ({card})")

    # the wide fp32 kernel's path: the VAE in fp32 (torch's TF32 off for the
    # convs and the plain attention; the kernel's own 3xTF32 reads no flag),
    # against the plain attention
    vae32 = copy.deepcopy(bundle.models["vae"]).float()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(1, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
    z = torch.randn(1, 64, 64, 4, generator=gen, device="cuda")
    with torch.inference_mode():
        _zero_counts()
        out = (vae_encode(vae32, x), vae_decode(vae32, z))
        torch.cuda.synchronize()
        fp32_launches = fa.launches_wide_fp32
        others = fa.launches + fa.launches_fp32 + fa.launches_wide
        routed = layers.flash_attention
        layers.flash_attention = lambda q, k, v, *, num_heads: layers._attention_plain(
            q, k, v, num_heads)
        try:
            plain = (vae_encode(vae32, x), vae_decode(vae32, z))
        finally:
            layers.flash_attention = routed
    rel = [_rel_l2(a, b) for a, b in zip(out, plain)]
    print(f"KL VAE fp32 512x512 encode + decode, the wide fp32 kernel ({fp32_launches} launches) vs "
          f"the plain attention: rel L2 encode {rel[0]:.3e}, decode {rel[1]:.3e} (bound "
          f"{KL_FP32_REL_L2:g})")
    if not (all(torch.isfinite(t).all() for t in out) and max(rel) <= KL_FP32_REL_L2
            and fp32_launches == 2 and others == 0):
        fail(f"the fp32 KL VAE disagrees with the plain attention, or launched the wide fp32 "
             f"kernel {fp32_launches} times (expected 2) and K1's others {others}")

    # tiled_decode of a large latent grid: one wide launch per 64-latent tile
    vae = bundle.models["vae"]
    zt = torch.randn(1, KL_TILED_GRID, KL_TILED_GRID, 4, generator=gen, device="cuda").bfloat16()
    with torch.inference_mode():
        _zero_counts()
        t0 = time.perf_counter()
        tiled = tiled_decode(lambda t: vae_decode(vae, t), zt)
        torch.cuda.synchronize()
        tiled_ms = (time.perf_counter() - t0) * 1e3
        tiled_launches = fa.launches_wide
        first = vae_decode(vae, zt[:, :64, :64]).float()
    # pixels [0, 448) of each axis lie in the first tile alone: out * w / w
    alone = (tiled[:, :448, :448] - first[:, :448, :448]).abs().max().item()
    print(f"tiled_decode of a {KL_TILED_GRID}x{KL_TILED_GRID} latent grid (64-latent tiles, "
          f"overlap 8) -> {list(tiled.shape)} {tiled.dtype} in {tiled_ms:.1f} ms, wide K1 "
          f"launches {tiled_launches} (expected {KL_TILES}); where the first tile is alone, "
          f"max|d| from its own decode {alone:.3e} ({card})")
    if not (tiled.shape == (1, 8 * KL_TILED_GRID, 8 * KL_TILED_GRID, 3)
            and torch.isfinite(tiled).all() and tiled_launches == KL_TILES
            and alone <= 1e-6 * first.abs().max().item()):
        fail("tiled_decode is off its tiles, or launched the wide kernel the wrong number of times")
    return {"bundle": bundle, "program": program, "embeds": embeds, "frame": frames[0],
            "args": (*args, [23]), "launches": counted["flash_attention_wide"],
            "fp32_launches": fp32_launches, "tiled_launches": tiled_launches,
            "replay_ms": replay_ms}


def phase_fp32_frame(card: str) -> dict:
    """The fp32 parity frame: a random sd15 bundle in fp32 with ControlNet
    and the KL VAE (the configuration of videosd_tpu/tools/parity.py), the
    512x512 4-step frame through build_frame_program: two replayed calls
    equal to the eager frame_program bit for bit, K1_FP32_PER_FRAME
    launches per frame at capture (counted from 0 just before), the
    replayed ms/frame (before any profiler session) and the peak memory."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd15", dtype=torch.float32, device="cuda", with_kl_vae=True)
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    program = build_frame_program(bundle, FrameSpec(batch=1, height=512, width=512, steps=4,
                                                    vae="kl"))
    rng = np.random.default_rng(11)
    frames = [torch.from_numpy(rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)).cuda()
              for _ in range(2)]
    args = ([0.6], [5.0], [2.0])
    torch.cuda.synchronize()
    print(f"sd15 fp32 bundle with ControlNet and the KL VAE + prompt: "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    counted = {}
    got = _replay_vs_eager("sd15 512x512 4-step CN+KL fp32", program,
                           [((frames[i], embeds, *args, [23 + i]), {}) for i in range(2)],
                           K1_FP32_PER_FRAME, counted)
    _check_frame("fp32 KL frame", got[-1])
    if got[-1][1].dtype != torch.float32:
        fail(f"the fp32 frame's latents are {got[-1][1].dtype}")
    want = {k: 2 * n for k, n in K1_FP32_PER_FRAME.items()}  # warm-up and capture
    if {k: n for k, n in counted.items() if n} != want:
        fail(f"the fp32 frame launched {counted} in its warm-up and capture, expected {want}")
    ms = []
    for i in range(FP32_FRAMES):
        t0 = time.perf_counter()
        program(frames[i % 2], embeds, *args, [30 + i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    replay_ms = statistics.median(ms)
    (bucket,) = program.buckets.values()
    print(f"sd15 512x512 4-step CN+KL fp32 batch 1 on {card}, CUDA graph replays: median "
          f"{replay_ms:.2f} ms/frame over {FP32_FRAMES} frames (min {min(ms):.2f}, max "
          f"{max(ms):.2f}); warm-up + capture {bucket.capture_s:.2f} s; peak allocated "
          f"{peak:.2f} GiB ({peak - held:.2f} above the {held:.2f} GiB the earlier phases hold)")
    return {"program": program, "embeds": embeds, "frame": frames[0], "args": (*args, [23]),
            "launches": counted["flash_attention_fp32"], "replay_ms": replay_ms}


# the bench's window sizes for one short pass through its code
BENCH_SHORT = {"windows": 1, "frames": 3, "latency_frames": 3, "batch4_frames": 2,
               "temporal_frames": 4, "ref_frames": 3}


def phase_bench(bundle) -> None:
    """The port bench's code once with short windows, on the phase-5
    bundle: its JSON keys, with positive finite rates."""
    result = bench.run(bundle, **BENCH_SHORT)
    print(f"bench, short windows {BENCH_SHORT}: {json.dumps(result)}")
    rates = [v for k, v in result.items() if k.endswith("_fps") and v is not None]
    rates += [result["value"], result["p50_latency_ms"]]
    if len(rates) != 9 or not all(math.isfinite(r) and r > 0 for r in rates):
        fail("the bench gave a rate that is not positive and finite")


def _taesd_routes(bundle) -> dict:
    return {name: dataclasses.replace(bundle.taesd_cfg, **kw) for name, kw in (
        ("default", {}), ("packed", {"packed_convs": True}), ("pallas", {"pallas_convs": True}))}


def phase_taesd_routes(card: str, bundle) -> int:
    """TAESD at 512x512 on each route: K3 against an fp32 copy and the
    packed library route; the fp32 copy through K3's fp32 kernel against the
    fp32 default route, which is that kernel's path (its launches, counted
    from 0 just before, are returned); and the device time of encode +
    decode."""
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
        k3.launches_fp32 = 0
        ref_k3 = (taesd_encode(ae32, x.float(), routes["pallas"]),
                  taesd_decode(ae32, z.float(), routes["pallas"]))
        torch.cuda.synchronize()
        fp32_launches = k3.launches_fp32
        outs = {n: (taesd_encode(ae, x, c), taesd_decode(ae, z, c)) for n, c in routes.items()}
        torch.cuda.synchronize()

        def rel(got, want):
            return [((a.float() - b.float()).norm() / b.float().norm()).item()
                    for a, b in zip(got, want)]

        vs32 = rel(ref_k3, ref)
        print(f"TAESD 512x512 fp32, K3's fp32 kernel ({fp32_launches} launches) vs the fp32 "
              f"default route: rel L2 encode {vs32[0]:.3e}, decode {vs32[1]:.3e} (bound "
              f"{TAESD_FP32_REL_L2:g})")
        if not (all(torch.isfinite(t).all() for t in ref_k3) and max(vs32) <= TAESD_FP32_REL_L2
                and fp32_launches == K3_PER_FRAME):
            fail(f"the fp32 TAESD route through K3 disagrees with the default route or launched "
                 f"K3's fp32 kernel {fp32_launches} times, expected {K3_PER_FRAME}")

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
    return fp32_launches


# device time by class of operation: the first class whose pattern is in a
# kernel's name (K1 and K3 before the library convs and GEMMs, whose names
# share words; convolutions before GEMMs: cuDNN's are implicit GEMMs)
OP_CLASSES = (
    ("K1 flash attention", ("flash_fwd", "flash_wide_fwd")),
    ("K3 TAESD conv", ("conv3x3_kernel",)),
    ("cuDNN NCHW<->NHWC layout transposes", ("nchwToNhwc", "nhwcToNchw", "tensorTransform",
                                             "nhwcAddPadding")),
    ("convolutions (cuDNN)", ("fprop", "convolve", "cudnn")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "splitKreduce")),
    ("softmax (plain-route attention)", ("softmax",)),
    ("layer norm", ("layer_norm",)),
    ("reductions (group-norm statistics, maxima)", ("reduce_kernel",)),
    ("copies and dtype casts", ("copy", "Copy", "Memcpy", "Memset", "memset")),
    ("elementwise (group-norm arithmetic, silu, adds, scales)", ("elementwise",)),
)


def _op_class(name: str) -> str:
    return next((cls for cls, keys in OP_CLASSES if any(k in name for k in keys)), "other")


def _timeline(fn, iters: int) -> tuple[float, float]:
    """(span, busy) in ms of ``iters`` calls of ``fn`` under one profiler
    session: from the first kernel's start to the last kernel's end, and the
    union of the kernels' intervals, read from the session's exported trace."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel")
    if not spans:
        fail("torch.profiler's trace holds no kernel of the replayed frames")
    busy, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return (end - spans[0][0]) / 1e3, busy / 1e3


def phase_profile(card: str, main, replay_ms: float) -> None:
    """One profiler pass over two replayed main-path frames, after every
    frame timing (a profiler session slows the host's later launches):
    kernels and device-busy time per frame, K1's 84, the idle share of the
    card in the profiled frames, and device time by class of operation."""
    bundle, embeds, frame, args, _, program = main
    _profile_frames(card, "main-path", lambda: program(frame, embeds, *args), replay_ms,
                    {"flash_fwd_kernel": K1_PER_FRAME})


def phase_kl_profile(card: str, kl: dict) -> None:
    """The same over two replayed KL frames: K1's 84 and the wide kernel's 2."""
    program, embeds, frame, args = kl["program"], kl["embeds"], kl["frame"], kl["args"]
    _profile_frames(card, "KL", lambda: program(frame, embeds, *args), kl["replay_ms"],
                    {"flash_fwd_kernel": K1_PER_FRAME, "flash_wide_fwd_kernel": 2})


def phase_fp32_profile(card: str, fp32: dict) -> None:
    """The same over two replayed fp32 parity frames: K1's fp32 kernel 84
    times, the wide fp32 kernel twice, and their device ms per frame."""
    program, embeds, frame, args = fp32["program"], fp32["embeds"], fp32["frame"], fp32["args"]
    _profile_frames(card, "fp32 CN+KL", lambda: program(frame, embeds, *args), fp32["replay_ms"],
                    {"flash_fwd_fp32_kernel": K1_PER_FRAME, "flash_wide_fwd_fp32_kernel": 2})


def phase_ref_profile(card: str, ref: dict) -> None:
    """The same over two replayed reference frames: K1's 180 (60 banked)."""
    _profile_frames(card, "reference-mode", ref["call"], ref["replay_ms"],
                    {"flash_fwd_kernel": K1_REF_PER_FRAME})


def _profile_frames(card: str, label: str, call, replay_ms: float, want: dict) -> None:
    """Profiles two calls of ``call``; ``want``: kernels per frame by a
    substring of their names."""
    frames = 2
    events = _profiled(call, frames)

    def per_frame(pred):
        picked = [e for e in events if pred(e.key)]
        return (sum(e.count for e in picked) / frames,
                sum(e.device_us for e in picked) / frames / 1e3)

    n_all, ms_all = per_frame(lambda key: True)
    k1 = {name: per_frame(lambda key, name=name: name in key) for name in want}
    span, busy = _timeline(call, frames)
    print(f"profile of {frames} replayed {label} frames on {card}: {n_all:.0f} kernels/frame, "
          f"device busy {ms_all:.2f} ms/frame; "
          + "; ".join(f"{name} {n:.0f} launches and {ms:.3f} ms/frame"
                      for name, (n, ms) in k1.items()) + "; "
          f"one more session's timeline: {span:.2f} ms from the first kernel to the last, "
          f"{busy:.2f} ms busy, idle share {1 - busy / span:.2%} (the two frames and the staging "
          f"between them); unprofiled replay {replay_ms:.2f} ms/frame (device busy over it "
          f"{ms_all / replay_ms:.1%})")
    classes = collections.defaultdict(lambda: [0.0, 0.0])
    for e in events:
        classes[_op_class(e.key)][0] += e.count / frames
        classes[_op_class(e.key)][1] += e.device_us / frames / 1e3
    print("device time by class of operation, per replayed frame (ms, share, kernels):")
    for cls, (n, ms) in sorted(classes.items(), key=lambda kv: -kv[1][1]):
        print(f"  {cls}: {ms:.2f} ms, {ms / ms_all:.1%}, {n:.0f}")
    top = sorted(events, key=lambda e: -e.device_us)[:12]
    print("  the longest kernels: " + "; ".join(
        f"{_op_class(e.key)} {e.device_us / frames / 1e3:.3f} ms x{e.count // frames} "
        f"{_demangle(e.key)[:60]}" for e in top))
    seen = {name: n for name, (n, _) in k1.items()}
    if seen != want:
        fail(f"the profiler saw {seen} K1 kernels per {label} frame, expected {want}")


def main() -> None:
    card, clock = phase_card()
    # fp32 products stay fp32 on the card (the fp32 kernels' plain versions
    # and library calls); bf16 work is untouched by these flags
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    k1_err, k1_fp32_err, k1_wide_err, k1_wide_fp32_err = phase_k1()
    print(f"K1 fp32 launches in the tiny paths (warm-ups and captures): "
          f"{phase_tiny() + phase_tiny_kl()}")
    k1_launches, main = phase_main(card)
    k3_launches, pallas_program = phase_taesd_pallas(card, main)
    programs, replay_ms = phase_graph(card, main, pallas_program)
    phase_production(card, main, programs)
    phase_engine_call(card, main)
    del programs, pallas_program
    ref_launches, ref = phase_reference(card, main)
    phase_engine(card, main)
    kl = phase_kl(card)
    fp32_frame = phase_fp32_frame(card)
    phase_bench(main[0])
    k1_times, k1_fp32_times, k1_wide_times, k1_wide_fp32_times = phase_k1_times(card, clock)
    k2_res = phase_k2(card, clock)
    k3_res = phase_k3(card, clock)
    k3_fp32_res = phase_k3_fp32(card, clock)
    k2_launches = phase_k2_path(main[2])
    k3_fp32_launches = phase_taesd_routes(card, main[0])
    phase_profile(card, main, replay_ms)
    phase_kl_profile(card, kl)
    phase_fp32_profile(card, fp32_frame)
    phase_ref_profile(card, ref)
    k1_src, k3_src = "videosd_tpu/ops/pallas/flash_attention.py:83", "videosd_tpu/ops/pallas/taesd_conv.py:231"
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention.cu", "replaces": k1_src,
         "launches": k1_launches + ref_launches, "max_abs_err": k1_err, **k1_times},
        {"name": "flash_attention_fp32", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention_fp32.cu", "replaces": k1_src,
         "launches": fp32_frame["launches"], "max_abs_err": k1_fp32_err, **k1_fp32_times},
        {"name": "flash_attention_wide", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention_wide.cu", "replaces": k1_src,
         "launches": kl["launches"], "max_abs_err": k1_wide_err, **k1_wide_times},
        {"name": "flash_attention_wide_fp32", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention_wide_fp32.cu", "replaces": k1_src,
         "launches": kl["fp32_launches"], "max_abs_err": k1_wide_fp32_err, **k1_wide_fp32_times},
        {"name": "fused_preprocess_sobel", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/preprocess.cu",
         "replaces": "videosd_tpu/ops/pallas/preprocess_kernel.py:64",
         "launches": k2_launches, **k2_res},
        {"name": "taesd_conv3x3", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/taesd_conv.cu", "replaces": k3_src,
         "launches": k3_launches, **k3_res},
        {"name": "taesd_conv3x3_fp32", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/taesd_conv_fp32.cu", "replaces": k3_src,
         "launches": k3_fp32_launches, **k3_fp32_res},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
