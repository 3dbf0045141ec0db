#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``videosd_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit from nvidia-smi;
2. build: compile the package's CUDA kernels from ``videosd_tpu_torch/csrc``;
3. kernel K1 (flash attention) against its plain PyTorch version in bf16 at
   the main path's shapes and at further ones (keys != queries, batch 2,
   d = 64, the sd21 frame's three shapes of heads of 64 and the SDXL frame's
   two), at every kind of head dim up to 256 (the tiny family's 8 and
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
   queries included; and K1 at the sd15 frame's shapes under 2-way tensor
   parallelism (4 of the 8 heads a rank);
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
6b'''. the server (``videosd_tpu_torch/server``): five protocol sessions
   (``server/protocol.py``, the per-connection code of ``/ws``; three raw
   RGB24 clients, one packed I420, one JPEG with the ``jpeg`` option where
   a codec runs) over one ``Engine`` on the phase-5 bundle, 30 frames each
   with two in flight: frames/s and p50 per stream beside the engine
   phase's (6b'');
   every reply the engine's output for its frame, in the order sent; one
   dispatched batch again through ``build_frame_program`` bit for bit; a
   2-second trace during traffic summarized by block with the engine's
   ``kernel_symbols()`` (unet/... and controlnet present, at most 10 %
   unmapped, no K1 outside attention blocks); where aiohttp imports,
   ``create_app`` on 127.0.0.1 driven over ``/healthz``, ``/stats``,
   ``/ws`` and ``/profile``; a ``{"server": ...}`` JSON line; then CUDA-only
   profiler sessions around 256 K1 launches each, which may lose at most
   16 of them (fault F7, measured: after a session of ~100k device events
   later sessions lose their last few);
6d. the sd21 frame (stabilityai/sd-turbo topology at full widths, OpenCLIP
   ViT-H text, its ControlNet, TAESD, 512x512, 4 steps, bf16, random
   weights): replay equal to eager bit for bit, 84 K1 launches per frame at
   d = 64, replayed ms/frame, peak memory and FLOPs; its profile last;
6f. the SDXL frame (stabilityai/stable-diffusion-xl-base-1.0 at full widths:
   UNet 320/640/1280 with transformer depth 0/2/10 and heads of 64, CLIP
   ViT-L/14 and OpenCLIP bigG, text_time, its ControlNet, TAESD; 1024x1024,
   4 steps, bf16, random weights): the prompt's [1, 77, 2048] context and
   [1, 1280] pooled embedding; the frame of ``tools/sdxl_prod.py`` (no
   ControlNet) and the ControlNet frame, each replayed equal to eager bit
   for bit with exactly 280 and 416 K1 launches per frame at capture,
   ms/frame, peak memory and FLOPs; one stream through an ``Engine`` of
   ``family: sdxl`` equal to a direct ``build_frame_program`` call; then
   ``python -m videosd_tpu_torch.tools.sdxl_prod`` in a process of its own;
   its profile last of all;
6e. training: the sd15 UNet train step (``train/step.py``, fp32, 512x512
   frames, batch 2, AdamW) and the ControlNet train step against the frozen
   UNet (Adafactor), three steps each on random weights: finite losses, a
   finite gradient for every parameter, a nonzero one for each projection
   of a routed self-attention, exactly 15 and 21 fp32 K1 launches a step
   (K1' forward: ``models/layers.py::FlashAttentionRecompute``), the first
   step's gradients within 1e-3 per tensor of the same step with every
   attention on the plain math, step ms and peak memory; then
   ``tools/train_toy.py`` (tiny, 64x64) and ``tools/turbo_ladder.py`` on
   its checkpoint, each a process of its own; after the K1 timings below,
   K1' at the main path's three shapes in bf16 and fp32 (its output held to
   K1's bars, dq/dk/dv to autograd through the plain version), its forward
   + backward timed beside its bound, the plain version's and SDPA's;
6g. LoRA and int8 w8a8 (``io/lora.py``, ``ops/quant.py``, ``models/layers.py::
   LinearW8A8``): (a) a rank-8 PEFT file over every UNet attention
   projection and feed-forward and a kohya file over the text tower, both
   from seeded random tensors, fused on the card into a copy of the
   phase-5 bundle, the fused state dicts equal to the same fusion on the
   CPU bit for bit, its frame replayed equal to eager with 84 K1 launches;
   (b) ``quant: int8`` on that bundle: the quantized-linear counts, 440
   ``torch._int_mm`` and 84 K1 launches per frame at capture, replay equal
   to eager, ms/frame beside the bf16 frame in alternating turns, UNet +
   ControlNet weight bytes and peak memory int8 beside bf16, the int8
   frame's PSNR against the bf16 frame, ``_int_mm``'s device time per
   frame, and three quantized linears at the frame's shapes whose int32
   products equal the CPU's bit for bit; (c) an ``Engine`` with ``lora:``
   and ``quant: int8`` serving one stream, its reply equal to a direct
   ``build_frame_program`` call on a bundle fused and quantized the same
   way, ``swap_params`` with the plain base state dicts keeping the
   reply, ``stats()`` showing both; (d) the SDXL 1024x1024 frame without
   the ControlNet in int8 beside phase 6f's bf16 frame; (e) the tools
   (``flicker``, ``temporal_gate``, ``ref_gate``, ``taesd_ab``, ``soak``)
   each in a process of its own, their identity rows held;
6h. more than one device (``videosd_tpu_torch/parallel``) on this one card:
   the mesh's slots repeat ``cuda:0`` (printed), so the numerics, partial
   sums, launch counts and placement are real and no traffic crosses cards:
   (a) ``verify_flagship_dp_tp`` in fp32 (TF32 off), sd15 512x512 4-step
   ControlNet + TAESD on a (2 data x 2 model) mesh against the
   single-device program (images within 2 levels, latents 1e-4; their
   max/mean |d| and the latents' relative L2 printed); (b) bf16 on (2 x 1)
   at batch 2: each row equal bit for bit to the single-device program on
   that row alone, each row's replay equal to its eager body; (c) bf16 on
   (1 x 2): 168 K1 launches a frame at capture (84 x 2, at [4,4096,40],
   [4,1024,80] and [4,256,160]), the image within 50 dB of the
   single-device one, replay = eager, replayed ms/frame in turns with the
   single-device frame; (d) ``PipelinedFrameEngine`` on 2 stages of (1 x 1):
   the fp32 verify, the bf16 frame within 50 dB of the single-device image
   and its eager ms/frame, ``run_pipelined`` over 2 microbatches equal to
   ``run``, each stage's weight bytes from the placement record; (e) an
   ``Engine(ServerConfig(gpus=2), devices=[cuda:0, cuda:0])``'s reply equal
   bit for bit to a direct ``ShardedFrameEngine`` call, ``stats()["devices"]``
   ``{"data": 2, "model": 1}``, and ``Engine(ServerConfig(gpus=2))`` without
   ``devices=`` logging the fallback and serving on ``{"data": 1, "model":
   1}``;
6i. the sharded train step in one process, inside 6e after the UNet
   steps: ``make_train_step(sched_cfg, mesh=...)`` on a (2 data x 2 model)
   mesh of ``cuda:0`` slots, sd15 fp32 512x512 batch 2, AdamW, TF32 off,
   three steps from the single-device step's start and draws: 60 fp32 K1
   launches a step (2 rows x 2 model ranks x 15), the first step's
   gradients within 1e-3 per tensor of the plain-attention pass's, every
   parameter with a finite gradient, the weights after each step within
   1e-5 relative L2 of the single-device step's, step ms and peak memory,
   then two more steps with their parts timed (placement loads, forwards,
   gradient reduction, optimizer, the rest);
   after the K1 timings, K1' in fp32 at the sharded step's shapes
   ([4,4096,40], [4,1024,80], [4,256,160]) timed beside its bound, the
   plain version's and SDPA's;
6j. two processes (``chip_smoke.py --mesh-child``), each on ``cuda:0`` with
   4 slots, joined by ``init_distributed`` over ``gloo`` (NCCL refuses two
   ranks on one card; the backend printed), each under a timeout: (a)
   JAX's psum case over the (4 x 2) mesh across them ([12, 16]; a model
   row across the processes raises); (b) the sd15 bf16 512x512 4-step
   CN+TAESD serving program at batch 2 on a (2 x 1) mesh of one slot a
   process, each process's row equal bit for bit to the single-device
   program on it; (c) the sharded train step across the processes at sd15
   fp32 256x256 batch 2 (AdamW, two steps, each step's parts timed): both
   processes' weights equal, and in rank 0 the one-process step on a
   (2 x 1) mesh from the same start and draws (first step's gradients
   within 1e-4 of each tensor's largest, weights within 1e-5 relative L2),
   the one-process step against itself (under the same bar) and under
   ``cudnn.deterministic``, and the step with its all-reduce skipped (a
   planted fault, which must miss the bar); each process's peak memory;
6c. K1's device time per shape beside its bound, the plain version's time
   and one ``scaled_dot_product_attention`` call's (timed here, used
   nowhere in the port; the reference mode's banked shapes among them),
   and at the main path's shapes and the tensor-parallel ones under every
   number of query rows per block the kernel can run: the first profiler sessions
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
    per frame), over two replayed reference frames, sd21 frames and SDXL
    frames (K1's 280).

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
import contextlib
import copy
import dataclasses
import json
import logging
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from videosd_tpu_torch import _build, bench  # noqa: E402
from videosd_tpu_torch.models import layers  # noqa: E402
from videosd_tpu_torch.models import unet as unet_mod  # noqa: E402
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
from videosd_tpu_torch.io.safetensors import write_safetensors  # noqa: E402
from videosd_tpu_torch.ops.sobel import div_rn, sobel_control_image  # noqa: E402
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
from videosd_tpu_torch.tools.turbo_ladder import structured_frame  # noqa: E402
from videosd_tpu_torch.train import optim  # noqa: E402
from videosd_tpu_torch.train import step as train_step  # noqa: E402

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
# K1's shapes on the sd21 frame's path at 512x512, as (B, H, Sq, Sk, d): heads
# of 64 (5, 10 and 20 of them at 320, 640 and 1280 channels) over 64^2, 32^2
# and 16^2 latents
K1_SD21 = [(1, 5, 4096, 4096, 64), (1, 10, 1024, 1024, 64), (1, 20, 256, 256, 64)]
# K1's shapes on the SDXL frame's path at 1024x1024, as (B, H, Sq, Sk, d): heads
# of 64 (10 and 20 at 640 and 1280 channels) over 64^2 and 32^2 latents (the
# 320-channel stage holds no attention)
K1_SDXL = [(1, 10, 4096, 4096, 64), (1, 20, 1024, 1024, 64)]
# K1's shapes on the sd15 512^2 frame under 2-way tensor parallelism (phase
# 6h), as (B, H, Sq, Sk, d): each rank runs 4 of the 8 heads, so each of the
# main path's attentions is two launches of half the heads
K1_TP2 = [(1, 4, 4096, 4096, 40), (1, 4, 1024, 1024, 80), (1, 4, 256, 256, 160)]
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
K1_TIMED["bf16"] += K1_SDXL  # the SDXL frame's two shapes, in the kernels line too
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
# the server phase: protocol sessions over one Engine (max_batch 4) on the
# phase-5 bundle, frames per stream, frames each client keeps in flight, the
# seconds of the trace taken during traffic, and the largest share of the
# traced device time the rollup by block may leave unmapped
SERVER_FRAMES, SERVER_IN_FLIGHT, SERVER_TRACE_S, SERVER_UNMAPPED_PCT = 30, 2, 2.0, 10.0
# the server phase's process is killed after this many seconds (it takes ~90)
SERVER_CHILD_S = 300
# CUDA-only profiler sessions taken after the server phase's traced ones (F7),
# the K1 launches each spans, and the events each may lose
# (_profiler_after_server; videosd_tpu_torch/profiler_probe.py measured 0-5
# lost a session after one of 100k-300k events, the server's traces 4)
F7_SESSIONS, F7_LAUNCHES, F7_LOST = 5, 256, 16
# blocks of the frame that hold no attention: K1 placed there is misplaced
NO_ATTENTION_BLOCKS = ("preprocess", "vae_encode", "vae_decode", "postprocess", "stage",
                       "scheduler", "outputs")
# K1 launches per sd21 512^2 4-step CN frame: the sd15 topology's 15 routed
# attentions a UNet pass and 6 a ControlNet call, at d = 64
K1_SD21_PER_FRAME = 84
SD21_FRAMES = 10
# K1 launches per SDXL 1024^2 4-step frame, without and with the ControlNet:
# per UNet pass 10 at [10, 4096, 64] (down1 and up1: 2 and 3 transformers of
# depth 2) and 60 at [20, 1024, 64] (down2 2 x 10, mid 10, up0 3 x 10); per
# ControlNet call 4 and 30
K1_SDXL_PER_FRAME = {False: 4 * 70, True: 4 * 104}
K1_SDXL_SHAPE_LAUNCHES = {False: (40, 240), True: (56, 360)}
SDXL_FRAMES, SDXL_SIDE = 8, 1024
# tools/sdxl_prod.py in a process of its own: its arguments and time limit
SDXL_PROD_ARGS = ["videosd_tpu_torch.tools.sdxl_prod", "--size", "1024", "--steps", "4",
                  "--frames", "4"]
SDXL_PROD_S = 300
# phase 6g: LoRA and int8 w8a8 on the serving paths.  The adapters: rank 8,
# a PEFT file over every UNet attention projection and feed-forward (16
# transformer blocks x 10 modules) at scale 0.8, its halves drawn with the
# standard deviations LORA_UNET_STD (down, up), and a kohya file over every
# projection of the text tower (12 layers x 6, alpha 4, both halves 0.02)
# at scale 1
LORA_RANK, LORA_SCALES = 8, (0.8, 1.0)
LORA_UNET_STD = (0.02, 0.1)
LORA_UNET = re.compile(r"\.(attn[12]\.to_(q|k|v|out\.0)|ff\.net\.(0\.proj|2))\.weight$")
LORA_CLIP = re.compile(r"\.(self_attn\.(q|k|v|out)_proj|mlp\.fc[12])\.weight$")
LORA_UNET_MODULES, LORA_CLIP_MODULES = 160, 72
# quant: int8 at the default policy (JAX's counts, tests/test_torch_port_quant.py):
# the ff pair of all 16 UNet blocks and the six attention projections of the
# 11 blocks of 640 channels or more; the ControlNet's 7 and 5
INT8_SD15_COUNTS = {"unet": {"quantized_linears": 98, "plain_linears": 87},
                    "controlnet": {"quantized_linears": 44, "plain_linears": 39}}
# torch._int_mm calls per sd15 512^2 4-step CN frame: a block of 640 channels
# or more makes 6 (fused qkv, to_out, the cross-attention's to_q and to_out,
# ff proj and out), a 320 one 2 (ff); UNet 5 x 2 + 11 x 6 = 76, ControlNet
# 2 x 2 + 5 x 6 = 34, each step.  SDXL without the ControlNet: 70 blocks, all
# of 640 channels or more
INT_MM_SD15, INT_MM_SDXL = 4 * (76 + 34), 4 * 70 * 6
# The UNet adapters held on their own: the fused UNet's noise prediction
# against the base UNet's on the same inputs (the base prompt embeddings,
# so the text-tower adapters cannot move it; nor can they move the frame,
# which takes the embeddings as an input), relative L2 at least
# LORA_EPS_REL_MIN, and the LoRA frame at most LORA_PSNR_MAX_DB from the
# base frame.  Readings on an H100 (PERF.md): 0.1398 and 55.88 dB;
# 0 and inf without the UNet adapters; the phase also reads the UNet file
# fused at half its scale, which must fall below the bar
LORA_EPS_REL_MIN, LORA_PSNR_MAX_DB = 0.1, 60.0
# int8 against bf16 on the same LoRA weights: the noise prediction within
# INT8_EPS_REL_MAX relative L2 and the frame above INT8_PSNR_DB, and the
# int8 UNet bit for bit its w8a8 linears in plain PyTorch (_w8a8_plain).
# Readings: sound 1.475e-2 and 64.46 dB; with each fault of W8A8_FAULTS
# patched in, which the phase reads again every run: 1.763e-2 and 64.12 dB,
# 1.485e-2 and 64.49 dB (within the noise: only the bit-for-bit check
# sees it), 2.340e-2 and 63.27 dB, 4.228e-2 and 61.37 dB
INT8_EPS_REL_MAX, INT8_PSNR_DB = 1.6e-2, 62.0
W8A8_FAULTS = ("the scale over the first token", "the scale over the first 64 channels",
               "codes truncated", "the weight scales reversed")
# the eager bf16 and int8 frames in alternating turns of this many frames each
INT8_TURNS, INT8_TURN_FRAMES = 4, 5
# the tools, each a process of its own: on the sd15 random bundle at 512^2
# with few frames, one at a time: flicker, taesd_ab, ref_gate's frames/s,
# and a half-minute soak of 2 streams (a minute until phase 6h joined the
# run); beside the soak, at once, the two gates
# on the committed toy checkpoint at 64^2 (for their identity rows only:
# they time nothing)
TOY_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "toy_tiny_ckpt")
TOOL_RUNS_TOY = {
    "temporal_gate": ["videosd_tpu_torch.tools.temporal_gate", "--weights", TOY_CKPT, "--size",
                      "64", "--frames", "24", "--every", "2", "4", "8"],
    "ref_gate": ["videosd_tpu_torch.tools.ref_gate", "--weights", TOY_CKPT, "--size", "64",
                 "--frames", "24", "--sf", "0", "0.5", "1", "--no-fps"],
}
TOOL_RUNS_CARD = {
    "flicker": ["videosd_tpu_torch.tools.flicker", "--family", "sd15", "--size", "512",
                "--frames", "6"],
    "taesd_ab": ["videosd_tpu_torch.tools.taesd_ab", "--size", "512", "--pairs", "2",
                 "--frames", "10", "--variants", "unpacked,packed,pallas"],
    "ref_gate_fps": ["videosd_tpu_torch.tools.ref_gate", "--family", "sd15", "--size", "512",
                     "--fps-only"],
    "soak": ["videosd_tpu_torch.tools.soak", "--minutes", "0.5", "--streams", "2", "--family",
             "sd15", "--size", "512", "--sample-every", "5"],
}
TOOL_S = 300
# taesd_ab's routes against the unpacked one: the packed and K3 routes sum
# in other orders (phase 6's taesd_pallas frame measured 64.92 dB)
TAESD_AB_PSNR_DB = 40.0
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


# the training phase (6e).  K1' (models/layers.py::FlashAttentionRecompute: K1
# forward writing each row's log-sum-exp, then the backward kernel pair of
# csrc/flash_attention_bwd.cu / flash_attention_bwd_fp32.cu, which recompute
# the logits from it) at the main path's three shapes, the sharded step's and
# K1P_EXTRA, in bf16 and fp32: its output held to K1's bars; dq/dk/dv, fp32,
# to the function's gradient in fp64 within 1e-3 of each one's largest |value|
# (3xTF32 products, fp32 sums: ~1e-5 on the card), bf16 to the plain
# version's gradient on the inputs in fp32 within 2^-6 of it (two bf16 ulps
# at the top binade: P and dS are rounded to bf16 before their products, as
# the plain version rounds its weights, and the gradients once)
K1P_GRAD_REL_FP32, K1P_GRAD_REL_BF16 = 1e-3, 2.0 ** -6
# further K1' shapes, as (B, H, Sq, Sk, d): the banked keys of the reference
# pass at d = 40 (Sk != Sq) and the sd21/SDXL heads of 64
K1P_EXTRA = [(1, 8, 4096, 8192, 40), (1, 10, 1024, 1024, 64)]
# the sd15 train steps: 512^2 frames (64^2 latents), batch 2, fp32, AdamW (the
# UNet) and Adafactor (the ControlNet against the frozen UNet) at lr 2e-4,
# three steps each (the first, the warm-up, on explicit t and noise, its
# gradients held to the same step with every attention on the plain math:
# |g - g_plain| <= 1e-3 |g_plain| in L2 per tensor; the kernels' fp32 forward
# is ~1e-6 relative off the plain one, which the backward carries through)
TRAIN_SIDE, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR, TRAIN_T_MAX = 512, 2, 3, 2e-4, 600
TRAIN_GRAD_REL = 1e-3
# K1 launches per train step: the UNet's 15 routed self-attentions; with the
# ControlNet, its 6 beside them.  Each that is K1' (its q, k or v wants a
# gradient) launches the backward kernel pair once (_k1p_applied)
K1_PER_UNET_STEP, K1_PER_CN_STEP = 15, 21
# the sharded UNet step (6i) on a (2 data x 2 model) mesh of cuda:0 slots:
# each data row runs the UNet on its half of the batch, and every routed
# attention splits over the 2 model ranks (8 heads, 4 a rank): 2 x 2 x 15
# launches a step, 20 at each of [4,4096,40], [4,1024,80] and [4,256,160].
# Its weights after each step against the single-device step's, by relative
# L2 over the whole model: the two sum the same products in other orders
# (row-split GEMMs, the ranks' partial sums, the rows' gradient mean), and
# AdamW's first steps are ~lr * sign(g), so an element whose gradient cancels
# to rounding size may move by ~lr either way: 1e-5 of the weights' norm
K1_PER_MESH_STEP, K1P_PER_MESH_SHAPE, MESH_TRAIN_REL_L2 = 60, 20, 1e-5
# then this many more steps, each with its parts timed (_step_parts)
MESH_PART_STEPS = 2
# the routed self-attentions' projections, by block: down 0-2 x 2 and up 1-3 x
# 3 transformer blocks in the UNet, down 0-2 x 2 in the ControlNet (the mid
# block's 64 tokens stay on the plain route)
ROUTED_QKV = re.compile(r"^(down_blocks\.[012]|up_blocks\.[123])\.attentions\.\d+\."
                        r"transformer_blocks\.0\.attn1\.to_[qkv]\.weight$")
# train_toy on the card (tiny, 64^2, a few hundred steps a stage), then the
# turbo ladder on its checkpoint at 64^2
TOY_ARGS = ["--family", "tiny", "--size", "64", "--ae-steps", "300", "--unet-steps", "300",
            "--cn-steps", "200", "--batch", "16"]
TOY_CHILD_S = 300


_T0 = time.perf_counter()


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# lines of a failed child process's output repeated on standard error
CHILD_TAIL_LINES = 40


def fail_child(label: str, rc: int, lines: list) -> None:
    """Fails the run for a child process that exited ``rc``: its last
    CHILD_TAIL_LINES lines of output (stdout and stderr merged) go to this
    process's standard error, whose end is what a reader of a failed run
    sees first, and the failure names the reason the child gave (its own
    FAIL line, else faulthandler's timeout, else its last line: a
    traceback's exception)."""
    tail = [ln.rstrip("\n") for ln in lines if ln.strip()][-CHILD_TAIL_LINES:]
    sys.stderr.write("".join(f"  [{label}] {ln}\n" for ln in tail))
    said = [ln for ln in tail if ln.startswith("chip_smoke: FAIL:")]
    hung = [ln for ln in tail if ln.startswith("Timeout (")]  # faulthandler's stacks follow
    reason = (said[-1] if said else f"{hung[-1]} (its stacks are above)" if hung
              else tail[-1] if tail else "no output")
    fail(f"{label} exited {rc}: {reason}")


def _note(msg: str) -> None:
    """A progress line, with the seconds since the process started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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
    return ([(1, s[0], s[1], s[1], s[2]) for s in K1_SHAPES] + K1_EXTRA + K1_SD21 + K1_SDXL
            + K1_TP2)


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
    bf16_cases = _k1_cases() + [c for c in K1_TIMED["bf16"] if c not in _k1_cases()]
    for kind, dtype, cases in (("bf16", torch.bfloat16, bf16_cases),
                               ("fp32", torch.float32, K1_TIMED["fp32"])):
        main_rows, per_shape, banked, sd21, sdxl, tp2 = [], [], [], [], [], []
        for b, h, sq, sk, d in cases:
            row = _k1_time(gen, b, h, sq, sk, d, dtype, card, clock)
            tensors = {key: row.pop(key) for key in ("q", "k", "v", "qf", "kf", "vf")}
            if (b, h, sq, sk, d) in K1_TIMED[kind]:
                per_shape.append(row)
            if kind == "bf16" and (b, h, sq, sk, d) in K1_BANKED:
                banked.append(row)
            if kind == "bf16" and (b, h, sq, sk, d) in K1_SD21:
                sd21.append(row)
            if kind == "bf16" and (b, h, sq, sk, d) in K1_SDXL:
                sdxl.append(row)
            if kind == "bf16" and (b, h, sq, sk, d) in K1_TP2:
                tp2.append(row)
            if sq == sk and b == 1 and (h, sq, d) in K1_SHAPES:
                main_rows.append(row)
            if kind == "bf16" and sq == sk and b == 1 and (
                    (h, sq, d) in K1_SHAPES or (b, h, sq, sk, d) in K1_TP2):
                # every number of rows per block the kernel can run this shape with,
                # held to the bar and timed: what block_rows' rule rests on (the
                # tensor-parallel shapes launch half the blocks)
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
        if sd21:  # the sd21 frame's shapes (d = 64), 28 launches of each per frame
            result[kind]["sd21_per_shape"] = sd21
            slower = [r["shape"] for r in sd21 if r["device_ms"] > r["library_ms"]]
            print(f"K1 at the sd21 frame's shapes (d = 64): device ms "
                  + ", ".join(f"{r['shape']} {r['device_ms']:.4f} (bound {r['bound_ms']:.4f}, "
                              f"SDPA {r['library_ms']:.4f})" for r in sd21)
                  + f"; slower than SDPA at {slower or 'none'}")
        if sdxl:  # the SDXL 1024^2 frame's shapes: K1's device time per frame
            result[kind]["sdxl_per_shape"] = sdxl
            for cn, counts in K1_SDXL_SHAPE_LAUNCHES.items():
                per = {key: sum(n * r[key] for n, r in zip(counts, sdxl))
                       for key in ("device_ms", "bound_ms", "library_ms", "plain_ms")}
                print(f"K1 per SDXL 1024x1024 4-step frame {'with' if cn else 'without'} the "
                      f"ControlNet ({counts[0]} + {counts[1]} launches): device "
                      f"{per['device_ms']:.3f} ms, bound {per['bound_ms']:.3f} ms "
                      f"({per['bound_ms'] / per['device_ms']:.1%}), SDPA "
                      f"{per['library_ms']:.3f} ms, plain {per['plain_ms']:.3f} ms ({card})")
        if tp2:  # the sd15 frame at 2-way tensor parallelism: 56 launches of each a frame
            result[kind]["tp2_per_shape"] = tp2
            per = {key: sum(2 * K1_PER_FRAME // 3 * r[key] for r in tp2)
                   for key in ("device_ms", "bound_ms", "library_ms", "plain_ms")}
            print(f"K1 per sd15 512x512 4-step frame at 2-way tensor parallelism "
                  f"({2 * K1_PER_FRAME} launches, {2 * K1_PER_FRAME // 3} at each shape): device "
                  f"{per['device_ms']:.3f} ms, bound {per['bound_ms']:.3f} ms "
                  f"({per['bound_ms'] / per['device_ms']:.1%}), SDPA {per['library_ms']:.3f} ms, "
                  f"plain {per['plain_ms']:.3f} ms ({card})")
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
    """Sets every kernel wrapper's launch count (and the int8 products') to 0."""
    fa.launches = fa.launches_fp32 = fa.launches_wide = fa.launches_wide_fp32 = 0
    fa.launches_bwd = fa.launches_bwd_fp32 = 0
    k2.launches = k3.launches = k3.launches_fp32 = layers.int_mm_launches = 0


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


def _check_frame(name: str, out, side: int = 512) -> None:
    img, lat = out[0], out[1]
    if img.shape != (1, side, side, 3) or img.dtype != torch.uint8:
        fail(f"{name}: image {tuple(img.shape)} {img.dtype}")
    if (lat.shape != (1, side // 8, side // 8, 4)
            or not all(torch.isfinite(t).all() for t in out[1:])):
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


class _ErrorLog(logging.Handler):
    """Collects the ERROR records of the named loggers while it is entered."""

    def __init__(self, *names):
        super().__init__(level=logging.ERROR)
        self.names, self.errors = names, []

    def emit(self, record):
        self.errors.append(self.format(record))

    def __enter__(self):
        for name in self.names:
            logging.getLogger(name).addHandler(self)
        return self

    def __exit__(self, *exc):
        for name in self.names:
            logging.getLogger(name).removeHandler(self)


def phase_engine(card: str, main) -> dict:
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
    import threading

    from videosd_tpu_torch.runtime.engine import Engine

    bundle = main[0]
    with _ErrorLog("videosd_tpu_torch.engine") as log:
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
    if log.errors:
        fail(f"the engine logged {len(log.errors)} error(s); the first: {log.errors[0]}")
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
    return {"steady_fps": steady, "fps": fps,
            "p50_ms": [statistics.median(v) for v in lat[:ref_sid]]}


def _jpeg_codec() -> str:
    """The JPEG codec the server would run: libjpeg through the native
    binding, else PIL, else none."""
    from videosd_tpu_torch.runtime import jpegcodec

    if jpegcodec.native_available():
        return "native"
    try:
        import PIL  # noqa: F401
    except ImportError:
        return "none"
    return "pil"


def _server_payloads(kind: str, cam, frames: int) -> list:
    """A client's binary messages: raw RGB24 or packed I420 behind the u16
    height and width, or JPEG blobs; the camera pans 8 pixels a frame."""
    from videosd_tpu_torch.runtime import jpegcodec

    out = []
    for n in range(frames):
        img = np.ascontiguousarray(np.roll(cam, 8 * n, 1))
        head = struct.pack("<HH", *img.shape[:2])
        if kind == "rgb":
            out.append(head + img.tobytes())
        elif kind == "i420":
            out.append(head + rgb_to_i420_host(img).tobytes())
        else:
            out.append(jpegcodec.encode_rgb(img, quality=90))
    return out


def _check_by_block(label: str, summary: dict) -> None:
    """The rollup by block placed every graph replay by position, holds
    unet/... and controlnet entries, leaves at most SERVER_UNMAPPED_PCT of
    the device time unmapped, and places every K1 event in a transformer
    block of the UNet or the ControlNet (none in a block without attention,
    none by name)."""
    if "by_block" not in summary:
        fail(f"{label}: the summary has no by_block ({summary.get('error')})")
    blocks = {e["name"]: e["pct"] for e in summary["by_block"]}
    k1_blocks = {b for op in summary["ops"] if "flash_fwd_kernel" in op["name"]
                 for b in op["blocks"]}
    print(f"{label}: device time {summary['device_time_ms']:.2f} ms traced; by block (% of it): "
          + ", ".join(f"{n} {p}" for n, p in blocks.items())
          + f"; events placed by {summary['mapped_by']}; graph replays {summary['graph_replays']}"
          f"; K1's blocks {sorted(k1_blocks)}")
    replays = summary["graph_replays"]
    if not replays["replays"] or replays["placed"] != replays["replays"]:
        fail(f"{label}: {replays['placed']} of {replays['replays']} graph replays placed by "
             f"position")
    if not any(b.startswith("unet/") for b in blocks) or not any(
            b == "controlnet" or b.startswith("controlnet/") for b in blocks):
        fail(f"{label}: by_block lacks unet/... or controlnet entries: {sorted(blocks)}")
    if blocks.get("(unmapped)", 0.0) > SERVER_UNMAPPED_PCT:
        fail(f"{label}: {blocks['(unmapped)']}% of the device time is unmapped "
             f"(bound {SERVER_UNMAPPED_PCT}%)")
    wrong = sorted(b for b in k1_blocks if b.startswith(NO_ATTENTION_BLOCKS)
                   or not b.startswith(("unet/", "controlnet/")))
    if not k1_blocks or wrong:
        fail(f"{label}: K1 placed in blocks without attention {wrong} (or nowhere)")


def phase_server_process(card: str, engine_res: dict) -> int:
    """Runs phase_server in a process of its own (``chip_smoke.py --server``,
    on a bundle drawn as phase 5's: sd15 bf16, seed 0) and returns its K1
    launches.  Its profiler sessions (CPU and CUDA, with the frame's
    ranges) left the CUDA-only sessions that this process takes later
    seeing no kernels (twice on an H100); in a process of their own
    they leave this one's untouched, and its frames are timed before any
    profiler session of that process.  The child's lines are passed on as
    they come, so a child that stops shows where; one that outlives
    SERVER_CHILD_S is killed and fails the phase."""
    import threading

    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--server",
                              json.dumps({"card": card, **engine_res})],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list = []

    def relay():
        for line in child.stdout:
            lines.append(line)
            sys.stdout.write(line)
            sys.stdout.flush()

    reader = threading.Thread(target=relay, daemon=True)
    reader.start()
    try:
        rc = child.wait(timeout=SERVER_CHILD_S)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        reader.join(timeout=10)
        fail_child(f"the server phase's process (killed after {SERVER_CHILD_S} s)",
                   child.returncode, lines)
    reader.join(timeout=10)
    if rc != 0:
        fail_child("the server phase's process", rc, lines)
    result = [ln for ln in lines if ln.startswith('{"server_launches"')]
    if not result:
        fail("the server phase's process printed no result")
    return json.loads(result[-1])["server_launches"]


def server_main(arg: str) -> None:
    """The server phase's process (``chip_smoke.py --server JSON``): the
    card's name from the parent, the phase-5 bundle drawn again.  Every
    thread's stack is dumped, and the process ends, if it is still running
    SERVER_CHILD_S - 30 seconds after it started."""
    import faulthandler

    faulthandler.dump_traceback_later(SERVER_CHILD_S - 30, exit=True)
    engine_res = json.loads(arg)
    card = engine_res.pop("card")
    bundle = ModelBundle.random("sd15", dtype=torch.bfloat16, device="cuda")
    launches = phase_server(card, (bundle,), engine_res)
    _profiler_after_server(card)
    print(json.dumps({"server_launches": launches}), flush=True)
    _note("server process: result printed, exiting")


def _profiler_after_server(card: str) -> None:
    """Fault F7's check, in the server phase's process after its traced
    sessions (the engine's start_trace/stop_trace and kernel_symbols, and
    ``/profile`` where aiohttp imports): F7_SESSIONS CUDA-only
    torch.profiler sessions, each around F7_LAUNCHES K1 launches, must each
    see all but at most F7_LOST of them.  F7, measured on an H100 (torch
    2.11, ``videosd_tpu_torch/profiler_probe.py``): after one session of
    about 100k device events or more, later sessions of the process lose
    their last few device events (one around a single kernel mostly sees
    none; sessions of 60k leave the later ones whole).  A session around
    one launch is printed beside, not held."""
    q = torch.randn(1, 4096, 320, device="cuda", dtype=torch.bfloat16)

    def session(launches: int) -> int:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fa.flash_attention(q, q, q, num_heads=8)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.self_device_time_total > 0)

    seen = [session(F7_LAUNCHES) for _ in range(F7_SESSIONS)]
    single = [session(1) for _ in range(F7_SESSIONS)]
    print(f"F7: after this process's traced server sessions ({card}), {F7_SESSIONS} CUDA-only "
          f"profiler sessions around {F7_LAUNCHES} K1 launches saw {seen} (at most {F7_LOST} "
          f"lost is held); sessions around one launch saw {single}")
    if min(seen) < F7_LAUNCHES - F7_LOST:
        fail(f"F7: a CUDA-only profiler session after the server's traced sessions lost more "
             f"than {F7_LOST} of {F7_LAUNCHES} K1 launches: {seen}")


def phase_server(card: str, main, engine_res: dict) -> int:
    """6b-3: the server over the port.  Protocol sessions
    (``server/protocol.py``, the per-connection code of ``/ws``) over one
    ``Engine`` (max_batch 4) on the phase-5 bundle: three clients send raw
    RGB24, one packed I420 and, where a JPEG codec runs, one more JPEG
    with the ``jpeg`` option, SERVER_FRAMES frames each with
    SERVER_IN_FLIGHT in flight.  Frames/s over the streams and p50 per
    stream beside the engine phase's numbers; every reply's header and
    size, and every reply equal to what the engine returned for that
    frame, in the order sent; one dispatched batch run again through
    ``build_frame_program`` equal bit for bit, and a reply equal to one of
    its rows; a SERVER_TRACE_S-second trace during traffic through
    ``start_trace``/``stop_trace`` and ``summarize_trace(symbols=
    engine.kernel_symbols())``, as ``/profile`` does, held by
    ``_check_by_block``.  Where aiohttp imports, ``create_app`` also serves
    on 127.0.0.1 and aiohttp's client drives ``/healthz``, ``/stats``,
    ``/ws`` and ``/profile``.  Any logged engine or server error fails the
    phase.  Returns the K1 launches of the phase (the engine's warm-ups and
    captures, counted from 0 just before)."""
    import asyncio
    import threading

    from videosd_tpu_torch.runtime.engine import Engine
    from videosd_tpu_torch.runtime.telemetry import summarize_trace
    from videosd_tpu_torch.server import protocol

    try:
        import aiohttp  # noqa: F401
        have_aiohttp = True
    except ImportError:
        have_aiohttp = False
    codec = _jpeg_codec()
    bundle, side = main[0], ENGINE_SIDE
    kinds = ["rgb", "rgb", "rgb", "i420"] + (["jpeg"] if codec != "none" else [])
    rng = np.random.default_rng(31)
    cams = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8) for _ in kinds]
    payloads = [_server_payloads(kind, cam, SERVER_FRAMES) for kind, cam in zip(kinds, cams)]
    _zero_counts()
    with _ErrorLog("videosd_tpu_torch.engine", "videosd_tpu_torch.server") as log:
        eng = Engine(bundle=bundle, max_streams=len(kinds) + 1, max_batch=4,
                     frame_hw=(side, side))
        t0 = time.perf_counter()
        # five ready streams form a batch of five over max_batch 4, served in
        # the batch-8 bucket: warmed here, so no capture lands in the timing
        eng.warmup(batch_sizes=(1, 2, 4, 8), steps=(4,), height=side, width=side)
        warm_s = time.perf_counter() - t0
        _note(f"server: engine warmed up in {warm_s:.1f} s")
        outputs, calls = collections.defaultdict(dict), collections.Counter()
        recent = collections.deque(maxlen=8)  # the dispatch thread's last program calls
        submit, get_program = eng.submit_frame, eng._get_program

        async def spy_submit(sid, frame):  # what the engine returned for each frame, by order
            i = calls[sid]
            calls[sid] += 1
            out = await submit(sid, frame)
            outputs[sid][i] = out
            return out

        def spy_program(spec, *, ref_mode=False):
            program = get_program(spec, ref_mode=ref_mode)

            def call(*a, **kw):
                out = program(*a, **kw)
                if threading.current_thread().name == "tpu-dispatch":
                    recent.append(dict(spec=spec, args=a, kwargs=kw, out=out))
                return out

            return call

        eng.submit_frame, eng._get_program = spy_submit, spy_program
        queues = [asyncio.Queue() for _ in kinds]
        replies = [[] for _ in kinds]

        def sender(i):
            async def send(payload):
                queues[i].put_nowait(payload)
            return send

        async def client(sess, i, frames=None, until=None):
            """Sends frames keeping SERVER_IN_FLIGHT in flight; latencies (ms)."""
            sent, lat, n = collections.deque(), [], 0

            async def take():
                msg = await asyncio.wait_for(queues[i].get(), 300)
                lat.append((time.perf_counter() - sent.popleft()) * 1e3)
                replies[i].append(msg)

            while (n < frames) if frames is not None else (time.perf_counter() < until):
                sent.append(time.perf_counter())
                await sess.on_binary(payloads[i][n % SERVER_FRAMES])
                n += 1
                if len(sent) >= SERVER_IN_FLIGHT:
                    await take()
            while sent:
                await take()
            return lat

        async def http_check(tmp):
            from aiohttp import ClientSession, web

            from videosd_tpu_torch.server.app import create_app

            runner = web.AppRunner(create_app(engine=eng))
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            base = f"http://127.0.0.1:{runner.addresses[0][1]}"
            _note(f"server: create_app serving at {base}")
            try:
                async with ClientSession() as http:
                    health = await (await http.get(base + "/healthz")).json()
                    ws = await http.ws_connect(base + "/ws")
                    await ws.send_str(json.dumps({"type": "init", "options": {
                        "height": side, "width": side, "prompt": "over http", "seed": 9}}))
                    got, done = [], asyncio.Event()

                    async def traffic():
                        n = 0
                        while not done.is_set() or n < 4:
                            await ws.send_bytes(payloads[0][n % SERVER_FRAMES])
                            got.append(await asyncio.wait_for(ws.receive(), 300))
                            n += 1

                    async def profile():
                        try:
                            r = await http.post(base + f"/profile?seconds=1&dir={tmp}/http")
                            return r.status, await r.json()
                        finally:
                            done.set()

                    (status, body), _ = await asyncio.gather(profile(), traffic())
                    _note(f"server: /profile answered {status}")
                    stats = await (await http.get(base + "/stats")).json()
                    await ws.close()
            finally:
                await runner.cleanup()  # stops the engine
                _note("server: the aiohttp app cleaned up")
            bad = [m for m in got if m.type.name != "BINARY" or len(m.data) != 4 + side * side * 3
                   or struct.unpack("<HH", m.data[:4]) != (side, side)]
            print(f"server over aiohttp on 127.0.0.1: /healthz {health}; /ws {len(got)} replies "
                  f"({len(bad)} malformed); /stats jpeg_codec {stats.get('jpeg_codec')}, "
                  f"frames_out {stats['frames_out']}; /profile {status}")
            if not health.get("ok") or bad or status != 200 or stats.get("jpeg_codec") != codec:
                fail("the aiohttp server answered wrong (see the line above)")
            _check_by_block("/profile over aiohttp", body["summary"])

        async def run(tmp):
            eng.start()
            sessions = [protocol.Session(eng, sender(i)) for i in range(len(kinds))]
            for i, (sess, kind) in enumerate(zip(sessions, kinds)):
                await sess.on_text(json.dumps({"type": "init", "options": {
                    "height": side, "width": side, "prompt": f"stream {i}", "seed": 200 + i,
                    "jpeg": kind == "jpeg"}}))
            t, made = time.perf_counter(), eng.telemetry.frames_out
            lat = await asyncio.gather(*[client(s, i, frames=SERVER_FRAMES)
                                         for i, s in enumerate(sessions)])
            wall, made = time.perf_counter() - t, eng.telemetry.frames_out - made
            _note(f"server: {made} generations timed in {wall:.1f} s")
            eng._get_program = get_program  # the checked batches are the timed window's
            # the trace, during traffic
            until = time.perf_counter() + SERVER_TRACE_S + 1.5
            traffic = asyncio.gather(*[client(s, i, until=until) for i, s in enumerate(sessions)])
            await asyncio.sleep(0.5)
            await eng.start_trace(f"{tmp}/direct")
            _note("server: trace started")
            await asyncio.sleep(SERVER_TRACE_S)
            await eng.stop_trace()
            _note("server: trace stopped and written")
            await traffic
            for sess in sessions:
                sess.close()
            loop = asyncio.get_running_loop()
            t_sym = time.perf_counter()
            symbols = await eng.kernel_symbols()
            t_sym = time.perf_counter() - t_sym
            _note(f"server: kernel_symbols took {t_sym:.1f} s")
            summary = await loop.run_in_executor(
                None, lambda: summarize_trace(f"{tmp}/direct", top=500, symbols=symbols))
            _note("server: trace summarized")
            if have_aiohttp:
                await http_check(tmp)
            else:
                await eng.stop()
            return lat, wall, made, symbols, t_sym, summary

        with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
            lat, wall, made, symbols, t_sym, summary = asyncio.run(run(tmp))
        _note("server: event loop closed")
        eng.submit_frame = submit
    if log.errors:
        fail(f"the engine or server logged {len(log.errors)} error(s); the first: {log.errors[0]}")
    launches = fa.launches
    # every reply: its header and size, and the engine's output for that frame, in order
    for i, kind in enumerate(kinds):
        sid = i  # the sessions opened their streams in order on a fresh engine
        if len(replies[i]) < SERVER_FRAMES or len(outputs[sid]) != len(replies[i]):
            fail(f"stream {i}: {len(replies[i])} replies to {len(outputs[sid])} frames")
        for k, msg in enumerate(replies[i]):
            out = outputs[sid][k]
            if isinstance(msg, dict):
                fail(f"stream {i} ({kind}): reply {k} is an error: {msg}")
            if kind == "jpeg":
                ok = msg[:2] == b"\xff\xd8" and msg == protocol.jpeg_encode(out, eng)
            else:
                ok = (len(msg) == 4 + side * side * 3
                      and struct.unpack("<HH", msg[:4]) == (side, side)
                      and msg == protocol.frame_reply(out, eng))
            if not ok:
                fail(f"stream {i} ({kind}): reply {k} is not the engine's output for frame {k}")
    # a frame whose stream had a newer one waiting shares that one's
    # generation (the engine's latest-wins mailbox): replies/s counts
    # replies, frames/s generations, as the engine phase does
    replies_per_s, fps = len(kinds) * SERVER_FRAMES / wall, made / wall
    p50 = [statistics.median(v) for v in lat]
    # the last dispatched batch whose rows some reply carries (a stream's
    # last frame may be generated after its clients stopped waiting)
    timed = [msg for rs in replies for msg in rs[:SERVER_FRAMES]]
    for last_call in reversed(recent):
        rows = [last_call["out"][0][r].cpu().numpy() for r in range(last_call["spec"].batch)]
        forms = {protocol.frame_reply(r, eng) for r in rows}
        if codec != "none":
            forms |= {protocol.jpeg_encode(r, eng) for r in rows}
        matched = sum(msg in forms for msg in timed)
        if matched:
            break
    again = build_frame_program(bundle, last_call["spec"])(*last_call["args"],
                                                           **last_call["kwargs"])
    same = _same(again, last_call["out"])
    print(f"server, {len(kinds)} protocol sessions ({', '.join(kinds)}) of {side}x{side} frames, "
          f"{SERVER_IN_FLIGHT} in flight each, sd15 CN+TAESD bf16, max_batch 4, on {card}: "
          f"warmup {warm_s:.1f} s; {fps:.2f} frames/s generated and {replies_per_s:.2f} replies/s "
          f"over the streams ({made} generations for {len(kinds) * SERVER_FRAMES} frames sent); "
          f"p50 per stream (ms) "
          + ", ".join(f"{v:.1f}" for v in p50)
          + f"; beside the engine alone (the engine phase, 4 synchronous streams, one in "
          f"reference mode): {engine_res['steady_fps']:.2f} frames/s, p50 (ms) "
          + ", ".join(f"{v:.1f}" for v in engine_res["p50_ms"])
          + f"; every reply in order and the engine's output for its frame; the last timed "
          f"batch a reply carries ({last_call['spec'].batch} rows, {matched} reply(ies) equal to "
          f"one of its rows) again through build_frame_program equal bit for bit: {same}; "
          f"kernel_symbols {len(symbols)} program signature(s) in {t_sym:.2f} s; K1 launches "
          f"{launches} (warm-ups and captures)")
    if not same or not matched:
        fail("a batch the server's engine dispatched differs from build_frame_program, or no "
             "reply holds a row of its last eight batches")
    if not launches:
        fail("the server's engine launched K1 no time")
    _check_by_block("server trace, start_trace/stop_trace + kernel_symbols", summary)
    print(json.dumps({"server": {
        "aiohttp": have_aiohttp, "jpeg": codec, "streams": kinds, "frames_per_s": fps,
        "replies_per_s": replies_per_s,
        "p50_ms": p50, "engine_frames_per_s": engine_res["steady_fps"],
        "engine_p50_ms": engine_res["p50_ms"], "mapped_by": summary["mapped_by"],
        "by_block": summary["by_block"][:12]}}))
    return launches


def phase_sd21(card: str) -> dict:
    """6d: the sd21 frame at full published widths (UNet 320/640/1280/1280
    with heads of 64 and linear projections, the OpenCLIP ViT-H text
    tower, the sd21 ControlNet, TAESD), 512x512, 4 steps, bf16, random
    weights (seed 0), depth not cut: two replayed calls equal to the eager
    ``frame_program`` bit for bit, K1_SD21_PER_FRAME K1 launches per frame
    at capture (counted from 0 just before), replayed ms/frame (median of
    SD21_FRAMES, before any profiler session), peak memory and FLOPs."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd21", dtype=torch.bfloat16, device="cuda")
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    if tuple(embeds.shape) != (1, 77, 1024):
        fail(f"the sd21 prompt embedding is {tuple(embeds.shape)}, not [1, 77, 1024]")
    spec = FrameSpec(batch=1, height=512, width=512, steps=4)
    program = build_frame_program(bundle, spec)
    rng = np.random.default_rng(13)
    frames = [torch.from_numpy(rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)).cuda()
              for _ in range(2)]
    args = ([0.6], [5.0], [2.0])
    torch.cuda.synchronize()
    print(f"sd21 bf16 bundle (ControlNet, TAESD) + prompt: {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    counted = {}
    got = _replay_vs_eager("sd21 512x512 4-step CN+TAESD bf16", program,
                           [((frames[i], embeds, *args, [23 + i]), {}) for i in range(2)],
                           {"flash_attention": K1_SD21_PER_FRAME}, counted)
    _check_frame("sd21 frame", got[-1])
    want = {"flash_attention": 2 * K1_SD21_PER_FRAME}  # warm-up and capture
    if {k: n for k, n in counted.items() if n} != want:
        fail(f"the sd21 frame launched {counted} in its warm-up and capture, expected {want}")
    ms = []
    for i in range(SD21_FRAMES):
        t0 = time.perf_counter()
        program(frames[i % 2], embeds, *args, [30 + i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    replay_ms = statistics.median(ms)
    (bucket,) = program.buckets.values()
    flops = frame_flops(bundle, spec)
    print(f"sd21 512x512 4-step CN+TAESD bf16 batch 1 on {card}, CUDA graph replays: median "
          f"{replay_ms:.2f} ms/frame over {SD21_FRAMES} frames (min {min(ms):.2f}, max "
          f"{max(ms):.2f}); K1 {program.last_launches['flash_attention']} launches/frame at "
          f"capture (d = 64); {flops['logical'] / 1e12:.3f} TFLOP/frame logical, "
          f"{flops['padded'] / 1e12:.3f} padded; warm-up + capture {bucket.capture_s:.2f} s; peak "
          f"allocated {peak:.2f} GiB ({peak - held:.2f} above the {held:.2f} GiB the earlier "
          f"phases hold)")
    launches = counted["flash_attention"] + _sd21_engine(card)
    return {"program": program, "embeds": embeds, "frame": frames[0], "args": (*args, [23]),
            "launches": launches, "replay_ms": replay_ms}


def _sd21_engine(card: str) -> int:
    """The engine serving ``family: sd21`` from a config file (random
    weights): its bundle built from the config, one stream's frames through
    its batch-1 graph.  Returns its K1 launches (warm-up and capture,
    counted from 0 just before)."""
    import asyncio

    from videosd_tpu_torch.config import load_config
    from videosd_tpu_torch.runtime.engine import Engine

    _zero_counts()
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        path = os.path.join(tmp, "config.yaml")
        with open(path, "w") as f:
            f.write("family: sd21\ndtype: bfloat16\nweights: random\nframe_hw: [512, 512]\n")
        eng = Engine(load_config(path), max_streams=1, max_batch=1)
    eng.warmup(batch_sizes=(1,), steps=(4,), height=512, width=512)
    frame = np.random.default_rng(14).integers(0, 256, (512, 512, 3), dtype=np.uint8)

    async def run():
        eng.start()
        try:
            st = eng.open_stream({"height": 512, "width": 512, "prompt": "a fox"})
            return [await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 120)
                    for _ in range(3)]
        finally:
            await eng.stop()

    outs = asyncio.run(run())
    unet = eng.bundle.models["unet"]
    print(f"engine from a config of family sd21 on {card}: bundle {eng.bundle.family}, "
          f"proj_in {type(unet.down_blocks[0].attentions[0].proj_in).__name__}, "
          f"{eng.telemetry.frames_out} frames generated, last {outs[-1].shape} "
          f"{outs[-1].dtype}, K1 {fa.launches} launches (warm-up and capture)")
    if (eng.bundle.family != "sd21" or not eng.telemetry.frames_out
            or outs[-1].shape != (512, 512, 3) or not fa.launches):
        fail("the engine did not serve family sd21 from its config")
    launches = fa.launches
    del eng
    return launches


def phase_sdxl(card: str) -> dict:
    """6f: the SDXL frame at full published widths (stabilityai/
    stable-diffusion-xl-base-1.0 unet/config.json: 320/640/1280, transformer
    depth 0/2/10, heads of 64, linear projections, 2048-wide context,
    text_time 256/2816; CLIP ViT-L/14 and OpenCLIP bigG; its ControlNet;
    TAESD), 1024x1024, 4 steps, bf16, random weights (seed 0), depth not
    cut.  The prompt ([1, 77, 2048] and a pooled [1, 1280]); the sdxl_prod
    frame (no ControlNet) and the ControlNet frame, each two replayed calls
    equal to the eager ``frame_program`` bit for bit with exactly
    K1_SDXL_PER_FRAME K1 launches per frame at capture (counted from 0
    just before), replayed ms/frame (median of SDXL_FRAMES, before any
    profiler session); peak memory and FLOPs; one stream through an
    ``Engine`` of ``family: sdxl``; ``tools/sdxl_prod.py`` in a process of
    its own.  Returns the no-ControlNet program for the profile, and the
    phase's K1 launches; the ControlNet program and the engine are freed."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = ModelBundle.random("sdxl", dtype=torch.bfloat16, device="cuda")
    embeds, pooled = build_prompt_encoder(bundle)(bundle.tokenizer(["cinematic photo, city"]))
    torch.cuda.synchronize()
    params = {name: sum(p.numel() for p in m.parameters()) for name, m in bundle.models.items()}
    print(f"sdxl bf16 bundle ({', '.join(f'{n} {c / 1e9:.3f} B' for n, c in params.items())} "
          f"parameters) + prompt: {time.perf_counter() - t0:.1f} s; context "
          f"{tuple(embeds.shape)}, pooled {tuple(pooled.shape)}")
    if tuple(embeds.shape) != (1, 77, 2048) or tuple(pooled.shape) != (1, 1280):
        fail(f"the SDXL prompt gave {tuple(embeds.shape)} and {tuple(pooled.shape)}, not "
             f"[1, 77, 2048] and [1, 1280]")
    if not (torch.isfinite(embeds).all() and torch.isfinite(pooled).all()):
        fail("the SDXL prompt embedding is not finite")
    rng = np.random.default_rng(17)
    frames = [torch.from_numpy(rng.integers(0, 256, (1, SDXL_SIDE, SDXL_SIDE, 3),
                                            dtype=np.uint8)).cuda() for _ in range(2)]
    args = ([0.7], [5.0], [1.0])
    kw = {"pooled_embeds": pooled}
    launches, res = 0, {}
    for cn in (False, True):
        spec = FrameSpec(batch=1, height=SDXL_SIDE, width=SDXL_SIDE, steps=4, use_controlnet=cn)
        name = f"sdxl {SDXL_SIDE}x{SDXL_SIDE} 4-step {'CN+' if cn else ''}TAESD bf16"
        program = build_frame_program(bundle, spec)
        _zero_counts()
        counted = {}
        got = _replay_vs_eager(name, program,
                               [((frames[i], embeds, *args, [23 + i]), dict(kw)) for i in range(2)],
                               {"flash_attention": K1_SDXL_PER_FRAME[cn]}, counted)
        _check_frame(name, got[-1], SDXL_SIDE)
        want = {"flash_attention": 2 * K1_SDXL_PER_FRAME[cn]}  # warm-up and capture
        if {k: n for k, n in counted.items() if n} != want:
            fail(f"the {name} frame launched {counted} in its warm-up and capture, expected "
                 f"{want}")
        launches += counted["flash_attention"]
        ms = []
        for i in range(SDXL_FRAMES):
            t0 = time.perf_counter()
            program(frames[i % 2], embeds, *args, [30 + i], **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        (bucket,) = program.buckets.values()
        res[cn] = {"program": program, "replay_ms": statistics.median(ms)}
        print(f"{name} batch 1 on {card}, CUDA graph replays: median "
              f"{res[cn]['replay_ms']:.2f} ms/frame over {SDXL_FRAMES} frames (min "
              f"{min(ms):.2f}, max {max(ms):.2f}); K1 {program.last_launches['flash_attention']} "
              f"launches/frame at capture (d = 64); warm-up + capture {bucket.capture_s:.2f} s")
    flops = frame_flops(bundle, res[False]["program"].spec)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"sdxl {SDXL_SIDE}x{SDXL_SIDE} 4-step TAESD frame (no ControlNet): "
          f"{flops['logical'] / 1e12:.3f} TFLOP/frame logical, {flops['padded'] / 1e12:.3f} "
          f"padded, {flops['logical'] / res[False]['replay_ms'] / 1e9:.1f} TFLOP/s replayed; "
          f"peak allocated {peak:.2f} GiB over both frames ({peak - held:.2f} above the "
          f"{held:.2f} GiB the earlier phases hold) ({card})")
    del res[True], program, got, bucket
    launches += _sdxl_engine(card)
    lines = _run_tool(SDXL_PROD_ARGS, "tools/sdxl_prod.py", timeout=SDXL_PROD_S)
    report = json.loads(lines[-1])
    if not (report.get("fps_parity", 0) > 0 and report.get("flops_per_frame_tflop_logical", 0) > 0
            and report.get("device") == "cuda"):
        fail(f"tools/sdxl_prod.py reported {report}")
    print(f"sdxl_prod report: {json.dumps(report)}")
    print(f"phase 6f took {time.perf_counter() - t_phase:.1f} s")
    return {"program": res[False]["program"], "embeds": embeds, "pooled": pooled,
            "frame": frames[0], "args": (*args, [23]), "launches": launches,
            "replay_ms": res[False]["replay_ms"]}


def _sdxl_engine(card: str) -> int:
    """The engine serving ``family: sdxl`` from a config file (random
    weights) at 1024x1024, max_batch 1: one stream's frames through its
    batch-1 graph (with the ControlNet, the engine's default), the reply
    equal bit for bit to a direct ``build_frame_program`` call of the same
    frame.  Returns its K1 launches (warm-up and capture, counted from 0
    just before; the direct call's are not counted)."""
    import asyncio
    import gc

    from videosd_tpu_torch.config import load_config
    from videosd_tpu_torch.runtime.engine import Engine

    _zero_counts()
    side = SDXL_SIDE
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        path = os.path.join(tmp, "config.yaml")
        with open(path, "w") as f:
            f.write(f"family: sdxl\ndtype: bfloat16\nweights: random\n"
                    f"frame_hw: [{side}, {side}]\n")
        eng = Engine(load_config(path), max_streams=1, max_batch=1)
    eng.warmup(batch_sizes=(1,), steps=(4,), height=side, width=side)
    frame = np.random.default_rng(18).integers(0, 256, (side, side, 3), dtype=np.uint8)

    async def run():
        eng.start()
        try:
            st = eng.open_stream({"height": side, "width": side, "prompt": "a fox"})
            outs = [await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 120)
                    for _ in range(3)]
            return st, outs
        finally:
            await eng.stop()

    st, outs = asyncio.run(run())
    launches = fa.launches
    embeds, pooled = eng._encode_prompt("a fox")
    spec = FrameSpec(batch=1, height=side, width=side, in_height=side, in_width=side, steps=4)
    lat = (1, side // 8, side // 8, 4)
    want = build_frame_program(eng.bundle, spec)(
        torch.from_numpy(frame[None]).cuda(), embeds, [0.6], [5.0], [2.0],
        [st.options["seed"]], warm_latents=torch.zeros(lat, device="cuda"), warm_alpha=[0.0],
        pooled_embeds=pooled, src_box=[[0, 0, side, side]])[0]
    same = bool(np.array_equal(outs[-1], want[0].cpu().numpy()))
    print(f"engine from a config of family sdxl on {card}: bundle {eng.bundle.family} "
          f"(clip2 {eng.bundle.clip2_cfg is not None}), {eng.telemetry.frames_out} frames "
          f"generated, last {outs[-1].shape} {outs[-1].dtype}, equal to a direct "
          f"build_frame_program call bit for bit: {same}; K1 {launches} launches (warm-up and "
          f"capture)")
    if (eng.bundle.family != "sdxl" or not eng.telemetry.frames_out
            or outs[-1].shape != (side, side, 3) or not launches or not same):
        fail("the engine did not serve family sdxl from its config, or its reply is not the "
             "frame program's")
    del eng, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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


def phase_sd21_profile(card: str, sd21: dict) -> None:
    """The same over two replayed sd21 frames: K1's 84 at d = 64."""
    program, embeds, frame, args = sd21["program"], sd21["embeds"], sd21["frame"], sd21["args"]
    _profile_frames(card, "sd21", lambda: program(frame, embeds, *args), sd21["replay_ms"],
                    {"flash_fwd_kernel": K1_SD21_PER_FRAME})


def phase_sdxl_profile(card: str, sdxl: dict) -> None:
    """The same over two replayed SDXL 1024x1024 frames (no ControlNet):
    K1's 280 at d = 64."""
    program, embeds, frame, args = sdxl["program"], sdxl["embeds"], sdxl["frame"], sdxl["args"]
    _profile_frames(card, "SDXL 1024x1024",
                    lambda: program(frame, embeds, *args, pooled_embeds=sdxl["pooled"]),
                    sdxl["replay_ms"], {"flash_fwd_kernel": K1_SDXL_PER_FRAME[False]})


def phase_sdxl_int8_profile(card: str, int8: dict) -> None:
    """The same over two replayed SDXL 1024x1024 int8 w8a8 frames (6g d):
    K1's 280, and where the time int8 adds goes, class by class beside
    the bf16 frame's profile above."""
    program, (args, kw) = int8["program"], int8["call"]
    _profile_frames(card, "SDXL 1024x1024 int8 w8a8", lambda: program(*args, **kw),
                    int8["replay_ms"], {"flash_fwd_kernel": K1_SDXL_PER_FRAME[False]})


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


@contextlib.contextmanager
def _k1p_applied(seen: list):
    """While inside, each application of K1' (layers.FlashAttentionRecompute)
    appends its head dim to ``seen``, and a call of the backward's plain
    version (``flash_attention_bwd_reference``) fails the run."""
    cls, apply, reference = layers.FlashAttentionRecompute, layers.FlashAttentionRecompute.apply, \
        fa.flash_attention_bwd_reference

    def counting(q, k, v, num_heads):
        seen.append(q.shape[-1] // num_heads)
        return apply(q, k, v, num_heads)

    def refused(*a, **kw):
        fail("the backward of K1' took its plain version on the card")

    cls.apply, fa.flash_attention_bwd_reference = counting, refused
    try:
        yield seen
    finally:
        del cls.apply  # torch.autograd.Function's own again
        fa.flash_attention_bwd_reference = reference


def _attention_grads_fp64(q, k, v, do, h: int):
    """The gradients of softmax(q k^T d^-1/2) v for q, k, v ([B, S, H*d]),
    by autograd in fp64."""
    b, d = q.shape[0], q.shape[-1] // h

    def fold(x):
        return x.detach().double().reshape(b, x.shape[1], h, d).transpose(1, 2)

    qd, kd, vd = (fold(x).requires_grad_(True) for x in (q, k, v))
    out = torch.matmul(torch.softmax(torch.matmul(qd, kd.transpose(-1, -2)) * d ** -0.5, -1), vd)
    return [g.transpose(1, 2).reshape(x.shape) for g, x in
            zip(torch.autograd.grad(out, (qd, kd, vd), fold(do)), (q, k, v))]


def _k1p_case(gen, b: int, h: int, sq: int, sk: int, d: int, dtype, clock: float) -> dict:
    """K1' on [b, sq, h*d] queries and [b, sk, h*d] keys in ``dtype``:
    autograd through ``layers.attention`` (the Function: one K1 launch a
    forward, one launch of the backward kernel pair of its dtype, no plain
    backward) against the function's gradient (fp32: in fp64; bf16: the
    plain version's on the inputs in fp32), then timed: forward + backward,
    the backward alone (``flash_attention_bwd``), the plain recompute, and
    one ``scaled_dot_product_attention`` forward + backward (the library
    call for the same function, used nowhere in the port), beside the
    bound."""
    q0, do = (torch.randn(b, sq, h * d, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k0, v0 = (torch.randn(b, sk, h * d, generator=gen, device="cuda").to(dtype) for _ in range(2))
    fp32 = dtype == torch.float32
    name, kind = f"[{h},{sq}{'' if sk == sq else f'->{sk}'},{d}]{'' if b == 1 else f' batch {b}'}", \
        "fp32" if fp32 else "bf16"

    def k1p(q, k, v):
        return layers.attention(q, k, v, num_heads=h)

    def plain(q, k, v):
        return layers._attention_plain(q, k, v, h)

    def grads(fn, cast=dtype):
        q, k, v = (x.detach().to(cast).requires_grad_(True) for x in (q0, k0, v0))
        out = fn(q, k, v)
        return out, out.grad_fn, torch.autograd.grad(out, (q, k, v), do.to(cast))

    _zero_counts()
    with _k1p_applied([]) as seen:
        out, grad_fn, got = grads(k1p)
        torch.cuda.synchronize()
    launched = (fa.launches + fa.launches_fp32, fa.launches_bwd_fp32 if fp32 else fa.launches_bwd,
                fa.launches_bwd if fp32 else fa.launches_bwd_fp32)
    if type(grad_fn) is not layers.FlashAttentionRecompute._backward_cls or launched != (1, 1, 0) \
            or seen != [d]:
        fail(f"K1' at {name} {kind}: grad_fn {grad_fn}, (K1, {kind} backward, other backward) "
             f"launches {launched} (want the Function's and (1, 1, 0)), applications {seen}")
    if fp32:
        fold = [x.reshape(b, -1, h, d).transpose(1, 2) for x in (q0, k0, v0)]
        exact = _attention_fp64(*fold, d ** -0.5).transpose(1, 2).reshape(out.shape)
        ok_out = fp32_within_bar(out, exact)
        want = _attention_grads_fp64(q0, k0, v0, do, h)
        own = None
    else:
        ref_out, _, own = grads(plain)  # own: the plain version's bf16 gradients, for scale
        ok_out = k1_within_bar(out, ref_out)
        want = grads(plain, torch.float32)[2]
    errs = []
    for label, g, w in zip("qkv", got, want):
        err = (g.double() - w.double()).abs().max().item()
        bar = (K1P_GRAD_REL_FP32 if fp32 else K1P_GRAD_REL_BF16) * w.abs().max().item()
        errs.append((label, err, bar, bool(torch.isfinite(g).all()) and err <= bar))
    plain_err = "" if own is None else "; the plain version's own bf16 gradients: " + ", ".join(
        f"d{lb} {(o.double() - w.double()).abs().max().item():.3e}"
        for lb, o, w in zip("qkv", own, want))
    print(f"K1' {name} {kind}: output max|d| {ok_out[1]:.3e} (bar {ok_out[3]:.3e}); "
          + "; ".join(f"d{lb} max|d| {e:.3e} (bar {b_:.3e})" for lb, e, b_, _ in errs)
          + f" from the {'fp64' if fp32 else 'fp32 plain'} gradient{plain_err}")
    if not ok_out[0] or not all(ok for _, _, _, ok in errs):
        fail(f"K1' at {name} {kind} misses a bar against the function's gradient")
    del want, own

    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q0, k0, v0))
    q4, k4, v4, do4 = (x.reshape(b, x.shape[1], h, d).transpose(1, 2) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        o, lse = fa.flash_attention_lse(q, k, v, num_heads=h)
    t_k = timed(lambda: torch.autograd.grad(k1p(q, k, v), (q, k, v), do))
    t_b = timed(lambda: fa.flash_attention_bwd(q0, k0, v0, o, lse, do, h, d ** -0.5))
    t_p = cuda_ms(lambda: torch.autograd.grad(plain(q, k, v), (q, k, v), do), iters=5)
    t_l = timed(lambda: torch.autograd.grad(sdpa(q4, k4, v4), (q, k, v), do4))
    elem = 4.0 if fp32 else 2.0
    # q, o, dO read and dq written (4 Sq rows), k, v read and dk, dv written
    # (4 Sk rows), lse read; forward + backward 2 + 5 products (the
    # recomputed logits counted once: 14 Sq Sk d a head), the backward 5
    nbytes = elem * b * h * d * (4 * sq + 4 * sk) + 4.0 * b * h * sq
    bound, by, term = bound_ms(nbytes, 14.0 * b * h * sq * sk * d, kind, clock)
    bwd_bound = bound_ms(nbytes, 10.0 * b * h * sq * sk * d, kind, clock)[0]
    print(f"   forward + backward: device {t_k[1]:.4f} ms (CUDA events {t_k[0]:.4f}), bound "
          f"{bound * 1e3:.2f} us by {term} (reached {bound / t_k[1]:.1%}); backward kernels "
          f"device {t_b[1]:.4f} ms (events {t_b[0]:.4f}), bound {bwd_bound * 1e3:.2f} us "
          f"(reached {bwd_bound / t_b[1]:.1%}); plain {t_p:.4f} ms, SDPA device {t_l[1]:.4f} ms "
          f"(events {t_l[0]:.4f})")
    return {"shape": [h, sq, d] if b == 1 and sq == sk else [b, h, sq, sk, d], "ms": t_k[0],
            "device_ms": t_k[1], "bwd_ms": t_b[0], "bwd_device_ms": t_b[1], "plain_ms": t_p,
            "library_ms": t_l[1], "bound_ms": bound, "bwd_bound_ms": bwd_bound, "bound_by": by,
            "bound_term": term,
            "max_abs_err": max([ok_out[1]] + [e for _, e, _, _ in errs])}


def phase_k1_prime(card: str, clock: float) -> dict:
    """6e (a): K1' at the main path's shapes, K1P_EXTRA and (fp32) the
    sharded step's, in bf16 and fp32, held and timed (forward + backward;
    after the first profiler sessions of the run).  Returns the fp32 main
    shapes' totals (the train steps' dtype) with every row."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    shapes = [(1, h, s, s, d) for h, s, d in K1_SHAPES] + K1P_EXTRA
    rows = {kind: [_k1p_case(gen, *shape, dtype, clock) for shape in shapes]
            for kind, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32))}
    # the sharded step's shapes (phase 6i: 4 of the 8 heads a model rank)
    rows["fp32_tp2"] = [_k1p_case(gen, *shape, torch.float32, clock) for shape in K1_TP2]
    main = len(K1_SHAPES)
    total = _k1_totals(rows["fp32"][:main])
    print(f"K1' fp32 forward + backward, one call at each main shape ({card}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in total.items() if k != "bound_by"))
    tp2 = _k1_totals(rows["fp32_tp2"])
    print(f"K1' fp32 forward + backward at the tensor-parallel shapes, one call each, "
          f"{K1P_PER_MESH_SHAPE} of each a (2 x 2) sharded step ({card}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tp2.items() if k != "bound_by"))
    return {**total, "max_abs_err": max(r["max_abs_err"] for k in rows for r in rows[k]),
            "per_shape": rows["fp32"], "bf16_per_shape": rows["bf16"],
            "tp2_per_shape": rows["fp32_tp2"]}


@contextlib.contextmanager
def _plain_attention():
    """Every attention on the plain math (no route to K1): the train steps'
    comparison."""
    routes = layers.routes_to_flash
    layers.routes_to_flash = lambda *a: False
    try:
        yield
    finally:
        layers.routes_to_flash = routes


def _plain_grads(model, run) -> dict:
    """``run(state)`` (one train step on explicit t and noise) with every
    attention on the plain math and an optimizer that leaves the weights as
    they are: each parameter's gradient."""
    model.requires_grad_(True)
    state = {"model": model, "optimizer": torch.optim.SGD(model.parameters(), lr=0.0)}
    _zero_counts()
    with _plain_attention():
        loss = run(state)["loss"]
    torch.cuda.synchronize()
    if fa.launches + fa.launches_fp32 + fa.launches_bwd + fa.launches_bwd_fp32:
        fail("the plain-attention train step launched K1 or its backward")
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return {"loss": loss.item(), "grads": grads}


def _train_steps(label: str, card: str, model, run, plain: dict, per_step: int,
                 routed: int, after=None) -> dict:
    """``TRAIN_STEPS`` calls of ``run(state, **draws)``: the first on the
    plain pass's t and noise (the warm-up), its gradients held to the plain
    pass's; then on a generator's draws, each timed by CUDA events.  Every
    step: a finite loss and ``per_step`` fp32 K1 launches; after the first,
    a finite gradient for every parameter and a nonzero one for each of the
    ``routed`` projections of routed self-attentions (ROUTED_QKV), and one
    launch of the fp32 backward kernel pair for each application of K1'
    (no plain backward; the forward's other K1 launches are attentions whose
    inputs want no gradient).  ``after(i)``: called after step i, outside
    the timing."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    losses, ms, launches, bwd_launches = [], [], 0, 0
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        kw = plain["draws"] if i == 0 else {"generator": gen}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _zero_counts()
        with _k1p_applied([]) as applied:
            start.record()
            loss = run(**kw)["loss"]
            end.record()
            torch.cuda.synchronize()
        launches += fa.launches_fp32
        bwd_launches += fa.launches_bwd_fp32
        if fa.launches_fp32 != per_step or fa.launches:
            fail(f"{label} train step {i}: {fa.launches_fp32} fp32 K1 launches (want "
                 f"{per_step}) and {fa.launches} bf16")
        if not applied or fa.launches_bwd_fp32 != len(applied) or fa.launches_bwd \
                or max(applied) > fa.MAX_HEAD_DIM:
            fail(f"{label} train step {i}: {fa.launches_bwd_fp32} fp32 and {fa.launches_bwd} "
                 f"bf16 launches of the backward kernels for {len(applied)} applications of K1' "
                 f"(head dims {sorted(set(applied))})")
        losses.append(loss.item())
        if i:
            ms.append(start.elapsed_time(end))
        if after is not None:
            after(i)
        if i == 0:
            worst, zero, bad = (0.0, ""), [], []
            for n, p in model.named_parameters():
                g = p.grad
                if g is None or not torch.isfinite(g).all():
                    bad.append(n)
                    continue
                ref = plain["grads"][n]
                rel = ((g - ref).norm() / ref.norm()).item() if ref.norm() > 0 else (
                    0.0 if g.norm() == 0 else math.inf)
                worst = max(worst, (rel, n))
                if ROUTED_QKV.match(n) and not g.abs().max() > 0:
                    zero.append(n)
            n_routed = sum(bool(ROUTED_QKV.match(n)) for n, _ in model.named_parameters())
            print(f"{label} train step 1 against the plain-attention step: loss {losses[0]:.6f} "
                  f"vs {plain['loss']:.6f}; largest per-tensor |g - g_plain| / |g_plain| "
                  f"{worst[0]:.3e} ({worst[1]}; bar {TRAIN_GRAD_REL:g}); {n_routed} routed "
                  f"q/k/v projections, {len(zero)} with a zero gradient; {len(bad)} tensors "
                  f"without a finite gradient")
            if bad or zero or n_routed != routed or worst[0] > TRAIN_GRAD_REL:
                fail(f"{label} train step: gradients missing {bad[:3]}, zero {zero[:3]}, "
                     f"{n_routed} routed projections (want {routed}), or off the plain step's "
                     f"by {worst[0]:.3e}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} train step, sd15 fp32 {TRAIN_SIDE}x{TRAIN_SIDE} batch {TRAIN_BATCH} "
          f"({card}): losses " + ", ".join(f"{x:.5f}" for x in losses)
          + f"; {per_step} fp32 K1 launches and {bwd_launches // TRAIN_STEPS} of the backward "
          f"kernels a step; step ms after the warm-up (CUDA events) "
          + ", ".join(f"{x:.2f}" for x in ms) + f"; peak memory {peak:.2f} GiB")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label} train step: a loss is not finite")
    return {"losses": losses, "step_ms": ms, "peak_gib": peak, "launches": launches,
            "bwd_launches": bwd_launches}


def phase_train(card: str) -> dict:
    """6e (b, c): the sd15 UNet train step (AdamW) and the ControlNet train
    step against the frozen UNet (Adafactor; its zero-initialized output
    convs drawn small and nonzero first, as after some training, so
    gradients reach its trunk) at full width, fp32, 512x512, batch 2, each
    held by :func:`_train_steps`.  Returns their numbers and the K1 launches
    of the steps (the training path's)."""
    torch.cuda.empty_cache()
    bundle = ModelBundle.random("sd15", dtype=torch.float32, device="cuda")
    unet, cn = bundle.models["unet"], bundle.models["controlnet"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, lat = TRAIN_BATCH, TRAIN_SIDE // 8
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    batch = {"latents": torch.randn(b, lat, lat, 4, generator=gen, device="cuda"),
             "context": embeds.float().repeat(b, 1, 1),
             "w_cond": layers.guidance_embedding(torch.full((b,), 5.0, device="cuda"),
                                                 bundle.unet_cfg.time_cond_proj_dim)}
    noise = torch.randn(batch["latents"].shape, generator=gen, device="cuda")

    step = train_step.make_train_step(bundle.sched_cfg)
    draws = {"t": torch.randint(0, 1000, (b,), generator=gen, device="cuda"), "noise": noise}
    plain = _plain_grads(unet, lambda st: step(st, batch, **draws))
    plain["draws"] = draws
    start = _host_copy(unet)
    record = []
    state = train_step.init_train_state(unet, optim.adamw(TRAIN_LR))
    res = {"unet": _train_steps("UNet", card, unet, lambda **kw: step(state, batch, **kw),
                                plain, K1_PER_UNET_STEP, 45,
                                after=lambda i: record.append(_host_copy(unet)))}
    del state
    unet.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    res["mesh"] = phase_6i(card, unet, batch, bundle.sched_cfg, plain, start, record)
    del plain, start, record
    unet.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    with torch.no_grad():
        for n, p in cn.named_parameters():
            if n.startswith(cn.ZERO_INIT) and p.ndim == 4:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    frames = np.stack([structured_frame(i, TRAIN_SIDE, TRAIN_SIDE) for i in range(b)])
    img01 = torch.from_numpy(frames).to("cuda").float() / 255.0
    cn_batch = {**batch, "control": sobel_control_image(img01)}
    cn_step = train_step.make_controlnet_train_step(bundle.sched_cfg, t_max=TRAIN_T_MAX)
    draws = {"t": torch.randint(0, TRAIN_T_MAX, (b,), generator=gen, device="cuda"),
             "noise": noise}
    plain = _plain_grads(cn, lambda st: cn_step(st, unet, cn_batch, **draws))
    plain["draws"] = draws
    state = train_step.init_train_state(cn, optim.adafactor(TRAIN_LR))
    res["controlnet"] = _train_steps(
        "ControlNet", card, cn, lambda **kw: cn_step(state, unet, cn_batch, **kw), plain,
        K1_PER_CN_STEP, 18)
    if any(p.requires_grad or p.grad is not None for p in unet.parameters()):
        fail("the ControlNet step left the UNet trainable or with gradients")
    del state, plain, bundle
    torch.cuda.empty_cache()
    res["launches"] = res["unet"]["launches"] + res["controlnet"]["launches"]
    res["bwd_launches"] = res["unet"]["bwd_launches"] + res["controlnet"]["bwd_launches"]
    return res


def _host_copy(model) -> dict:
    """Every parameter of ``model``, copied to host memory."""
    return {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}


def phase_6i(card: str, unet, batch: dict, sched_cfg, plain: dict, start: dict,
             record: list) -> dict:
    """6i: the sharded UNet train step in one process
    (``make_train_step(sched_cfg, mesh=...)``) on a (2 x 2) mesh of
    ``cuda:0`` slots, from the single-device step's start (``start``) with
    its draws and optimizer (AdamW), held by :func:`_train_steps` (60 fp32 K1
    launches a step: 2 rows x 2 model ranks x 15; the first step's
    gradients to the plain-attention pass's) and, after each step, the
    whole model against the single-device step's (``record``) by relative
    L2, every parameter with a finite gradient.  Returns the readings."""
    from videosd_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    with torch.no_grad():
        for n, p in unet.named_parameters():
            p.copy_(start[n])
    mesh = make_mesh(devices=MESH_SLOTS, model_parallel=2)
    step = train_step.make_train_step(sched_cfg, mesh=mesh)
    state = train_step.init_train_state(unet, optim.adamw(TRAIN_LR))
    rel, missing = [], []

    def against_single(i):
        num = den = 0.0
        for n, p in unet.named_parameters():
            want = record[i][n].to(p.device).double()
            num = num + (p.detach().double() - want).pow(2).sum()
            den = den + want.pow(2).sum()
            if p.grad is None or not torch.isfinite(p.grad).all():
                missing.append((i, n))
        rel.append(math.sqrt((num / den).item()))

    res = _train_steps("UNet on a (2 x 2) mesh", card, unet,
                       lambda **kw: step(state, batch, **kw), plain, K1_PER_MESH_STEP, 45,
                       after=against_single)
    print(f"6i sharded step, sd15 fp32 {TRAIN_SIDE}x{TRAIN_SIDE} batch {TRAIN_BATCH} AdamW on a "
          f"{mesh.shape} mesh of {[str(d) for d in MESH_SLOTS]} ({card}): whole-model relative "
          f"L2 to the single-device step's weights after each step "
          + ", ".join(f"{x:.3e}" for x in rel) + f" (bar {MESH_TRAIN_REL_L2:g}); "
          f"{len(missing)} (step, parameter) without a finite gradient; "
          f"{K1_PER_MESH_STEP} fp32 K1 launches a step ({res['launches']} in all); "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if missing or max(rel) > MESH_TRAIN_REL_L2:
        fail(f"6i: the sharded step's weights are {max(rel):.3e} off the single-device step's, "
             f"or parameters without a gradient {missing[:3]}")
    gen = torch.Generator(device="cuda").manual_seed(13)
    parts = [_timed_step(lambda: step(state, batch, generator=gen), state["optimizer"])[1]
             for _ in range(MESH_PART_STEPS)]
    print(f"6i the sharded step's parts, {MESH_PART_STEPS} more steps ({card}; host ms, each "
          f"part between two synchronizations): " + "; ".join(map(_parts_text, parts)))
    del state, step
    return {**res, "rel_l2": rel, "parts": parts}


@contextlib.contextmanager
def _step_parts(opt, parts: dict):
    """While inside, the sharded train step's parts are timed on the host
    clock, each between two synchronizations of the card, and their ms
    added into ``parts``: the placement loads (``load``), the rows'
    forwards (``forward``), the gradient reduction with its all-reduce
    (``reduce_grads``) and ``opt``'s step (``optimizer``)."""
    from videosd_tpu_torch.parallel import mesh as pmesh

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    saved = pmesh.Placement.load, train_step.unet_apply, train_step.reduce_grads
    pmesh.Placement.load = timed("load", saved[0])
    train_step.unet_apply = timed("forward", saved[1])
    train_step.reduce_grads = timed("reduce_grads", saved[2])
    opt.step = timed("optimizer", opt.step)
    try:
        yield parts
    finally:
        pmesh.Placement.load, train_step.unet_apply, train_step.reduce_grads = saved
        del opt.step


def _timed_step(run, opt) -> tuple[float, dict]:
    """One sharded train step ``run()`` with its parts timed by
    :func:`_step_parts`: its loss and {part: host ms}, with ``wall`` and
    ``backward and rest`` (the wall time less the timed parts: the rows'
    backwards, the draws and the batch split)."""
    parts = {}
    with _step_parts(opt, parts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = run()["loss"].item()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    parts["backward and rest"] = wall - sum(parts.values())
    parts["wall"] = wall
    return loss, parts


def _parts_text(parts: dict) -> str:
    return f"wall {parts['wall']:.1f} (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items() if k != "wall") + ")"


def _run_tool(args: list, label: str, timeout: float = TOY_CHILD_S) -> list:
    """``python -m`` one of the port's tools in a process of its own; its
    output is passed on (and its lines returned), and a nonzero exit or a
    run past ``timeout`` seconds fails."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                              timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired:
        fail(f"{label} ran past {timeout} s")
    lines = proc.stdout.splitlines()
    print("\n".join(f"   {ln}" for ln in lines[-14:]))
    print(f"{label}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    if proc.returncode:
        fail_child(label, proc.returncode, lines + proc.stderr.splitlines())
    return lines


def phase_toy(card: str) -> dict:
    """6e (d): ``tools/train_toy.py`` on the card (TOY_ARGS), then
    ``tools/turbo_ladder.py --weights`` on its checkpoint at 64x64
    (``--skip-fps``): the TAESD stage learns, every loss is finite, every
    ladder row has a PSNR."""
    with tempfile.TemporaryDirectory() as tmp:
        report_path, ladder_path = os.path.join(tmp, "toy.json"), os.path.join(tmp, "ladder.json")
        _run_tool(["videosd_tpu_torch.tools.train_toy", "--out", os.path.join(tmp, "ckpt"),
                   *TOY_ARGS, "--json", report_path], "train_toy")
        _run_tool(["videosd_tpu_torch.tools.turbo_ladder", "--weights",
                   os.path.join(tmp, "ckpt"), "--size", "64", "--skip-fps", "--json",
                   ladder_path], "turbo_ladder")
        with open(report_path) as f:
            report = json.load(f)
        with open(ladder_path) as f:
            ladder = json.load(f)
    keys = ("ae_first_mse", "ae_final_mse", "ae_holdout_psnr_db", "unet_final_loss",
            "cn_first_loss", "cn_final_loss", "cn_holdout_base_loss", "cn_holdout_cn_loss",
            "cn_holdout_gain_pct", "ae_seconds", "unet_seconds", "cn_seconds")
    print(f"train_toy on {card} ({' '.join(TOY_ARGS)}): "
          + ", ".join(f"{k} {report[k]}" for k in keys) + f"; device {report['device']}")
    print("turbo_ladder on its checkpoint, 64x64, 4 steps: "
          + "; ".join(f"cn {r['cn_interval']} dc {r['dc_interval']}"
                      f"{' +last' if r['refresh_last'] else ''} PSNR {r['psnr_mean']}/"
                      f"{r['psnr_min']} SSIM {r['ssim_mean']}/{r['ssim_min']}" for r in ladder))
    if not (report["ae_final_mse"] < 0.8 * report["ae_first_mse"]
            and all(math.isfinite(report[k]) for k in keys)):
        fail("train_toy on the card: the TAESD stage did not learn, or a number is not finite")
    if len(ladder) < 12 or not all(r["psnr_min"] > 0 and r["ssim_min"] > 0 for r in ladder):
        fail("turbo_ladder on the trained checkpoint gave a row without a PSNR or SSIM")
    return {"report": report, "ladder": ladder}


# ------------------------------------------------------------ 6g: LoRA, int8, tools


def _weight_bytes(*models) -> int:
    return sum(t.numel() * t.element_size() for m in models
               for t in list(m.parameters()) + list(m.buffers()))


def _write_loras(bundle, tmp: str) -> list:
    """The phase's two adapters from seeded random tensors: a rank-8 PEFT
    file over every UNet attention projection and feed-forward, and a
    rank-8 kohya file (alpha 4) over every projection of the text tower.
    Returns the config's ``[(path, scale), ...]``."""
    rng = np.random.default_rng(31)

    def halves(w, std=(0.02, 0.02)):
        out_dim, in_dim = w.shape
        return ((rng.standard_normal((LORA_RANK, in_dim)) * std[0]).astype(np.float32),
                (rng.standard_normal((out_dim, LORA_RANK)) * std[1]).astype(np.float32))

    peft, kohya = {}, {}
    for key, w in bundle.models["unet"].state_dict().items():
        if LORA_UNET.search(key):
            m = key[: -len(".weight")]
            peft[f"unet.{m}.lora_A.weight"], peft[f"unet.{m}.lora_B.weight"] = halves(
                w, LORA_UNET_STD)
    for key, w in bundle.models["clip"].state_dict().items():
        if LORA_CLIP.search(key):
            m = "lora_te_" + key[: -len(".weight")].replace(".", "_")
            kohya[f"{m}.lora_down.weight"], kohya[f"{m}.lora_up.weight"] = halves(w)
            kohya[f"{m}.alpha"] = np.asarray(4.0, np.float32)
    paths = [os.path.join(tmp, "unet_peft.safetensors"), os.path.join(tmp, "te_kohya.safetensors")]
    write_safetensors(paths[0], peft)
    write_safetensors(paths[1], kohya)
    print(f"LoRA files: {len(peft) // 2} UNet modules (PEFT), {len(kohya) // 3} text-tower "
          f"modules (kohya, alpha 4), rank {LORA_RANK}")
    return list(zip(paths, LORA_SCALES))


def _copy_bundle(bundle):
    """A second bundle with ``bundle``'s weights (so the phase-5 bundle that
    later phases and profiles use stays as it is)."""
    return ModelBundle.from_state_dicts(
        bundle.family, {n: m.state_dict() for n, m in bundle.models.items()},
        dtype=bundle.dtype, device="cuda")


def _unet_eps(bundle, embeds):
    """The bundle's UNet alone on fixed inputs (phase 5's UNet call: a
    seeded latent, t = 519, guidance 5, ``embeds``): its noise prediction
    in fp32."""
    x = torch.randn(1, 4, 64, 64, generator=torch.Generator("cuda").manual_seed(3),
                    device="cuda").bfloat16()
    w = layers.guidance_embedding(torch.tensor([5.0], device="cuda"), 256).bfloat16()
    with torch.inference_mode():
        return bundle.models["unet"](x, torch.tensor([519], device="cuda"), embeds,
                                     timestep_cond=w).float()


def _rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def _w8a8_plain(x, w8, sw, bias=None, fault=None):
    """``linear_w8a8``'s function in plain PyTorch: the scale over the whole
    input and the codes as JAX takes them, their product in fp64 in place of
    ``torch._int_mm`` (exact: every sum is an integer below 2**53), then the
    same epilogue; bit for bit the int8 route where that route is sound.
    ``fault``, one of W8A8_FAULTS, breaks it on purpose."""
    n, k = w8.shape
    xf = x.float()
    over = {W8A8_FAULTS[0]: xf.reshape(-1, k)[:1], W8A8_FAULTS[1]: xf[..., :64]}.get(fault, xf)
    sx = div_rn(torch.clamp_min(over.abs().amax(), 1e-6), 127.0)
    rnd = torch.trunc if fault == W8A8_FAULTS[2] else torch.round
    xq = torch.clamp(rnd(xf / sx), -127, 127).reshape(-1, k)
    sw = sw.flip(0) if fault == W8A8_FAULTS[3] else sw
    y = (xq.double() @ w8.double().t()).float() * (sw * sx)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], n)


@contextlib.contextmanager
def _plain_w8a8(fault=None):
    """Every w8a8 linear on :func:`_w8a8_plain` (with ``fault``) inside."""
    routed = layers.linear_w8a8, unet_mod.linear_w8a8
    layers.linear_w8a8 = unet_mod.linear_w8a8 = (
        lambda x, w8, sw, bias=None: _w8a8_plain(x, w8, sw, bias, fault))
    try:
        yield
    finally:
        layers.linear_w8a8, unet_mod.linear_w8a8 = routed


def _int8_parts(x, w8):
    """The activation codes and the int32 product of ``linear_w8a8``'s first
    steps, on x's device."""
    xf = x.float()
    sx = div_rn(torch.clamp_min(xf.abs().amax(), 1e-6), 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8).reshape(-1, w8.shape[1])
    return xq, torch._int_mm(xq, w8.t())


def _int8_layers_on_card(unet) -> None:
    """Three quantized linears of the frame at its real shapes, the card
    against the CPU on the same bf16 input: the activation codes and the
    int32 product of ``torch._int_mm`` equal bit for bit, and the layer's
    bf16 output within one bf16 ulp of the CPU's fp32 chain."""
    blocks = [unet.down_blocks[i].attentions[0].transformer_blocks[0] for i in range(3)]
    a1 = blocks[1].attn1
    cases = [
        ("ff.net.0.proj at 4096 tokens", 4096, blocks[0].ff.net[0].proj.w8,
         blocks[0].ff.net[0].proj.sw, blocks[0].ff.net[0].proj.bias),
        ("fused to_q|to_k|to_v at 1024 tokens", 1024,
         torch.cat([a1.to_q.w8, a1.to_k.w8, a1.to_v.w8]),
         torch.cat([a1.to_q.sw, a1.to_k.sw, a1.to_v.sw]), None),
        ("attn1.to_out.0 at 256 tokens", 256, blocks[2].attn1.to_out[0].w8,
         blocks[2].attn1.to_out[0].sw, blocks[2].attn1.to_out[0].bias),
    ]
    gen = torch.Generator("cuda").manual_seed(41)
    for name, tokens, w8, sw, bias in cases:
        x = torch.randn(1, tokens, w8.shape[1], generator=gen, device="cuda").bfloat16()
        xq, prod = _int8_parts(x, w8)
        xq_cpu, prod_cpu = _int8_parts(x.cpu(), w8.cpu())
        y = layers.linear_w8a8(x, w8, sw, bias)
        want = layers.linear_w8a8(x.cpu().float(), w8.cpu(), sw.cpu(),
                                  None if bias is None else bias.cpu())
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
        over = int(((y.float().cpu() - want).abs() > ulp).sum())
        same = torch.equal(xq.cpu(), xq_cpu) and torch.equal(prod.cpu(), prod_cpu)
        print(f"int8 linear {name} ({tuple(x.shape)} x [{w8.shape[1]}, {w8.shape[0]}]): codes "
              f"and int32 product equal to the CPU's bit for bit: {same}; bf16 output "
              f"elements more than one bf16 ulp from the CPU's fp32 chain: {over}")
        if not same or over:
            fail(f"the int8 linear {name} on the card disagrees with the CPU")


def _int_mm_device_ms(program, call) -> tuple[float, float, int]:
    """The int8 products of one frame of ``program``: their shapes recorded
    through one eager frame, each shape's ``torch._int_mm`` timed with CUDA
    events and summed over its calls, beside one bf16 matmul of each shape.
    Returns (int8 ms per frame, bf16 ms at the same shapes, calls)."""
    shapes = collections.Counter()
    int_mm = torch._int_mm

    def record(a, b):
        shapes[(a.shape[0], a.shape[1], b.shape[1])] += 1
        return int_mm(a, b)

    torch._int_mm = record
    try:
        frame_program(program.bundle, program.spec, *call[0], **call[1])
    finally:
        torch._int_mm = int_mm
    torch.cuda.synchronize()
    int8 = bf16 = 0.0
    for (m, k, n), count in shapes.items():
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda")
        b = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda")
        int8 += count * cuda_ms(lambda: torch._int_mm(a, b.t()), iters=50)
        a16, b16 = a.bfloat16(), b.bfloat16()
        bf16 += count * cuda_ms(lambda: torch.matmul(a16, b16.t()), iters=50)
    return int8, bf16, sum(shapes.values())


def _frame_in_turns(programs: dict, call, turns: int = INT8_TURNS,
                    frames: int = INT8_TURN_FRAMES) -> dict:
    """Blocking replayed frames of each program in alternating turns: the
    median ms per frame of each over all turns."""
    ms = {name: [] for name in programs}
    for turn in range(turns):
        order = list(programs) if turn % 2 == 0 else list(reversed(programs))
        for name in order:
            for i in range(frames):
                t0 = time.perf_counter()
                programs[name](*call[0][:-1], [60 + i], **call[1])
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(v) for name, v in ms.items()}


def _captured(program, call) -> float:
    """The program's first call (its warm-up and capture) from counts of 0;
    returns the bytes it allocated at its peak above what was allocated
    before it (the activations' working set and the graph's pool)."""
    _zero_counts()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    program(*call[0], **call[1])
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def _w8a8_fault_readings(bundle, spec, call, embeds, bf16: tuple, int8, bar: float) -> None:
    """The int8 bars against a deliberately broken w8a8 linear: for each
    fault of W8A8_FAULTS patched into every quantized linear, the UNet's
    noise prediction and the eager frame against bf16's (``bf16``: the
    prediction and the image), and which checks catch it; each fault must
    be caught (by the bit-for-bit check against ``int8``, the sound
    prediction, at the least)."""
    for fault in W8A8_FAULTS:
        with _plain_w8a8(fault):
            eps = _unet_eps(bundle, embeds)
            img = frame_program(bundle, spec, *call[0], **call[1])[0]
        rel, psnr = _rel_l2(eps, bf16[0]), _psnr(img, bf16[1])
        caught = [name for name, hit in (
            ("bit for bit", (eps - int8).abs().max().item() > bar),
            ("rel L2", rel > INT8_EPS_REL_MAX), ("PSNR", psnr <= INT8_PSNR_DB)) if hit]
        print(f"int8 with a fault, {fault}: the UNet's noise prediction rel L2 {rel:.4e}, the "
              f"frame PSNR {psnr:.2f} dB against bf16; caught by {caught or 'nothing'}")
        if not caught:
            fail(f"no int8 check catches a w8a8 linear with {fault}")


def phase_lora_int8(card: str, main, tmp: str) -> dict:
    """6g (a) and (b): LoRA on a copy of the phase-5 bundle, fused on the
    card and equal to the CPU's fusion bit for bit, its frame replayed equal
    to eager with 84 K1 launches, the UNet adapters' move of the UNet's
    noise prediction and of the frame held to their bars; then ``quant:
    int8`` on it: the quantized linears, ``_int_mm`` and K1 launches per
    frame at capture, replay equal to eager, the int8 UNet and frame against
    bf16 within their bars and the int8 UNet equal to its plain w8a8
    version, ms/frame beside the bf16 frame in turns, weight bytes and the
    capture's memory, the int8 products' device time per frame, and three
    linears held to the CPU."""
    from videosd_tpu_torch.io.lora import fuse_bundle_loras, fuse_state_dict_loras
    from videosd_tpu_torch.ops.quant import quant_stats, quantize_bundle_params

    bundle0, embeds, frame, args, _, program0 = main
    loras = _write_loras(bundle0, tmp)
    eps_base = _unet_eps(bundle0, embeds)
    bundle = _copy_bundle(bundle0)
    t0 = time.perf_counter()
    stats = fuse_bundle_loras(bundle, loras, strict=True)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    on_cpu = {n: {k: v.cpu() for k, v in bundle0.models[n].state_dict().items()}
              for n in ("unet", "clip")}
    want, _ = fuse_state_dict_loras(bundle0, on_cpu, loras, strict=True)
    diff = [f"{n}.{k}" for n in want for k, v in bundle.models[n].state_dict().items()
            if not torch.equal(v.cpu(), want[n][k])]
    changed = sum(not torch.equal(want[n][k], on_cpu[n][k]) for n in want for k in want[n])
    print(f"LoRA fused on {card} in {fuse_s:.2f} s: {stats} modules per tower, {changed} "
          f"weights changed; fused state dicts equal to the CPU's fusion bit for bit: "
          f"{not diff}" + (f" (first differing: {diff[:3]})" if diff else ""))
    if diff or stats != {"unet": LORA_UNET_MODULES, "text_encoder": LORA_CLIP_MODULES}:
        fail("the LoRA fusion on the card differs from the CPU's, or fused other modules")

    spec = FrameSpec(batch=1, height=512, width=512, steps=4)
    calls = [((frame, embeds, *args[:3], [23 + i]), {}) for i in range(2)]
    res = {"launches": 0}
    mem = {}
    lora_program = build_frame_program(bundle, spec)
    mem["bf16"] = _captured(lora_program, calls[0])
    counted = {}
    lora_out = _replay_vs_eager("sd15 512x512 4-step CN+TAESD bf16 with LoRA", lora_program,
                                calls, {"flash_attention": K1_PER_FRAME, "int_mm": 0}, counted)
    res["launches"] += counted["flash_attention"]
    base_out = program0(*calls[0][0])
    lora_psnr = _psnr(lora_out[0][0], base_out[0])
    eps_lora = _unet_eps(bundle, embeds)
    lora_rel = _rel_l2(eps_lora, eps_base)
    half = _copy_bundle(bundle0)
    fuse_bundle_loras(half, [(loras[0][0], loras[0][1] / 2)], strict=True)
    half_rel = _rel_l2(_unet_eps(half, embeds), eps_base)
    del half
    print(f"LoRA against the base: the UNet alone (base prompt embeddings) noise prediction "
          f"rel L2 {lora_rel:.4e} (bar >= {LORA_EPS_REL_MIN:g}; the UNet file fused at half "
          f"its scale {half_rel:.4e}); the frame (same inputs) PSNR {lora_psnr:.2f} dB (bar "
          f"<= {LORA_PSNR_MAX_DB:g})")
    if not (lora_rel >= LORA_EPS_REL_MIN > half_rel and lora_psnr <= LORA_PSNR_MAX_DB):
        fail("the UNet adapters did not move the UNet's prediction, the bar does not tell "
             "them from half their scale, or the LoRA frame did not move off the base frame")
    del lora_program

    bf16_bytes = _weight_bytes(bundle.models["unet"], bundle.models["controlnet"])
    quantize_bundle_params(bundle)
    torch.cuda.empty_cache()
    int8_bytes = _weight_bytes(bundle.models["unet"], bundle.models["controlnet"])
    counts = {n: quant_stats(bundle.models[n]) for n in ("unet", "controlnet")}
    print(f"int8 w8a8: {counts}; UNet + ControlNet weights {bf16_bytes / 2**30:.3f} GiB bf16, "
          f"{int8_bytes / 2**30:.3f} GiB int8")
    if counts != INT8_SD15_COUNTS:
        fail(f"quant: int8 quantized {counts}, expected {INT8_SD15_COUNTS}")
    int8_program = build_frame_program(bundle, spec)
    mem["int8"] = _captured(int8_program, calls[0])
    counted = {}
    int8_out = _replay_vs_eager("sd15 512x512 4-step CN+TAESD int8 w8a8 with LoRA",
                                int8_program, calls,
                                {"flash_attention": K1_PER_FRAME, "int_mm": INT_MM_SD15}, counted)
    res["launches"] += counted["flash_attention"]
    int8_psnr = _psnr(int8_out[0][0], lora_out[0][0])
    eps_int8 = _unet_eps(bundle, embeds)
    int8_rel = _rel_l2(eps_int8, eps_lora)
    again = _unet_eps(bundle, embeds)
    with _plain_w8a8():
        eps_plain = _unet_eps(bundle, embeds)
    stable = torch.equal(again, eps_int8)
    bar = 0.0 if stable else (again - eps_int8).abs().max().item()
    plain_d = (eps_plain - eps_int8).abs().max().item()
    print(f"int8 against bf16 on the same LoRA weights: the UNet's noise prediction rel L2 "
          f"{int8_rel:.4e} (bar <= {INT8_EPS_REL_MAX:g}); the frame PSNR {int8_psnr:.2f} dB "
          f"(bar > {INT8_PSNR_DB:g}); the int8 UNet against its w8a8 linears in plain PyTorch "
          f"(fp64 products): max|d| {plain_d:.3e} (bar {bar:.3e}: the int8 UNet "
          f"{'equal to itself' if stable else 'against itself'})")
    if not (int8_rel <= INT8_EPS_REL_MAX and math.isfinite(int8_psnr)
            and int8_psnr > INT8_PSNR_DB and plain_d <= bar):
        fail("the int8 UNet or frame is further from bf16 than the bars, or the int8 UNet "
             "differs from its plain w8a8 version")
    _w8a8_fault_readings(bundle, spec, calls[0], embeds, (eps_lora, lora_out[0][0]), eps_int8,
                         bar)
    ms = _frame_in_turns({"bf16": program0, "int8": int8_program}, calls[0])
    int_mm_ms, bf16_mm_ms, mm_calls = _int_mm_device_ms(int8_program, calls[0])
    print(f"sd15 512x512 4-step CN+TAESD on {card}, replayed in {INT8_TURNS} alternating turns of "
          f"{INT8_TURN_FRAMES}: bf16 {ms['bf16']:.2f} ms/frame, int8 w8a8 {ms['int8']:.2f} "
          f"ms/frame; the first call's peak above what was allocated before it (warm-up, "
          f"capture, the graph's pool) bf16 {mem['bf16'] / 2**30:.3f} GiB, int8 "
          f"{mem['int8'] / 2**30:.3f} GiB; torch._int_mm {mm_calls} calls/frame, "
          f"{int_mm_ms:.3f} ms of device time per frame (each shape timed alone with CUDA "
          f"events), {100 * int_mm_ms / ms['int8']:.1f} % of the int8 frame; bf16 matmuls of the "
          f"same shapes {bf16_mm_ms:.3f} ms")
    _int8_layers_on_card(bundle.models["unet"])
    res.update(bundle=bundle, loras=loras, ms=ms, int_mm_ms=int_mm_ms, bf16_mm_ms=bf16_mm_ms,
               mm_calls=mm_calls, bytes={"bf16": bf16_bytes, "int8": int8_bytes}, mem=mem,
               psnr=int8_psnr, int8_rel=int8_rel, lora_rel=lora_rel, lora_psnr=lora_psnr)
    del int8_program
    return res


def phase_engine_lora_int8(card: str, main, g: dict, tmp: str) -> int:
    """6g (c): an ``Engine`` from a config with ``lora:`` (the two files)
    and ``quant: int8`` serving one 512x512 stream: its reply equal to a
    direct ``build_frame_program`` call on the phase's bundle (fused and
    quantized the same way) bit for bit; ``swap_params`` with the plain
    base state dicts re-fuses and re-quantizes, and the next reply equals
    the one before; ``stats()`` shows both.  Returns its K1 launches
    (warm-ups and captures, counted from 0 just before; each graph holds
    INT_MM_SD15 ``_int_mm`` launches for its K1_PER_FRAME)."""
    import asyncio
    import gc

    from videosd_tpu_torch.config import load_config
    from videosd_tpu_torch.runtime.engine import Engine

    _zero_counts()
    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        f.write("family: sd15\ndtype: bfloat16\nweights: random\nframe_hw: [512, 512]\n"
                "quant: int8\nlora:\n" + "".join(f"  - {{path: {p}, scale: {s}}}\n"
                                                 for p, s in g["loras"]))
    eng = Engine(load_config(path), max_streams=1, max_batch=1)
    eng.warmup(batch_sizes=(1,), steps=(4,), height=512, width=512)
    frame = np.random.default_rng(19).integers(0, 256, (512, 512, 3), dtype=np.uint8)

    async def serve(st, n):
        return [await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 120)
                for _ in range(n)]

    async def run():
        eng.start()
        try:
            st = eng.open_stream({"height": 512, "width": 512, "prompt": "a fox"})
            before = await serve(st, 3)
            eng.swap_params({n: m.state_dict() for n, m in main[0].models.items()},
                            source="base")
            after = await serve(st, 2)
            return st, before, after
        finally:
            await eng.stop()

    st, before, after = asyncio.run(run())
    launches, int_mm = fa.launches, layers.int_mm_launches
    embeds, _ = eng._encode_prompt("a fox")
    spec = FrameSpec(batch=1, height=512, width=512, in_height=512, in_width=512, steps=4)
    want = build_frame_program(g["bundle"], spec)(
        torch.from_numpy(frame[None]).cuda(), embeds, [0.6], [5.0], [2.0],
        [st.options["seed"]], warm_latents=torch.zeros((1, 64, 64, 4), device="cuda"),
        warm_alpha=[0.0], src_box=[[0, 0, 512, 512]])[0]
    same = bool(np.array_equal(before[-1], want[0].cpu().numpy()))
    kept = bool(np.array_equal(after[-1], before[-1]))
    s = eng.stats()
    print(f"engine with lora (2 files) and quant: int8 on {card}: {eng.telemetry.frames_out} "
          f"frames generated; reply equal to a direct build_frame_program call on the fused, "
          f"quantized bundle bit for bit: {same}; after swap_params with the plain base "
          f"state dicts, the next reply equal to the one before: {kept}; stats lora "
          f"{s.get('lora')}, quant {s.get('quant')}; K1 {launches}, _int_mm {int_mm} launches "
          f"(warm-ups and captures)")
    if not (same and kept and s.get("quant") == "int8" and len(s.get("lora") or []) == 2
            and launches > 0 and int_mm * K1_PER_FRAME == launches * INT_MM_SD15):
        fail("the engine with lora and quant: int8 did not serve the fused, quantized frame, "
             "or lost them in swap_params")
    del eng, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_sdxl_int8(card: str, sdxl: dict) -> tuple[int, dict]:
    """6g (d): the SDXL 1024x1024 4-step frame without the ControlNet on a
    random SDXL bundle in bf16 and the same bundle's weights quantized int8
    (seed 0 both): each replayed equal to eager, K1 and ``_int_mm``
    launches per frame at capture, UNet weight bytes, the capture's memory
    and the bundle's resident bytes, and replayed ms/frame in alternating
    turns (phase 6f's bf16 frame printed beside).  Returns the K1 launches
    (warm-ups and captures) and, for the profile after every timing, the
    int8 program with its call and replayed ms/frame."""
    import gc

    from videosd_tpu_torch.ops.quant import quant_stats, quantize_bundle_params

    kw = {"pooled_embeds": sdxl["pooled"]}
    calls = [((sdxl["frame"], sdxl["embeds"], *sdxl["args"][:3], [23 + i]), dict(kw))
             for i in range(2)]
    programs, launches, rows = {}, 0, {}
    for mode in ("bf16", "int8"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        bundle = ModelBundle.random("sdxl", dtype=torch.bfloat16, device="cuda",
                                    with_controlnet=False)
        if mode == "int8":
            quantize_bundle_params(bundle)
            torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() - held
        program = build_frame_program(bundle, FrameSpec(
            batch=1, height=SDXL_SIDE, width=SDXL_SIDE, steps=4, use_controlnet=False))
        capture = _captured(program, calls[0])
        counted = {}
        out = _replay_vs_eager(f"sdxl {SDXL_SIDE}x{SDXL_SIDE} 4-step TAESD {mode}", program,
                               calls, {"flash_attention": K1_SDXL_PER_FRAME[False],
                                       "int_mm": INT_MM_SDXL if mode == "int8" else 0}, counted)
        _check_frame(f"sdxl {mode}", out[-1], SDXL_SIDE)
        launches += counted["flash_attention"]
        programs[mode] = program
        rows[mode] = {"unet": _weight_bytes(bundle.models["unet"]), "resident": resident,
                      "capture": capture, "stats": quant_stats(bundle.models["unet"])}
        del bundle, out
    ms = _frame_in_turns(programs, calls[0], turns=2, frames=4)
    print(f"sdxl {SDXL_SIDE}x{SDXL_SIDE} 4-step TAESD (no ControlNet) on {card}, replayed in 2 "
          f"alternating turns of 4: bf16 {ms['bf16']:.2f} ms/frame, int8 w8a8 {ms['int8']:.2f} "
          f"(phase 6f's bf16 frame {sdxl['replay_ms']:.2f}); " + "; ".join(
              f"{m}: UNet {r['unet'] / 2**30:.3f} GiB ({r['stats']}), bundle resident "
              f"{r['resident'] / 2**30:.3f} GiB, first call's peak above it "
              f"{r['capture'] / 2**30:.3f} GiB" for m, r in rows.items()))
    int8 = {"program": programs.pop("int8"), "call": calls[0], "replay_ms": ms["int8"]}
    del programs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, int8


def phase_tools(card: str) -> dict:
    """6g (e): each tool of ``videosd_tpu_torch/tools`` in a process of its
    own (TOOL_RUNS_CARD one at a time, the two toy gates beside the soak),
    its JSON printed and its identity rows held."""
    reports, cwd = {}, os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        procs = {}
        for name, argv in TOOL_RUNS_CARD.items():
            if name == "soak":
                for toy, toy_argv in TOOL_RUNS_TOY.items():
                    out = os.path.join(tmp, toy + ".json")
                    with open(out + ".log", "w") as log:  # a file: no pipe to fill meanwhile
                        procs[toy] = (out, time.perf_counter(), subprocess.Popen(
                            [sys.executable, "-m", *toy_argv, "--json", out], stdout=log,
                            stderr=subprocess.STDOUT, cwd=cwd))
            out = os.path.join(tmp, name + ".json")
            _run_tool([*argv, "--json", out], name, timeout=TOOL_S)
            with open(out) as f:
                reports[name] = json.load(f)
        for name, (out, t0, proc) in procs.items():
            try:
                proc.wait(timeout=TOOL_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                fail(f"{name} ran past {TOOL_S} s")
            with open(out + ".log") as f:
                lines = f.read().splitlines()
            print("\n".join(f"   {ln}" for ln in lines[-8:]))
            print(f"{name}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s "
                  f"(beside the soak)")
            if proc.returncode:
                print("\n".join(lines[-60:]))
                fail(f"{name} exited {proc.returncode}")
            with open(out) as f:
                reports[name] = json.load(f)
    rows = reports["temporal_gate"]
    drift = reports["ref_gate"]["drift"]
    frames = int(TOOL_RUNS_TOY["ref_gate"][TOOL_RUNS_TOY["ref_gate"].index("--frames") + 1])
    soak_r = reports["soak"]
    checks = {
        "temporal_gate N=1 at identity": rows[0]["every"] == 1 and rows[0]["psnr_min"] == math.inf,
        "ref_gate sf=0 at identity": drift[0]["style_fidelity"] == 0
        and drift[0]["identity_frames"] == frames,
        "flicker rows with frames/s": all(r["fps"] and r["fps"] > 0
                                          for r in reports["flicker"]),
        "taesd_ab routes agree": all(v > TAESD_AB_PSNR_DB
                                     for v in reports["taesd_ab"]["psnr_db"].values())
        and len(reports["taesd_ab"]["pairs"]) > 0,
        "ref_gate frames/s": reports["ref_gate_fps"].get("fps_ref", 0) > 0,
        "soak stable": soak_r["programs_stable"] and soak_r["rss_ok"]
        and soak_r["frames_served"] > 0 and soak_r["graphs_final"] > 0,
    }
    for name, r in reports.items():
        r = {k: v for k, v in r.items() if k != "samples"} if isinstance(r, dict) else r
        print(f"tool {name} on {card}: {json.dumps(r)}")
    print(f"tools' identity rows and checks: {checks}")
    if not all(checks.values()):
        fail(f"a tool's identity row or check failed: {checks}")
    return reports


def phase_6g(card: str, main, sdxl: dict) -> dict:
    """6g: LoRA and int8 w8a8 on the serving paths, then the tools."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        g = phase_lora_int8(card, main, tmp)
        g["launches"] += phase_engine_lora_int8(card, main, g, tmp)
    del g["bundle"]
    torch.cuda.empty_cache()
    launches, g["sdxl_int8"] = phase_sdxl_int8(card, sdxl)
    g["launches"] += launches
    g["tools"] = phase_tools(card)
    print(f"phase 6g took {time.perf_counter() - t_phase:.1f} s")
    return g


# phase 6h: the mesh's slots on this one card (every slot is cuda:0, so the
# numerics, partial sums, launch counts and placement are the real ones and
# no traffic crosses cards); the (2 x 2) fp32 verify's bars are JAX's
# (videosd_tpu/parallel/verify.py: images within 2 levels, latents 1e-4);
# the tensor-parallel frame's replays timed in turns with the single-device
# frame's; the pipelined bf16 frames timed alone (they run eagerly)
MESH_SLOTS = [torch.device("cuda", 0)] * 4
MESH_TURNS, MESH_TURN_FRAMES, PIPE_FRAMES = 3, 4, 4
# phase 6j: two processes on cuda:0, each given this long; the group's
# rendezvous and collectives wait at most MESH_DIST_TIMEOUT_S; the train
# step across them at sd15 fp32 256x256, batch 2, two steps; its first
# step's gradients against the one-process step's, as max |d| over each
# tensor's largest.  The two sum the rows' gradients alike (g0 + g1, once
# through host memory), but the rows' gradients are not reproducible:
# cuDNN's default convolution backward algorithms sum in another order from
# run to run.  Readings (H100): the one-process step against itself
# 4.573e-6, the step across processes against it 4.6e-6 to 4.9e-6, both 0
# with cudnn.deterministic (re-read every run); the all-reduce skipped (a
# planted fault, re-read every run) 1.078.  The bar sits 20x above the
# first and 1e4x below the second
MESH_CHILD_S, MESH_DIST_TIMEOUT_S = 240, 120
MESH_CHILD_TRAIN_SIDE, MESH_CHILD_STEPS, MESH_CHILD_GRAD_REL = 256, 2, 1e-4
# K1 launches a process makes a step at 256^2 (one data row, one model
# rank): the routed self-attentions at 1024 and 256 tokens (down 0-1 x 2,
# up 2-3 x 3); the 64-token stage stays on the plain route
MESH_CHILD_K1_PER_STEP = 10


def _mesh_rows_vs_eager(name: str, program, got) -> None:
    """Each data row's share of ``got`` (the program's last call, replayed
    from the rows' graphs) against the row's body run eagerly on the same
    staged buffers, bit for bit."""
    for i, (row, rows) in enumerate(zip(program.programs, program.rows)):
        (bucket,) = row.buckets.values()
        with torch.inference_mode():
            eager = bucket.body(**bucket.buffers)
        torch.cuda.synchronize()
        if not _same([x[rows] for x in got], eager):
            fail(f"{name}: data row {i}'s replay differs from its eager body")


def phase_6h(card: str, main) -> dict:
    """6h: more than one device, on one card (``videosd_tpu_torch/parallel``).
    (a) ``verify_flagship_dp_tp`` in fp32 on a (2 x 2) mesh; (b) bf16 data
    parallelism on (2 x 1): each row bit for bit the single-device program
    on that row alone, replay = eager; (c) bf16 tensor parallelism on
    (1 x 2): K1 launches at capture, the image against the single-device
    one, ms/frame in turns; (d) the pipeline (2 stages of 1 x 1): fp32
    verify, bf16 against the single-device image, ``run_pipelined`` =
    ``run``, each stage's weight bytes from the placement record; (e) the
    engine over two slots against a direct ``ShardedFrameEngine`` call,
    and ``gpus=2`` without ``devices=`` falling back with JAX's warning.
    Returns the K1 launches (bf16 and fp32), counted from 0 before each
    path, and the readings."""
    import asyncio
    import gc

    from videosd_tpu_torch.config import ServerConfig
    from videosd_tpu_torch.parallel.pipe import PipelinedFrameEngine
    from videosd_tpu_torch.parallel.serving import ShardedFrameEngine
    from videosd_tpu_torch.parallel.verify import verify_flagship_dp_tp, verify_pipeline_parallel
    from videosd_tpu_torch.runtime.engine import Engine

    t_phase = time.perf_counter()
    print(f"phase 6h mesh slots: {[str(d) for d in MESH_SLOTS]} (one card: every slot is "
          f"cuda:0, no traffic crosses cards)")
    res = {"launches": 0, "fp32_launches": 0}

    def counted():
        torch.cuda.synchronize()
        res["launches"] += fa.launches
        res["fp32_launches"] += fa.launches_fp32
        _zero_counts()

    # (a) fp32 sd15 512^2 4 steps, ControlNet + TAESD, TF32 off, on (2 data x 2 model)
    _zero_counts()
    a = verify_flagship_dp_tp(devices=MESH_SLOTS, model_parallel=2, family="sd15", size=512,
                              steps=4, dtype=torch.float32)
    a_fp32 = fa.launches_fp32
    counted()
    print(f"6h (a) verify_flagship_dp_tp fp32 sd15 512x512 4-step CN+TAESD on a {a['mesh']} mesh, "
          f"batch {a['batch']}, against the single-device program: image max|d| {a['max_diff']} "
          f"levels (bar 2), mean|d| {a['mean_diff']:.4f}; latents within 1e-4: "
          f"{a['latents_allclose']}, rel L2 {a['latents_rel_l2']:.3e}; {a_fp32} fp32 K1 launches "
          f"(both programs' warm-ups and captures)")
    gc.collect()
    torch.cuda.empty_cache()

    bundle, embeds, frame, args, img, parity = main
    rng = np.random.default_rng(61)
    frame2 = torch.cat([frame, torch.from_numpy(
        rng.integers(0, 256, frame.shape, dtype=np.uint8)).cuda()])
    args2 = ([0.6, 0.45], [5.0, 4.0], [2.0, 1.5], [23, 41])

    # (b) bf16 data parallelism on (2 x 1) at batch 2
    dp = ShardedFrameEngine(bundle, devices=MESH_SLOTS[:2])
    dp_prog = dp.program(FrameSpec(batch=2, height=512, width=512, steps=4))
    got = dp_prog(frame2, embeds.expand(2, -1, -1), *args2)
    rows_same = []
    for i in range(2):
        alone = parity(frame2[i:i + 1], embeds, *([a2[i]] for a2 in args2))
        rows_same.append(_same([x[i:i + 1] for x in got], alone))
    dp_launches = dp_prog.last_launches["flash_attention"]
    _mesh_rows_vs_eager("6h (b)", dp_prog, got)
    counted()
    print(f"6h (b) bf16 sd15 512x512 4-step CN+TAESD batch 2 on a (2 x 1) mesh: each row equal bit "
          f"for bit to the single-device program on that row alone: {rows_same}; replay = eager "
          f"in each row; K1 {dp_launches} launches per batch at capture (84 a row)")
    if not all(rows_same) or dp_launches != 2 * K1_PER_FRAME or dp_prog.graphs != 2:
        fail("6h (b): a data row differs from the single-device program, or its graph")

    # (c) bf16 tensor parallelism on (1 x 2)
    tp = ShardedFrameEngine(bundle, devices=MESH_SLOTS[:2], model_parallel=2)
    tp_prog = tp.program(parity.spec)
    out_tp = tp_prog(frame, embeds, *args)
    tp_k1 = tp_prog.last_launches["flash_attention"]
    psnr_tp = _psnr(out_tp[0], img)
    _mesh_rows_vs_eager("6h (c)", tp_prog, out_tp)
    counted()
    turns = []
    for _ in range(MESH_TURNS):
        row = {}
        for name, prog in (("single", parity), ("tp2", tp_prog)):
            ms = []
            for _ in range(MESH_TURN_FRAMES):
                t0 = time.perf_counter()
                prog(frame, embeds, *args)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            row[name] = statistics.median(ms)
        turns.append(row)
    res["tp_ms"] = statistics.median(r["tp2"] for r in turns)
    res["single_ms"] = statistics.median(r["single"] for r in turns)
    print(f"6h (c) bf16 sd15 512x512 4-step CN+TAESD on a (1 x 2) mesh on {card}: K1 {tp_k1} "
          f"launches per frame at capture (84 x 2); image PSNR vs the single-device image "
          f"{psnr_tp:.2f} dB (bound {FRAME_PSNR_DB:g}); replay = eager; replayed ms/frame in "
          f"{MESH_TURNS} turns of {MESH_TURN_FRAMES} (single-device, tp2): "
          + ", ".join(f"({r['single']:.2f}, {r['tp2']:.2f})" for r in turns))
    if tp_k1 != 2 * K1_PER_FRAME or psnr_tp < FRAME_PSNR_DB or tp_prog.graphs != 1:
        fail("6h (c): the tensor-parallel frame's K1 launches, image or graph")
    del dp, dp_prog, tp, tp_prog
    gc.collect()

    # (d) the pipeline: fp32 verify, then bf16 on the phase-5 bundle
    _zero_counts()
    d = verify_pipeline_parallel(devices=MESH_SLOTS[:2], model_parallel=1, family="sd15",
                                 size=512, steps=4, dtype=torch.float32)
    counted()
    print(f"6h (d) verify_pipeline_parallel fp32 sd15 512x512 4-step CN+TAESD, 2 stages of "
          f"{d['stage_mesh']}: image max|d| {d['max_diff']} levels (bar 2), mean|d| "
          f"{d['mean_diff']:.4f}; latents within 1e-4: {d['latents_allclose']}, rel L2 "
          f"{d['latents_rel_l2']:.3e}; stage weight bytes {d['stage_bytes']}")
    gc.collect()
    torch.cuda.empty_cache()
    pipe = PipelinedFrameEngine(bundle, devices=MESH_SLOTS[:2])
    stage_bytes = [sum(p.nbytes() for p in pipe.placements(st)) for st in (0, 1)]
    out_p = pipe.run(parity.spec, frame, embeds, *args)
    pipe_k1 = fa.launches
    psnr_p = _psnr(out_p[0], img)
    ms = []
    for _ in range(PIPE_FRAMES):
        t0 = time.perf_counter()
        pipe.run(parity.spec, frame, embeds, *args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counted()
    res["pipe_ms"] = statistics.median(ms)
    mb = [dict(frame_u8=frame2[i:i + 1], embeds=embeds, strength=[args2[0][i]],
               guidance=[args2[1][i]], cn=[args2[2][i]], seed=[args2[3][i]]) for i in range(2)]
    inter = pipe.run_pipelined(parity.spec, mb)
    solo = [pipe.run(parity.spec, **m) for m in mb]
    counted()
    same_pp = [_same(x, y) for x, y in zip(inter, solo)]
    print(f"6h (d) bf16 pipeline, 2 stages of (1 x 1), sd15 512x512 4-step CN+TAESD on {card}: "
          f"image PSNR vs the single-device image {psnr_p:.2f} dB (bound {FRAME_PSNR_DB:g}); "
          f"eager ms/frame median {res['pipe_ms']:.2f} over {PIPE_FRAMES} (min {min(ms):.2f}); "
          f"K1 {pipe_k1} launches a frame; run_pipelined over 2 microbatches equal to run: "
          f"{same_pp}; stage weight bytes (placement record) {stage_bytes} "
          f"({stage_bytes[0] / 2**30:.3f} / {stage_bytes[1] / 2**30:.3f} GiB)")
    if psnr_p < FRAME_PSNR_DB or not all(same_pp) or pipe_k1 != K1_PER_FRAME:
        fail("6h (d): the pipelined bf16 frame, its K1 launches, or run_pipelined")
    del pipe, inter, solo
    gc.collect()

    # (e) the engine over two slots, and gpus=2 without devices= on one card
    eng = Engine(ServerConfig(gpus=2), bundle=bundle, max_streams=1, max_batch=2,
                 frame_hw=(512, 512), devices=MESH_SLOTS[:2])
    eng.warmup(batch_sizes=(1,), steps=(4,), height=512, width=512)  # the batch-2 bucket
    cam = frame[0].cpu().numpy()

    async def serve():
        eng.start()
        try:
            st = eng.open_stream({"height": 512, "width": 512, "prompt": "portrait, pixar, cg"})
            outs = [await asyncio.wait_for(eng.submit_frame(st.stream_id, cam), 120)
                    for _ in range(3)]
            return st, outs
        finally:
            await eng.stop()

    st, outs = asyncio.run(serve())
    counted()
    e_embeds, _ = eng._encode_prompt("portrait, pixar, cg")
    direct = ShardedFrameEngine(bundle, devices=MESH_SLOTS[:2])
    spec = FrameSpec(batch=2, height=512, width=512, in_height=512, in_width=512, steps=4)
    want = direct.run(spec, frame.expand(2, -1, -1, -1), e_embeds.expand(2, -1, -1),
                      [0.6] * 2, [5.0] * 2, [2.0] * 2, [st.options["seed"]] * 2,
                      warm_latents=torch.zeros((2, 64, 64, 4), device="cuda"),
                      warm_alpha=[0.0] * 2, src_box=[[0, 0, 512, 512]] * 2)[0]
    _zero_counts()  # the direct call's launches compare; they are not counted
    same_e = bool(np.array_equal(outs[-1], want[0].cpu().numpy()))
    devices_e = eng.stats()["devices"]

    class _Warnings(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    seen = _Warnings()
    logging.getLogger("videosd_tpu_torch.engine").addHandler(seen)
    try:
        short = Engine(ServerConfig(gpus=2), frame_hw=(512, 512))
        fallback = (short.mesh, short.stats()["devices"])
    finally:
        logging.getLogger("videosd_tpu_torch.engine").removeHandler(seen)
    warned = any("gpus=2 but only 1 device(s) exist; serving on 1" in m for m in seen.messages)
    print(f"6h (e) Engine(ServerConfig(gpus=2), devices=[cuda:0, cuda:0]) on {card}: "
          f"{eng.telemetry.frames_out} frames generated, stats devices {devices_e}, the reply "
          f"equal bit for bit to a direct ShardedFrameEngine call: {same_e}; "
          f"Engine(ServerConfig(gpus=2)) on {torch.cuda.device_count()} card(s): mesh "
          f"{fallback[0]}, stats devices {fallback[1]}, warned: {warned} ({seen.messages})")
    if (not same_e or devices_e != {"data": 2, "model": 1} or not eng.telemetry.frames_out
            or fallback != (None, {"data": 1, "model": 1}) or not warned):
        fail("6h (e): the engine over the mesh, or its fallback on one card")
    del eng, direct, want, short
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 6h took {time.perf_counter() - t_phase:.1f} s")
    return res


def _gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def mesh_child_main(rank: int, addr: str) -> None:
    """One of phase 6j's two processes (``chip_smoke.py --mesh-child RANK
    ADDR``), both on ``cuda:0``: it joins the group at ``tcp://ADDR`` with 4
    local slots, then runs (a) JAX's psum case, (b) the sd15 bf16 512x512
    4-step CN+TAESD serving program at batch 2 on a (2 x 1) mesh of one
    slot a process, its row against the single-device program on that row
    bit for bit, (c) the sharded UNet train step at sd15 fp32 256x256 batch
    2 (AdamW) on that mesh across the processes, then, in rank 0, the
    one-process step on a (2 x 1) mesh of cuda:0 slots from the same start
    and draws, that step against itself (cuDNN free, then deterministic),
    and the step across processes with its all-reduce skipped (a planted
    fault).  Prints one ``MESH_CHILD_RESULT {json}`` line; any failure
    exits nonzero."""
    import faulthandler

    import torch.distributed as dist

    from videosd_tpu_torch.parallel import mesh as pmesh
    from videosd_tpu_torch.parallel.serving import ShardedFrameEngine

    faulthandler.dump_traceback_later(MESH_CHILD_S - 20, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    n = pmesh.init_distributed(addr, num_processes=2, process_id=rank, devices=[cuda] * 4,
                               timeout=MESH_DIST_TIMEOUT_S)
    world = pmesh.world()
    out = {"rank": rank, "backend": world.backend, "slots": n}
    print(f"6j rank {rank}: init_distributed over tcp://{addr}: {n} slots ({len(world.local)} "
          f"local), data-axis reductions over {world.backend}", flush=True)

    # (a) JAX's psum case (tests/test_multihost.py)
    mesh8 = pmesh.make_mesh(8, model_parallel=2)
    full = torch.arange(8.0, device=cuda)
    psum = pmesh.reduce_data([full[2 * i:2 * i + 2] for i in mesh8.local_rows()], mesh8)
    try:
        pmesh.make_mesh(8, model_parallel=8)
        spans = "no error"
    except ValueError as e:
        spans = str(e)
    out["psum"] = psum.tolist()
    if out["psum"] != [12.0, 16.0] or "span processes" not in spans:
        fail(f"6j rank {rank}: psum over data {out['psum']} (want [12, 16]), a row across "
             f"processes: {spans}")

    # (b) serving, one row a process
    mesh = pmesh.Mesh([slots[0] for slots in world.slots], processes=range(world.size))
    bundle = ModelBundle.random("sd15", dtype=torch.bfloat16, device="cuda")
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    rng = np.random.default_rng(61)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 512, 512, 3), dtype=np.uint8)).cuda()
    args = ([0.6, 0.45], [5.0, 4.0], [2.0, 1.5], [23, 41])
    spec = FrameSpec(batch=2, height=512, width=512, steps=4)
    eng = ShardedFrameEngine(bundle, mesh=mesh)
    _zero_counts()
    shards = eng.program(spec).shards(frames, embeds.expand(2, -1, -1), *args)
    torch.cuda.synchronize()
    out["serve_launches"] = fa.launches
    _zero_counts()  # the single-device program below compares; it is not counted
    ((rows, got),) = shards
    alone = build_frame_program(bundle, dataclasses.replace(spec, batch=1))(
        frames[rows], embeds, *(a[rows] for a in args))
    out["serve_rows"] = [rows.start, rows.stop]
    out["serve_same"] = _same(got, alone)
    out["serve_peak_gib"] = _gib()
    print(f"6j rank {rank}: serving rows {out['serve_rows']} of batch 2 equal bit for bit to the "
          f"single-device program on them: {out['serve_same']}; {out['serve_launches']} K1 "
          f"launches (warm-up and capture); peak {out['serve_peak_gib']:.2f} GiB", flush=True)
    if (rows != slice(rank, rank + 1) or not out["serve_same"]
            or out["serve_launches"] != 2 * K1_PER_FRAME):
        fail(f"6j rank {rank}: the serving row, or its K1 launches (want {2 * K1_PER_FRAME}: "
             f"{K1_PER_FRAME} a frame, warm-up and capture)")
    del eng, shards, got, alone, bundle, embeds
    torch.cuda.empty_cache()

    # (c) the sharded train step across the two processes
    side, b = MESH_CHILD_TRAIN_SIDE, TRAIN_BATCH
    tb = ModelBundle.random("sd15", dtype=torch.float32, device="cuda", with_controlnet=False)
    unet = tb.models["unet"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    cfg = tb.unet_cfg
    batch = {"latents": torch.randn(b, side // 8, side // 8, 4, generator=gen, device="cuda"),
             "context": torch.randn(b, 77, cfg.cross_attention_dim, generator=gen,
                                    device="cuda"),
             "w_cond": layers.guidance_embedding(torch.full((b,), 5.0, device="cuda"),
                                                 cfg.time_cond_proj_dim)}
    start = _host_copy(unet) if rank == 0 else None

    def steps(step_mesh, n=MESH_CHILD_STEPS, keep="cpu"):
        state = train_step.init_train_state(unet, optim.adamw(TRAIN_LR))
        step = train_step.make_train_step(tb.sched_cfg, mesh=step_mesh)
        draw = torch.Generator(device="cuda").manual_seed(11)
        losses, parts, first = [], [], None
        for i in range(n):
            loss, timed = _timed_step(lambda: step(state, batch, generator=draw),
                                      state["optimizer"])
            losses.append(loss)
            parts.append(timed)
            if i == 0:
                first = {n: p.grad.detach().to(keep, copy=True)
                         for n, p in unet.named_parameters()}
        del state, step
        return losses, parts, first

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, parts, grads = steps(mesh)
    torch.cuda.synchronize()
    out.update(train_launches=fa.launches_fp32, train_bwd_launches=fa.launches_bwd_fp32,
               train_losses=losses,
               train_ms=[p["wall"] for p in parts], train_parts=parts, train_peak_gib=_gib())
    digest = [float(p.detach().double().sum()) for p in unet.parameters()]
    both = [None, None]
    dist.all_gather_object(both, digest)
    out["same_weights"] = both[0] == both[1]
    print(f"6j rank {rank}: sharded step across 2 processes, sd15 fp32 {side}x{side} batch {b} "
          f"AdamW: losses {losses}; host ms per step: {'; '.join(map(_parts_text, parts))}; "
          f"{out['train_launches']} fp32 K1 launches, {out['train_bwd_launches']} of the "
          f"backward kernels, peak {out['train_peak_gib']:.2f} GiB; "
          f"both processes' weights equal: {out['same_weights']}", flush=True)
    # every routed attention of a UNet train step is K1': one backward launch each
    want = MESH_CHILD_STEPS * MESH_CHILD_K1_PER_STEP
    if not out["same_weights"] or out["train_launches"] != want \
            or out["train_bwd_launches"] != want:
        fail(f"6j rank {rank}: the processes' weights differ, or the K1 launches, or its "
             f"backward's")
    # both processes give their memory back before rank 0 runs the
    # one-process step alone (the card is shared with the parent)
    after = _host_copy(unet) if rank == 0 else None
    unet.zero_grad(set_to_none=True)
    if rank:
        del tb, unet, batch
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        def restore():
            with torch.no_grad():
                for n, p in unet.named_parameters():
                    p.copy_(start[n])

        def rel(got, want):
            return max(((got[n] - g).abs().max().item() / g.abs().max().item(), n)
                       for n, g in want.items())

        restore()
        one_mesh = pmesh.make_mesh(devices=[cuda] * 2)
        one_losses, _, one_grads = steps(one_mesh)
        grad_err = rel(grads, one_grads)
        num = sum((p.detach().cpu().double() - after[n].double()).pow(2).sum().item()
                  for n, p in unet.named_parameters())
        den = sum(p.detach().cpu().double().pow(2).sum().item() for p in unet.parameters())
        # the backward's own spread: the one-process step again from the same
        # start and draws; then twice with cuDNN held to deterministic
        # algorithms (these runs keep their start and gradients on the card)
        start = {n: t.to(cuda) for n, t in start.items()}
        want = {n: g.to(cuda) for n, g in one_grads.items()}
        restore()
        spread = rel(steps(one_mesh, 1, cuda)[2], want)
        torch.backends.cudnn.deterministic = True
        try:
            restore()
            det = steps(one_mesh, 1, cuda)[2]
            restore()
            det_spread = rel(steps(one_mesh, 1, cuda)[2], det)
        finally:
            torch.backends.cudnn.deterministic = False
        del det
        # a planted fault: the step across processes with its all-reduce
        # skipped, so that this process keeps its own row's gradient
        saved = pmesh._all_reduce
        pmesh._all_reduce = lambda t: None
        try:
            restore()
            fault = rel(steps(mesh, 1, cuda)[2], want)
        finally:
            pmesh._all_reduce = saved
        del start, want
        out.update(one_process_losses=one_losses, grad_rel_max=grad_err[0],
                   weights_rel_l2=math.sqrt(num / den), repeat_rel_max=spread[0],
                   deterministic_repeat_rel_max=det_spread[0], fault_rel_max=fault[0])
        print(f"6j rank 0: against the one-process step on a (2 x 1) mesh of cuda:0 slots: "
              f"losses {one_losses}; first step's gradients max |d| / max |g| {grad_err[0]:.3e} "
              f"({grad_err[1]}; bar {MESH_CHILD_GRAD_REL:g}); weights after "
              f"{MESH_CHILD_STEPS} steps relative L2 {out['weights_rel_l2']:.3e} "
              f"(bar {MESH_TRAIN_REL_L2:g}); the one-process step against itself "
              f"{spread[0]:.3e} ({spread[1]}), with cuDNN deterministic {det_spread[0]:.3e} "
              f"({det_spread[1]}); the planted fault (the all-reduce skipped) {fault[0]:.3e} "
              f"({fault[1]})", flush=True)
        if (grad_err[0] > MESH_CHILD_GRAD_REL or out["weights_rel_l2"] > MESH_TRAIN_REL_L2
                or spread[0] > MESH_CHILD_GRAD_REL or fault[0] <= MESH_CHILD_GRAD_REL):
            fail("6j: the step across processes is off the one-process step, the one-process "
                 "step off itself, or the planted fault passes")
    dist.barrier()
    pmesh.shutdown_distributed()
    print("MESH_CHILD_RESULT " + json.dumps(out), flush=True)


def phase_6j(card: str) -> dict:
    """6j: two processes on ``cuda:0`` (:func:`mesh_child_main`), each under a
    timeout; the parent frees its cache first.  A child's failure, a run
    past its time or a missing result fails the run.  Returns the
    children's results and the K1 launches of their main paths."""
    import socket

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_allocated() / 2**30, torch.cuda.memory_reserved() / 2**30)
    sock = socket.socket()
    sock.bind(("localhost", 0))
    addr = f"localhost:{sock.getsockname()[1]}"
    sock.close()
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, "--mesh-child", str(r), addr],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=os.path.dirname(here)) for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=MESH_CHILD_S)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                text = p.communicate()[0]  # a retried communicate loses no output
                fail_child(f"6j rank {r} (killed after {MESH_CHILD_S} s)", p.returncode,
                           text.splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = text.splitlines()
        print("\n".join(f"   [6j rank {r}] {ln}" for ln in lines[-40:]
                        if not ln.startswith("MESH_CHILD_RESULT ")))
        found = [json.loads(ln.split(" ", 1)[1]) for ln in lines
                 if ln.startswith("MESH_CHILD_RESULT ")]
        if p.returncode:
            fail_child(f"6j rank {r}", p.returncode, lines)
        if not found:
            fail(f"6j: rank {r} exited 0 without its result")
        results.append(found[0])
    res = {"children": results,
           "launches": sum(c["serve_launches"] for c in results),
           "fp32_launches": sum(c["train_launches"] for c in results),
           "bwd_launches": sum(c["train_bwd_launches"] for c in results)}
    print(f"6j two processes on {card}, backend {results[0]['backend']}: psum {results[0]['psum']}; "
          f"serving rows bit for bit {[c['serve_same'] for c in results]}; train step ms per "
          f"process {[c['train_ms'] for c in results]}; peak GiB per process (serving, training) "
          f"{[(round(c['serve_peak_gib'], 2), round(c['train_peak_gib'], 2)) for c in results]} "
          f"beside the parent's {held[0]:.2f} GiB allocated, {held[1]:.2f} reserved; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return res


def main() -> None:
    import faulthandler

    faulthandler.dump_traceback_later(1100, exit=True)  # a hang shows where, then ends
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
    engine_res = phase_engine(card, main)
    server_launches = phase_server_process(card, engine_res)
    kl = phase_kl(card)
    fp32_frame = phase_fp32_frame(card)
    sd21 = phase_sd21(card)
    sdxl = phase_sdxl(card)
    phase_bench(main[0])
    train = phase_train(card)
    phase_toy(card)
    g = phase_6g(card, main, sdxl)
    mesh = phase_6h(card, main)
    processes = phase_6j(card)
    k1_times, k1_fp32_times, k1_wide_times, k1_wide_fp32_times = phase_k1_times(card, clock)
    k1_prime = phase_k1_prime(card, clock)
    k2_res = phase_k2(card, clock)
    k3_res = phase_k3(card, clock)
    k3_fp32_res = phase_k3_fp32(card, clock)
    k2_launches = phase_k2_path(main[2])
    k3_fp32_launches = phase_taesd_routes(card, main[0])
    phase_profile(card, main, replay_ms)
    phase_kl_profile(card, kl)
    phase_fp32_profile(card, fp32_frame)
    phase_ref_profile(card, ref)
    phase_sd21_profile(card, sd21)
    phase_sdxl_profile(card, sdxl)
    phase_sdxl_int8_profile(card, g.pop("sdxl_int8"))
    k1_src, k3_src = "videosd_tpu/ops/pallas/flash_attention.py:83", "videosd_tpu/ops/pallas/taesd_conv.py:231"
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention.cu", "replaces": k1_src,
         "launches": (k1_launches + ref_launches + server_launches + sd21["launches"]
                      + sdxl["launches"] + g["launches"] + mesh["launches"]
                      + processes["launches"]),
         "max_abs_err": k1_err, **k1_times},
        {"name": "flash_attention_fp32", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention_fp32.cu", "replaces": k1_src,
         "launches": fp32_frame["launches"] + mesh["fp32_launches"],
         "max_abs_err": k1_fp32_err, **k1_fp32_times},
        {"name": "flash_attention_wide", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention_wide.cu", "replaces": k1_src,
         "launches": kl["launches"], "max_abs_err": k1_wide_err, **k1_wide_times},
        {"name": "flash_attention_wide_fp32", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention_wide_fp32.cu", "replaces": k1_src,
         "launches": kl["fp32_launches"], "max_abs_err": k1_wide_fp32_err, **k1_wide_fp32_times},
        {"name": "flash_attention_recompute", "route": "cuda",
         "source": "videosd_tpu_torch/csrc/flash_attention_bwd_fp32.cu",
         "sources": ["videosd_tpu_torch/csrc/flash_attention_fp32.cu",
                     "videosd_tpu_torch/csrc/flash_attention_bwd_fp32.cu",
                     "videosd_tpu_torch/csrc/flash_attention_bwd.cu"],
         "function": "videosd_tpu_torch/models/layers.py::FlashAttentionRecompute",
         "replaces": "videosd_tpu/models/layers.py:283",
         # the backward kernel pair's launches on the train paths (6e, 6i, 6j)
         "launches": (train["bwd_launches"] + train["mesh"]["bwd_launches"]
                      + processes["bwd_launches"]),
         "forward_launches": (train["launches"] + train["mesh"]["launches"]
                              + processes["fp32_launches"]),
         **k1_prime},
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
    if sys.argv[1:2] == ["--server"]:
        server_main(sys.argv[2])
    elif sys.argv[1:2] == ["--mesh-child"]:
        mesh_child_main(int(sys.argv[2]), sys.argv[3])
    else:
        main()
