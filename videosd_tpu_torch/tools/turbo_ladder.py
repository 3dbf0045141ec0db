"""Measure and quality-gate the turbo ladder on the port.

Counterpart of ``videosd_tpu/tools/turbo_ladder.py``.  Sweeps the two
opt-in approximation knobs of ``FrameSpec`` -- ``controlnet_interval`` and
``deepcache_interval`` (with ``interval_refresh_last``) -- on the 4-step
img2img frame program and reports for each configuration its image quality
against the parity program (cn = 1, dc = 1) as PSNR/SSIM over a fixed set
of frames and seeds (``ops/metrics.py``) and, unless ``--skip-fps``, its
frames/s (best of ``--windows`` windows, two calls in flight) and p50
blocking latency on the card.

Both programs run the same weights on the same inputs, so PSNR/SSIM measure
the approximation error the knob introduces.  ``--weights`` takes a
checkpoint directory of either layout (``ModelBundle.from_dir``: a
``save_bundle`` directory such as ``tools/train_toy.py``'s output, whose
family it records, or a diffusers snapshot of ``--family``); without it the
weights are random, of ``--family`` (default sd15, as the JAX tool), in
bf16.  The program runs on ``--device`` (default ``cuda``; frames/s need the
card).

Usage:
    python -m videosd_tpu_torch.tools.turbo_ladder [--quality-frames 4]
        [--windows 3] [--json OUT.json] [--skip-fps] [--weights DIR]
        [--family sd15] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def structured_frame(idx: int, h: int = 512, w: int = 512) -> np.ndarray:
    """Deterministic structured test frame: gradients + disks + stripes.

    Structured (not iid noise) so the canny edge map carries real edges and
    SSIM's local statistics vary across the image like a camera frame's.
    """
    rng = np.random.default_rng(1000 + idx)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = xx / w * 255.0
    img[..., 1] = yy / h * 255.0
    img[..., 2] = ((xx + yy) / (h + w) * 255.0 + 40 * np.sin(xx / 17.0)) % 255.0
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(h / 16, h / 4)
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img[mask] = rng.uniform(0, 255, 3)
    stripes = ((xx // 24).astype(int) % 2 == 0) & (yy > h * 0.7)
    img[stripes] = 255.0 - img[stripes]
    img += rng.normal(0, 6.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# (controlnet_interval, deepcache_interval, interval_refresh_last);
# (1, 1, False) is reference parity.  The +last rows re-evaluate both
# caches on the final denoise step (FrameSpec.interval_refresh_last) --
# round-4 trained-weight gating found final-step freshness dominates
# interval quality cost.
LADDER = [
    (1, 1, False),
    (2, 1, False),
    (4, 1, False),
    (1, 2, False),
    (1, 3, False),
    (2, 2, False),
    (4, 2, False),
    (4, 3, False),
    (2, 1, True),
    (4, 1, True),
    (2, 2, True),
    (4, 2, True),
]


def parse_ladder(text: str) -> list:
    """"cn:dc[,cn:dc+last,...]" -> [(cn, dc, refresh_last), ...]."""
    out = []
    for part in text.split(","):
        part = part.strip()
        rl = part.endswith("+last")
        if rl:
            part = part[: -len("+last")]
        cn, dc = part.split(":")
        out.append((int(cn), int(dc), rl))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quality-frames", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--frames-per-window", type=int, default=30)
    ap.add_argument("--skip-fps", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--weights", default=None, help="checkpoint dir (optional)")
    ap.add_argument(
        "--ladder",
        default=None,
        help='custom sweep, e.g. "1:1,4:2,4:2+last" (cn:dc[+last]); '
        "default = the module LADDER",
    )
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--family", default="sd15",
                    help="the random bundle's family, or a diffusers snapshot's")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from videosd_tpu_torch.bench import _fps
    from videosd_tpu_torch.ops.metrics import psnr, ssim
    from videosd_tpu_torch.pipelines.lcm_img2img import (
        FrameSpec,
        ModelBundle,
        build_frame_program,
        build_prompt_encoder,
    )

    device = torch.device(args.device)
    if not args.skip_fps and device.type != "cuda":
        ap.error("frames/s are measured on the card only: pass --skip-fps on another device")
    if args.weights:
        bundle = ModelBundle.from_dir(args.weights, family=args.family, device=device)
    else:
        bundle = ModelBundle.random(args.family, dtype=torch.bfloat16, device=device)
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))

    hw = args.size
    frames = [structured_frame(i, hw, hw) for i in range(args.quality_frames)]
    consts = [torch.tensor([v], dtype=torch.float32, device=device) for v in (0.6, 5.0, 2.0)]

    ladder = parse_ladder(args.ladder) if args.ladder else list(LADDER)
    if (1, 1, False) not in ladder:
        ladder.insert(0, (1, 1, False))  # the quality metric's identity
    programs = {}
    for cn_i, dc_i, rl in ladder:
        spec = FrameSpec(
            batch=1,
            height=hw,
            width=hw,
            steps=args.steps,
            controlnet_interval=cn_i,
            deepcache_interval=dc_i,
            interval_refresh_last=rl,
        )
        t0 = time.perf_counter()
        prog = build_frame_program(bundle, spec)
        prog(frames[0][None], embeds, *consts, [23])  # warm-up (and capture, on the card)
        programs[(cn_i, dc_i, rl)] = prog
        print(
            f"# built cn={cn_i} dc={dc_i} rl={int(rl)} in {time.perf_counter() - t0:.1f}s",
            flush=True,
        )

    # ---- quality: every config vs parity on the fixed frame/seed grid ----
    ref_out: dict[tuple[int, int], np.ndarray] = {}
    quality: dict[tuple, dict] = {}
    for cn_i, dc_i, rl in ladder:
        prog = programs[(cn_i, dc_i, rl)]
        psnrs, ssims = [], []
        for fi, fr in enumerate(frames):
            for si in range(args.seeds):
                out, _ = prog(fr[None], embeds, *consts, [23 + 101 * si])
                img = out[0].cpu().numpy()
                if (cn_i, dc_i, rl) == (1, 1, False):
                    ref_out[(fi, si)] = img
                else:
                    psnrs.append(psnr(ref_out[(fi, si)], img))
                    ssims.append(ssim(ref_out[(fi, si)], img))
        if (cn_i, dc_i, rl) != (1, 1, False):
            quality[(cn_i, dc_i, rl)] = {
                "psnr_mean": round(float(np.mean(psnrs)), 2),
                "psnr_min": round(float(np.min(psnrs)), 2),
                "ssim_mean": round(float(np.mean(ssims)), 4),
                "ssim_min": round(float(np.min(ssims)), 4),
            }
        else:
            quality[(cn_i, dc_i, rl)] = {
                "psnr_mean": float("inf"),
                "psnr_min": float("inf"),
                "ssim_mean": 1.0,
                "ssim_min": 1.0,
            }
        print(
            f"# quality cn={cn_i} dc={dc_i} rl={int(rl)}: {quality[(cn_i, dc_i, rl)]}",
            flush=True,
        )

    # ---- throughput + latency (serialized AFTER all builds/quality) ----
    results = []
    frame0 = torch.from_numpy(frames[0][None]).to(device)
    for cn_i, dc_i, rl in ladder:
        prog = programs[(cn_i, dc_i, rl)]
        row = {
            "cn_interval": cn_i,
            "dc_interval": dc_i,
            "refresh_last": rl,
            **quality[(cn_i, dc_i, rl)],
        }
        if not args.skip_fps:
            def call(i, prog=prog):
                return prog(frame0, embeds, *consts, [23 + i])

            row["fps"] = round(
                max(_fps(call, args.frames_per_window) for _ in range(args.windows)), 2
            )
            lat = []
            for i in range(10):
                t0 = time.perf_counter()
                call(500 + i)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            row["p50_ms"] = round(float(np.percentile(lat, 50)), 1)
        results.append(row)
        print(json.dumps(row), flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    # markdown Pareto table for PERF.md
    print("\n| cn | dc | +last | FPS | p50 ms | PSNR mean/min | SSIM mean/min |")
    print("|---|---|---|---|---|---|---|")
    for r in results:
        print(
            f"| {r['cn_interval']} | {r['dc_interval']} "
            f"| {'y' if r['refresh_last'] else ''} | {r.get('fps', '—')} "
            f"| {r.get('p50_ms', '—')} | {r['psnr_mean']}/{r['psnr_min']} "
            f"| {r['ssim_mean']}/{r['ssim_min']} |"
        )
    return results


if __name__ == "__main__":
    main()
