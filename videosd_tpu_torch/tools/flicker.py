"""Temporal warm-start stability measurement, on the port.

Counterpart of ``videosd_tpu/tools/flicker.py``.  ``warm_alpha`` blends the
previous frame's denoised latents into the current frame's encoded latents
before the timestep ladder (``FrameProgram``'s ``warm_latents`` /
``warm_alpha``).  This tool measures what that buys: frame-to-frame
FLICKER, the mean |delta| between consecutive uint8 outputs, on a slowly
changing synthetic input sequence (:func:`drifting_frame`) at each
``--alphas`` value, and its frames/s on the card (none on another device).

The warm path mirrors the serving engine's: frame N's ``warm_latents`` are
frame N-1's returned denoised latents, with the seed held constant per
stream.  ``--device`` (default ``cuda``) picks where the program runs.

Usage:
    python -m videosd_tpu_torch.tools.flicker [--family sd15] [--size 512]
        [--frames 24] [--alphas 0,0.3,0.5] [--json OUT.json] [--weights DIR]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def drifting_frame(i: int, h: int, w: int) -> np.ndarray:
    """Slowly-changing synthetic camera: structured content translated by
    1 px/frame with a slow brightness drift."""
    from videosd_tpu_torch.tools.turbo_ladder import structured_frame

    base = structured_frame(0, h, w).astype(np.float32)
    rolled = np.roll(base, shift=i, axis=1)
    drift = 1.0 + 0.02 * np.sin(2 * np.pi * i / 24.0)
    return np.clip(rolled * drift, 0, 255).astype(np.uint8)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="sd15")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--alphas", default="0,0.3,0.5")
    # lower strength couples the output more tightly to the input camera
    # motion, giving the flicker metric dynamic range (with random weights
    # at high strength the output is nearly static)
    ap.add_argument("--strength", type=float, default=0.6)
    ap.add_argument("--json", default=None)
    ap.add_argument(
        "--weights",
        default=None,
        help="checkpoint dir (diffusers snapshot or save_bundle dir, e.g. "
        "tools/train_toy.py output; overrides --family)",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from videosd_tpu_torch.pipelines.lcm_img2img import (
        FrameSpec,
        ModelBundle,
        build_frame_program,
        build_prompt_encoder,
    )

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if args.weights:
        bundle = ModelBundle.from_dir(args.weights, family=args.family, device=device)
    else:
        dtype = torch.float32 if args.family.startswith("tiny") else torch.bfloat16
        bundle = ModelBundle.random(args.family, dtype=dtype, device=device)
    spec = FrameSpec(batch=1, height=args.size, width=args.size, steps=args.steps)
    program = build_frame_program(bundle, spec)
    embeds, pooled = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    kw = {"pooled_embeds": pooled} if bundle.clip2_cfg is not None else {}
    consts = ([args.strength], [5.0], [2.0], [23])
    frames = [drifting_frame(i, args.size, args.size) for i in range(args.frames)]

    results = []
    for alpha in [float(a) for a in args.alphas.split(",")]:
        # first frame: no history (alpha applies from frame 2)
        warm = torch.zeros((1, args.size // 8, args.size // 8, 4), dtype=bundle.dtype,
                           device=device)
        # warm-up (and capture, on the card) of the warm-signature program
        program(frames[0][None], embeds, *consts, warm_latents=warm, warm_alpha=[0.0], **kw)
        if on_card:
            torch.cuda.synchronize(device)
        outs = []
        t0 = time.perf_counter()
        warm_a = [0.0]  # no history on frame 0
        for fr in frames:
            out, lat = program(fr[None], embeds, *consts, warm_latents=warm, warm_alpha=warm_a,
                               **kw)
            warm, warm_a = lat, [alpha]
            outs.append(out[0].cpu().numpy().astype(np.float32))
        dt = time.perf_counter() - t0
        flick = float(
            np.mean([np.mean(np.abs(outs[i + 1] - outs[i])) for i in range(len(outs) - 1)])
        )
        row = {
            "warm_alpha": alpha,
            "strength": args.strength,
            "flicker_mean_abs_delta": round(flick, 3),
            # frames/s of the card only: each frame's image is read back
            "fps": round(len(frames) / dt, 2) if on_card else None,
            "device": device.type,
        }
        results.append(row)
        print(json.dumps(row), flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print("\n| warm_alpha | flicker (mean abs du8/frame) | FPS |")
    print("|---|---|---|")
    for r in results:
        print(f"| {r['warm_alpha']} | {r['flicker_mean_abs_delta']} | {r['fps']} |")
    return results


if __name__ == "__main__":
    main()
