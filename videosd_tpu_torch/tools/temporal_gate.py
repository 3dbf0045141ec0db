"""Quality gate for temporal DeepCache (cross-frame trunk reuse), on the port.

Counterpart of ``videosd_tpu/tools/temporal_gate.py``.  Replays the
drifting synthetic camera (``tools/flicker.drifting_frame``) through the
serving cadence the engine implements for the ``deepcache_temporal``
option: refresh the per-step trunk caches every N frames (produce mode),
reuse them in between.  Every frame's temporal output is scored against
that frame's parity output (PSNR/SSIM, ``ops/metrics.py``), plus the
consecutive-output flicker (mean |delta u8|).  N = 1 is all-produce and
must score identity (the replay harness's check).  ``--device`` (default
``cuda``) picks where the programs run.

Usage:
    python -m videosd_tpu_torch.tools.temporal_gate --weights examples/toy_tiny_ckpt \
        --size 64 [--frames 24] [--every 2 4 8] [--cn-interval 1] [--json OUT] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def flicker(outs) -> float:
    """Mean |delta| of consecutive uint8 outputs."""
    return float(np.mean([np.abs(a.astype(np.int16) - b.astype(np.int16)).mean()
                          for a, b in zip(outs[1:], outs[:-1])]))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="sd15")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--strength", type=float, default=0.6)
    ap.add_argument("--every", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--cn-interval", type=int, default=1)
    ap.add_argument(
        "--refresh-last", action="store_true",
        help="interval_refresh_last for the cn interval (final-step residual "
        "freshness dominates quality)",
    )
    ap.add_argument("--weights", default=None, help="checkpoint dir (optional)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from videosd_tpu_torch.ops.metrics import psnr, ssim
    from videosd_tpu_torch.pipelines.lcm_img2img import (
        FrameSpec,
        ModelBundle,
        build_frame_program,
        build_prompt_encoder,
    )
    from videosd_tpu_torch.tools.flicker import drifting_frame

    device = torch.device(args.device)
    if args.weights:
        bundle = ModelBundle.from_dir(args.weights, device=device)
    else:
        print("# note: random weights — orderings transfer, magnitudes do not")
        bundle = ModelBundle.random(args.family, dtype=torch.bfloat16, device=device)

    embeds, pooled = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    # SDXL families consume the pooled embeds (text_time conditioning)
    kw = {"pooled_embeds": pooled} if bundle.clip2_cfg is not None else {}
    hw = args.size
    run_args = ([args.strength], [5.0], [2.0], [23])
    frames = [drifting_frame(i, hw, hw)[None] for i in range(args.frames)]

    parity = build_frame_program(bundle, FrameSpec(batch=1, height=hw, width=hw,
                                                   steps=args.steps))
    parity_out = [parity(f, embeds, *run_args, **kw)[0].cpu().numpy() for f in frames]

    spec_t = FrameSpec(
        batch=1, height=hw, width=hw, steps=args.steps,
        deepcache_temporal=True,
        controlnet_interval=max(1, args.cn_interval),
        interval_refresh_last=bool(args.refresh_last),
    )
    prog_t = build_frame_program(bundle, spec_t)

    results = []
    for n in [1] + list(args.every):
        outs, caches = [], None
        for i, f in enumerate(frames):
            if caches is None or i % n == 0:
                img, _lat, caches = prog_t(f, embeds, *run_args, **kw)
            else:
                img, _lat = prog_t(f, embeds, *run_args, deep_caches=caches, **kw)
            outs.append(img.cpu().numpy())
        ps = [psnr(o[0], p[0]) for o, p in zip(outs, parity_out)]
        ss = [ssim(o[0], p[0]) for o, p in zip(outs, parity_out)]
        # refresh frames are bit-exact (psnr inf): the quality question is
        # the REUSE frames, so their stats are reported separately
        reuse_ps = [v for v in ps if np.isfinite(v)]
        reuse_ss = [s_ for v, s_ in zip(ps, ss) if np.isfinite(v)]
        row = {
            "every": n,
            "psnr_min": round(float(np.min(ps)), 2),
            "psnr_mean_reuse": round(float(np.mean(reuse_ps)), 2) if reuse_ps else None,
            "ssim_min": round(float(np.min(ss)), 4),
            "ssim_mean_reuse": round(float(np.mean(reuse_ss)), 4) if reuse_ss else None,
            "flicker": round(flicker(outs), 3),
            "parity_flicker": round(flicker(parity_out), 3),
        }
        print(json.dumps(row), flush=True)
        results.append(row)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
