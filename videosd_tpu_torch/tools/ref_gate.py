"""Measure the reference-attention program: frames/s and drift stability, on
the port.

Counterpart of ``videosd_tpu/tools/ref_gate.py``.  Reference mode runs the
UNet twice a step (a WRITE pass banking self-attention states from the
noised style reference, then a READ pass over the live latents with the
banked K/V concatenated); ``pipelines/reference_attn.py`` runs it as one
CUDA graph per call signature.  This tool adds:

* **frames/s** at the requested geometry with two calls in flight, best
  of three windows, beside the plain program measured the same way in the
  same process (on the card only: pass ``--no-fps`` on another device);
* **drift stability** over the drifting synthetic camera with the serving
  feedback rule (the last generated frame becomes the new reference, as
  the engine does) for a style-fidelity grid: consecutive-frame flicker
  and PSNR against the plain program's per-frame outputs.  sf = 0 rows
  must sit at identity (the plain program's frames bit for bit); sf > 0
  rows measure how far the style coupling pulls the stream.

Usage:
    python -m videosd_tpu_torch.tools.ref_gate --family sd15 --size 512 --fps-only
    python -m videosd_tpu_torch.tools.ref_gate --weights examples/toy_tiny_ckpt \
        --size 64 [--frames 24] [--sf 0 0.5 1] [--json OUT] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from videosd_tpu_torch.tools.temporal_gate import flicker


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="sd15")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--strength", type=float, default=0.6)
    ap.add_argument("--sf", type=float, nargs="+", default=[0.0, 0.5, 1.0])
    ap.add_argument("--weights", default=None, help="checkpoint dir (optional)")
    ap.add_argument("--fps-only", action="store_true")
    ap.add_argument(
        "--fixed-ref", action="store_true",
        help="hold the FIRST frame as the reference for the whole sequence "
        "instead of the serving feedback rule (the A/B that separates "
        "self-feedback instability from inherent ref-mode noise)",
    )
    ap.add_argument("--no-fps", action="store_true")
    ap.add_argument("--json", default=None)
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
    from videosd_tpu_torch.pipelines.reference_attn import build_reference_program
    from videosd_tpu_torch.tools.flicker import drifting_frame

    device = torch.device(args.device)
    if not args.no_fps and device.type != "cuda":
        ap.error("frames/s are measured on the card only: pass --no-fps on another device")
    if args.weights:
        bundle = ModelBundle.from_dir(args.weights, device=device)
    else:
        print("# note: random weights — orderings transfer, magnitudes do not")
        bundle = ModelBundle.random(args.family, dtype=torch.bfloat16, device=device)

    embeds, pooled = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    kw = {"pooled_embeds": pooled} if bundle.clip2_cfg is not None else {}
    hw = args.size
    strength, guidance, cn = [args.strength], [5.0], [2.0]

    # ref mode serves without ControlNet (the engine forces
    # use_controlnet=False for ref buckets)
    plain = build_frame_program(bundle, FrameSpec(batch=1, height=hw, width=hw, steps=args.steps))
    ref_prog = build_reference_program(
        bundle, FrameSpec(batch=1, height=hw, width=hw, steps=args.steps, use_controlnet=False))

    report: dict = {"family": bundle.family, "size": hw, "steps": args.steps,
                    "weights": args.weights, "device": device.type}
    frame = np.random.default_rng(0).integers(0, 256, (1, hw, hw, 3), dtype=np.uint8)
    sf_pair = [[1.0, 1.0]]

    if not args.no_fps:
        frame_d = torch.from_numpy(frame).to(device)
        plain(frame_d, embeds, strength, guidance, cn, [23], **kw)  # warm-up and capture
        ref_prog(frame_d, frame_d, embeds, strength, guidance, sf_pair, [23], **kw)
        fps_plain = max(_fps(lambda i: plain(frame_d, embeds, strength, guidance, cn,
                                             [23 + i], **kw), 20) for _ in range(3))
        fps_ref = max(_fps(lambda i: ref_prog(frame_d, frame_d, embeds, strength, guidance,
                                              sf_pair, [23 + i], **kw), 20) for _ in range(3))
        report["fps_plain"] = round(fps_plain, 3)
        report["fps_ref"] = round(fps_ref, 3)
        report["ref_cost_x"] = round(fps_plain / fps_ref, 3)
        print(json.dumps({k: report[k] for k in ("fps_plain", "fps_ref", "ref_cost_x")}),
              flush=True)

    if not args.fps_only:
        frames = [drifting_frame(i, hw, hw)[None] for i in range(args.frames)]
        # drift targets come from the CN-free plain program: ref mode has no
        # ControlNet, and sf = 0 is bit-equal to this spec, so the sf = 0
        # row lands at identity iff the replay harness is faithful
        plain_nocn = build_frame_program(
            bundle, FrameSpec(batch=1, height=hw, width=hw, steps=args.steps,
                              use_controlnet=False))
        plain_out = [plain_nocn(f, embeds, strength, guidance, cn, [23], **kw)[0].cpu().numpy()
                     for f in frames]
        rows = []
        for sf in args.sf:
            sfp = [[float(sf)] * 2]
            outs = []
            ref = frames[0]  # first reference = first camera frame
            # (the engine starts ref_frame as the camera frame, then every
            # generated frame replaces it; --fixed-ref pins it instead)
            for f in frames:
                img, _lat = ref_prog(f, ref, embeds, strength, guidance, sfp, [23], **kw)
                out = img.cpu().numpy()
                outs.append(out)
                if not args.fixed_ref:
                    ref = out
            ps = [psnr(o[0], p[0]) for o, p in zip(outs, plain_out)]
            ss = [ssim(o[0], p[0]) for o, p in zip(outs, plain_out)]
            finite = [v for v in ps if np.isfinite(v)]
            row = {
                "style_fidelity": sf,
                "ref_rule": "fixed" if args.fixed_ref else "feedback",
                "vs_plain_psnr_min": round(float(np.min(ps)), 2),
                "vs_plain_psnr_mean": round(float(np.mean(finite)), 2) if finite else None,
                "identity_frames": int(sum(not np.isfinite(v) for v in ps)),
                "vs_plain_ssim_min": round(float(np.min(ss)), 4),
                "flicker": round(flicker(outs), 3),
                "plain_flicker": round(flicker(plain_out), 3),
            }
            print(json.dumps(row), flush=True)
            rows.append(row)
        report["drift"] = rows

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
