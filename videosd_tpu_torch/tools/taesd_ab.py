"""A/B the TAESD conv routes at frame level, on the port.

Counterpart of ``videosd_tpu/tools/taesd_ab.py``.  The pixel-pair-packed
layout (``TAESDConfig(packed_convs=True)``) does the space-to-depth
transform as a free reshape with block-packed kernels, and
``pallas_convs=True`` runs the residual blocks' convs on kernel K3
(``csrc/taesd_conv.cu``).  This tool measures what each buys at FRAME
level: same-window A/B pairs in alternating order of the 4-step program
built with each route, plus the output PSNR against the first route's
(the routes agree up to the order of their fp32 sums).

It also runs an isolated encode+decode slope probe: K round trips
``encode(decode(z))`` captured in ONE CUDA graph (where the JAX tool ran
them inside one jit), replayed for K = 2 and 6; the slope is the device
time of one round trip, free of launch overhead.  Frames/s and the probe
need the card: on another device the tool reports the PSNRs only.

Usage:
    python -m videosd_tpu_torch.tools.taesd_ab [--pairs 3] [--frames 30]
        [--size 512] [--json OUT.json] [--skip-probe] [--variants unpacked,pallas]
        [--family sd15] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time


def _probe_ms(ae, cfg, z0, device) -> tuple[float, dict]:
    """Median replay time of K decode+encode round trips in one CUDA graph,
    for K = 2 and 6 (distinct inputs per replay); returns the slope in ms
    per round trip and the two medians."""
    import numpy as np
    import torch

    from videosd_tpu_torch.models.taesd import taesd_decode, taesd_encode

    times = {}
    for k in (2, 6):
        z = z0.clone()

        def chain(z=z, k=k):
            c = z
            for _ in range(k):
                c = taesd_encode(ae, taesd_decode(ae, c, cfg), cfg)
            return c

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), torch.inference_mode():
            chain()  # warm-up: library plans, K3's taps
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(graph):
            out = chain()
        samples = []
        for i in range(5):
            z.copy_(torch.from_numpy(np.random.default_rng(i).standard_normal(tuple(z.shape)))
                    .to(z))
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            graph.replay()
            float(out.float().sum())  # read back: the replay has finished
            samples.append(time.perf_counter() - t0)
        times[k] = statistics.median(samples)
        del graph
    return (times[6] - times[2]) / 4 * 1e3, times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--json", default=None)
    ap.add_argument("--skip-probe", action="store_true")
    ap.add_argument(
        "--variants",
        default="unpacked,pallas",
        help="comma list from {unpacked, packed, pallas}; first entry is the "
        "baseline for PSNR and win counting",
    )
    ap.add_argument("--family", default="sd15")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from videosd_tpu_torch.ops.metrics import psnr
    from videosd_tpu_torch.pipelines.lcm_img2img import (
        FrameSpec,
        ModelBundle,
        build_frame_program,
        build_prompt_encoder,
    )
    from videosd_tpu_torch.tools.turbo_ladder import structured_frame

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    dtype = torch.float32 if args.family.startswith("tiny") else torch.bfloat16
    bundle = ModelBundle.random(args.family, dtype=dtype, device=device)
    variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    cfg_overrides = {"unpacked": {}, "packed": {"packed_convs": True},
                     "pallas": {"pallas_convs": True}}
    bundles = {
        name: dataclasses.replace(
            bundle, taesd_cfg=dataclasses.replace(bundle.taesd_cfg, **cfg_overrides[name]))
        for name in variants
    }
    base = variants[0]
    hw = args.size
    probe = {}

    # ---- isolated encode+decode slope probe (the card only) -------------
    if on_card and not args.skip_probe:
        z0 = torch.randn((1, hw // 8, hw // 8, 4), generator=torch.Generator(device).manual_seed(0),
                         device=device).to(dtype)
        for name in variants:
            slope_ms, times = _probe_ms(bundle.models["taesd"], bundles[name].taesd_cfg, z0,
                                        device)
            probe[name] = round(slope_ms, 4)
            print(f"# probe {name}: decode+encode round trip {slope_ms:.3f} ms "
                  f"(k2={times[2] * 1e3:.2f} k6={times[6] * 1e3:.2f})", flush=True)

    # ---- frame-level same-window A/B pairs -------------------------------
    spec = FrameSpec(batch=1, height=hw, width=hw, steps=args.steps)
    progs = {name: build_frame_program(bundles[name], spec) for name in variants}
    embeds, pooled = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    kw = {"pooled_embeds": pooled} if bundle.clip2_cfg is not None else {}
    frame0 = torch.from_numpy(structured_frame(0, hw, hw)[None]).to(device)
    sgcs = ([0.6], [5.0], [2.0], [23])

    outs = {}
    for name, prog in progs.items():
        t0 = time.perf_counter()
        out, _ = prog(frame0, embeds, *sgcs, **kw)
        outs[name] = out[0].cpu().numpy()
        print(f"# built {name} in {time.perf_counter() - t0:.1f}s", flush=True)
    psnrs = {name: float(psnr(outs[base], outs[name])) for name in variants[1:]}
    for name, v in psnrs.items():
        print(f"# {name}-vs-{base} output PSNR: {v:.2f} dB", flush=True)

    def window(prog) -> float:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            last, _ = prog(frame0, embeds, *sgcs, **kw)
        torch.cuda.synchronize(device)
        return args.frames / (time.perf_counter() - t0)

    pairs = []
    for i in range(args.pairs if on_card else 0):
        order = list(variants) if i % 2 == 0 else list(reversed(variants))
        row = {name: round(window(progs[name]), 2) for name in order}
        pairs.append(row)
        print(f"# pair {i}: {row}", flush=True)

    result = {
        "psnr_db": {k: round(v, 2) for k, v in psnrs.items()},
        "pairs": pairs,
        "best": {name: max(p[name] for p in pairs) for name in variants} if pairs else {},
        "wins_vs_base": {name: sum(1 for p in pairs if p[name] > p[base])
                         for name in variants[1:]},
        "probe_ms": probe,
        "device": device.type,
    }
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
