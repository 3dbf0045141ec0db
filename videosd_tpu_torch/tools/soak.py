"""Serving soak: resource stability under sustained multi-stream churn, on
the port.

Counterpart of ``videosd_tpu/tools/soak.py``.  Drives the port's ``Engine``
for ``--minutes`` with N concurrent simulated streams (the drifting
synthetic camera, ``tools/flicker.drifting_frame``), churning the live
options a client exposes (temporal DeepCache, ControlNet interval, prompt,
strength, ControlNet scale; geometry and steps stay fixed, so the set of
programs is closed after the warm-up), and samples:

* RSS (VmRSS from ``/proc/self/status``): the leak check;
* the engine's program counts and the CUDA graphs its programs hold (where
  the JAX tool counted compiled executables);
* frames served and the rolling p50/p99 submit-to-reply latency.

Pass criteria (in the report): RSS drift over the second half under
``--rss-slack`` MB, and a graph count (and program count) flat after the
first churn cycle.  ``--device`` (default ``cuda``) picks where the engine
runs; on another device no graph is captured.

Usage (on the card):
    python -m videosd_tpu_torch.tools.soak --minutes 30 --streams 3 \
        --family sd15 --size 512 [--json PERF_soak.json]
On the CPU:
    python -m videosd_tpu_torch.tools.soak --minutes 1 --streams 2 \
        --family tiny --size 64 --steps 2 --hz 4 --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


# seconds a stream waits for a reply before the soak fails
REPLY_TIMEOUT_S = 300.0

# the churn table: the public live options a client slider can flip
CHURN_CYCLE = [
    {"deepcache_temporal": 2, "controlnet_interval": 2, "interval_refresh_last": True},
    {"deepcache_temporal": 0, "controlnet_interval": 2, "interval_refresh_last": True},
    {"deepcache_temporal": 0, "controlnet_interval": 1, "interval_refresh_last": False},
    {"deepcache_temporal": 4, "controlnet_interval": 2, "interval_refresh_last": True},
]
PROMPTS = ["portrait, pixar, cg", "watercolor landscape", "cyberpunk city",
           "oil painting, baroque"]


async def soak(args) -> dict:
    import torch

    from videosd_tpu_torch.config import ServerConfig
    from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle
    from videosd_tpu_torch.runtime.engine import Engine
    from videosd_tpu_torch.tools.flicker import drifting_frame

    device = torch.device(args.device)
    dtype = torch.float32 if args.family.startswith("tiny") else torch.bfloat16
    bundle = ModelBundle.random(args.family, dtype=dtype, device=device)
    eng = Engine(ServerConfig(), bundle=bundle, max_streams=args.streams, max_batch=8,
                 deadline_ms=8, frame_hw=(args.size, args.size))
    # warm the closed bucket set the churn cycles through: parity,
    # cn-interval, temporal produce + reuse, at every batch bucket up to the
    # streams' (streams whose options differ batch apart); live churn then
    # never captures
    print("# warmup...", flush=True)
    buckets = tuple(b for b in (1, 2, 4, 8) if b < 2 * args.streams)
    geometry = dict(batch_sizes=buckets, steps=(args.steps,), height=args.size,
                    width=args.size)
    eng.warmup(**geometry)
    eng.warmup(**geometry, cn_interval=2, refresh_last=True)
    eng.warmup(**geometry, cn_interval=2, refresh_last=True, temporal=True)
    eng.start()

    streams = [eng.open_stream({"height": args.size, "width": args.size, "steps": args.steps})
               for _ in range(args.streams)]
    lat: list = []
    samples: list = []
    stop_at = time.monotonic() + args.minutes * 60.0
    frame_interval = 1.0 / args.hz
    t_start = time.monotonic()

    async def drive(si: int, st):
        i = 0
        while time.monotonic() < stop_at:
            f = drifting_frame(i + 97 * si, args.size, args.size)
            t0 = time.perf_counter()
            await asyncio.wait_for(eng.submit_frame(st.stream_id, f), REPLY_TIMEOUT_S)
            lat.append((time.perf_counter() - t0) * 1e3)
            i += 1
            # churn on a per-stream cadence, desynced across streams
            if i % args.churn_every == 0:
                k = i // args.churn_every
                c = dict(CHURN_CYCLE[(k + si) % len(CHURN_CYCLE)])
                c["prompt"] = PROMPTS[(k + si) % len(PROMPTS)]
                c["strength"] = 0.5 + 0.1 * (k % 3)
                c["controlnet_scale"] = 1.0 + 0.5 * (si % 3)
                eng.update_options(st.stream_id, c)
            await asyncio.sleep(max(0.0, frame_interval - (time.perf_counter() - t0)))

    async def sample():
        while time.monotonic() < stop_at:
            await asyncio.sleep(args.sample_every)
            s = eng.stats()
            recent = lat[-500:]
            samples.append({
                "t_s": round(time.monotonic() - t_start, 1),
                "rss_mb": round(rss_mb(), 1),
                "programs_compiled": s["programs_compiled"],
                "programs_ready": s["programs_ready"],
                "graphs": s["graphs"],
                "frames_out": s["frames_out"],
                "p50_ms": round(float(np.percentile(recent, 50)), 1) if recent else None,
                "p99_ms": round(float(np.percentile(recent, 99)), 1) if recent else None,
            })
            print(json.dumps(samples[-1]), flush=True)

    try:
        await asyncio.gather(*(drive(i, st) for i, st in enumerate(streams)), sample())
    finally:
        await eng.stop()

    half = len(samples) // 2
    rss_second_half = [s["rss_mb"] for s in samples[half:]]
    drift = (round(rss_second_half[-1] - rss_second_half[0], 1)
             if len(rss_second_half) >= 2 else 0.0)
    tail = samples[half:]
    return {
        "minutes": args.minutes,
        "streams": args.streams,
        "family": args.family,
        "size": args.size,
        "device": device.type,
        "frames_served": samples[-1]["frames_out"] if samples else 0,
        "p50_ms": round(float(np.percentile(lat, 50)), 1) if lat else None,
        "p99_ms": round(float(np.percentile(lat, 99)), 1) if lat else None,
        "rss_start_mb": samples[0]["rss_mb"] if samples else None,
        "rss_end_mb": samples[-1]["rss_mb"] if samples else None,
        "rss_drift_second_half_mb": drift,
        "programs_compiled_final": samples[-1]["programs_compiled"] if samples else None,
        "graphs_final": samples[-1]["graphs"] if samples else None,
        "programs_stable": bool(tail) and len({(s["programs_compiled"], s["graphs"])
                                               for s in tail}) == 1,
        "rss_ok": abs(drift) < args.rss_slack,
        "samples": samples,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--family", default="sd15")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--hz", type=float, default=20.0, help="per-stream submit rate")
    ap.add_argument("--churn-every", type=int, default=50, help="frames between option churns")
    ap.add_argument("--sample-every", type=float, default=30.0,
                    help="seconds between samples")
    ap.add_argument("--rss-slack", type=float, default=200.0,
                    help="second-half RSS drift budget (MB)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    report = asyncio.run(soak(args))
    print(json.dumps({k: v for k, v in report.items() if k != "samples"}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
