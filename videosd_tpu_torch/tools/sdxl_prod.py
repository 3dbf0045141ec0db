"""SDXL 1024x1024 production measurement on the port.

Counterpart of ``videosd_tpu/tools/sdxl_prod.py``.  Measures, on one card,
what the sd15 bench measures for its flagship: the parity frame's frames/s
and p50 latency, and the temporal-DeepCache cadence (a produce frame every
N-th frame, reuse of its caches between), without ControlNet, as
``examples/sdxl_lightning.py`` serves SDXL.  From the measured rates it
sizes the data-parallel cards a 20 frames/s target needs.  The weights are
random (seed 0, bf16): no SDXL checkpoint is in the repository.

Report keys (one JSON line, and ``--json`` writes it to a file):
``fps_parity`` (best of three windows of ``--frames`` frames, two calls in
flight), ``p50_ms`` (five blocking frames), ``flops_per_frame_tflop_logical``
(``ops/flops.py::frame_flops``), ``mfu`` (against
``device_peak_flops``; None for a card its table does not know, and on the
CPU), ``fps_temporal_n{N}`` for each ``--every`` N, ``chips_for_20fps_dp``,
and beside them ``device``, ``card`` and ``power_limit_w`` (nvidia-smi's
name and power limit; ``cpu`` and None on the CPU).  Every program comes
from ``build_frame_program``, so on the card each call signature replays
one CUDA graph, captured at its first call (the warm-up here).  A failing
warm-up raises: nothing is retried.

Usage:
    python -m videosd_tpu_torch.tools.sdxl_prod --size 1024 --steps 4
        [--frames 16] [--every 2 4] [--json OUT.json] [--device cuda]

``run(family="tiny-xl", device="cpu", ...)`` runs the same measurement on
the SDXL topology at tiny widths, for a test on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

PROMPT = "cinematic photo, city"


def _card(device: torch.device) -> tuple[str, float | None]:
    """The card's name and power limit in W, as nvidia-smi reports them;
    ``("cpu", None)`` on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return name, float(limit.split()[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fps(call, n: int, device: torch.device) -> float:
    """Frames/s over ``n`` calls of ``call(i)`` with two calls in flight (on
    the CPU every call is blocking)."""
    in_flight = []
    t0 = time.perf_counter()
    for i in range(n):
        call(i)
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            in_flight.append(done)
            if len(in_flight) > 2:
                in_flight.pop(0).synchronize()
    _sync(device)
    return n / (time.perf_counter() - t0)


def _check(out, size: int) -> None:
    img = out[0]
    if tuple(img.shape) != (1, size, size, 3) or img.dtype != torch.uint8:
        raise RuntimeError(f"the SDXL program gave an image {tuple(img.shape)} {img.dtype}")
    if not all(torch.isfinite(t).all() for t in out[1:]):
        raise RuntimeError("the SDXL program gave latents or caches that are not finite")


def run(*, family: str = "sdxl", size: int = 1024, steps: int = 4, frames: int = 16,
        every=(2, 4), device="cuda") -> dict:
    """The report as a dict (see the module's docstring)."""
    from videosd_tpu_torch.ops.flops import device_peak_flops, frame_flops, mfu
    from videosd_tpu_torch.pipelines.lcm_img2img import (
        FrameSpec,
        ModelBundle,
        build_frame_program,
        build_prompt_encoder,
    )

    dtype = torch.float32 if device == "cpu" else torch.bfloat16
    bundle = ModelBundle.random(family, dtype=dtype, device=device, with_controlnet=False)
    dev = bundle.device
    card, power_limit = _card(dev)
    embeds, pooled = build_prompt_encoder(bundle)(bundle.tokenizer([PROMPT]))
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)).to(dev)
    run_args = ([0.7], [5.0], [1.0])
    kw = {"pooled_embeds": pooled}
    report: dict = {"family": family, "size": size, "steps": steps}

    spec_p = FrameSpec(batch=1, height=size, width=size, steps=steps, use_controlnet=False)
    parity = build_frame_program(bundle, spec_p)

    def parity_call(i):
        return parity(frame, embeds, *run_args, [23 + i], **kw)

    _check(parity_call(0), size)  # the warm-up, which captures the graph
    report["fps_parity"] = max(_fps(parity_call, frames, dev) for _ in range(3))
    lat = []
    for i in range(5):
        t0 = time.perf_counter()
        parity_call(i)
        _sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    report["p50_ms"] = float(np.percentile(lat, 50))
    print(json.dumps({k: report[k] for k in ("fps_parity", "p50_ms")}), flush=True)

    fl = frame_flops(bundle, spec_p)
    peak = device_peak_flops(card) if dev.type == "cuda" else None
    report["flops_per_frame_tflop_logical"] = fl["logical"] / 1e12
    report["mfu"] = mfu(fl["logical"], 1.0 / report["fps_parity"], peak)

    # temporal DeepCache cadence: produce every N-th frame, reuse between
    spec_t = FrameSpec(batch=1, height=size, width=size, steps=steps, use_controlnet=False,
                       deepcache_temporal=True)
    prog_t = build_frame_program(bundle, spec_t)
    caches = prog_t(frame, embeds, *run_args, [23], **kw)[2]
    _check(prog_t(frame, embeds, *run_args, [23], deep_caches=caches, **kw), size)
    for n_every in every:
        held = {"caches": caches}

        def cadence(i, n_every=n_every, held=held):
            if i % n_every == 0:
                out = prog_t(frame, embeds, *run_args, [23 + i], **kw)
                held["caches"] = out[2]
                return out
            return prog_t(frame, embeds, *run_args, [23 + i], deep_caches=held["caches"], **kw)

        report[f"fps_temporal_n{n_every}"] = max(_fps(cadence, frames, dev) for _ in range(3))
        print(json.dumps({f"fps_temporal_n{n_every}": report[f"fps_temporal_n{n_every}"]}),
              flush=True)

    best = max([report[f"fps_temporal_n{n}"] for n in every] + [report["fps_parity"]])
    report["chips_for_20fps_dp"] = math.ceil(20.0 / best)
    report["note"] = ("dp replicates the program per card (frames/s per card add); "
                      "mesh_pipe=2 halves a card's weights and activations "
                      "(parallel/pipe.py); throughput across cards not measured")
    report.update(device=dev.type, card=card, power_limit_w=power_limit)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--frames", type=int, default=16, help="per frames/s window")
    ap.add_argument("--every", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = run(size=args.size, steps=args.steps, frames=args.frames, every=args.every,
                 device=args.device)
    print(json.dumps(report), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
