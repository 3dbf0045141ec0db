"""Frame rate of the port on one card, the counterpart of the JAX package's ``bench.py``.

    python -m videosd_tpu_torch.bench

Prints one JSON line with ``bench.py``'s keys, measured the same way: a
random-weight sd15 bundle in bf16, the prompt "portrait, pixar, cg", a
512x512 frame from ``default_rng(0)``, strength 0.6, guidance 5.0,
ControlNet scale 2.0, seed 23 + i for frame i.  Every program comes from
``build_frame_program``, so each call signature replays one CUDA graph;
its first call (the warm-up here) captures it.

* ``value``: frames/s of the parity program (4 steps, ControlNet every
  step), the best of ``windows`` windows of ``frames`` frames with two
  frames in flight (the host waits for frame i-2 before it enqueues i);
* ``p50_latency_ms``: the median of ``latency_frames`` blocking frames;
* ``batch4_aggregate_fps``: batch 4 (seeds 0-3), frames/s over the four
  streams, windows of ``batch4_frames`` calls;
* the three interval programs of ``bench.py`` (``*_turbo_fps``), as
  ``value``;
* the two temporal DeepCache programs over ``temporal_frames`` frames, a
  produce frame every 2nd frame and reuse of its caches between;
* ``ref_mode_fps``: the reference-attention program
  (``pipelines/reference_attn.py``, 4 steps, no ControlNet, the frame as
  its own reference, style fidelity 1 for both mechanisms), as the JAX
  bench measures it: the best of ``windows`` windows of ``ref_frames``
  frames with two in flight;
* ``flops_per_frame_tflop_logical`` / ``_padded`` from
  ``ops/flops.py`` and ``mfu``, ``mfu_padded``, ``mfu_batch4`` against
  the card's bf16 peak (None for a card the table does not know);
* the card's name and power limit (nvidia-smi) and the peak device memory
  allocated and reserved, with every program of the run held (a graph's
  private pool keeps the blocks its capture freed: reserved, not
  allocated).

The JAX bench's ``vs_baseline`` and ``production_turbo_vs_baseline`` compare
with an earlier production target and are left out.  Needs a CUDA card;
without one it exits with an error and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from videosd_tpu_torch.ops.flops import device_peak_flops, frame_flops, mfu
from videosd_tpu_torch.pipelines.lcm_img2img import (
    FrameSpec,
    ModelBundle,
    build_frame_program,
    build_prompt_encoder,
)
from videosd_tpu_torch.pipelines.reference_attn import build_reference_program

__all__ = ["main", "run"]

PROMPT = "portrait, pixar, cg"
SIDE, STEPS = 512, 4
# the interval programs of bench.py: (controlnet_interval, deepcache_interval,
# interval_refresh_last)
TURBO = {"cn_interval4_turbo_fps": (4, 1, False), "dc_interval2_turbo_fps": (1, 2, False),
         "production_turbo_cn2_dc3_last_fps": (2, 3, True)}
# its temporal DeepCache programs: (controlnet_interval, interval_refresh_last),
# a produce frame every TEMPORAL_EVERY frames
TEMPORAL = {"production_temporal2_cn1_fps": (1, False),
            "production_temporal2_cn2_last_fps": (2, True)}
TEMPORAL_EVERY = 2


def _card() -> tuple[str, float]:
    """The card's name and power limit in W, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return name, float(limit.split()[0])


def _fps(call, n: int, frames_per_call: int = 1) -> float:
    """Frames/s over ``n`` calls of ``call(i)`` with two calls in flight."""
    in_flight = []
    t0 = time.perf_counter()
    for i in range(n):
        out = call(i)
        done = torch.cuda.Event()
        done.record()
        in_flight.append((done, out))
        if len(in_flight) > 2:
            in_flight.pop(0)[0].synchronize()
    torch.cuda.synchronize()
    return n * frames_per_call / (time.perf_counter() - t0)


def _check(out, batch: int) -> None:
    img, lat = out[0], out[1]
    if img.shape != (batch, SIDE, SIDE, 3) or img.dtype != torch.uint8:
        raise RuntimeError(f"the bench's program gave an image {tuple(img.shape)} {img.dtype}")
    if not all(torch.isfinite(t).all() for t in out[1:]) or lat.shape[0] != batch:
        raise RuntimeError("the bench's program gave latents or caches that are not finite")


def run(bundle: ModelBundle | None = None, *, windows: int = 3, frames: int = 30,
        latency_frames: int = 10, batch4_frames: int = 12, temporal_frames: int = 32,
        ref_frames: int = 20) -> dict:
    """The bench's measurements as a dict of its JSON keys.  ``bundle``: an
    sd15 bf16 bundle on the card (default: a random one, seed 0); the
    window sizes are ``bench.py``'s by default."""
    if not torch.cuda.is_available():
        raise SystemExit("videosd_tpu_torch.bench needs a CUDA card: torch.cuda.is_available() "
                         "is False")
    card, power_limit = _card()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if bundle is None:
        bundle = ModelBundle.random("sd15", dtype=torch.bfloat16, device="cuda")
    dev = bundle.device
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer([PROMPT]))
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(0, 256, (1, SIDE, SIDE, 3), dtype=np.uint8)).to(dev)
    scalars = [torch.tensor([v], device=dev) for v in (0.6, 5.0, 2.0)]
    spec = FrameSpec(batch=1, height=SIDE, width=SIDE, steps=STEPS)
    programs = []  # every program stays held, so the peak counts every graph

    def program_for(**fields):
        programs.append(build_frame_program(bundle, dataclasses.replace(spec, **fields)))
        return programs[-1]

    def best_fps(program, **kw):
        def call(i):
            return program(frame, embeds, *scalars, [23 + i], **kw)

        _check(call(0), 1)  # the warm-up, which captures the graph
        return max(_fps(call, frames) for _ in range(windows))

    parity = program_for()
    result = {"metric": "lcm_4step_512x512_img2img_fps_1stream", "value": best_fps(parity),
              "unit": "frames/s"}

    latency = []
    for i in range(latency_frames):
        t0 = time.perf_counter()
        parity(frame, embeds, *scalars, [23 + i])
        torch.cuda.synchronize()
        latency.append((time.perf_counter() - t0) * 1e3)
    result["p50_latency_ms"] = float(np.percentile(latency, 50))

    program4 = program_for(batch=4)
    frame4 = torch.from_numpy(rng.integers(0, 256, (4, SIDE, SIDE, 3), dtype=np.uint8)).to(dev)
    embeds4 = torch.cat([embeds] * 4)
    args4 = [torch.full((4,), v, device=dev) for v in (0.6, 5.0, 2.0)] + [list(range(4))]

    def call4(i):
        return program4(frame4, embeds4, *args4)

    _check(call4(0), 4)
    result["batch4_aggregate_fps"] = max(_fps(call4, batch4_frames, 4) for _ in range(windows))

    for key, (cn, dc, last) in TURBO.items():
        result[key] = best_fps(program_for(controlnet_interval=cn, deepcache_interval=dc,
                                           interval_refresh_last=last))

    for key, (cn, last) in TEMPORAL.items():
        program = program_for(deepcache_temporal=True, controlnet_interval=cn,
                              interval_refresh_last=last)
        caches = program(frame, embeds, *scalars, [23])[2]
        _check(program(frame, embeds, *scalars, [23], deep_caches=caches), 1)
        held = {"caches": caches}

        def temporal(i, program=program, held=held):
            if i % TEMPORAL_EVERY == 0:
                img, lat, held["caches"] = program(frame, embeds, *scalars, [23 + i])
                return img, lat
            return program(frame, embeds, *scalars, [23 + i], deep_caches=held["caches"])

        result[key] = max(_fps(temporal, temporal_frames) for _ in range(windows))

    ref_program = build_reference_program(bundle, dataclasses.replace(spec, use_controlnet=False))
    programs.append(ref_program)
    sf_pair = torch.ones((1, 2), device=dev)

    def ref_call(i):
        return ref_program(frame, frame, embeds, *scalars[:2], sf_pair, [23 + i])

    _check(ref_call(0), 1)
    result["ref_mode_fps"] = max(_fps(ref_call, ref_frames) for _ in range(windows))
    flops = frame_flops(bundle, spec)
    flops4 = frame_flops(bundle, program4.spec)
    peak = device_peak_flops(card)
    result.update(
        flops_per_frame_tflop_logical=flops["logical"] / 1e12,
        flops_per_frame_tflop_padded=flops["padded"] / 1e12,
        chip_peak_bf16_tflops=None if peak is None else peak / 1e12,
        mfu=mfu(flops["logical"], 1.0 / result["value"], peak),
        mfu_padded=mfu(flops["padded"], 1.0 / result["value"], peak),
        mfu_batch4=mfu(flops4["logical"], 4.0 / result["batch4_aggregate_fps"], peak),
        card=card,
        power_limit_w=power_limit,
        peak_allocated_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        peak_reserved_gib=torch.cuda.max_memory_reserved(dev) / 2**30,
    )
    return result


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
