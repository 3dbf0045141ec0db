"""One run of a cell: the program's set-up, the measured window, the records.

The system under test is ``videosd_tpu_torch``'s serving engine: a
``ModelBundle`` loaded from the benchmark's weights, an ``Engine`` with one
stream per camera (``max_batch`` the number of streams), the cell's batch
buckets warmed and captured, every stream's prompt encoded; then the
cameras run (``camera.run_clients``) through ``Engine.submit_frame`` while
the engine's batch loop serves them.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import importlib.util
import os
import sys
import time

import numpy as np
import torch

from benchmark import camera as cam
from benchmark.reference.frame import build_models
from benchmark.weights import draw_state_dicts

__all__ = ["Run", "serve"]

ENGINE_BUCKETS = (1, 2, 4, 8, 16)  # the engine's batch buckets (its _bucket_batch)
TRACE_SECONDS = 6.0  # the traced sub-window: the last seconds of the window


def warm_batches(streams: int) -> tuple:
    """The buckets a cell can use: every one up to the first that holds all
    of its streams."""
    top = next(b for b in ENGINE_BUCKETS if b >= streams)
    return tuple(b for b in ENGINE_BUCKETS if b <= top)


@dataclasses.dataclass
class Run:
    """What one run leaves for the metrics and the output check."""

    cameras: cam.Cameras
    options: list  # each stream's options, as opened
    ticks: list  # every submitted frame (camera.Tick)
    drops: list  # (stream, tick, due) of frames dropped at the track
    late: list  # (due, wake-up minus due) of every tick
    t_window: tuple  # (start, end) of the measured window, perf_counter s
    setup_s: float
    stats: dict  # deltas of Engine.stats()'s frames_out and batches over the window
    peak_reserved: int
    trace: tuple | None = None  # (trace file, clock offset us, start, stop)


def _traffic_clients(traffic: dict):
    """The client loop of a traffic mix's kind: the camera's, or
    ``benchmark/traffic/<kind>.py``'s ``run_clients``."""
    if traffic.get("kind", "camera") == "camera":
        return cam.run_clients
    path = os.path.join(os.path.dirname(__file__), "traffic", traffic["kind"] + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_traffic_{traffic['kind']}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.run_clients


def warm(engine, opt: dict, batches: tuple) -> None:
    """Warm and capture, for each batch, the program that the batcher asks
    for under the stream options ``opt``: its ControlNet switch, intervals
    and temporal reuse as the options set them."""
    from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec

    steps, height, width = int(opt["steps"]), int(opt["height"]), int(opt["width"])
    cn_i = max(1, int(opt.get("controlnet_interval", 1) or 1))
    dc_i = max(1, int(opt.get("deepcache_interval", 1) or 1))
    refresh = bool(opt.get("interval_refresh_last", False))
    temporal = int(opt.get("deepcache_temporal", 0) or 0) > 0
    if opt.get("controlnet", True):
        engine.warmup(batch_sizes=batches, steps=(steps,), height=height, width=width,
                      cn_interval=cn_i, dc_interval=dc_i, refresh_last=refresh,
                      temporal=temporal)
        return
    # Engine.warmup has no ControlNet switch: the spec it would warm, with
    # the ControlNet off, under the batcher's rules for the intervals
    dc_i = 1 if temporal else dc_i
    for b in batches:
        engine._warm_spec(FrameSpec(batch=b, height=height, width=width,
                                    in_height=engine.frame_hw[0], in_width=engine.frame_hw[1],
                                    in_format=engine.input_format, steps=steps,
                                    use_controlnet=False, controlnet_interval=cn_i,
                                    deepcache_interval=dc_i,
                                    interval_refresh_last=refresh and (cn_i > 1 or dc_i > 1),
                                    deepcache_temporal=temporal),
                          ref_mode=False)


def build_engine(cfg: dict, traffic: dict, cameras: cam.Cameras, seed: int, device: str):
    """The program's set-up: the bundle from the benchmark's weights (in the
    configuration's ``quant`` form, default none), the engine, the cell's
    buckets warmed and captured, one stream per camera opened and its
    prompt encoded.  Returns (engine, stream states, options)."""
    from videosd_tpu_torch.config import ServerConfig
    from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle
    from videosd_tpu_torch.runtime.engine import Engine

    dtype = getattr(torch, cfg["dtype"])
    state_dicts = draw_state_dicts(build_models(cfg, "meta"), seed, dtype, device)
    bundle = ModelBundle.from_state_dicts(cfg["family"], state_dicts, dtype=dtype, device=device)
    del state_dicts
    quant = cfg.get("quant", "none")
    if quant == "int8":
        # what the engine does to a bundle it loads itself under this setting
        from videosd_tpu_torch.ops.quant import quantize_bundle_params

        quantize_bundle_params(bundle)
    n = len(cameras.rates)
    hw = tuple(traffic["camera_hw"])
    engine = Engine(ServerConfig(family=cfg["family"], dtype=cfg["dtype"], weights="random",
                                 frame_hw=hw, quant=quant),
                    bundle=bundle, max_streams=n, max_batch=n, frame_hw=hw, device=device)
    opt = cfg["stream_options"]
    warm(engine, opt, warm_batches(n))
    states, options = [], []
    for i in range(n):
        o = dict(opt, prompt=cameras.prompts[i], seed=cameras.seeds[i])
        states.append(engine.open_stream(o))
        options.append(o)
        engine._encode_prompt(o["prompt"])
    return engine, states, options


async def _drive(engine, states, cameras, traffic, seconds: float, trace_dir: str | None,
                 process_start: float):
    ticks, drops, late = [], [], []
    engine.start()
    lead = float(traffic.get("lead_in_s", 1.0))
    t0 = time.perf_counter() + 0.05
    w0, w1 = t0 + lead, t0 + lead + seconds
    stats: dict = {}
    trace = None

    async def submit(i, frame, rec):
        st = states[i]
        before = st.last_output
        try:
            img = await engine.submit_frame(st.stream_id, frame)
        except Exception as err:  # a failed submit is counted (not fresh), never retried
            print(f"submit of stream {i} tick {rec.tick} failed: {err!r}", file=sys.stderr)
            rec.resolved = time.perf_counter()
            return
        rec.resolved = time.perf_counter()
        rec.image = img
        rec.latents = st.last_latents
        rec.fresh = img is not before and getattr(img, "base", None) is not None

    async def at(t):
        delay = t - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)

    async def counters():
        await at(w0)
        stats["start"] = engine.stats()
        await at(w1)
        stats["end"] = engine.stats()

    async def tracer():
        nonlocal trace
        await at(w1 - min(TRACE_SECONDS, seconds / 2))
        offset = time.time_ns() / 1e3 - time.perf_counter() * 1e6
        await engine.start_trace(trace_dir)
        started = time.perf_counter()
        await at(w1)
        stopped = time.perf_counter()
        await engine.stop_trace()
        trace = (os.path.join(trace_dir, "trace.json"), offset, started, stopped)

    tasks = [asyncio.ensure_future(counters())]
    if trace_dir is not None:
        tasks.append(asyncio.ensure_future(tracer()))
    try:
        await asyncio.wait_for(
            _traffic_clients(traffic)(cameras, submit, t0, w1, ticks, drops, late),
            timeout=lead + seconds + 60.0)
        await asyncio.gather(*tasks)
    finally:
        for t in tasks:
            t.cancel()
        await engine.stop()
    delta = {k: stats["end"][k] - stats["start"][k] for k in ("frames_out", "batches")}
    return ticks, drops, late, (w0, w1), w0 - process_start, delta, trace


def serve(cfg: dict, traffic: dict, seed: int, seconds: float, device: str,
          trace_dir: str | None, process_start: float) -> Run:
    """One run: set-up, the window (traced over its last seconds when
    ``trace_dir`` is given), the engine stopped and its state freed.
    ``process_start``: the process's start on the perf_counter clock."""
    cameras = cam.Cameras(traffic, seed)
    engine, states, options = build_engine(cfg, traffic, cameras, seed, device)
    ticks, drops, late, window, setup_s, delta, trace = asyncio.run(
        _drive(engine, states, cameras, traffic, seconds, trace_dir, process_start))
    peak_reserved = 0
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        peak_reserved = torch.cuda.max_memory_reserved()
    # the program's state goes before the reference runs; a frame's
    # latents are held as a host copy
    for rec in ticks:
        if rec.latents is not None:
            rec.latents = rec.latents.float().cpu()
    del engine, states
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return Run(cameras, options, ticks, drops, late, window, setup_s, delta, peak_reserved, trace)


def window_frames(run: Run) -> list:
    """The frames whose ticks fall in the measured window."""
    w0, w1 = run.t_window
    return [r for r in run.ticks if w0 <= r.due < w1]


def latencies_ms(run: Run) -> list:
    return [(r.resolved - r.due) * 1e3 for r in window_frames(run) if r.resolved is not None]


def delivered(run: Run) -> int:
    """Styled frames delivered within the window."""
    w0, w1 = run.t_window
    return sum(1 for r in run.ticks if r.fresh and w0 <= r.resolved <= w1)


def generator_late_ms(run: Run) -> tuple[float, float]:
    """(median, largest) lateness of the camera clocks' wake-ups in the window, ms."""
    w0, w1 = run.t_window
    vals = [d * 1e3 for due, d in run.late if w0 <= due < w1]
    return (float(np.median(vals)), float(max(vals))) if vals else (0.0, 0.0)
