"""The harness's arithmetic, traffic, work count and imports, on the CPU."""

from __future__ import annotations

import ast
import asyncio
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import camera, serve, trace
from benchmark.cells import BENCH_DIR, ROOT, load_cell

DATA = os.path.join(os.path.dirname(__file__), "data")
TRAFFIC = {"kind": "camera", "streams": 3, "camera_hw": [48, 80], "fps": [29.5, 30.5],
           "jitter_ms": 2.0, "lead_in_s": 0.1, "prompts": ["a", "b", "c"]}


def test_cameras_are_deterministic_by_seed():
    a, b, c = (camera.Cameras(TRAFFIC, s) for s in (2**40 + 3, 2**40 + 3, 5))
    assert a.rates == b.rates and a.phases == b.phases and a.seeds == b.seeds
    assert sorted(a.rates) == sorted(c.rates)  # every seed: the same rates, dealt anew
    assert np.array_equal(a.frame(1, 17), b.frame(1, 17))
    assert not np.array_equal(a.frame(1, 17), a.frame(1, 18))  # a new picture every tick
    assert a.due(2, 9, 0.0) == b.due(2, 9, 0.0)
    assert abs(a.due(0, 10, 0.0) - a.phases[0] - 10 / a.rates[0]) <= 0.002
    assert a.frame(0, 0).shape == (48, 80, 3) and a.frame(0, 0).dtype == np.uint8


def test_submit_rule_drops_frames_while_one_is_in_flight():
    cams = camera.Cameras(dict(TRAFFIC, streams=1, fps=[100.0, 100.0]), 1)
    ticks, drops, late = [], [], []

    async def slow_submit(stream, frame, rec):
        await asyncio.sleep(0.035)  # three and a half ticks
        rec.resolved = time.perf_counter()

    t0 = time.perf_counter() + 0.01
    asyncio.run(camera.run_clients(cams, slow_submit, t0, t0 + 0.5, ticks, drops, late))
    assert len(ticks) + len(drops) == len(late) >= 45
    assert 8 <= len(ticks) <= 14 and len(drops) >= 3 * len(ticks) - 6
    for prev, nxt in zip(ticks, ticks[1:]):  # never two in flight
        assert nxt.submitted >= prev.resolved


def test_window_arithmetic_counts_every_sample():
    w0, w1 = 10.0, 20.0
    ticks = []
    for i in range(100):
        rec = camera.Tick(0, i, w0 - 1.0 + 0.12 * i, submitted=w0 - 1.0 + 0.12 * i)
        rec.resolved = rec.due + (0.05 if i % 10 else 0.5)
        rec.fresh = True
        ticks.append(rec)
    run = serve.Run(None, [{}], ticks, [], [], (w0, w1), 1.0, {}, 0)
    frames = serve.window_frames(run)
    assert len(frames) == sum(1 for r in ticks if w0 <= r.due < w1)
    lat = serve.latencies_ms(run)
    assert len(lat) == len(frames)
    # the tail is the tail of every sample, not a median of chunks
    assert camera.percentile(lat, 95) == pytest.approx(float(np.percentile(lat, 95)))
    assert camera.percentile(lat, 95) > 400
    assert serve.delivered(run) == sum(1 for r in ticks if w0 <= r.resolved <= w1)


def test_trace_reduction_reads_busy_idle_and_labels(tmp_path):
    class Img:  # a frame of a batch of two (the engine's host batch array)
        base = np.zeros((2, 1))

    frames = []
    for i, (sub, res) in enumerate([(0.0, 1.0), (0.0, 1.0), (1.1, 2.0), (1.1, 2.0)]):
        rec = camera.Tick(i % 2, i, sub, submitted=sub)
        rec.resolved, rec.fresh, rec.image = res, True, Img()
        frames.append(rec)
    frames[2].image = frames[3].image = type("Img2", (), {"base": np.zeros((2, 1))})()
    us = 1e6
    events = [  # device busy 1.1-1.5 and 1.7-1.9; a graph launch 1.5-1.65 inside "stage"
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel", "ts": 1.1 * us, "dur": 0.4 * us},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 1.7 * us,
         "dur": 0.2 * us},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1.5 * us,
         "dur": 0.15 * us},
        {"ph": "X", "cat": "cpu_op", "name": "stage", "ts": 1.45 * us, "dur": 0.2 * us},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events, "baseTimeNanoseconds": 0}))
    rec = trace.reduce_trace(str(path), 0.0, frames, 0.5, 2.5)
    assert rec["window_s"] == pytest.approx(1.0)  # from the resolve at 1.0 to that at 2.0
    assert rec["busy_s"] == pytest.approx(0.6)
    assert rec["idle_s"] == pytest.approx(0.3)  # 1.0-1.1 before the submits: not pending
    assert rec["frames"] == 2 and rec["rows"] == 2 and rec["batches"] == 1
    labels = dict(rec["idle_gaps"])
    assert labels["cudaGraphLaunch"] == pytest.approx(0.2)  # the gap 1.5-1.7, by its middle
    assert labels["python"] == pytest.approx(0.1)
    assert dict(rec["device_ops"])["flash attention (K1)"] == pytest.approx(0.4)


@pytest.mark.parametrize("workload,batches", [("sd15-cam4", (1, 2, 4)), ("sdxl-cam1", (1,))])
def test_frozen_flop_count_equals_the_ports_count_today(workload, batches):
    """The benchmark counts on its own reference models; today that is the
    port's ``ops/flops.py`` count of the engine's call at every bucket."""
    import torch

    from benchmark.flops import frame_work
    from videosd_tpu_torch.ops.flops import frame_flops
    from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec, ModelBundle

    cell = load_cell(workload)
    cfg, hw = cell.config, cell.traffic["camera_hw"]
    work = frame_work(cfg, hw)
    bundle = ModelBundle.random(cfg["family"], dtype=torch.bfloat16, device="meta",
                                with_controlnet=cfg["controlnet"])
    opt = cfg["stream_options"]
    assert serve.warm_batches(cell.traffic["streams"]) == batches
    for b in batches:
        spec = FrameSpec(batch=b, height=opt["height"], width=opt["width"], in_height=hw[0],
                         in_width=hw[1], steps=opt["steps"], use_controlnet=opt["controlnet"])
        assert frame_flops(bundle, spec, warm=True, src_box=True)["logical"] == b * work.flops
    assert work.attention_calls == {"sd15-cam4": 84, "sdxl-cam1": 280}[workload]


@pytest.mark.parametrize("options,quant,expect", [
    ({"controlnet_interval": 2, "deepcache_interval": 3, "interval_refresh_last": True}, "none",
     {"use_controlnet": True, "controlnet_interval": 2, "deepcache_interval": 3,
      "interval_refresh_last": True, "deepcache_temporal": False}),
    ({"controlnet": False, "deepcache_interval": 3, "deepcache_temporal": 2}, "int8",
     {"use_controlnet": False, "controlnet_interval": 1, "deepcache_interval": 1,
      "interval_refresh_last": False, "deepcache_temporal": True}),
])
def test_set_up_follows_the_configuration_file(options, quant, expect, monkeypatch):
    """The warm-up captures, for each of the cell's buckets, the program that
    the configuration's stream options select (the batcher's rules: temporal
    reuse overrides the DeepCache interval), and the bundle takes the
    configuration's ``quant`` form."""
    from videosd_tpu_torch.ops import quant as Q
    from videosd_tpu_torch.runtime.engine import Engine

    cell = load_cell("tiny-cam2", os.path.join(DATA, "cells.json"), DATA)
    cfg = dict(cell.config, quant=quant,
               stream_options=dict(cell.config["stream_options"], **options))
    warmed, quantized = [], []
    monkeypatch.setattr(Engine, "_warm_spec", lambda self, spec, ref_mode: warmed.append(spec))
    monkeypatch.setattr(Q, "quantize_bundle_params", lambda bundle, **kw: quantized.append(bundle))
    cams = camera.Cameras(cell.traffic, 2**36 + 1)
    engine, _, _ = serve.build_engine(cfg, cell.traffic, cams, 2**36 + 1, "cpu")
    assert [s.batch for s in warmed] == list(serve.warm_batches(cell.traffic["streams"]))
    for spec in warmed:
        assert {k: getattr(spec, k) for k in expect} == expect
    assert quantized == ([engine.bundle] if quant == "int8" else [])
    assert engine.stats().get("quant", "none") == quant


def test_reference_imports_nothing_of_the_port_or_jax():
    forbidden = ("videosd_tpu_torch", "videosd_tpu", "jax", "jaxlib", "flax")
    for name in os.listdir(os.path.join(BENCH_DIR, "reference")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(BENCH_DIR, "reference", name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(m.split(".")[0] in forbidden for m in mods), (name, mods)
    code = ("import sys; import benchmark.reference.frame, benchmark.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & set(forbidden)
