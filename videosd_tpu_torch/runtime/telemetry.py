"""Telemetry: generation-time EMA, per-stage timers, profiler trace.

The port's counterpart of ``videosd_tpu/runtime/telemetry.py``: the EMA
(0.95 / 0.05, prior 0.4 s), the stage timers and the metrics registry are
copies (held equal by ``tests/test_torch_port_copies.py``); the trace is
``torch.profiler`` in place of ``jax.profiler``, and
:func:`summarize_trace` reads the trace it exports into the same
device-time breakdown (``device_time_ms``, ``by_type``, ``ops``).
"""

from __future__ import annotations

import contextlib
import sys
import time

__all__ = [
    "EMA",
    "StageTimers",
    "Telemetry",
    "summarize_trace",
]

_TRACE_FILE = "trace.json"


def summarize_trace(log_dir: str, top: int = 15) -> dict:
    """Aggregate a trace written by :meth:`Telemetry.stop_trace` into a
    per-op device-time breakdown: ``{"device_time_ms", "by_type": [{"name",
    "ms", "pct"}], "ops": [...]}``.  Device time is the card's kernels,
    copies and memsets; a trace without them (a CPU run) falls back to the
    host's outermost operator events."""
    import glob
    import json
    import os
    import re

    paths = sorted(glob.glob(os.path.join(log_dir, "**", _TRACE_FILE), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        return {"error": f"no {_TRACE_FILE} under {log_dir}"}
    with open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    chosen = device or _outermost([e for e in events if e.get("cat") == "cpu_op"])

    totals: dict[str, float] = {}
    for ev in chosen:
        totals[ev["name"]] = totals.get(ev["name"], 0.0) + float(ev.get("dur", 0.0)) / 1e3
    device_ms = sum(totals.values())
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]

    # rollup by op category: a kernel's name up to its template arguments,
    # an operator's name ("aten::conv2d")
    by_type: dict[str, float] = {}
    for n, ms in totals.items():
        base = re.sub(r"[<(].*$", "", n).strip() or n
        by_type[base] = by_type.get(base, 0.0) + ms

    def pct(ms):
        return round(100.0 * ms / device_ms, 1) if device_ms else 0.0

    return {
        "device_time_ms": round(device_ms, 3),
        "by_type": [
            {"name": n[:120], "ms": round(ms, 3), "pct": pct(ms)}
            for n, ms in sorted(by_type.items(), key=lambda kv: -kv[1])[:top]
        ],
        "ops": [{"name": n[:120], "ms": round(ms, 3), "pct": pct(ms)} for n, ms in ops],
    }


def _outermost(events: list) -> list:
    """The events no other event of their thread encloses (an operator's
    time already holds the operators it calls)."""
    out, end = [], {}
    for ev in sorted(events, key=lambda e: (str(e.get("tid")), e["ts"])):
        tid = str(ev.get("tid"))
        if ev["ts"] >= end.get(tid, float("-inf")):
            out.append(ev)
            end[tid] = ev["ts"] + ev.get("dur", 0)
    return out


class EMA:
    """Exponential moving average, reference constants (0.95 old / 0.05 new,
    initial prior 0.4 s — server.py:96,113)."""

    def __init__(self, initial: float = 0.4, decay: float = 0.95):
        self.value = initial
        self.decay = decay
        self.count = 0

    def update(self, sample: float) -> float:
        self.value = self.decay * self.value + (1.0 - self.decay) * sample
        self.count += 1
        return self.value


class StageTimers:
    def __init__(self):
        self.emas: dict[str, EMA] = {}

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0)

    def record(self, stage: str, seconds: float):
        self.emas.setdefault(stage, EMA(0.0)).update(seconds)

    def snapshot(self) -> dict[str, float]:
        return {k: v.value for k, v in self.emas.items()}


class Telemetry:
    """Process-wide metrics registry + optional torch.profiler tracing."""

    def __init__(self):
        self.gen_time = EMA()
        self.stages = StageTimers()
        self.frames_in = 0
        self.frames_out = 0
        self.frames_dropped = 0
        self.batches = 0
        self.batch_fill = EMA(1.0)
        self._trace_dir: str | None = None
        self._profiler = None

    def record_generation(self, seconds: float, batch: int = 1, fill: float = 1.0):
        self.gen_time.update(seconds)
        self.frames_out += batch
        self.batches += 1
        self.batch_fill.update(fill)

    def print_gentime(self):
        """Reference-style live EMA line (server.py:114)."""
        sys.stdout.write("\rAverage gentime %f" % self.gen_time.value)
        sys.stdout.flush()

    def snapshot(self) -> dict:
        return {
            "avg_gen_time_s": self.gen_time.value,
            "frames_in": self.frames_in,
            "frames_out": self.frames_out,
            "frames_dropped": self.frames_dropped,
            "batches": self.batches,
            "avg_batch_fill": self.batch_fill.value,
            "stages": self.stages.snapshot(),
        }

    def start_trace(self, log_dir: str):
        """Profile until :meth:`stop_trace`: the calling thread's torch
        operators and, on a card, the kernels of every thread."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.__enter__()
        self._trace_dir = log_dir

    def stop_trace(self):
        """End the trace and write it as ``<log_dir>/trace.json`` (Chrome
        trace format), which :func:`summarize_trace` reads."""
        if self._trace_dir is not None:
            import os

            self._profiler.__exit__(None, None, None)
            os.makedirs(self._trace_dir, exist_ok=True)
            self._profiler.export_chrome_trace(os.path.join(self._trace_dir, _TRACE_FILE))
            self._profiler = None
            self._trace_dir = None
