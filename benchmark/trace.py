"""Reduction of the traced run: the profiler's trace and the window's frames
into the record that the per-layer readers (``benchmark/metrics/``) read.

The traced sub-window runs from the first styled frame resolved after the
profiler started to the last one resolved before it stopped, so it holds
whole service cycles.  Times are seconds on the harness's clock
(``time.perf_counter``); the trace's microseconds are brought onto it
through the wall clock (the trace's ``baseTimeNanoseconds`` and one
reading of both clocks).

Device activity is every kernel, copy and memset in the trace.  The card
counts as idle where at least one submitted frame is unresolved and
nothing runs on it; each idle stretch is put down to the host call or
range that was running through its middle (a runtime call such as
``cudaGraphLaunch``, a ``record_function`` range such as ``stage``, an
operator), else to Python.
"""

from __future__ import annotations

import bisect
import collections
import json

__all__ = ["OP_CLASSES", "op_class", "reduce_trace", "union"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# device time by class of operation: the first class whose pattern is in a
# kernel's name (the attention and TAESD kernels before the library convs
# and GEMMs, whose names share words; convolutions before GEMMs: cuDNN's
# are implicit GEMMs)
OP_CLASSES = (
    ("flash attention (K1)", ("flash_fwd", "flash_wide_fwd")),
    ("TAESD conv (K3)", ("conv3x3_kernel",)),
    ("layout transposes (cuDNN NCHW<->NHWC)", ("nchwToNhwc", "nhwcToNchw", "tensorTransform",
                                               "nhwcAddPadding")),
    ("convolutions (cuDNN)", ("fprop", "convolve", "cudnn")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "splitKreduce")),
    ("softmax (plain attention)", ("softmax",)),
    ("layer norm", ("layer_norm",)),
    ("reductions (norm statistics, maxima)", ("reduce_kernel",)),
    ("copies and casts", ("copy", "Copy", "Memcpy", "Memset", "memset")),
    ("elementwise (norm arithmetic, silu, adds, scales)", ("elementwise",)),
)


def op_class(name: str) -> str:
    return next((cls for cls, keys in OP_CLASSES if any(k in name for k in keys)), "other")


def union(intervals) -> list:
    """Sorted disjoint union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def _gaps(pending, busy) -> list:
    """Parts of ``pending`` not covered by ``busy`` (both disjoint, sorted)."""
    out = []
    for s, e in pending:
        cur = s
        k = bisect.bisect_left(busy, (s,)) - 1
        k = max(k, 0)
        while k < len(busy) and busy[k][0] < e:
            bs, be = busy[k]
            if be > cur:
                if bs > cur:
                    out.append((cur, min(bs, e)))
                cur = max(cur, be)
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def _label(host: list, starts: list, longest: float, t: float) -> str:
    """The innermost host event (a runtime call before a range or an
    operator) running at ``t``, else "python".  ``host`` is sorted by start,
    ``longest`` its longest duration."""
    best = None
    for i in range(bisect.bisect_left(starts, t - longest), bisect.bisect_right(starts, t)):
        name, s, e, rank = host[i]
        if s <= t < e and (best is None or rank > best[2] or (rank == best[2] and s > best[1])):
            best = (name, s, rank)
    return best[0] if best else "python"


def reduce_trace(path: str, clock_offset_us: float, frames: list, t_start: float,
                 t_stop: float) -> dict | None:
    """The traced run's record.

    ``clock_offset_us``: wall-clock microseconds minus perf_counter
    microseconds, read once; ``frames``: the window's submitted frames
    (``camera.Tick``); ``t_start``/``t_stop``: when the profiler started and
    stopped (perf_counter seconds).  None when the trace holds no device
    activity in a sub-window of whole cycles."""
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3

    def sec(ts_us: float) -> float:
        return (ts_us + base_us - clock_offset_us) / 1e6

    device, host = [], []
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = sec(ev["ts"])
        e = s + ev["dur"] / 1e6
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((ev.get("name", ""), s, e))
        elif cat in ("cuda_runtime", "cuda_driver"):
            host.append((ev.get("name", ""), s, e, 2))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((ev.get("name", ""), s, e, 1))
    fresh = sorted(r.resolved for r in frames
                   if r.fresh and r.resolved is not None and t_start < r.resolved < t_stop)
    if len(fresh) < 2 or not device:
        return None
    ta, tb = fresh[0], fresh[-1]
    in_window = [r for r in frames if r.fresh and r.resolved is not None and ta < r.resolved <= tb]
    batches = {id(r.image.base): r.image.base.shape[0] for r in in_window
               if getattr(r.image, "base", None) is not None}
    dev_in = [(n, max(s, ta), min(e, tb)) for n, s, e in device if e > ta and s < tb]
    busy = union((s, e) for _, s, e in dev_in)
    pending = _clip(union((r.submitted, r.resolved) for r in frames if r.resolved is not None),
                    ta, tb)
    idle = _gaps(pending, busy)
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    longest = max((h[2] - h[1] for h in host), default=0.0)
    by_label: dict = collections.defaultdict(float)
    for s, e in idle:
        by_label[_label(host, starts, longest, 0.5 * (s + e))] += e - s
    by_class: dict = collections.defaultdict(float)
    for n, s, e in dev_in:
        by_class[op_class(n)] += e - s
    return {
        "window_s": tb - ta,
        "busy_s": sum(e - s for s, e in busy),
        "idle_s": sum(e - s for s, e in idle),
        "frames": len(in_window),
        "rows": sum(batches.values()),
        "batches": len(batches),
        "device_events": dev_in,  # (name, start, end) clipped to the sub-window
        "device_ops": sorted(by_class.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(by_label.items(), key=lambda kv: -kv[1])[:10],
    }
