"""Telemetry: generation-time EMA, per-stage timers, profiler trace.

The port's counterpart of ``videosd_tpu/runtime/telemetry.py``: the EMA
(0.95 / 0.05, prior 0.4 s), the stage timers and the metrics registry are
copies (held equal by ``tests/test_torch_port_copies.py``); the trace is
``torch.profiler`` in place of ``jax.profiler``, and
:func:`summarize_trace` reads the trace it exports into the same
device-time breakdown (``device_time_ms``, ``by_type``, ``ops``) and, as
JAX's does with its HLO symbols, the rollup ``by_block``.

The model's blocks are ``torch.profiler.record_function`` ranges named as
the JAX program's scopes (``unet/down0/res1``, ``controlnet``,
``vae_decode``, ...).  A kernel launched eagerly inside them takes its
scope from the trace itself: its launch call's enclosing ranges on the
launching thread.  A kernel replayed from a CUDA graph has no ranges
around it; it takes its scope from its position in the kernel sequence of
its ``cudaGraphLaunch`` (the events that share that launch's
``correlation``), against the sequences that ``Engine.kernel_symbols``
records by running each captured program's body eagerly under the
profiler.
"""

from __future__ import annotations

import contextlib
import sys
import time

__all__ = [
    "EMA",
    "StageTimers",
    "Telemetry",
    "scoped_events",
    "summarize_trace",
]

_TRACE_FILE = "trace.json"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_UNMAPPED = "(unmapped)"


def _load_events(path: str) -> list:
    import json

    with open(path) as f:
        return [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]


def _corr(ev):
    return (ev.get("args") or {}).get("correlation")


class _Trace:
    """One exported trace: its device events (kernels, copies, memsets),
    the host calls that launched them (by ``correlation``) and the
    ``record_function`` ranges of every thread."""

    def __init__(self, events: list):
        self.device = sorted((e for e in events if e.get("cat") in _DEVICE_CATS),
                             key=lambda e: e["ts"])
        self.launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and _corr(e) is not None:
                self.launch[_corr(e)] = e
        self.ranges: dict = {}  # tid -> [(ts, end, name)], by start
        for e in events:
            if e.get("cat") == "user_annotation":
                self.ranges.setdefault(str(e.get("tid")), []).append(
                    (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        for rs in self.ranges.values():
            rs.sort()
        self.host_ops = _outermost([e for e in events if e.get("cat") == "cpu_op"])

    @staticmethod
    def _enclosing(ranges, ts) -> str:
        """The names of the ranges that hold ``ts``, outermost first, as a
        scope path ("" outside every range)."""
        return "/".join(n for a, b, n in ranges if a <= ts <= b)

    def scope(self, ev) -> str | None:
        """The scope of a host operator, or of a device event from the ranges
        around its launch on the launching thread ("" outside every range);
        None for a graph replay's events, and for a device event whose
        launch the trace lacks."""
        if ev.get("cat") == "cpu_op":
            return self._enclosing(self.ranges.get(str(ev.get("tid")), ()), ev["ts"])
        launch = self.launch.get(_corr(ev))
        if launch is None or "GraphLaunch" in launch["name"]:
            return None
        return self._enclosing(self.ranges.get(str(launch.get("tid")), ()), launch["ts"])

    def graph_replays(self) -> list:
        """The device events of each ``cudaGraphLaunch``, in device order."""
        groups: dict = {}
        for ev in self.device:
            launch = self.launch.get(_corr(ev))
            if launch is not None and "GraphLaunch" in launch["name"]:
                groups.setdefault(_corr(ev), []).append(ev)
        return list(groups.values())


def scoped_events(path: str, root: str) -> list:
    """``[(name, scope)]`` for the work a thread ran inside the
    ``record_function(root)`` range of the trace at ``path``, in the order
    it ran, each with its scope below ``root``: the device events where the
    trace has them, else the outermost host operators.  What
    ``Engine.kernel_symbols`` records for one program."""
    trace = _Trace(_load_events(path))
    spans = [(tid, a, b) for tid, rs in trace.ranges.items() for a, b, n in rs if n == root]
    if not spans:
        return []
    tid, a, b = spans[0]

    def inside(host_ev):
        return (host_ev is not None and str(host_ev.get("tid")) == tid
                and a <= host_ev["ts"] <= b)

    if trace.device:
        chosen = [e for e in trace.device if inside(trace.launch.get(_corr(e)))]
    else:
        chosen = [e for e in trace.host_ops if inside(e)]
    out = []
    for ev in chosen:
        parts = trace.scope(ev).split("/")  # root's range holds its launch
        out.append((ev["name"], "/".join(parts[parts.index(root) + 1:])))
    return out


def _block(scope: str) -> str:
    """A scope's model block: its first two parts (``unet/down0``); work
    outside every scope is ``(unmapped)``."""
    return "/".join(scope.split("/")[:2]) if scope else _UNMAPPED


_LOOKAHEAD = 64  # recorded events an aligned replay may skip at once


def _walk(names: list, seq: list) -> tuple[int, list]:
    """Walk a replay's event names along a recorded sequence from its start:
    a name that matches the recorded event at hand takes it; a name the
    recorded sequence lacks (the next name matches there) takes that
    position and leaves it; else the next recorded event of that name within
    _LOOKAHEAD (events the replay lacks are skipped), or none.  Returns
    (names matched, the recorded index of each)."""
    at, hits, idx, last = 0, 0, [], len(seq) - 1
    for i, name in enumerate(names):
        if at <= last and seq[at][0] == name:
            j = at
        elif at <= last and i + 1 < len(names) and seq[at][0] == names[i + 1]:
            idx.append(at)  # recorded without this event
            continue
        else:
            j = next((k for k in range(at, min(at + _LOOKAHEAD, len(seq)))
                      if seq[k][0] == name), None)
            if j is None:
                idx.append(min(at, last))
                continue
        hits += 1
        idx.append(j)
        at = j + 1
    return hits, idx


def _diff_align(names: list, seq: list) -> tuple[int, list]:
    """Align a replay's event names with a recorded sequence where the
    walks fall short (a run of events one side lost, a cut replay): the
    matching blocks of a longest-match diff (``difflib``, no junk
    heuristic: the frame runs the same few kernels thousands of times;
    seconds for one replay of the sd15 frame).  A name the diff leaves
    unmatched takes the position after the previous matched one (before
    the next, ahead of the first).  Returns (names matched, the recorded
    index of each)."""
    import difflib

    recorded = [n for n, _ in seq]
    idx: list = [None] * len(names)
    hits = 0
    for a, b, size in difflib.SequenceMatcher(
        None, names, recorded, autojunk=False
    ).get_matching_blocks():
        idx[a:a + size] = range(b, b + size)
        hits += size
    nxt = next((j - i for i, j in enumerate(idx) if j is not None), 0)
    for i, j in enumerate(idx):
        if j is None:
            idx[i] = min(max(i + nxt, 0), len(seq) - 1)
        else:
            nxt = j - i + 1  # the unmatched names after it follow it
    return hits, idx


def _graph_blocks(names: list, symbols: dict) -> list | None:
    """The blocks of one graph replay's events, by position: from the
    recorded sequence that :func:`_walk` follows best, where the walks
    from its start and from its end each match nine names in ten and put
    all but one in a hundred in the same blocks; else from the sequence
    that holds the most of its names (counted with their multiplicity),
    aligned by :func:`_diff_align`, where nine in ten names match there;
    else None (no sequence fits).  A walk can match most names and still
    drift through a run of events one side lost, since the frame repeats
    its kernels block after block; the two walks then disagree."""
    import collections

    seqs = [seq for seq in symbols.values() if seq]
    if not seqs:
        return None
    hits, idx, seq = max(((*_walk(names, seq), seq) for seq in seqs), key=lambda w: w[0])
    back, rev = _walk(names[::-1], seq[::-1])
    blocks = [_block(seq[i][1]) for i in idx]
    agree = sum(b == _block(seq[-1 - i][1]) for b, i in zip(blocks, rev[::-1]))
    if min(hits, back) >= 0.9 * len(names) and agree >= 0.99 * len(names):
        return blocks
    have = collections.Counter(names)
    seq = max(seqs, key=lambda seq: sum((have & collections.Counter(n for n, _ in seq)).values()))
    hits, idx = _diff_align(names, seq)
    return [_block(seq[i][1]) for i in idx] if hits >= 0.9 * len(names) else None


def _by_name(symbols: dict) -> dict:
    """JAX's rule where position cannot be used: a name's first block, with
    a trailing ``*`` where the name ran in more than one block."""
    out: dict = {}
    for seq in symbols.values():
        for name, scope in seq:
            blk = _block(scope)
            if name in out and out[name].rstrip("*") != blk:
                out[name] = out[name].rstrip("*") + "*"
            else:
                out.setdefault(name, blk)
    return out


def summarize_trace(log_dir: str, top: int = 15, symbols: dict | None = None) -> dict:
    """Aggregate a trace written by :meth:`Telemetry.stop_trace` into a
    per-op device-time breakdown: ``{"device_time_ms", "by_type": [{"name",
    "ms", "pct"}], "ops": [...]}``.  Device time is the card's kernels,
    copies and memsets; a trace without them (a CPU run) falls back to the
    host's outermost operator events.

    ``symbols``: ``{program: [(name, scope), ...]}`` from
    ``Engine.kernel_symbols()``.  With it the summary also holds
    ``by_block``, the time by model block (``unet/down0``, ``controlnet``,
    ``vae_decode``, ..., and ``(unmapped)``), and each top op its
    ``block`` (where most of its time went, ``*`` when it ran in several)
    and ``blocks`` (its ms in each).
    An event launched eagerly takes its block from the trace's own ranges
    (``(unmapped)`` outside them); a graph replay's events take theirs by
    position in the replay, from the recorded sequence it matches; where
    neither can tell, JAX's rule: by name, the first block, ``*`` where
    the name ran in several.  ``mapped_by`` counts the events placed each
    way, ``graph_replays`` the replays seen, those placed by position and
    the events of each one not placed."""
    import glob
    import os
    import re

    paths = sorted(glob.glob(os.path.join(log_dir, "**", _TRACE_FILE), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        return {"error": f"no {_TRACE_FILE} under {log_dir}"}
    trace = _Trace(_load_events(paths[-1]))
    chosen = trace.device or trace.host_ops

    def ms_of(ev):
        return float(ev.get("dur", 0.0)) / 1e3

    totals: dict[str, float] = {}
    for ev in chosen:
        totals[ev["name"]] = totals.get(ev["name"], 0.0) + ms_of(ev)
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

    out = {
        "device_time_ms": round(device_ms, 3),
        "by_type": [
            {"name": n[:120], "ms": round(ms, 3), "pct": pct(ms)}
            for n, ms in sorted(by_type.items(), key=lambda kv: -kv[1])[:top]
        ],
        "ops": [{"name": n[:120], "ms": round(ms, 3), "pct": pct(ms)} for n, ms in ops],
    }
    if symbols is None:
        return out

    block_of: dict[int, str] = {}
    mapped_by = {"trace": 0, "position": 0, "name": 0, "none": 0}
    replays = trace.graph_replays()
    placed, unplaced, seen = 0, [], {}
    for group in replays:
        names = tuple(e["name"] for e in group)
        if names not in seen:  # a program's replays mostly carry the same names
            seen[names] = _graph_blocks(list(names), symbols)
        blocks = seen[names]
        if blocks is None:
            unplaced.append(len(names))
            continue
        placed += 1
        for ev, blk in zip(group, blocks):
            block_of[id(ev)] = blk
            mapped_by["position"] += 1
    out["graph_replays"] = {"replays": len(replays), "placed": placed, "unplaced": unplaced}
    names = _by_name(symbols)
    by_block: dict[str, float] = {}
    per_op: dict[str, dict] = {}
    for ev in chosen:
        blk = block_of.get(id(ev))
        if blk is None:
            scope = trace.scope(ev)
            if scope is not None:
                blk = _block(scope)
                mapped_by["trace"] += 1
            elif ev["name"] in names:
                blk = names[ev["name"]]
                mapped_by["name"] += 1
            else:
                blk = _UNMAPPED
                mapped_by["none"] += 1
        by_block[blk] = by_block.get(blk, 0.0) + ms_of(ev)
        op = per_op.setdefault(ev["name"], {})
        op[blk] = op.get(blk, 0.0) + ms_of(ev)
    out["by_block"] = [
        {"name": n, "ms": round(ms, 3), "pct": pct(ms)}
        for n, ms in sorted(by_block.items(), key=lambda kv: -kv[1])[:top]
    ]
    out["mapped_by"] = mapped_by
    for op, (name, _) in zip(out["ops"], ops):
        blocks = per_op[name]
        main = max(blocks, key=blocks.get)
        op["block"] = main + ("*" if len(blocks) > 1 and not main.endswith("*") else "")
        op["blocks"] = {b: round(ms, 3) for b, ms in sorted(blocks.items(), key=lambda kv: -kv[1])}
    return out


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
        self._tracing = False

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
        """Profile until :meth:`stop_trace` (:func:`profiler`): on a card the
        kernels, copies and memsets of every thread with the runtime calls
        that launched them (``cudaGraphLaunch`` for a replay); on the CPU
        the torch operators and ``record_function`` ranges of every thread
        (the frames run on the engine's dispatch thread).  A serving engine
        starts and stops it through ``Engine.start_trace``/``stop_trace``,
        where no other thread launches on the card meanwhile."""
        self._profiler = profiler()
        self._profiler.__enter__()
        self._trace_dir = log_dir
        self._tracing = True

    def stop_trace(self):
        """End the trace and write it as ``<log_dir>/trace.json`` (Chrome
        trace format), which :func:`summarize_trace` reads."""
        self.end_trace()
        self.write_trace()

    def end_trace(self):
        """End the profiler session (the part of :meth:`stop_trace` that
        must not overlap another thread's launches on a card:
        ``Engine.stop_trace``)."""
        if self._tracing:
            self._profiler.__exit__(None, None, None)
            self._tracing = False

    def write_trace(self):
        """Write the ended trace as ``<log_dir>/trace.json``."""
        if self._trace_dir is not None:
            import os

            os.makedirs(self._trace_dir, exist_ok=True)
            self._profiler.export_chrome_trace(os.path.join(self._trace_dir, _TRACE_FILE))
            self._profiler = None
            self._trace_dir = None


def profiler():
    """A ``torch.profiler.profile`` of the CPU and, where there is a card,
    CUDA activity.  The card's activity (kernels, copies, memsets and the
    runtime calls that launch them) is recorded for every thread; without
    a card, the host operators of every thread where this torch can (its
    experimental ``profile_all_threads``), else of the entering thread's."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=acts)
    return torch.profiler.profile(activities=acts, experimental_config=config)
