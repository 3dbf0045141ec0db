"""Run one cell of the benchmark once, on the card of the machine it runs on.

    python3 benchmark/run.py --workload sd15-cam4 --seed 7 --seconds 30 --trace 0

Prints progress on standard error and, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number of the output check with its limit.  Exits non-zero
without a result where there is no card, too few cards, a failure, or a
module of JAX or of the JAX package loaded in this process.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cache of the program and its libraries at a fixed path inside the
# checkout, and no tokenizer vocabulary from the environment (the served
# prompts tokenize by the package's own fallback, as the reference does)
_CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(_CACHE, "inductor")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["HF_HOME"] = os.path.join(_CACHE, "no_hf_home")
os.environ.pop("VIDEOSD_VOCAB_DIR", None)
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "videosd_tpu")


def process_start_perf() -> float:
    """This process's start on the perf_counter clock (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - age


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def end_to_end(name: str, run, setup_s: float):
    """An end-to-end metric's value on the host's clock."""
    from benchmark import camera, serve

    lat = serve.latencies_ms(run)
    if name == "setup_s":
        return setup_s
    if name == "frames_per_s":
        return serve.delivered(run) / (run.t_window[1] - run.t_window[0])
    if name == "latency_p50_ms":
        return camera.percentile(lat, 50)
    if name == "latency_p95_ms":
        return camera.percentile(lat, 95)
    raise KeyError(f"the harness has no end-to-end metric {name!r}")


def layer_record(cell, run, work) -> dict:
    """What the per-layer readers read (``benchmark/metrics/``)."""
    from benchmark import serve
    from benchmark.trace import reduce_trace

    # the host-clock readings take the window up to the profiler's start:
    # starting and stopping it holds the dispatch thread
    w0 = run.t_window[0]
    cut = run.trace[2] if run.trace is not None else run.t_window[1]
    done = [r for r in serve.window_frames(run)
            if r.fresh and r.resolved is not None and r.resolved < cut]
    record = {
        "cell": cell.name,
        "streams": len(run.options),
        "window_s": cut - w0,
        "delivered": sum(1 for r in run.ticks if r.fresh and w0 <= r.resolved < cut),
        "mean_service_s": sum(r.resolved - r.submitted for r in done) / max(1, len(done)),
        "stats": run.stats,
        "peak_reserved_bytes": run.peak_reserved,
        "flops_per_frame": work.flops,
        "attention_bound_s_per_frame": work.attention_bound_s,
        "trace": None,
    }
    if run.trace is not None:
        path, offset, started, stopped = run.trace
        record["trace"] = reduce_trace(path, offset, run.ticks, started, stopped)
    return record


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             process_start: float | None = None) -> dict:
    """One run of ``cell``: the result line's object (every key but the
    device's name and count, which the caller knows)."""
    import torch

    from benchmark import cells, check, serve
    from benchmark.flops import frame_work

    if process_start is None:
        process_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run = serve.serve(cell.config, cell.traffic, seed, seconds, device,
                          tmp if trace else None, process_start)
        record = None
        if trace:
            work = frame_work(cell.config, cell.traffic["camera_hw"])
            record = layer_record(cell, run, work)
    frames = serve.window_frames(run)
    failed = sum(1 for r in frames if not r.fresh)
    w0, w1 = run.t_window
    drops = sum(1 for _, _, due in run.drops if w0 <= due < w1)
    late50, late_max = serve.generator_late_ms(run)
    print(f"window: {len(frames)} frames submitted, {drops} dropped at the track, "
          f"{serve.delivered(run)} styled frames delivered ({serve.delivered(run) / (w1 - w0):.3f}"
          f" frames/s), {failed} failed; engine frames_out {run.stats['frames_out']} in "
          f"{run.stats['batches']} batches; camera clocks late by {late50:.3f} ms median, "
          f"{late_max:.3f} ms at most", file=sys.stderr, flush=True)
    correct, worst, limits = check.check(cell.config, run, seed, device)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cells.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], run, run.setup_s),
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": correct, "attempted": len(frames), "failed": failed,
              "metrics": metrics,
              "device": {"memory_peak_bytes": int(run.peak_reserved)}}
    if trace and record["trace"] is not None:
        tr = record["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                               "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    # a frame that never came back reads inf, which JSON holds as null
    result["compared"] = {k: {"value": worst[k] if math.isfinite(worst[k]) else None,
                              "limit": limits[k]} for k in limits}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return result


def main(argv=None) -> int:
    start = process_start_perf()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.cells import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      process_start=start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips, **result["device"]}
    result = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device",
                                     "breakdown", "compared") if k in result}
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
