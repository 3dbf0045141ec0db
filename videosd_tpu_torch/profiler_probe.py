"""Measure fault F7: short torch.profiler sessions after a long one.

    python3 videosd_tpu_torch/profiler_probe.py

On a card, each variant runs in a process of its own: a CPU + CUDA
torch.profiler session over N kernels (replays of a CUDA graph of 2000
small kernels, or eager kernels inside ``record_function`` ranges), then
CUDA-only sessions around one K1 launch, around ``add, K1, mul`` (20 ms
apart), and around one replay of the 2000-kernel graph; each prints the
device events every session saw.  ``TEARDOWN_CUPTI=0`` (kineto keeps CUPTI
up between sessions) runs as a variant of its own.  Its numbers are
PERF.md's F7 finding (PR 16): after a session of ~100k device events or
more, every later session of the process lost its last one or two events.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# (name, graph replays of 2000 kernels or eager kernels, the sessions of that
# size in a row, environment)
VARIANTS = [
    ("none", 0, 0, {}),
    ("graph 30k x10", 15, 10, {}),
    ("graph 60k", 30, 1, {}),
    ("graph 100k", 50, 1, {}),
    ("graph 300k", 150, 1, {}),
    ("eager 100k", -100000, 1, {}),
    ("graph 300k, TEARDOWN_CUPTI=0", 150, 1, {"TEARDOWN_CUPTI": "0"}),
]


def _variant(index: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from videosd_tpu_torch.ops.cuda import flash_attention as fa

    name, size, repeat, _ = VARIANTS[index]
    q = torch.randn(1, 4096, 320, device="cuda", dtype=torch.bfloat16)
    x = torch.zeros(16, device="cuda")
    side, graph = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        x.add_(1.0)
        fa.flash_attention(q, q, q, num_heads=8)
        torch.cuda.synchronize()
        graph.capture_begin(capture_error_mode="thread_local")
        for _ in range(2000):
            x.add_(1.0)
        graph.capture_end()
    torch.cuda.synchronize()

    def session(fn, acts=(ProfilerActivity.CUDA,)) -> int:
        with profile(activities=list(acts)) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.self_device_time_total > 0)

    def k1():
        fa.flash_attention(q, q, q, num_heads=8)

    def three():
        x.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.02)
        k1()
        torch.cuda.synchronize()
        time.sleep(0.02)
        x.mul_(1.0)

    def long_session():
        if size >= 0:
            for _ in range(size):
                graph.replay()
        else:
            for _ in range(-size):
                with record_function("r"):
                    x.add_(1.0)

    out = {"variant": name, "before, one K1": [session(k1) for _ in range(2)]}
    if size:
        both = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
        out["long sessions"] = [session(long_session, both) for _ in range(repeat)]
    out["after, one K1"] = [session(k1) for _ in range(4)]
    out["after, add K1 mul"] = [session(three) for _ in range(2)]
    out["after, 2000"] = [session(graph.replay) for _ in range(2)]
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe.py needs a CUDA card")
    from videosd_tpu_torch import _build

    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for i, (_, _, _, env) in enumerate(VARIANTS):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(i)],
                              capture_output=True, text=True, timeout=300,
                              env={**os.environ, **env})
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        print(f"{lines[-1] if lines else proc.stderr[-2000:]} (rc {proc.returncode}, "
              f"{time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if len(sys.argv) > 1:
        print(json.dumps(_variant(int(sys.argv[1]))), flush=True)
    else:
        main()
