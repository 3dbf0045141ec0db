"""Device time per call of kernels K1 and K2 in one checkout of the port.

    python3 videosd_tpu_torch/kernel_times.py [--root DIR]

Imports ``videosd_tpu_torch`` from DIR (default: the checkout this file is
in), so that an older tree unpacked beside this one can be timed with the
same code: run it for the old tree and this one in turns (old, new, new,
old) in one call on one card, since cards and their power limits differ
between calls.  It times, with torch.profiler (the device time of every
kernel and memset a call issues, median of three sessions of 20 calls):

* K1, ``flash_attention`` in bf16 on ``[1, S, 8*d]`` tensors at the sd15
  512x512 main path's three shapes;
* K2, ``fused_preprocess`` of a uint8 frame at 512x512, 768x768, 480x640
  and 1080x1920, with its device operations per call.

Prints one JSON line per kernel and shape, then the card's name and power
limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

K1_SHAPES = [(8, 4096, 40), (8, 1024, 80), (8, 256, 160)]
K2_SHAPES = [(512, 512), (768, 768), (480, 640), (1080, 1920)]
CALLS, SESSIONS = 20, 3


def _device(torch, fn) -> tuple[float, float]:
    """(device ms per call, device operations per call): medians over
    sessions of CALLS calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    ms, ops = [], []
    for _ in range(SESSIONS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        ms.append(sum(e.self_device_time_total for e in events) / CALLS / 1e3)
        ops.append(sum(e.count for e in events) / CALLS)
    return statistics.median(ms), statistics.median(ops)


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=here, help="checkout to import the port from")
    root = os.path.abspath(parser.parse_args().root)
    sys.path.insert(0, root)
    import torch

    from videosd_tpu_torch.ops.cuda import flash_attention as fa
    from videosd_tpu_torch.ops.cuda import preprocess_kernel as k2

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    tree = os.path.relpath(root, here)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, s, d in K1_SHAPES:
        q, k, v = (torch.randn(1, s, h * d, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        ms, ops = _device(torch, lambda: fa.flash_attention(q, k, v, num_heads=h))
        print(json.dumps({"tree": tree, "kernel": "K1", "shape": [h, s, d],
                          "device_ms": ms, "device_ops_per_call": ops}))
    for hw in K2_SHAPES:
        frame = torch.randint(0, 256, (*hw, 3), generator=gen, device="cuda", dtype=torch.uint8)
        ms, ops = _device(torch, lambda: k2.fused_preprocess(frame))
        print(json.dumps({"tree": tree, "kernel": "K2", "shape": [*hw, 3],
                          "device_ms": ms, "device_ops_per_call": ops}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")


if __name__ == "__main__":
    main()
