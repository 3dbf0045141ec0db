"""Ahead-of-boot warm-up: run every configured serving bucket once, exit.

Counterpart of ``videosd_tpu/tools/warm_cache.py``.  An ops pre-roll, run
before (re)starting the server:

    python -m videosd_tpu_torch.tools.warm_cache --config config.yaml [--device cuda]

It warms exactly what ``Engine.warmup`` would at startup (the same call
signatures), one bucket and step count at a time, and prints their seconds
(``init_s``: the engine and its weights, before the first bucket).
Where JAX's tool fills XLA's persistent cache, what persists here is the
kernel library that ``_build.py`` compiles into
``videosd_tpu_torch/_build/`` (keyed by a hash of the sources, installed
by an atomic rename, so two processes may race to build it): a server
booted after this run loads it instead of running ``nvcc``.  The CUDA
graphs this process captures die with it; a server captures its own.  Run
it twice and compare the seconds to see what the library saves.  The
report names the library's path and whether it exists.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="config.yaml")
    p.add_argument(
        "--steps",
        type=int,
        nargs="*",
        default=[4],
        help="step counts to warm (each is its own program)",
    )
    p.add_argument(
        "--cn-interval",
        type=int,
        default=1,
        help="warm the controlnet_interval=k turbo variant of every"
        " bucket (1 = reference-parity programs)",
    )
    p.add_argument(
        "--dc-interval",
        type=int,
        default=1,
        help="warm the deepcache_interval=k turbo variant of every"
        " bucket (1 = reference-parity programs)",
    )
    p.add_argument(
        "--refresh-last",
        action="store_true",
        help="warm the interval_refresh_last variant (final-step cache"
        " refresh; no effect when both intervals are 1)",
    )
    p.add_argument(
        "--ref",
        action="store_true",
        help="also warm each bucket's reference-attention program "
        "(ref-mode streams; double-pass UNet: a program of its own)",
    )
    p.add_argument(
        "--temporal",
        action="store_true",
        help="warm the temporal-DeepCache variants of every bucket (both"
        " call signatures: produce and reuse)",
    )
    p.add_argument("--device", default="cuda", help="the engine's device (default the card)")
    args = p.parse_args(argv)

    from videosd_tpu_torch._build import library_path
    from videosd_tpu_torch.config import load_config
    from videosd_tpu_torch.runtime.engine import Engine

    cfg = load_config(args.config)
    t0 = time.perf_counter()
    engine = Engine(cfg, device=args.device)
    engine.bundle  # noqa: B018 -- the weights load here, inside init_s
    init_s = round(time.perf_counter() - t0, 2)
    buckets = sorted(set(cfg.batch_buckets)) or [1]
    timings: dict[str, float] = {}
    t_all = time.perf_counter()
    for b in buckets:
        for s in args.steps:
            t0 = time.perf_counter()
            engine.warmup(
                batch_sizes=(b,), steps=(s,), cn_interval=args.cn_interval,
                dc_interval=args.dc_interval, refresh_last=args.refresh_last,
                temporal=args.temporal or None,
                ref=args.ref,
            )
            timings[f"b{b}_s{s}"] = round(time.perf_counter() - t0, 2)
    lib = library_path()
    print(
        json.dumps(
            {
                "buckets": timings,
                "total_s": round(time.perf_counter() - t_all, 2),
                "init_s": init_s,
                "kernel_library": lib,
                "kernel_library_built": os.path.isfile(lib),
            }
        )
    )


if __name__ == "__main__":
    main()
