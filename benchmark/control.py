"""The output check's control: the reference put in the program's place and
computed a precision below the configuration's, and its readings.

The configurations serve bf16, so the control computes the reference's
frame with fp8 (e4m3) products: every linear's, convolution's and
attention product's inputs, activations and weights alike, rounded to fp8
with one scale a tensor (its largest magnitude to 448), the products summed
in fp32, as fp8 tensor-core GEMMs do.  Its frames are compared with the
fp32 reference's by the numbers of ``check.py``; the smallest reading over
the seeds is the upper reading a limit must stay under.

    python3 benchmark/control.py --workload sd15-cam1 --seeds 1 2 3 --frames 3

Prints one JSON line a seed and the readings' extremes.  Each control frame
is judged by the output check's own ``check.compare`` and ``check.passes``,
as a served frame would be: its image rounded to uint8, its latents as
computed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from benchmark import camera, check  # noqa: E402
from benchmark.cells import load_cell  # noqa: E402
from benchmark.reference import models as M  # noqa: E402
from benchmark.reference.frame import Reference, build_models  # noqa: E402
from benchmark.weights import draw_state_dicts  # noqa: E402

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def fp8(x):
    """``x`` rounded to fp8 e4m3 under one scale (largest magnitude to 448)."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def fp8_products():
    """Every linear, convolution and attention product of the reference on
    fp8 inputs for the duration."""
    linear, conv2d, attention = F.linear, F.conv2d, M.attention

    def attn(q, k, v, heads, mask=None, kind="self"):
        return attention(fp8(q), fp8(k), fp8(v), heads, mask, kind)

    F.linear = lambda x, w, b=None: linear(fp8(x), fp8(w), b)
    F.conv2d = lambda x, w, b=None, *a, **k: conv2d(fp8(x), fp8(w), b, *a, **k)
    M.attention = attn
    try:
        yield
    finally:
        F.linear, F.conv2d, M.attention = linear, conv2d, attention


def readings(cell, seed: int, frames: int, device: str) -> dict:
    """{number: worst over ``frames`` frames a stream} of the fp8 control
    against the fp32 reference, by ``check.compare``; the frames' ticks are
    drawn from the seed."""
    cfg = cell.config
    cams = camera.Cameras(cell.traffic, seed)
    ref = Reference(cfg, draw_state_dicts(build_models(cfg, "meta"), seed,
                                          getattr(torch, cfg["dtype"]), device), device)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 4])
    hw = (int(cfg["stream_options"]["height"]), int(cfg["stream_options"]["width"]))
    worst = dict.fromkeys(cfg["limits"], 0.0)
    for s in range(len(cams.rates)):
        opts = dict(cfg["stream_options"], prompt=cams.prompts[s], seed=cams.seeds[s])
        for tick in sorted(rng.choice(900, frames, replace=False)):
            cam = torch.from_numpy(cams.frame(s, int(tick)))
            img, lat = ref.frame(cam, opts["prompt"], opts)
            with fp8_products():
                c_img, c_lat = ref.frame(cam, opts["prompt"], opts)
            # the control's frame in the form the engine serves it
            served = camera.Tick(s, int(tick), 0.0, fresh=True, latents=c_lat.cpu(),
                                 image=torch.round(c_img).to(torch.uint8).cpu().numpy())
            for k, v in check.compare(served, img, lat, hw).items():
                worst[k] = max(worst[k], v)
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, default=3, help="frames a stream")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        rows.append(readings(cell, seed, args.frames, "cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed, **rows[-1]}), flush=True)
        torch.cuda.empty_cache()
    limits = cell.config["limits"]
    for k in limits:
        vals = [r[k] for r in rows]
        print(f"{k}: min {min(vals)!r} max {max(vals)!r} (limit {limits[k]!r})")
    failed = sum(not check.passes(r, limits) for r in rows)
    print(f"the control fails the check on {failed} of {len(rows)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
