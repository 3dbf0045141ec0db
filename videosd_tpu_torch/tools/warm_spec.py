"""Single-spec warm-up in a process of its own: the child half of the
engine's ``compile_subprocess`` mode.

Counterpart of ``videosd_tpu/tools/warm_spec.py``.
``Engine._compile_spec_background`` (``runtime/engine_warmup.py``) runs
this module with a JSON request file when ``config.compile_subprocess`` is
on: a separate interpreter builds the same ``Engine`` on the parent's
device, runs exactly one ``FrameSpec`` once (``Engine._warm_spec``: the
warm-up and, on the card, the CUDA graph capture), prints one JSON line
and exits.  What outlives it is the kernel library that ``_build.py``
compiles into ``videosd_tpu_torch/_build/`` and the proof that the spec
builds and runs on that device; its graphs die with it (see config
``compile_subprocess``).

Request schema::

    {"cfg": <ServerConfig.from_dict dict>,
     "spec": <FrameSpec field dict>,
     "ref_mode": false,
     "device": "cuda:0"}

``cfg`` carries the engine's live input/output formats and frame size.
A request for a CUDA device on a machine without a card exits non-zero:
the child never falls back to the CPU.

Usage:
    python -m videosd_tpu_torch.tools.warm_spec --json REQUEST.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json", required=True, help="request file (see schema)")
    args = p.parse_args(argv)

    with open(args.json) as f:
        req = json.load(f)

    import torch

    from videosd_tpu_torch.config import ServerConfig
    from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec
    from videosd_tpu_torch.runtime.engine import Engine

    device = torch.device(req.get("device", "cuda"))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit(f"warm_spec: {device} requested and no CUDA device is visible")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    cfg = ServerConfig.from_dict(req["cfg"])
    ref_mode = bool(req.get("ref_mode", False))
    t0 = time.perf_counter()
    engine = Engine(cfg, device=device)
    engine.bundle  # noqa: B018 -- the weights load here, inside init_s
    t_init = time.perf_counter() - t0
    spec = FrameSpec(**req["spec"])
    t0 = time.perf_counter()
    engine._warm_spec(spec, ref_mode=ref_mode)
    print(
        json.dumps(
            {
                "spec": req["spec"],
                "ref_mode": ref_mode,
                "init_s": round(t_init, 2),
                "warm_s": round(time.perf_counter() - t0, 2),
                "device": str(device),
            }
        )
    )


if __name__ == "__main__":
    main()
