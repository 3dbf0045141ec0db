"""Device memory held by the frame programs' CUDA graphs, in one checkout.

    python3 videosd_tpu_torch/graph_memory.py [--root DIR]

Imports ``videosd_tpu_torch`` from DIR (default: the checkout this file is
in), so that an older tree unpacked beside this one is measured by the
same code; run old and new in one call on one card.  It builds the random
sd15 bf16 bundle (seed 0) and the programs whose graphs ``chip_smoke.py``
phase 6a holds: the 512x512 4-step parity frame at batch 1 and 4, the three
interval programs and the two temporal DeepCache programs (produce and
reuse, two graphs each), calls each signature once (a warm-up and a
capture), and prints one JSON line: graphs held, GiB allocated and
reserved with every graph held, and the peaks.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

# the programs of chip_smoke.py phase 6a, as FrameSpec fields
PROGRAMS = {"parity": {}, "parity_b4": {"batch": 4},
            "cn_interval4": {"controlnet_interval": 4},
            "dc_interval2": {"deepcache_interval": 2},
            "cn2_dc3_last": {"controlnet_interval": 2, "deepcache_interval": 3,
                             "interval_refresh_last": True},
            "temporal_cn1": {"deepcache_temporal": True},
            "temporal_cn2_last": {"deepcache_temporal": True, "controlnet_interval": 2,
                                  "interval_refresh_last": True}}


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=here, help="checkout to import the port from")
    root = os.path.abspath(parser.parse_args().root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from videosd_tpu_torch.pipelines import lcm_img2img as P

    if not torch.cuda.is_available():
        raise SystemExit("graph_memory.py needs a CUDA card")
    bundle = P.ModelBundle.random("sd15", dtype=torch.bfloat16, device="cuda")
    embeds = P.build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))[0]
    rng = np.random.default_rng(0)
    spec = P.FrameSpec(batch=1, height=512, width=512, steps=4)
    programs = []
    for fields in PROGRAMS.values():
        s = dataclasses.replace(spec, **fields)
        program = P.build_frame_program(bundle, s)
        programs.append(program)
        b = s.batch
        frame = torch.from_numpy(rng.integers(0, 256, (b, 512, 512, 3), dtype=np.uint8)).cuda()
        args = (frame, embeds.expand(b, -1, -1), [0.6] * b, [5.0] * b, [2.0] * b, list(range(b)))
        out = program(*args)
        if s.deepcache_temporal:
            program(*args, deep_caches=out[2])
    torch.cuda.synchronize()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "tree": os.path.relpath(root, here),
        "graphs": sum(len(p.buckets) for p in programs),
        "allocated_gib": torch.cuda.memory_allocated() / 2**30,
        "reserved_gib": torch.cuda.memory_reserved() / 2**30,
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
        "card": card,
    }))


if __name__ == "__main__":
    main()
