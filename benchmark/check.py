"""Whether the timed path's frames are right: the output check.

After the window, a sample of the styled frames that the engine delivered
in it, drawn from the seed (``check_frames`` of each stream, or every one
where fewer came), is made again by the plain float32 reference
(``reference/frame.py``) from what the client sent: the camera frame (made
again from the stream and the tick), the prompt, the stream's options and
seed.  The reference's weights are drawn again from the seed.  Two numbers
are compared, each the worst over the sample, each with its limit from
the configuration's ``limits``:

* ``latent_rel_l2``: ‖z − z_ref‖ / ‖z_ref‖ of the denoised latents that the
  frame was decoded from (the program's, as the engine keeps them for the
  stream);
* ``image_rms``: the root mean square, in levels of 255, of the served
  uint8 image less the reference's image before rounding.

Every sampled frame has to have come back as a new styled frame of the
configuration's size.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from benchmark.reference.frame import Reference, build_models
from benchmark.weights import draw_state_dicts

__all__ = ["check", "compare", "passes", "sample"]


def sample(frames: list, streams: int, per_stream: int, seed: int) -> list:
    """Up to ``per_stream`` of each stream's ``frames``, drawn from ``seed``,
    in tick order."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 3])
    out = []
    for s in range(streams):
        mine = [r for r in frames if r.stream == s]
        if len(mine) > per_stream:
            idx = sorted(rng.choice(len(mine), per_stream, replace=False))
            mine = [mine[i] for i in idx]
        out.extend(mine)
    return out


def compare(rec, ref_image: torch.Tensor, ref_latents: torch.Tensor, hw) -> dict:
    """The numbers of one frame; inf where the frame is missing or malformed."""
    img = rec.image
    if (not rec.fresh or img is None or tuple(img.shape) != (*hw, 3) or img.dtype != np.uint8
            or rec.latents is None):
        return {"latent_rel_l2": math.inf, "image_rms": math.inf}
    prog = torch.from_numpy(np.ascontiguousarray(img)).float()
    ref = ref_image.float().cpu()
    lat = rec.latents.float().reshape(ref_latents.shape)
    ref_lat = ref_latents.float().cpu()
    return {
        "latent_rel_l2": float(torch.linalg.vector_norm(lat - ref_lat)
                               / torch.linalg.vector_norm(ref_lat)),
        "image_rms": float(torch.sqrt(torch.mean((prog - ref) ** 2))),
    }


def passes(worst: dict, limits: dict) -> bool:
    """The rule of ``correct``: every number at or under its limit."""
    return all(worst[k] <= limits[k] for k in limits)


def check(cfg: dict, run, seed: int, device: str) -> tuple[bool, dict, dict]:
    """(correct, {number: worst reading}, {number: limit}) of one run."""
    w0, w1 = run.t_window
    frames = [r for r in run.ticks if w0 <= r.due < w1]
    picked = sample(frames, len(run.options), int(cfg["check_frames"]), seed)
    limits = {k: float(v) for k, v in cfg["limits"].items()}
    worst = dict.fromkeys(limits, 0.0 if picked else math.inf)
    models = build_models(cfg, "meta")
    ref = Reference(cfg, draw_state_dicts(models, seed, getattr(torch, cfg["dtype"]), device),
                    device)
    del models
    gc.collect()
    hw = (int(cfg["stream_options"]["height"]), int(cfg["stream_options"]["width"]))
    for rec in picked:
        camera = torch.from_numpy(run.cameras.frame(rec.stream, rec.tick))
        image, latents = ref.frame(camera, run.options[rec.stream]["prompt"],
                                   run.options[rec.stream])
        for k, v in compare(rec, image, latents, hw).items():
            worst[k] = max(worst[k], v)
    correct = bool(picked) and passes(worst, limits)
    return correct, worst, limits
