"""The work of one frame, counted on the benchmark's own reference models.

The reference's frame (after the prompt's encoding) runs on the meta device
under ``FlopCounterMode``: 2·M·K·N for every matrix product and
convolution, whatever implements them in the program, so a change to the
program leaves the count where it is.  The same pass records every
attention call, from which the attention's least time is counted.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import roofline
from benchmark.reference import frame as R
from benchmark.reference import models as M

__all__ = ["FrameWork", "frame_work"]

# the self-attentions a fused attention kernel takes: token counts that are
# multiples of 128, at least 256 (the mid block's 64 tokens at sd15 512² run
# as plain products, and are < 0.1 % of the attention's work)
MIN_FUSED_TOKENS = 256


@dataclasses.dataclass(frozen=True)
class FrameWork:
    flops: float  # matrix-product and convolution FLOPs of one frame
    attention_bound_s: float  # least seconds of the frame's long self-attentions
    attention_calls: int  # how many such self-attentions a frame makes


def _fused(sq: int, sk: int) -> bool:
    return sq % 128 == 0 and sk % 128 == 0 and min(sq, sk) >= MIN_FUSED_TOKENS


def frame_work(cfg: dict, camera_hw) -> FrameWork:
    """Work of one frame of configuration ``cfg`` from a camera of
    ``camera_hw`` (the count does not depend on the batch: every counted
    product is linear in it)."""
    ref = R.Reference(cfg, None, "meta")
    opt = dict(cfg["stream_options"], seed=0)
    unet = ref.unet_cfg
    context = torch.empty((1, 77, unet.cross_attention_dim), device="meta")
    pooled = None
    if unet.addition_embed_type == "text_time":
        width = unet.projection_class_embeddings_input_dim - 6 * unet.addition_time_embed_dim
        pooled = torch.empty((1, width), device="meta")
    camera = torch.empty((*camera_hw, 3), dtype=torch.uint8, device="meta")
    calls: list = []
    M.attention_calls = calls
    try:
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            ref.denoise(camera, context, pooled, opt)
    finally:
        M.attention_calls = None
    long_self = [c for c in calls if c[0] == "self" and _fused(c[3], c[4])]
    return FrameWork(
        flops=float(counter.get_total_flops()),
        attention_bound_s=sum(roofline.attention_bound_s(b, h, sq, sk, d)
                              for _, b, h, sq, sk, d in long_self),
        attention_calls=len(long_self),
    )
