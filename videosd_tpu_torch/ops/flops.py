"""FLOP account of one frame, and MFU, for the port.

Counterpart of ``videosd_tpu/ops/flops.py``, which walks the jitted
program's jaxpr.  Here the frame program's body runs on the ``meta``
device (shapes only, no weights, no data) under
``torch.utils.flop_counter.FlopCounterMode``, which counts every matrix
product and convolution it dispatches: the logical count, 2·M·K·N per
product, as JAX counts its ``dot_general`` and ``conv_general_dilated``.

Kernel K1 is a ctypes call that the counter cannot see, so the routed
attentions run through K1's plain version while counting (the
``_attention_xla`` products, which JAX counts with
``VIDEOSD_ATTN_IMPL=xla``), and each routed shape is recorded.  TAESD is
counted on its default route: the ``pallas_convs`` route (kernel K3) runs
the same 3×3 convs.

**Padded** is defined for this card, not for the TPU's 128-lane tiles:
K1's two products at the head width its kernel computes (the bf16
kernel's instance, :data:`~videosd_tpu_torch.ops.cuda.flash_attention.INSTANCE_WIDTHS`,
rounded up to ``wgmma``'s bf16 K-step of 16; the fp32 kernel's head dim
rounded up to ``mma.sync``'s k-step and n-tile of 8; above d = 256 the wide
kernels'
Q·Kᵀ once per slice of output columns, at the depth padded to 64 columns
in bf16 and to 16 in fp32, and their P·V once, at the columns padded to
64 in bf16 and to 8 in fp32; the fp32 kernels' three TF32 products per
fp32 product count as one), and every product the libraries run
(cuBLAS, cuDNN) as it is, logical.

Peaks: the dense bf16 tensor-core rate from NVIDIA's data sheet
(:func:`device_peak_flops`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils.flop_counter import FlopCounterMode

from videosd_tpu_torch.models import layers
from videosd_tpu_torch.ops.cuda.flash_attention import (
    MAX_HEAD_DIM,
    depth,
    instance_width,
    wide_plan,
    wide_slices,
)
from videosd_tpu_torch.pipelines.lcm_img2img import (
    ModelBundle,
    _call_inputs,
    _check_spec,
    _frame_body,
    _latent_hw,
    _new_buffers,
)

__all__ = ["attention_padded_width", "device_peak_flops", "frame_flops", "mfu"]

# dense bf16 tensor-core peak FLOP/s by torch.cuda.get_device_name (NVIDIA's
# data sheets): the H100 SXM is "NVIDIA H100 80GB HBM3"
_PEAKS = {"NVIDIA H100 80GB HBM3": 989.4e12, "NVIDIA H100 SXM": 989.4e12}


def device_peak_flops(name: str | None = None) -> float | None:
    """Dense bf16 peak FLOP/s of the card named ``name`` (default: CUDA
    device 0's name), or None for a card this table does not know and where
    there is no card."""
    if name is None:
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    return next((peak for key, peak in _PEAKS.items() if name.startswith(key)), None)


def mfu(flops: float, seconds: float, peak: float | None) -> float | None:
    """``flops / (seconds * peak)``, or None when the peak is unknown."""
    if not peak or seconds <= 0:
        return None
    return flops / (seconds * peak)


def attention_padded_width(d: int, dtype: torch.dtype) -> int:
    """The head width K1's two products run at for head dim ``d``, as the
    width ``w`` of ``4 Sq Sk w`` flops: the bf16 instance rounded up to 16,
    or ``d`` rounded up to 8 in fp32 (the ``mma.sync`` k-step of Q·Kᵀ's
    depth and the n-tile of P·V's columns).  Above d = 256 the wide kernels run
    P·V once and Q·Kᵀ once per block (fp32: one per slice of 512 columns,
    :func:`wide_slices`) or once per cluster (bf16: the slices of a cluster
    split the depth, :func:`wide_plan`; one cluster up to d = 2048): in bf16
    both at ``d`` padded to 64 (panels), in fp32 Q·Kᵀ at ``d`` padded to 16
    (two k-steps of 8) and P·V at ``d`` padded to 8 (an m16n8 tile's
    columns).  ``w`` is their mean: 512 at d = 512 in bf16 and in fp32."""
    if d > MAX_HEAD_DIM:
        if dtype == torch.float32:
            return (-(-d // 16) * 16 * wide_slices(d, dtype) + -(-d // 8) * 8) // 2
        plan = wide_plan(d)
        dp = -(-d // 64) * 64
        return dp * (plan.grid_slices // plan.cluster_slices + 1) // 2
    if dtype == torch.float32:
        return -(-d // 8) * 8
    return depth(instance_width(d))


def _meta_bundle(bundle):
    """A bundle of ``bundle``'s family, dtype and hook on the meta device,
    without weights; TAESD on its default route."""
    meta = ModelBundle.random(bundle.family, dtype=bundle.dtype, device="meta",
                              with_controlnet="controlnet" in bundle.models,
                              with_kl_vae="vae" in bundle.models)
    taesd_cfg = dataclasses.replace(bundle.taesd_cfg, packed_convs=False, pallas_convs=False)
    return dataclasses.replace(meta, taesd_cfg=taesd_cfg, safety_hook=bundle.safety_hook)


@contextlib.contextmanager
def _plain_attention(routed: list):
    """Route K1's attentions through its plain version, recording each as
    (batch x heads, Sq, Sk, d, dtype) in ``routed``.  Not thread-safe: it
    swaps ``layers.flash_attention`` for the duration."""
    kernel = layers.flash_attention

    def plain(q, k, v, *, num_heads):
        routed.append((q.shape[0] * num_heads, q.shape[1], k.shape[1],
                       q.shape[2] // num_heads, q.dtype))
        return layers._attention_plain(q, k, v, num_heads)

    layers.flash_attention = plain
    try:
        yield
    finally:
        layers.flash_attention = kernel


def frame_flops(bundle, spec, *, warm: bool = False, src_box: bool = False,
                reuse: bool = False) -> dict:
    """Matrix-product and convolution FLOPs of one call of ``spec``'s frame
    program on ``bundle``'s family and dtype: ``{"logical", "padded"}``.
    ``warm``, ``src_box`` and ``reuse`` pick the call signature (warm start,
    a crop box, temporal reuse of deep caches).  Counted on the meta
    device: nothing runs and no weight is read."""
    _check_spec(bundle, spec)
    meta = _meta_bundle(bundle)
    B = spec.batch
    h, w = _latent_hw(bundle, spec)
    hin, win = spec.resolved_in_shape()
    frame = (torch.zeros((B, hin * 3 // 2, win), dtype=torch.uint8) if spec.in_format == "i420"
             else torch.zeros((B, hin, win, 3), dtype=torch.uint8))
    deep = None
    if reuse:  # the deep features' shape, from a produce call's body
        produce = dataclasses.replace(spec, deepcache_temporal=True)
        deep = _run_body(meta, produce, _inputs(meta, produce, frame, None, None, None))[2]
    bufs = _inputs(meta, spec, frame,
                   torch.zeros((B, h, w, 4)) if warm else None,
                   torch.zeros((B, 4), dtype=torch.int32) if src_box else None, deep)
    routed = []
    with FlopCounterMode(display=False) as counter, _plain_attention(routed):
        _run_body(meta, spec, bufs)
    logical = float(counter.get_total_flops())
    padded = logical + sum(4.0 * bh * sq * sk * (attention_padded_width(d, dt) - d)
                           for bh, sq, sk, d, dt in routed)
    return {"logical": logical, "padded": padded}


def _inputs(meta_bundle, spec, frame, warm_latents, src_box, deep_caches) -> dict:
    """Meta buffers of one call (shapes only: nothing is staged)."""
    B = spec.batch
    inputs = _call_inputs(
        meta_bundle, spec, frame,
        torch.zeros((B, 77, meta_bundle.unet_cfg.cross_attention_dim)),
        [0.6] * B, [5.0] * B, [2.0] * B, None, warm_latents,
        None if warm_latents is None else [0.3] * B, None, src_box, deep_caches,
    )
    return _new_buffers(meta_bundle, spec, inputs)


def _run_body(meta_bundle, spec, bufs):
    with torch.inference_mode():
        return _frame_body(meta_bundle, spec, **bufs)
