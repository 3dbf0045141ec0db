"""The port's FLOP account (``videosd_tpu_torch/ops/flops.py``) against JAX's.

JAX counts one frame's products by walking the jitted program's jaxpr
(``videosd_tpu/ops/flops.py::program_flops``, with
``VIDEOSD_ATTN_IMPL=xla`` so attention appears as two ``dot_general``s);
the port runs the frame body on the ``meta`` device under torch's
``FlopCounterMode``, attention through K1's plain version.  The logical
counts agree exactly at the tiny family's shapes, but for one difference,
named in :func:`_crop_resize_products`; at sd15 512x512 the port comes
within 1 % of the 4.61 TFLOP/frame of the JAX walk (``BENCH_r05.json``, a
count of work, not a measurement).  Nothing here runs a model: JAX only
traces and the port counts on ``meta``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.ops.flops import program_flops
from videosd_tpu.ops.preprocess import rgb_to_i420_host
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu_torch.ops import flops as PF
from videosd_tpu_torch.pipelines import lcm_img2img as P

# one torch thread per process (see tests/test_torch_port_production.py)
torch.set_num_threads(1)

# sd15 512x512 4-step CN + TAESD, logical TFLOP per frame from JAX's jaxpr
# walk (BENCH_r05.json, "flops_per_frame_tflop_logical")
SD15_JAX_TFLOP = 4.61


@pytest.fixture(scope="module")
def jax_bundle():
    return J.ModelBundle.random("tiny", dtype=jnp.float32)


# (spec fields, input shape (H, W) of the frame, call signature)
CASES = {
    "parity_64": ({"height": 64, "width": 64, "steps": 2}, None, {}),
    "parity_128_routed_attention": ({"height": 128, "width": 128, "steps": 2}, None, {}),
    "cn2_dc3_last": ({"height": 64, "width": 64, "steps": 4, "controlnet_interval": 2,
                      "deepcache_interval": 3, "interval_refresh_last": True}, None, {}),
    "temporal_produce": ({"height": 64, "width": 64, "steps": 3, "deepcache_temporal": True},
                         None, {}),
    "temporal_reuse": ({"height": 64, "width": 64, "steps": 3, "deepcache_temporal": True},
                       None, {"reuse": True}),
    "resize_48x80_batch2": ({"height": 32, "width": 32, "steps": 2, "batch": 2}, (48, 80), {}),
    "warm_start_src_box_i420": ({"height": 32, "width": 32, "steps": 2, "in_height": 64,
                                 "in_width": 64, "in_format": "i420"}, None,
                                {"warm": True, "src_box": True}),
}


def _crop_resize_products(spec) -> float:
    """The one difference between the two counts: JAX's ``crop_resize``
    applies its lanczos taps with two ``einsum``s (``dot_general``s, counted),
    the port's with an elementwise product and a sum (not a product the
    counter sees).  Per element, rows then columns: [out_h, taps_h] taps
    over [Win, 3], then [out_w, taps_w] over [out_h, 3], with the tap budget
    of ``_resample_axis``."""
    hin, win = spec.resolved_in_shape()

    def taps(n_in, n_out):
        return int(np.ceil(2.0 * 3.0 * max(1.0, n_in / n_out))) + 2

    per_element = (spec.height * taps(hin, spec.height) * win * 3
                   + spec.height * spec.width * taps(win, spec.width) * 3)
    return 2.0 * spec.batch * per_element


def _jax_count(jb, spec_kw, in_hw, sig, monkeypatch) -> float:
    monkeypatch.setenv("VIDEOSD_ATTN_IMPL", "xla")
    spec = J.FrameSpec(**spec_kw)
    b = spec.batch
    hin, win = in_hw or spec.resolved_in_shape()
    if spec.in_format == "i420":
        frame = jnp.asarray(np.stack([rgb_to_i420_host(np.zeros((hin, win, 3), np.uint8))] * b))
    else:
        frame = jnp.zeros((b, hin, win, 3), jnp.uint8)
    embeds = jnp.zeros((b, 77, jb.clip_cfg.hidden_size), jnp.float32)
    args = (jnp.full((b,), 0.6), jnp.full((b,), 5.0), jnp.full((b,), 2.0),
            jnp.arange(b, dtype=jnp.int32))
    kw = {}
    h, w = -(-spec.height // 8), -(-spec.width // 8)
    if sig.get("warm"):
        kw.update(warm_latents=jnp.zeros((b, h, w, 4)), warm_alpha=jnp.full((b,), 0.3))
    if sig.get("src_box"):
        kw["src_box"] = jnp.zeros((b, 4), jnp.int32)
    program = J.build_frame_program(jb, spec)
    if sig.get("reuse"):  # the caches' shape, from a produce call's trace
        caches = jax.eval_shape(program, jb.params, frame, embeds, *args)[2]
        kw["deep_caches"] = jnp.zeros(caches.shape, caches.dtype)
    return program_flops(program, jb.params, frame, embeds, *args, **kw)["logical"]


def _port_count(spec_kw, in_hw, sig) -> float:
    spec = P.FrameSpec(**spec_kw)
    if in_hw is not None:
        spec = P.FrameSpec(**spec_kw, in_height=in_hw[0], in_width=in_hw[1])
    meta = P.ModelBundle.random("tiny", dtype=torch.float32, device="meta")
    return PF.frame_flops(meta, spec, **sig)["logical"]


@pytest.mark.parametrize("case", list(CASES))
def test_logical_flops_match_jax(jax_bundle, case, monkeypatch):
    spec_kw, in_hw, sig = CASES[case]
    want = _jax_count(jax_bundle, spec_kw, in_hw, sig, monkeypatch)
    got = _port_count(spec_kw, in_hw, sig)
    if sig.get("src_box"):
        got += _crop_resize_products(P.FrameSpec(**spec_kw))
    assert got == want


@pytest.mark.parametrize("batch", [1, 4])
def test_sd15_512_frame_is_jax_count(batch):
    meta = P.ModelBundle.random("sd15", dtype=torch.bfloat16, device="meta")
    r = PF.frame_flops(meta, P.FrameSpec(batch=batch, height=512, width=512, steps=4))
    assert r["logical"] / batch == pytest.approx(SD15_JAX_TFLOP * 1e12, rel=1e-2)
    # padded: K1's 84 attentions per frame, d = 40 at 48 (80 and 160 need no
    # padding): 28 at [8, 4096, 4096] per frame, 4 products of 8 extra columns
    extra = 28 * 4.0 * 8 * 4096 * 4096 * (48 - 40) * batch
    assert r["padded"] - r["logical"] == extra


def test_kl_frame_flops_match_jax(monkeypatch):
    """A tiny fp32 KL frame at 128x128 (the VAE's mid attention at S = 256
    routes to K1 in encode and decode): the port's count equals JAX's
    jaxpr walk exactly."""
    spec_kw = {"height": 128, "width": 128, "steps": 2, "vae": "kl"}
    jb = J.ModelBundle.random("tiny", dtype=jnp.float32, with_kl_vae=True)
    want = _jax_count(jb, spec_kw, None, {}, monkeypatch)
    meta = P.ModelBundle.random("tiny", dtype=torch.float32, device="meta", with_kl_vae=True)
    assert PF.frame_flops(meta, P.FrameSpec(**spec_kw))["logical"] == want


def test_sd15_kl_frame_pads_the_wide_attention():
    """sd15 512x512 with the KL VAE: the padded count adds, beside the
    UNet's d = 40 padding, nothing for the wide kernel at the VAE's d = 512
    in encode and in decode ([1, 4096, 4096]): its two slices of 256 columns
    split the depth of Q·Kᵀ in one cluster (1 Q·Kᵀ + 1 P·V, a width of 512
    in ``4 Sq Sk w``)."""
    meta = P.ModelBundle.random("sd15", dtype=torch.bfloat16, device="meta", with_kl_vae=True)
    kl = PF.frame_flops(meta, P.FrameSpec(height=512, width=512, steps=4, vae="kl"))
    taesd = PF.frame_flops(meta, P.FrameSpec(height=512, width=512, steps=4))
    unet_pad = 28 * 4.0 * 8 * 4096 * 4096 * (48 - 40)
    assert kl["padded"] - kl["logical"] == unet_pad + 2 * 4.0 * 4096 * 4096 * (512 - 512)
    assert taesd["padded"] - taesd["logical"] == unet_pad
    assert kl["logical"] > taesd["logical"]


def test_fp32_kl_frame_forms_the_wide_logits_once():
    """sd15 512x512 with the KL VAE in fp32: the fp32 kernels run every
    product at its logical width (d = 40 in k-steps of 8, and the VAE's
    d = 512 in one slice of 512 columns: Q·Kᵀ once), so padded = logical."""
    meta = P.ModelBundle.random("sd15", dtype=torch.float32, device="meta", with_kl_vae=True)
    kl = PF.frame_flops(meta, P.FrameSpec(height=512, width=512, steps=4, vae="kl"))
    assert kl["padded"] == kl["logical"] > 0


@pytest.mark.parametrize("d, dtype, width", [
    (40, torch.bfloat16, 48), (80, torch.bfloat16, 80), (160, torch.bfloat16, 160),
    (8, torch.bfloat16, 16), (24, torch.bfloat16, 48), (72, torch.bfloat16, 80),
    (256, torch.bfloat16, 256), (8, torch.float32, 8), (20, torch.float32, 24),
    (6, torch.float32, 8), (512, torch.bfloat16, 512), (512, torch.float32, 512),
    (264, torch.bfloat16, 320), (264, torch.float32, 268), (640, torch.bfloat16, 640),
    (516, torch.float32, 788), (640, torch.float32, 960),
])
def test_padded_width_is_the_kernels(d, dtype, width):
    assert PF.attention_padded_width(d, dtype) == width


def test_padded_counts_the_bf16_instance_at_tiny_widths():
    """A bf16 tiny bundle at 128x128 routes its d = 8 attentions to K1's
    16-wide instance (8 on an fp32 bundle: no padding)."""
    spec = P.FrameSpec(height=128, width=128, steps=2)
    bf16 = PF.frame_flops(P.ModelBundle.random("tiny", dtype=torch.bfloat16, device="meta"), spec)
    fp32 = PF.frame_flops(P.ModelBundle.random("tiny", dtype=torch.float32, device="meta"), spec)
    assert bf16["logical"] == fp32["logical"] == fp32["padded"]
    assert bf16["padded"] > bf16["logical"]


def test_mfu_and_peak():
    assert PF.mfu(989.4e12, 1.0, 989.4e12) == 1.0
    assert PF.mfu(1e12, 0.5, 989.4e12) == pytest.approx(2e12 / 989.4e12)
    assert PF.mfu(1e12, 1.0, None) is None
    assert PF.device_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert PF.device_peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert PF.device_peak_flops() is None or math.isfinite(PF.device_peak_flops())
