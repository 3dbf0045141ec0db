"""The port's models against the JAX ones (fp32, CPU), at the tiny family.

Weights come from one JAX ``ModelBundle.random("tiny")`` and cross through
``state_dict_from_jax``; the ControlNet's zero-initialized output convs are
first filled with random values, on both sides, so its residuals are not
trivially zero.  Bar: 1e-4 relative (``test_torch_parity_composed.py``'s),
with an absolute floor of 1e-4 for values near zero.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.models.clip_text import clip_text_apply as j_clip
from videosd_tpu.models.controlnet import controlnet_apply as j_cn
from videosd_tpu.models.taesd import taesd_decode as j_dec
from videosd_tpu.models.taesd import taesd_encode as j_enc
from videosd_tpu.models.unet import unet_apply as j_unet
from videosd_tpu.pipelines.lcm_img2img import ModelBundle as JBundle
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models import (
    CLIP_PRESETS,
    UNET_PRESETS,
    AutoencoderTiny,
    CLIPTextModel,
    ControlNetModel,
    TAESDConfig,
    UNet2DConditionModel,
    controlnet_apply,
    taesd_decode,
    taesd_encode,
    unet_apply,
)

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

CFG = UNET_PRESETS["tiny"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_bundle():
    jb = JBundle.random("tiny", dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jb.params)
    params["controlnet"] = copy.deepcopy(params["controlnet"])
    r = np.random.default_rng(11)
    cn = params["controlnet"]
    for zc in cn["controlnet_down_blocks"] + [cn["controlnet_mid_block"]]:
        zc["kernel"] = (r.standard_normal(zc["kernel"].shape) * 0.3).astype(np.float32)
        zc["bias"] = (r.standard_normal(zc["bias"].shape) * 0.1).astype(np.float32)
    return jb, params


def _port(ctor, params, plan):
    mod = ctor().eval()
    mod.load_state_dict(PW.state_dict_from_jax(params, plan), strict=True)
    return mod


def _inputs(r, batch=2, side=8):
    x = r.standard_normal((batch, side, side, 4)).astype(np.float32)
    t = np.array([999, 259][:batch], np.int32)
    ctx = r.standard_normal((batch, 77, CFG.cross_attention_dim)).astype(np.float32)
    w = r.standard_normal((batch, CFG.time_cond_proj_dim)).astype(np.float32)
    return x, t, ctx, w


def test_unet_with_controlnet_residuals(jax_bundle):
    _, params = jax_bundle
    unet = _port(lambda: UNet2DConditionModel(CFG), params["unet"], PW.unet_plan(CFG))
    r = np.random.default_rng(1)
    x, t, ctx, w = _inputs(r)
    skips = [(8, 32), (8, 32), (4, 32), (4, 64)]
    down = [r.standard_normal((2, s, s, c)).astype(np.float32) for s, c in skips]
    mid = r.standard_normal((2, 4, 4, 64)).astype(np.float32)
    # jitted: op by op, the first JAX call compiles every primitive (~15 s)
    want = jax.jit(
        lambda p, *a: j_unet(p, CFG, *a[:3], timestep_cond=a[3],
                             down_block_additional_residuals=a[4],
                             mid_block_additional_residual=a[5])
    )(params["unet"], x, t, ctx, w, down, mid)
    with torch.no_grad():
        got = unet_apply(unet, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         timestep_cond=torch.from_numpy(w),
                         down_block_additional_residuals=[torch.from_numpy(d) for d in down],
                         mid_block_additional_residual=torch.from_numpy(mid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(np.asarray(want)).max() > 0.01


def test_controlnet(jax_bundle):
    _, params = jax_bundle
    cn = _port(lambda: ControlNetModel(CFG), params["controlnet"], PW.controlnet_plan(CFG))
    r = np.random.default_rng(2)
    x, t, ctx, w = _inputs(r)
    cond = r.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    scale = np.array([2.0, 0.5], np.float32)
    want_down, want_mid = jax.jit(
        lambda p, *a: j_cn(p, CFG, *a[:4], conditioning_scale=a[4], timestep_cond=a[5])
    )(params["controlnet"], x, t, ctx, cond, scale, w)
    with torch.no_grad():
        got_down, got_mid = controlnet_apply(
            cn, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
            torch.from_numpy(cond), conditioning_scale=torch.from_numpy(scale),
            timestep_cond=torch.from_numpy(w))
    assert len(got_down) == len(want_down) == 4
    for g, wnt in zip(got_down + [got_mid], list(want_down) + [want_mid]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    assert np.abs(np.asarray(want_mid)).max() > 0.01


def test_taesd_encode_decode(jax_bundle):
    jb, params = jax_bundle
    cfg = TAESDConfig(hidden=16, blocks_per_stage=1)
    assert (cfg.hidden, cfg.blocks_per_stage) == (jb.taesd_cfg.hidden, jb.taesd_cfg.blocks_per_stage)
    ae = _port(lambda: AutoencoderTiny(cfg), params["taesd"], PW.taesd_plan(cfg))
    r = np.random.default_rng(3)
    img = r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = (r.standard_normal((2, 4, 4, 4)) * 3).astype(np.float32)  # past the soft clamp
    with torch.no_grad():
        got_z = taesd_encode(ae, torch.from_numpy(img)).numpy()
        got_img = taesd_decode(ae, torch.from_numpy(z)).numpy()
    want_z = jax.jit(lambda p, a: j_enc(p, a, jb.taesd_cfg))(params["taesd"], img)
    want_img = jax.jit(lambda p, a: j_dec(p, a, jb.taesd_cfg))(params["taesd"], z)
    np.testing.assert_allclose(got_z, np.asarray(want_z), **TOL)
    np.testing.assert_allclose(got_img, np.asarray(want_img), **TOL)


def test_clip_text(jax_bundle):
    jb, params = jax_bundle
    cfg = CLIP_PRESETS["tiny"]
    clip = _port(lambda: CLIPTextModel(cfg), params["clip"], PW.clip_plan(cfg))
    ids = jb.tokenizer(["portrait, pixar, cg", "a"])
    ids[1, 5] = cfg.vocab_size + 7  # out of vocabulary: clamped on both sides
    want_ctx, want_pool = jax.jit(lambda p, a: j_clip(p, jb.clip_cfg, a))(params["clip"], ids)
    with torch.no_grad():
        got_ctx, got_pool = clip(torch.from_numpy(ids))
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), **TOL)
    np.testing.assert_allclose(got_pool.numpy(), np.asarray(want_pool), **TOL)
