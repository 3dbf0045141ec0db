"""The port's own modules against the JAX ones at sd15 widths (fp32, CPU).

``tests/test_torch_port_models.py`` holds the port's UNet, ControlNet and
CLIP against JAX at the tiny family's widths.  Here the same modules are
held block by block at the geometry of SimianLuo/LCM_Dreamshaper_v7: the
resnet block at 320, 640 and 1280 channels (one of them changing its
channels), the Transformer2D at 320 channels with 8 heads as a count
(d = 40) and 1x1-conv projections over 256 tokens (so the self-attention
takes the route of kernel K1, whose plain version runs on the CPU), a
ControlNet stage with its zero convs and conditioning embedder, and one
CLIP ViT-L/14 layer with the final layer norm and the pooled output.

Weights come from the JAX package's own initializers and cross through
``state_dict_from_jax``; the ControlNet's zero-initialized convs are filled
with random values first, so its residuals are not trivially zero.  Bar:
1e-4 relative (``test_torch_parity_composed.py``'s), with an absolute floor
of 1e-4 for values near zero.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from videosd_tpu.models import clip_text as JC
from videosd_tpu.models import controlnet as JCN
from videosd_tpu.models import unet as JU
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models import CLIP_PRESETS, UNET_PRESETS, CLIPTextModel, ControlNetModel
from videosd_tpu_torch.models.layers import routes_to_flash
from videosd_tpu_torch.models.unet import ResnetBlock2D, Transformer2DModel

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

SD15 = UNET_PRESETS["sd15"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _sub(params, plan_fn):
    """State dict of one block: its plan written under the prefix ``m`` and
    the prefix taken off again."""
    plan = []
    plan_fn(plan)
    return {k[2:]: v for k, v in PW.state_dict_from_jax(params, plan).items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("cin,cout", [(320, 320), (320, 640), (640, 640), (1280, 1280)],
                         ids=["320", "320to640", "640", "1280"])
def test_resnet_block(cin, cout):
    jcfg = JU.UNET_PRESETS["sd15"]
    params = _np(JU.resnet_init(jax.random.PRNGKey(cin + cout), jcfg, cin, cout))
    blk = ResnetBlock2D(SD15, cin, cout).eval()
    blk.load_state_dict(_sub(params, lambda p: PW._resnet_plan(p, (), "m", cin != cout)),
                        strict=True)
    r = np.random.default_rng(cin + cout)
    x = r.standard_normal((2, 8, 8, cin)).astype(np.float32)
    temb = r.standard_normal((2, SD15.time_embed_dim)).astype(np.float32)
    want = jax.jit(lambda p, a, t: JU.resnet_apply(p, jcfg, a, t))(params, x, temb)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(temb))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_transformer2d_320_eight_heads():
    jcfg = JU.UNET_PRESETS["sd15"]
    assert SD15.num_heads(320) == 8 and not SD15.use_linear_projection  # d = 40, 1x1 convs
    params = _np(JU.transformer2d_init(jax.random.PRNGKey(3), jcfg, 320, 1))
    blk = Transformer2DModel(SD15, 320, 1).eval()
    blk.load_state_dict(
        _sub(params, lambda p: PW._transformer2d_plan(p, (), "m", 1, linear_proj=False)),
        strict=True)
    r = np.random.default_rng(4)
    side = 16
    assert routes_to_flash(side * side, side * side, False)  # K1's route
    x = r.standard_normal((1, side, side, 320)).astype(np.float32)
    ctx = r.standard_normal((1, 77, SD15.cross_attention_dim)).astype(np.float32)
    want = jax.jit(lambda p, a, c: JU.transformer2d_apply(p, jcfg, a, c))(params, x, ctx)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_controlnet_stage():
    """The ControlNet cut to its first sd15 stage (320 wide, two resnets with
    their Transformer2Ds, the downsampler) and a second stage of 640 without
    attention, with the conditioning embedder and every zero conv."""
    fields = dict(block_out_channels=(320, 640), attn_down=(True, False))
    jcfg = dataclasses.replace(JU.UNET_PRESETS["sd15"], **fields)
    cfg = dataclasses.replace(SD15, **fields)
    params = copy.deepcopy(_np(JCN.controlnet_init(jax.random.PRNGKey(5), jcfg)))
    r = np.random.default_rng(6)
    for zc in params["controlnet_down_blocks"] + [params["controlnet_mid_block"],
                                                  params["controlnet_cond_embedding"]["conv_out"]]:
        zc["kernel"] = (r.standard_normal(zc["kernel"].shape) * 0.05).astype(np.float32)
        zc["bias"] = (r.standard_normal(zc["bias"].shape) * 0.05).astype(np.float32)
    cn = ControlNetModel(cfg).eval()
    cn.load_state_dict(PW.state_dict_from_jax(params, PW.controlnet_plan(cfg)), strict=True)
    x = r.standard_normal((1, 16, 16, 4)).astype(np.float32)
    t = np.array([519], np.int32)
    ctx = r.standard_normal((1, 77, cfg.cross_attention_dim)).astype(np.float32)
    w = r.standard_normal((1, cfg.time_cond_proj_dim)).astype(np.float32)
    cond = r.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    scale = np.array([1.5], np.float32)
    want_down, want_mid = jax.jit(
        lambda p, *a: JCN.controlnet_apply(p, jcfg, *a[:4], conditioning_scale=a[4],
                                           timestep_cond=a[5])
    )(params, x, t, ctx, cond, scale, w)
    with torch.no_grad():
        got_down, got_mid = cn(
            torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
            torch.from_numpy(ctx), torch.from_numpy(cond).permute(0, 3, 1, 2),
            conditioning_scale=torch.from_numpy(scale), timestep_cond=torch.from_numpy(w))
    assert len(got_down) == len(want_down) == 6
    for g, wnt in zip(got_down + [got_mid], list(want_down) + [want_mid]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(wnt), **TOL)
        assert np.abs(np.asarray(wnt)).max() > 1e-2


def test_clip_vit_l14_layer():
    """One encoder layer of CLIP ViT-L/14 (768 wide, 12 heads, 3072 MLP,
    quick_gelu, causal mask over 77 tokens), the final layer norm and the
    pooled output at the EOT token."""
    jcfg = dataclasses.replace(JC.CLIP_PRESETS["sd15"], num_layers=1)
    cfg = dataclasses.replace(CLIP_PRESETS["sd15"], num_layers=1)
    assert (cfg.hidden_size, cfg.num_heads, cfg.max_position_embeddings) == (768, 12, 77)
    params = _np(JC.clip_text_init(jax.random.PRNGKey(7), jcfg))
    r = np.random.default_rng(8)
    # random norm scales and biases, so the layer norms are not identities
    for ln in (params["layers"][0]["layer_norm1"], params["layers"][0]["layer_norm2"],
               params["final_layer_norm"]):
        ln["scale"] = (1 + 0.1 * r.standard_normal(ln["scale"].shape)).astype(np.float32)
        ln["bias"] = (0.1 * r.standard_normal(ln["bias"].shape)).astype(np.float32)
    clip = CLIPTextModel(cfg).eval()
    clip.load_state_dict(PW.state_dict_from_jax(params, PW.clip_plan(cfg)), strict=True)
    ids = r.integers(1, 49406, (2, 77)).astype(np.int32)
    ids[:, 0], ids[0, 9], ids[1, 40] = 49406, 49407, 49407  # BOT; EOT where pooling reads
    want_ctx, want_pool = jax.jit(lambda p, a: JC.clip_text_apply(p, jcfg, a))(params, ids)
    with torch.no_grad():
        got_ctx, got_pool = clip(torch.from_numpy(ids))
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), **TOL)
    np.testing.assert_allclose(got_pool.numpy(), np.asarray(want_pool), **TOL)
