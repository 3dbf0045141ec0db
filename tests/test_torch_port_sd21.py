"""The sd21 family (stabilityai/sd-turbo topology) of the port against the
JAX package's (CPU).

* A Transformer2D with linear projections at 320 channels, 5 heads of 64
  (``head_dim_is_num_heads=False``), context 1024, over 256 tokens, so its
  self-attention takes the route of kernel K1 (its plain version here).
* One OpenCLIP ViT-H/14 text layer (1024 wide, 16 heads, 4096 MLP, gelu)
  with the final layer norm and the pooled output, in fp32 and in bf16 (the
  tower applies its gelu to fp32 values in both, so erf in both).
* A UNet and a ControlNet of sd21 topology cut to widths (32, 64), heads of
  8, context 64.
* The frame program over those cut models, through the noise seam (JAX's
  own noise), against JAX's ``build_frame_program`` on a ``ModelBundle``
  assembled in the test from the same cut configs.
* The prompt encoder's padding: SD2.x pads with id 0, not the EOT token.

Weights: the JAX initializers' for the single blocks; for the models,
drawn in numpy at the modules' shapes and brought into the JAX tree by its
own plan (JAX's initializers take seconds a model on the CPU), so the
ControlNet's output convs are not zero.  Each crosses to the port through
``state_dict_from_jax``.  Bars: fp32 1e-4 relative with an absolute floor of 1e-4 for values
near zero (``test_torch_port_sd15_widths.py``'s); bf16 6e-2
(``test_torch_port_layers.py``'s); the frame program's, those of
``test_torch_port_pipeline.py`` (latents atol 5e-4 / rtol 1e-4, image
within one level).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.io import weights as JW
from videosd_tpu.models import clip_text as JC
from videosd_tpu.models import controlnet as JCN
from videosd_tpu.models import unet as JU
from videosd_tpu.models.taesd import TAESDConfig as JTAESDConfig
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu.schedulers.lcm import LCMSchedulerConfig as JSched
from videosd_tpu.schedulers.lcm import make_alphas_cumprod as j_alphas
from videosd_tpu.text.tokenizer import CLIPTokenizer as JTok
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models import (
    CLIP_PRESETS,
    UNET_PRESETS,
    AutoencoderTiny,
    CLIPTextModel,
    ControlNetModel,
    UNet2DConditionModel,
)
from videosd_tpu_torch.models.layers import routes_to_flash
from videosd_tpu_torch.models.unet import Transformer2DModel, unet_apply
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.text.tokenizer import CLIPTokenizer

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

SD21 = UNET_PRESETS["sd21"]
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
# the sd21 topology cut to narrow widths
_CUT = dict(block_out_channels=(32, 64), attn_down=(True, False), transformer_depth=(1, 1),
            attention_head_dim=8, cross_attention_dim=64, norm_num_groups=8)
_CUT_CLIP = dict(vocab_size=1000, hidden_size=64, num_layers=1, num_heads=4,
                 intermediate_size=128)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _random_params(ctor, jplan, seed):
    """JAX params for the module ``ctor()`` builds, drawn in numpy (JAX's
    own initializers take seconds a model on the CPU) and brought into the
    JAX tree through the JAX plan: weights N(0, 1/fan_in), norm scales
    1 + N(0, 0.1²), biases N(0, 0.05²)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in ctor().state_dict().items()}
    r = np.random.default_rng(seed)
    sd = {}
    for k, shape in sorted(shapes.items()):
        z = r.standard_normal(shape)
        if k.endswith("bias"):
            z = 0.05 * z
        elif "norm" in k.split(".")[-2] and len(shape) == 1:
            z = 1.0 + 0.1 * z
        else:
            z = z / np.sqrt(max(1, int(np.prod(shape[1:]))))
        sd[k] = z.astype(np.float32)
    return _np(JW.convert(sd, jplan))


def test_sd21_presets_follow_jax():
    for field in ("cross_attention_dim", "attention_head_dim", "head_dim_is_num_heads",
                  "use_linear_projection", "time_cond_proj_dim", "block_out_channels"):
        assert getattr(SD21, field) == getattr(JU.UNET_PRESETS["sd21"], field), field
    assert [SD21.num_heads(c) for c in (320, 640, 1280)] == [5, 10, 20]  # d = 64
    assert dataclasses.asdict(CLIP_PRESETS["sd21"]) == dataclasses.asdict(JC.CLIP_PRESETS["sd21"])
    with pytest.raises(NotImplementedError, match="text_time"):
        UNet2DConditionModel(dataclasses.replace(SD21, addition_embed_type="text_time"))
    with pytest.raises(NotImplementedError, match="penultimate"):
        CLIPTextModel(dataclasses.replace(CLIP_PRESETS["sd21"], output_hidden_state=-2))


def test_transformer2d_linear_projection_five_heads_of_64():
    jcfg = JU.UNET_PRESETS["sd21"]
    params = _np(JU.transformer2d_init(jax.random.PRNGKey(3), jcfg, 320, 1))
    assert params["proj_in"]["kernel"].ndim == 2  # a linear, not a 1x1 conv
    blk = Transformer2DModel(SD21, 320, 1).eval()
    assert isinstance(blk.proj_in, torch.nn.Linear)
    blk.load_state_dict(
        {k[2:]: v for k, v in PW.state_dict_from_jax(
            params, _plan(lambda p: PW._transformer2d_plan(p, (), "m", 1, linear_proj=True))
        ).items()}, strict=True)
    r = np.random.default_rng(4)
    assert routes_to_flash(256, 256, False)  # K1's route
    x = r.standard_normal((1, 16, 16, 320)).astype(np.float32)
    ctx = r.standard_normal((1, 77, 1024)).astype(np.float32)
    want = jax.jit(lambda p, a, c: JU.transformer2d_apply(p, jcfg, a, c))(params, x, ctx)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def _plan(fill):
    plan = []
    fill(plan)
    return plan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_openclip_h_layer(dtype):
    """One OpenCLIP ViT-H/14 text layer, the final LN and the pooled output,
    on ids padded with 0 (SD2.x's pad)."""
    jcfg = dataclasses.replace(JC.CLIP_PRESETS["sd21"], num_layers=1)
    cfg = dataclasses.replace(CLIP_PRESETS["sd21"], num_layers=1)
    params = _np(JC.clip_text_init(jax.random.PRNGKey(7), jcfg))
    r = np.random.default_rng(8)
    for ln in (params["layers"][0]["layer_norm1"], params["layers"][0]["layer_norm2"],
               params["final_layer_norm"]):
        ln["scale"] = (1 + 0.1 * r.standard_normal(ln["scale"].shape)).astype(np.float32)
        ln["bias"] = (0.1 * r.standard_normal(ln["bias"].shape)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    clip = CLIPTextModel(cfg).eval()
    clip.load_state_dict(PW.state_dict_from_jax(params, PW.clip_plan(cfg)), strict=True)
    clip = clip.to(td)
    ids = np.zeros((2, 77), np.int32)
    ids[:, 0] = 49406
    ids[0, 1:9] = r.integers(1, 49406, 8)
    ids[0, 9] = 49407
    ids[1, 1:40] = r.integers(1, 49406, 39)
    ids[1, 40] = 49407
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jd), params)
    want_ctx, want_pool = jax.jit(lambda p, a: JC.clip_text_apply(p, jcfg, a))(jparams, ids)
    with torch.no_grad():
        got_ctx, got_pool = clip(torch.from_numpy(ids))
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got_ctx.float().numpy(), np.asarray(want_ctx, np.float32), **tol)
    np.testing.assert_allclose(got_pool.float().numpy(), np.asarray(want_pool, np.float32), **tol)


def test_unet_of_sd21_topology():
    jcfg = dataclasses.replace(JU.UNET_PRESETS["sd21"], **_CUT)
    cfg = dataclasses.replace(SD21, **_CUT)
    params = _random_params(lambda: UNet2DConditionModel(cfg), JW.unet_plan(jcfg), 11)
    unet = UNet2DConditionModel(cfg).eval()
    unet.load_state_dict(PW.state_dict_from_jax(params, PW.unet_plan(cfg)), strict=True)
    r = np.random.default_rng(12)
    # 8x8 latents: 64 tokens, the plain attention route (the K1 route is the
    # Transformer2D case's), so the JAX side compiles no interpreted kernel
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 259], np.int32)
    ctx = r.standard_normal((2, 77, 64)).astype(np.float32)
    want = jax.jit(lambda p, a, b, c: JU.unet_apply(p, jcfg, a, b, c))(params, x, t, ctx)
    with torch.no_grad():
        got = unet_apply(unet, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_controlnet_of_sd21_topology():
    jcfg = dataclasses.replace(JU.UNET_PRESETS["sd21"], **_CUT)
    cfg = dataclasses.replace(SD21, **_CUT)
    params = _random_params(lambda: ControlNetModel(cfg), JW.controlnet_plan(jcfg), 5)
    r = np.random.default_rng(6)
    cn = ControlNetModel(cfg).eval()
    cn.load_state_dict(PW.state_dict_from_jax(params, PW.controlnet_plan(cfg)), strict=True)
    x = r.standard_normal((1, 8, 8, 4)).astype(np.float32)
    t = np.array([519], np.int32)
    ctx = r.standard_normal((1, 77, 64)).astype(np.float32)
    cond = r.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    scale = np.array([1.5], np.float32)
    want_down, want_mid = jax.jit(
        lambda p, *a: JCN.controlnet_apply(p, jcfg, *a[:4], conditioning_scale=a[4])
    )(params, x, t, ctx, cond, scale)
    with torch.no_grad():
        got_down, got_mid = cn(
            torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
            torch.from_numpy(ctx), torch.from_numpy(cond).permute(0, 3, 1, 2),
            conditioning_scale=torch.from_numpy(scale))
    assert len(got_down) == len(want_down)
    for g, w in zip(got_down + [got_mid], list(want_down) + [want_mid]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **TOL)
        assert np.abs(np.asarray(w)).max() > 1e-2


def _jax_noise(seeds, steps, latent_hw):
    return np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(s), k), (*latent_hw, 4), jnp.float32))
        for s in seeds]) for k in range(steps + 1)])


def test_frame_program_of_cut_sd21_bundle():
    """The whole frame (ControlNet on, two steps, batch 2) over the cut sd21
    models, the JAX ``ModelBundle`` assembled from the same configs."""
    jcfg = dataclasses.replace(JU.UNET_PRESETS["sd21"], **_CUT)
    jclip = dataclasses.replace(JC.CLIP_PRESETS["sd21"], **_CUT_CLIP)
    cfg = dataclasses.replace(SD21, **_CUT)
    clip_cfg = dataclasses.replace(CLIP_PRESETS["sd21"], **_CUT_CLIP)
    pbase = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    ctors = {"unet": lambda: UNet2DConditionModel(cfg), "controlnet": lambda: ControlNetModel(cfg),
             "clip": lambda: CLIPTextModel(clip_cfg), "taesd": lambda: AutoencoderTiny(pbase.taesd_cfg)}
    jplans = {"unet": JW.unet_plan(jcfg), "controlnet": JW.controlnet_plan(jcfg),
              "clip": JW.clip_plan(jclip),
              "taesd": JW.taesd_plan(JTAESDConfig(hidden=16, blocks_per_stage=1))}
    plans = {"unet": PW.unet_plan(cfg), "controlnet": PW.controlnet_plan(cfg),
             "clip": PW.clip_plan(clip_cfg), "taesd": PW.taesd_plan(pbase.taesd_cfg)}
    params = {name: _random_params(ctors[name], jplans[name], 21 + i)
              for i, name in enumerate(ctors)}
    sched = JSched()
    jb = J.ModelBundle(family="sd21", unet_cfg=jcfg, clip_cfg=jclip, sched_cfg=sched,
                       params=params, alphas_cumprod=jnp.asarray(j_alphas(sched)),
                       tokenizer=JTok(None, vocab_size=1000), dtype=jnp.float32,
                       taesd_cfg=JTAESDConfig(hidden=16, blocks_per_stage=1))
    models = {}
    for name, ctor in ctors.items():
        models[name] = ctor().eval()
        models[name].load_state_dict(PW.state_dict_from_jax(params[name], plans[name]),
                                     strict=True)
    pb = dataclasses.replace(pbase, family="sd21", unet_cfg=cfg, clip_cfg=clip_cfg,
                             models=models, tokenizer=CLIPTokenizer(None, vocab_size=1000))

    kw = dict(batch=2, height=32, width=32, steps=2)
    frame = np.random.default_rng(23).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    strength = np.array([0.6, 0.02], np.float32)  # 0.02: one valid step of two
    guidance = np.array([1.0, 1.0], np.float32)
    cn_scale = np.array([1.0, 0.5], np.float32)
    seeds = np.array([3, 4], np.int32)
    ids = jb.tokenizer(["a fox", "a castle at dusk"])
    jemb, _ = J.build_prompt_encoder(jb)(jb.params, jnp.asarray(ids, jnp.int32))
    jimg, jlat = J.build_frame_program(jb, J.FrameSpec(**kw))(
        jb.params, jnp.asarray(frame), jemb, jnp.asarray(strength), jnp.asarray(guidance),
        jnp.asarray(cn_scale), jnp.asarray(seeds))
    pemb, _ = P.build_prompt_encoder(pb)(ids)
    np.testing.assert_allclose(pemb.numpy(), np.asarray(jemb), **TOL)
    pimg, plat = P.build_frame_program(pb, P.FrameSpec(**kw))(
        frame, pemb, strength, guidance, cn_scale, seeds,
        noise=_jax_noise(seeds.tolist(), 2, (4, 4)))
    np.testing.assert_allclose(plat.numpy(), np.asarray(jlat), atol=5e-4, rtol=1e-4)
    assert np.abs(pimg.numpy().astype(int) - np.asarray(jimg).astype(int)).max() <= 1


def test_prompt_encoder_pads_with_id_0():
    """SD2.x's tokenizer pads with id 0 (``from_pretrained`` passes
    ``pad_to_eos=family != "sd21"``, as JAX's does), and the EOT token
    stays the largest id, which the pooled output reads (argmax)."""
    ours, theirs = CLIPTokenizer(None, pad_to_eos=False), JTok(None, pad_to_eos=False)
    texts = ["a photo of a cat", ""]
    ids = ours(texts)
    np.testing.assert_array_equal(ids, theirs(texts))
    assert ours.pad_id == theirs.pad_id == 0
    eot = ids.argmax(axis=1)
    assert (ids[np.arange(2), eot] == ours.EOT).all()
    assert (ids[0, eot[0] + 1:] == 0).all() and (ids[1, eot[1] + 1:] == 0).all()
