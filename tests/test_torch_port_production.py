"""The port's production frame-program variants against the JAX program (fp32, CPU).

One JAX ``ModelBundle.random("tiny")`` crosses to the port through
``state_dict_from_jax``.  The ControlNet's zero-initialized output convs
are perturbed identically on both sides first: with them at zero the
residuals vanish and the interval modes could not be observed.  The JAX
side runs ``frame_program`` op by op (the function the engine jits), the
port gets JAX's noise through its seam and JAX's prompt embeddings, and
both are held to ``test_golden.py``'s bars: latents atol 5e-4 / rtol
1e-4, image within 1 level, DeepCache features as latents.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.models.unet import UNET_PRESETS as J_UNET
from videosd_tpu.models.unet import unet_apply as j_unet_apply
from videosd_tpu.ops.preprocess import center_crop_box, rgb_to_i420_host
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu.pipelines import safety as JS
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig, unet_apply
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.pipelines import safety as PS

# One torch thread per process, set when the module is imported (every
# xdist worker imports every test module before running any): with torch
# using every core in each worker, the oversubscribed cores stall the
# io_callbacks of JAX's interpreted Pallas kernels in the worker running
# tests/test_models.py's Pallas test, which then never finishes.
torch.set_num_threads(1)

LAT_ATOL, LAT_RTOL, IMG_LEVELS = 5e-4, 1e-4, 1
B = 2
ARGS = (np.array([0.9, 0.7], np.float32), np.array([5.0, 3.0], np.float32),
        np.array([2.0, 0.5], np.float32), np.array([23, 7], np.int32))


@pytest.fixture(scope="module")
def bundles():
    jb = J.ModelBundle.random("tiny", dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jb.params)
    cn = dict(params["controlnet"])
    prng = np.random.default_rng(3)

    def perturb(tree):
        return jax.tree.map(lambda a: prng.normal(0, 0.05, a.shape).astype(np.float32), tree)

    cn["controlnet_down_blocks"] = perturb(cn["controlnet_down_blocks"])
    cn["controlnet_mid_block"] = perturb(cn["controlnet_mid_block"])
    cn["controlnet_cond_embedding"] = {**cn["controlnet_cond_embedding"],
                                       "conv_out": perturb(cn["controlnet_cond_embedding"]["conv_out"])}
    params["controlnet"] = cn
    plans = {
        "unet": PW.unet_plan(P.UNET_PRESETS["tiny"]),
        "controlnet": PW.controlnet_plan(P.UNET_PRESETS["tiny"]),
        "clip": PW.clip_plan(P.CLIP_PRESETS["tiny"]),
        "taesd": PW.taesd_plan(jb.taesd_cfg),
    }
    sds = {k: PW.state_dict_from_jax(params[k], plan) for k, plan in plans.items()}
    pb = P.ModelBundle.from_state_dicts("tiny", sds, dtype=torch.float32, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    ids = jnp.asarray(jb.tokenizer(["a portrait", "a landscape"]), jnp.int32)
    emb, _ = J.build_prompt_encoder(jb)(jparams, ids)
    return jb, jparams, pb, np.array(emb)


def _jax_noise(seeds, steps, latent_hw):
    """Row k of element b: normal(fold_in(PRNGKey(seed_b), k)), the JAX
    program's draws in the port's seam layout [S+1, B, h, w, 4]."""
    return np.stack([
        np.stack([np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(s), k),
                                               (*latent_hw, 4), jnp.float32)) for s in seeds])
        for k in range(steps + 1)
    ])


def _run_jax(bundles, spec, frame, safety_hook=None, **kw):
    jb, jparams, _, emb = bundles
    out = J.frame_program(
        jparams, spec, jb.unet_cfg, jb.sched_cfg, jb.taesd_cfg, jb.vae_cfg, jb.alphas_cumprod,
        jb.dtype, jnp.asarray(frame), jnp.asarray(emb), *(jnp.asarray(a) for a in ARGS),
        safety_hook=safety_hook, **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    return [np.asarray(o) for o in out]


def _run_port(bundles, spec, frame, safety_hook=None, **kw):
    pb, emb = bundles[2], bundles[3]
    pb = dataclasses.replace(pb, safety_hook=safety_hook)
    noise = _jax_noise(ARGS[3].tolist(), spec.steps, (spec.height // 8, spec.width // 8))
    out = P.build_frame_program(pb, spec)(
        frame, torch.from_numpy(emb), *ARGS, noise=noise,
        **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()},
    )
    return [o.numpy() for o in out]


def _assert_close(port, ref):
    assert len(port) == len(ref)
    img, lat, *caches = port
    assert img.dtype == np.uint8 and img.shape == ref[0].shape
    assert np.abs(img.astype(int) - ref[0].astype(int)).max() <= IMG_LEVELS
    for got, want in zip([lat, *caches], ref[1:]):
        np.testing.assert_allclose(got, want, atol=LAT_ATOL, rtol=LAT_RTOL)


def _frames(hw=(32, 32), seed=5):
    return np.random.default_rng(seed).integers(0, 256, (B, *hw, 3), dtype=np.uint8)


def _mailbox():
    """Two camera frames (48x64 and 64x40) in 64x64 mailboxes, with each
    element's center-crop box for a 32x32 target."""
    rng = np.random.default_rng(11)
    mail = np.zeros((B, 64, 64, 3), np.uint8)
    boxes = []
    for b, (h, w) in enumerate(((48, 64), (64, 40))):
        mail[b, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        left, top, right, bottom = center_crop_box(w, h, 32, 32)
        boxes.append([top, left, bottom - top, right - left])
    return mail, np.array(boxes, np.int32)


def _variant(name):
    """(spec kwargs, frame, program kwargs, (jax hook, port hook))."""
    rgb = _frames()
    if name == "warm_alpha_0.3":
        warm = np.random.default_rng(9).standard_normal((B, 4, 4, 4)).astype(np.float32)
        return {"steps": 2}, rgb, {"warm_latents": warm,
                                   "warm_alpha": np.array([0.3, 0.0], np.float32)}, None
    if name == "src_box_mailbox64":
        mail, box = _mailbox()
        return {"steps": 2, "in_height": 64, "in_width": 64}, mail, {"src_box": box}, None
    if name == "i420":
        return {"steps": 2, "in_format": "i420"}, np.stack([rgb_to_i420_host(f) for f in rgb]), {}, None
    if name.startswith("safety"):
        thr = -1.0 if name == "safety_always" else 1.0
        return {"steps": 2}, rgb, {}, (JS.default_safety_hook(thr), PS.default_safety_hook(thr))
    spec = {
        "cn2": {"steps": 4, "controlnet_interval": 2},
        "dc2": {"steps": 4, "deepcache_interval": 2},
        "dc2_last": {"steps": 4, "deepcache_interval": 2, "interval_refresh_last": True},
        "cn2_dc3_last": {"steps": 4, "controlnet_interval": 2, "deepcache_interval": 3,
                         "interval_refresh_last": True},
        "temporal_produce": {"steps": 3, "deepcache_temporal": True},
    }[name]
    return spec, rgb, {}, None


VARIANTS = ["cn2", "dc2", "dc2_last", "cn2_dc3_last", "temporal_produce", "warm_alpha_0.3",
            "src_box_mailbox64", "i420", "safety_always", "safety_never"]


@pytest.mark.parametrize("name", VARIANTS)
def test_port_variant_matches_jax(bundles, name):
    spec_kw, frame, kw, hooks = _variant(name)
    jhook, phook = hooks or (None, None)
    ref = _run_jax(bundles, J.FrameSpec(batch=B, height=32, width=32, **spec_kw), frame,
                   safety_hook=jhook, **kw)
    port = _run_port(bundles, P.FrameSpec(batch=B, height=32, width=32, **spec_kw), frame,
                     safety_hook=phook, **kw)
    _assert_close(port, ref)
    if name == "temporal_produce":
        assert port[2].shape == (B, 3, 4, 4, 64)
    if name == "safety_always":
        assert (port[0] == 0).all()


def test_port_temporal_reuse_of_jax_caches_matches_jax(bundles):
    """Reuse mode fed JAX's produce-mode caches, on another frame (where the
    carried trunk is an approximation): the port follows JAX."""
    spec_kw = {"batch": B, "height": 32, "width": 32, "steps": 3, "deepcache_temporal": True}
    _, _, caches = _run_jax(bundles, J.FrameSpec(**spec_kw), _frames())
    frame2 = _frames(seed=6)
    ref = _run_jax(bundles, J.FrameSpec(**spec_kw), frame2, deep_caches=caches)
    port = _run_port(bundles, P.FrameSpec(**spec_kw), frame2, deep_caches=caches)
    _assert_close(port, ref)


def test_port_temporal_reuse_of_own_caches_is_bit_exact(bundles):
    """Produce returns the parity outputs, and reuse fed the caches of the
    same inputs reproduces them bit for bit (the shallow pass is the full
    pass's own arithmetic)."""
    pb, emb = bundles[2], torch.from_numpy(bundles[3])
    frame = _frames()
    spec_kw = {"batch": B, "height": 32, "width": 32, "steps": 3}
    img_p, lat_p = P.build_frame_program(pb, P.FrameSpec(**spec_kw))(frame, emb, *ARGS)
    prog = P.build_frame_program(pb, P.FrameSpec(**spec_kw, deepcache_temporal=True))
    img_f, lat_f, caches = prog(frame, emb, *ARGS)
    img_r, lat_r = prog(frame, emb, *ARGS, deep_caches=caches)
    for got in (img_f, img_r):
        assert torch.equal(got, img_p)
    for got in (lat_f, lat_r):
        assert torch.equal(got, lat_p)
    img_w, lat_w, _ = prog(frame, emb, *ARGS, warm_latents=torch.ones(B, 4, 4, 4),
                           warm_alpha=[0.0, 0.0])
    assert torch.equal(img_w, img_p) and torch.equal(lat_w, lat_p)


def test_port_unet_deepcache_split_matches_jax(bundles):
    """The deep feature of a full pass and the shallow pass over it, with
    ControlNet residuals on both, against JAX's ``unet_apply``."""
    jb, jparams, pb, emb = bundles
    cfg = J_UNET["tiny"]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    t = np.array([799, 459], np.int32)
    w_emb = rng.standard_normal((B, cfg.time_cond_proj_dim)).astype(np.float32)
    chans = [32, 32, 32, 64]  # conv_in, down0 resnet, down0 downsample, down1 resnet
    sizes = [8, 8, 4, 4]
    down = [rng.standard_normal((B, s, s, c)).astype(np.float32) * 0.1 for s, c in zip(sizes, chans)]
    mid = rng.standard_normal((B, 4, 4, 64)).astype(np.float32) * 0.1

    def jax_call(**kw):
        return j_unet_apply(jparams["unet"], cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb),
                            timestep_cond=jnp.asarray(w_emb),
                            down_block_additional_residuals=[jnp.asarray(d) for d in down], **kw)

    def port_call(**kw):
        with torch.inference_mode():
            return unet_apply(pb.models["unet"], torch.from_numpy(x), torch.from_numpy(t),
                              torch.from_numpy(emb), timestep_cond=torch.from_numpy(w_emb),
                              down_block_additional_residuals=[torch.from_numpy(d) for d in down],
                              **kw)

    j_eps, j_deep = jax_call(mid_block_additional_residual=jnp.asarray(mid), return_deep_feature=True)
    p_eps, p_deep = port_call(mid_block_additional_residual=torch.from_numpy(mid),
                              return_deep_feature=True)
    assert tuple(p_deep.shape) == (B, 8, 8, 64)
    for got, want in ((p_eps, j_eps), (p_deep, j_deep)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAT_ATOL, rtol=LAT_RTOL)
    j_shallow = jax_call(deep_feature=j_deep)
    p_shallow = port_call(deep_feature=torch.from_numpy(np.array(j_deep)))
    np.testing.assert_allclose(p_shallow.numpy(), np.asarray(j_shallow), atol=LAT_ATOL,
                               rtol=LAT_RTOL)
    # on its own feature the shallow pass is the full pass, bit for bit
    assert torch.equal(port_call(deep_feature=p_deep), p_eps)

    # JAX's guards
    deep = torch.from_numpy(np.array(j_deep))
    with pytest.raises(ValueError, match="mid_block_additional_residual"):
        port_call(deep_feature=deep, mid_block_additional_residual=torch.from_numpy(mid))
    with pytest.raises(ValueError, match="full pass"):
        port_call(deep_feature=deep, return_deep_feature=True)
    one = UNet2DConditionModel(UNetConfig(block_out_channels=(32,), attn_down=(False,),
                                          layers_per_block=1, transformer_depth=(1,),
                                          cross_attention_dim=32, norm_num_groups=8))
    with pytest.raises(ValueError, match=">= 2 resolution blocks"), torch.inference_mode():
        unet_apply(one, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(emb),
                   deep_feature=torch.zeros(B, 8, 8, 32))
