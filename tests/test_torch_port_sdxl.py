"""The SDXL family of the port against the JAX package's (fp32, CPU).

One JAX ``ModelBundle.random("tiny-xl")`` (the SDXL topology at tiny
widths: ``text_time`` micro-conditioning, linear projections, transformer
depth 0/2, two text towers) crosses to the port through
``state_dict_from_jax``; its zero-initialized biases and ControlNet output
convs are drawn small first, so that loading each of them shows.

* The UNet and the ControlNet with ``added_cond_kwargs`` (the pooled
  embedding and time ids up to 1024, where the sinusoid's arguments reach
  1024 rad; both sides compute the frequencies with the same fp32 ops).
* Both CLIP towers (the penultimate state without the final LN, the pooled
  output through ``text_projection``) and the two-tower prompt encoder.
* The frame program with and without ControlNet, and temporal DeepCache
  produce and reuse, JAX's noise through the port's seam; the reference
  program (counterpart of ``tests/test_reference_attn.py::
  test_reference_program_sdxl_family``).
* ``from_dir`` on a JAX ``save_bundle`` directory with ``clip2``, the
  port's ``save_bundle`` read back, and ``from_pretrained`` on a tiny-xl
  snapshot the test writes (tower 2 keeps its random init on both sides).
* ``frame_flops`` against JAX's jaxpr walk on tiny-xl, and at SDXL 1024²
  4 steps without ControlNet within 1 % of the walk's 28.1 TFLOP
  (``examples/sdxl_prod_1024.json``, a count of work, not a measurement).
* At SDXL's published widths: the 640-wide Transformer2D at depth 2 over
  256 tokens (K1's route, heads of 64), the ``add_embedding`` at
  2816 -> 1280, and one OpenCLIP bigG layer with ``text_projection``.
* ``tools/sdxl_prod.py`` on tiny-xl at 32x32 on the CPU: its report keys.

Bars: fp32 1e-4 relative with an absolute floor of 1e-4 for values near
zero; the frame programs' latents atol 5e-4 / rtol 1e-4 and images within
one level (``test_torch_port_pipeline.py``'s).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.io import weights as JW
from videosd_tpu.io.checkpoint import save_bundle as j_save_bundle
from videosd_tpu.io.safetensors import read_safetensors, write_safetensors
from videosd_tpu.models import clip_text as JC
from videosd_tpu.models import controlnet as JCN
from videosd_tpu.models import unet as JU
from videosd_tpu.models.layers import linear_init
from videosd_tpu.models.vae import VAEConfig as JVAEConfig
from videosd_tpu.ops.flops import program_flops
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu.pipelines import reference_attn as JR
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.io.checkpoint import save_bundle as p_save_bundle
from videosd_tpu_torch.models import (
    CLIP_PRESETS,
    UNET_PRESETS,
    VAE_PRESETS,
    CLIPTextModel,
    controlnet_apply,
    unet_apply,
)
from videosd_tpu_torch.models.clip_text import second_tower_for, tower_for
from videosd_tpu_torch.models.layers import routes_to_flash
from videosd_tpu_torch.models.unet import AddEmbedding, Transformer2DModel
from videosd_tpu_torch.ops import flops as PF
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.pipelines import reference_attn as R
from videosd_tpu_torch.tools import sdxl_prod

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
LAT_ATOL, LAT_RTOL, IMG_LEVELS = 5e-4, 1e-4, 1
SIDE = 32
ARGS = ([0.7], [5.0], [1.5], [19])
# sdxl 1024x1024 4-step without ControlNet, logical TFLOP per frame from JAX's
# jaxpr walk (examples/sdxl_prod_1024.json, "flops_per_frame_tflop_logical")
SDXL_JAX_TFLOP = 28.1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def bundles():
    """(JAX tiny-xl bundle with its zeros perturbed, the port's bundle of the
    same weights)."""
    cached = J.ModelBundle._random_cache
    J.ModelBundle._random_cache = {}
    try:
        jb = J.ModelBundle.random("tiny-xl", dtype=jnp.float32, with_controlnet=True)
    finally:
        J.ModelBundle._random_cache = cached
    rng = np.random.default_rng(17)

    def perturb(path, a):
        zero = path[-1].key == "bias" or any(
            getattr(k, "key", None) in ("controlnet_down_blocks", "controlnet_mid_block")
            for k in path)
        return rng.normal(0, 0.05, a.shape).astype(np.float32) if zero else np.asarray(a)

    params = jax.tree_util.tree_map_with_path(perturb, _np(jb.params))
    jb = J.ModelBundle(**{**vars(jb), "params": jax.tree.map(jnp.asarray, params)})
    cfg = UNET_PRESETS["tiny-xl"]
    plans = {"unet": PW.unet_plan(cfg), "controlnet": PW.controlnet_plan(cfg),
             "clip": PW.clip_plan(CLIP_PRESETS["tiny"]),
             "clip2": PW.clip_plan(CLIP_PRESETS["tiny"]),
             "taesd": PW.taesd_plan(jb.taesd_cfg)}
    sds = {k: PW.state_dict_from_jax(params[k], plan) for k, plan in plans.items()}
    pb = P.ModelBundle.from_state_dicts("tiny-xl", sds, dtype=torch.float32, device="cpu")
    return jb, pb


def _jax_embeds(jb, prompts=("a fox in the snow",)):
    ids = jnp.asarray(jb.tokenizer(list(prompts)), jnp.int32)
    return J.build_prompt_encoder(jb)(jb.params, ids)


def _jax_noise(seeds, steps, latent_hw):
    """The JAX program's noise: row k of element b is
    normal(fold_in(PRNGKey(seed_b), k)), the port's seam layout."""
    return np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(s), k), (*latent_hw, 4), jnp.float32))
        for s in seeds]) for k in range(steps + 1)])


def _frame(seed=3, hw=(SIDE, SIDE), batch=1):
    return np.random.default_rng(seed).integers(0, 256, (batch, *hw, 3), dtype=np.uint8)


def _assert_frames_close(port, ref):
    np.testing.assert_allclose(np.asarray(port[1]), np.asarray(ref[1]), atol=LAT_ATOL,
                               rtol=LAT_RTOL)
    assert np.abs(np.asarray(port[0]).astype(int) - np.asarray(ref[0]).astype(int)).max() \
        <= IMG_LEVELS


def _time_ids(hw_rows):
    return np.array([[h, w, 0, 0, h, w] for h, w in hw_rows], np.float32)


# ------------------------------------------------------------------ presets


def test_sdxl_presets_follow_jax():
    for name in ("sdxl", "tiny-xl", "sd15-base"):
        assert dataclasses.asdict(UNET_PRESETS[name]) == dataclasses.asdict(
            JU.UNET_PRESETS[name]), name
    for name in ("sdxl-1", "sdxl-2"):
        assert dataclasses.asdict(CLIP_PRESETS[name]) == dataclasses.asdict(
            JC.CLIP_PRESETS[name]), name
    for name in ("sdxl", "tiny-xl", "sd15-base"):
        assert dataclasses.asdict(VAE_PRESETS[name]) == dataclasses.asdict(JVAEConfig())
    # the towers of each family, as JAX's ModelBundle.random picks them
    assert [tower_for(f) for f in ("sd15", "sd21", "sdxl", "tiny", "tiny-xl", "sd15-base")] == [
        "sd15", "sd21", "sdxl-1", "tiny", "tiny", "sd15"]
    assert (second_tower_for("sdxl"), second_tower_for("tiny-xl")) == ("sdxl-2", "tiny")
    sdxl = UNET_PRESETS["sdxl"]
    assert [sdxl.num_heads(c) for c in (640, 1280)] == [10, 20]  # d = 64
    assert sdxl.time_embed_dim == 1280 and sdxl.cross_attention_dim == 768 + 1280
    assert sdxl.projection_class_embeddings_input_dim == 1280 + 6 * 256


def test_random_bundles_of_the_new_families():
    """sdxl on the meta device (its published widths: 2.6 B UNet
    parameters), tiny-xl and sd15-base on the CPU; clip2 is drawn after
    clip, so an existing family's values do not move."""
    meta = P.ModelBundle.random("sdxl", dtype=torch.bfloat16, device="meta")
    assert sorted(meta.models) == ["clip", "clip2", "controlnet", "taesd", "unet"]
    n_unet = sum(p.numel() for p in meta.models["unet"].parameters())
    assert 2.55e9 < n_unet < 2.6e9, n_unet
    assert meta.clip2_cfg == CLIP_PRESETS["sdxl-2"] and meta.clip_cfg == CLIP_PRESETS["sdxl-1"]
    xl = P.ModelBundle.random("tiny-xl", dtype=torch.float32, device="cpu", with_kl_vae=True)
    assert xl.models["unet"].add_embedding is not None and "clip2" in xl.models
    assert xl.taesd_cfg == P.TAESDConfig()  # full-width TAESD, as JAX gives tiny-xl
    base = P.ModelBundle.random("sd15-base", dtype=torch.float32, device="meta")
    assert base.unet_cfg.time_cond_proj_dim is None and base.clip2_cfg is None
    tiny = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    again = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    assert "clip2" not in tiny.models
    assert all(torch.equal(a, b) for a, b in zip(tiny.models["clip"].state_dict().values(),
                                                 again.models["clip"].state_dict().values()))
    with pytest.raises(ValueError, match="unknown family"):
        P.ModelBundle.random("sd3", device="cpu")


# ------------------------------------------------------------------ models


def test_unet_with_added_cond(bundles):
    jb, pb = bundles
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 259], np.int32)
    ctx = r.standard_normal((2, 77, 64)).astype(np.float32)
    pooled = r.standard_normal((2, 32)).astype(np.float32)
    time_ids = _time_ids([(1024, 1024), (832, 1216)])
    want = jax.jit(lambda p, *a: JU.unet_apply(
        p, jb.unet_cfg, *a[:3], added_cond_kwargs={"text_embeds": a[3], "time_ids": a[4]}))(
        jb.params["unet"], x, t, ctx, pooled, time_ids)
    with torch.no_grad():
        got = unet_apply(pb.models["unet"], *map(torch.from_numpy, (x, t, ctx)),
                         added_cond_kwargs={"text_embeds": torch.from_numpy(pooled),
                                            "time_ids": torch.from_numpy(time_ids)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="added_cond_kwargs"):
        unet_apply(pb.models["unet"], *map(torch.from_numpy, (x, t, ctx)))


def test_controlnet_with_added_cond(bundles):
    jb, pb = bundles
    r = np.random.default_rng(5)
    x = r.standard_normal((1, 8, 8, 4)).astype(np.float32)
    t = np.array([519], np.int32)
    ctx = r.standard_normal((1, 77, 64)).astype(np.float32)
    cond = r.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    scale = np.array([1.5], np.float32)
    pooled = r.standard_normal((1, 32)).astype(np.float32)
    time_ids = _time_ids([(64, 64)])
    want_down, want_mid = jax.jit(lambda p, *a: JCN.controlnet_apply(
        p, jb.unet_cfg, *a[:4], conditioning_scale=a[4],
        added_cond_kwargs={"text_embeds": a[5], "time_ids": a[6]}))(
        jb.params["controlnet"], x, t, ctx, cond, scale, pooled, time_ids)
    with torch.no_grad():
        got_down, got_mid = controlnet_apply(
            pb.models["controlnet"], *map(torch.from_numpy, (x, t, ctx, cond)),
            conditioning_scale=torch.from_numpy(scale),
            added_cond_kwargs={"text_embeds": torch.from_numpy(pooled),
                               "time_ids": torch.from_numpy(time_ids)})
    assert len(got_down) == len(want_down)
    for g, w in zip([*got_down, got_mid], [*want_down, want_mid]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert np.abs(np.asarray(w)).max() > 1e-2


@pytest.mark.parametrize("tower", ["sdxl-1", "sdxl-2"])
def test_clip_tower_penultimate_and_projected(tower):
    """Each SDXL tower cut to tiny widths: the context is the penultimate
    state WITHOUT the final LN, the pooled output the final-LN state at
    the EOT token (tower 2: through ``text_projection``)."""
    cut = dict(vocab_size=1000, hidden_size=32, num_layers=3, num_heads=2,
               intermediate_size=64)
    if tower == "sdxl-2":
        cut["projection_dim"] = 24
    jcfg = dataclasses.replace(JC.CLIP_PRESETS[tower], **cut)
    cfg = dataclasses.replace(CLIP_PRESETS[tower], **cut)
    params = _np(JC.clip_text_init(jax.random.PRNGKey(3), jcfg))
    r = np.random.default_rng(8)
    ln = params["final_layer_norm"]
    ln["scale"] = (1 + 0.1 * r.standard_normal(ln["scale"].shape)).astype(np.float32)
    ln["bias"] = (0.1 * r.standard_normal(ln["bias"].shape)).astype(np.float32)
    clip = CLIPTextModel(cfg).eval()
    clip.load_state_dict(PW.state_dict_from_jax(params, PW.clip_plan(cfg)), strict=True)
    assert (clip.text_projection is None) == (tower == "sdxl-1")
    ids = r.integers(1, 990, (2, 77)).astype(np.int32)
    ids[0, 9], ids[1, 40] = 999, 999  # the EOT where pooling reads
    want_ctx, want_pool = jax.jit(lambda p, a: JC.clip_text_apply(p, jcfg, a))(params, ids)
    with torch.no_grad():
        got_ctx, got_pool = clip(torch.from_numpy(ids))
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), **TOL)
    np.testing.assert_allclose(got_pool.numpy(), np.asarray(want_pool), **TOL)
    assert got_pool.shape == (2, cut.get("projection_dim", 32))


def test_two_tower_prompt_encoder(bundles):
    jb, pb = bundles
    jctx, jpool = _jax_embeds(jb, ("a fox in the snow", "portrait"))
    ctx, pool = P.build_prompt_encoder(pb)(pb.tokenizer(["a fox in the snow", "portrait"]))
    assert ctx.shape == (2, 77, 64) and pool.shape == (2, 32)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool), **TOL)
    # the context is tower 1's beside tower 2's; pooled is tower 2's
    ids = torch.as_tensor(pb.tokenizer(["a fox in the snow", "portrait"]))
    with torch.no_grad():
        c1, _ = pb.models["clip"](ids)
        c2, p2 = pb.models["clip2"](ids)
    assert torch.equal(ctx, torch.cat([c1, c2], dim=-1)) and torch.equal(pool, p2)


# ------------------------------------------------------------------ programs


@pytest.mark.parametrize("use_controlnet", [True, False])
def test_frame_program_matches_jax(bundles, use_controlnet):
    jb, pb = bundles
    spec_kw = dict(batch=1, height=SIDE, width=SIDE, steps=2, use_controlnet=use_controlnet)
    jctx, jpool = _jax_embeds(jb)
    frame = _frame()
    want = J.build_frame_program(jb, J.FrameSpec(**spec_kw))(
        jb.params, jnp.asarray(frame), jctx, *map(jnp.asarray, ARGS), pooled_embeds=jpool)
    program = P.build_frame_program(pb, P.FrameSpec(**spec_kw))
    got = program(frame, np.asarray(jctx), *ARGS, noise=_jax_noise(ARGS[3], 2, (4, 4)),
                  pooled_embeds=np.asarray(jpool))
    _assert_frames_close(got, want)
    with pytest.raises(ValueError, match="requires pooled_embeds"):
        program(frame, np.asarray(jctx), *ARGS)
    with pytest.raises(ValueError, match="pooled_embeds must be"):
        program(frame, np.asarray(jctx), *ARGS, pooled_embeds=np.zeros((1, 16), np.float32))


def test_temporal_deepcache_matches_jax(bundles):
    """Produce (full passes, the per-step deep features out) and reuse
    (shallow passes over them) against JAX's, on one frame pair."""
    jb, pb = bundles
    spec_kw = dict(batch=1, height=SIDE, width=SIDE, steps=2, deepcache_temporal=True)
    jctx, jpool = _jax_embeds(jb)
    frame, nxt = _frame(3), _frame(4)
    jprog = J.build_frame_program(jb, J.FrameSpec(**spec_kw))
    jargs = tuple(map(jnp.asarray, ARGS))
    jprod = jprog(jb.params, jnp.asarray(frame), jctx, *jargs, pooled_embeds=jpool)
    jreuse = jprog(jb.params, jnp.asarray(nxt), jctx, *jargs, pooled_embeds=jpool,
                   deep_caches=jprod[2])
    program = P.build_frame_program(pb, P.FrameSpec(**spec_kw))
    noise = _jax_noise(ARGS[3], 2, (4, 4))
    prod = program(frame, np.asarray(jctx), *ARGS, noise=noise, pooled_embeds=np.asarray(jpool))
    _assert_frames_close(prod, jprod)
    np.testing.assert_allclose(prod[2].numpy(), np.asarray(jprod[2]), **TOL)
    reuse = program(nxt, np.asarray(jctx), *ARGS, noise=noise, pooled_embeds=np.asarray(jpool),
                    deep_caches=np.asarray(jprod[2]))
    _assert_frames_close(reuse, jreuse)


def test_reference_program_matches_jax(bundles):
    """text_time conditioning threads through both UNet passes (the JAX
    case's shape and finiteness, and the JAX program's values)."""
    jb, pb = bundles
    spec_kw = dict(batch=1, height=SIDE, width=SIDE, steps=2, use_controlnet=False)
    jctx, jpool = _jax_embeds(jb, ("style",))
    frame, ref = _frame(5), _frame(6)
    sf = np.array([0.8], np.float32)
    want = JR.build_reference_program(jb, J.FrameSpec(**spec_kw))(
        jb.params, jnp.asarray(frame), jnp.asarray(ref), jctx, jnp.array([0.6], jnp.float32),
        jnp.array([5.0], jnp.float32), jnp.asarray(sf), jnp.array([23], jnp.int32),
        pooled_embeds=jpool)
    key = jax.random.PRNGKey(23)
    draw = lambda k: np.asarray(jax.random.normal(jax.random.fold_in(key, k), (4, 4, 4)))  # noqa: E731
    noise = np.stack([draw(k)[None] for k in range(3)])
    got = R.build_reference_program(pb, P.FrameSpec(**spec_kw))(
        frame, ref, np.asarray(jctx), [0.6], [5.0], sf, [23], noise, draw(10_000)[None],
        pooled_embeds=np.asarray(jpool))
    assert got[0].shape == (1, SIDE, SIDE, 3) and torch.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    assert np.abs(got[0].numpy().astype(int) - np.asarray(want[0]).astype(int)).max() <= 1
    with pytest.raises(ValueError, match="requires pooled_embeds"):
        R.reference_frame_program(pb, P.FrameSpec(**spec_kw), frame, ref, np.asarray(jctx),
                                  [0.6], [5.0], sf, [23])


# ------------------------------------------------------------------ checkpoints


def test_from_dir_reads_a_jax_save_bundle_with_clip2(bundles, tmp_path):
    """JAX's ``save_bundle`` writes ``clip2`` for an SDXL bundle; the port's
    ``from_dir`` loads it (prompt encoder and frame equal to JAX's), and the
    port's ``save_bundle`` writes the same tensors back."""
    jb, _ = bundles
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    j_save_bundle(jb, str(jdir))
    pb = P.ModelBundle.from_dir(str(jdir), device="cpu")
    assert pb.family == "tiny-xl" and pb.dtype == torch.float32
    assert json.loads((jdir / "bundle.json").read_text())["models"] == [
        "unet", "controlnet", "clip", "clip2", "taesd"]
    jctx, jpool = _jax_embeds(jb)
    ctx, pool = P.build_prompt_encoder(pb)(pb.tokenizer(["a fox in the snow"]))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool), **TOL)
    p_save_bundle(pb, str(pdir))
    assert (pdir / "bundle.json").read_text() == (jdir / "bundle.json").read_text()
    for name in ("unet", "controlnet", "clip", "clip2", "taesd"):
        a = read_safetensors(str(jdir / f"{name}.safetensors"))
        b = read_safetensors(str(pdir / f"{name}.safetensors"))
        assert list(a) == list(b), name
        assert all(np.array_equal(a[k], b[k]) for k in a), name
    again = P.ModelBundle.from_dir(str(pdir), device="cpu")
    for name, model in again.models.items():
        want = pb.models[name].state_dict()
        assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items()), name


def test_from_pretrained_tiny_xl_snapshot(bundles, tmp_path):
    """A diffusers snapshot of tiny-xl (``unet/``, ``text_encoder/``, the
    ControlNet and TAESD in their own directories, no ``vae/``): both
    loaders read tower 1 and leave tower 2 at its random init, so with the
    same prompt embeddings the frames agree."""
    jb, _ = bundles
    model, cn_dir, taesd_dir = (str(tmp_path / d) for d in ("model", "cn", "taesd"))
    for path, params, plan in (
            (os.path.join(model, "unet"), jb.params["unet"], JW.unet_plan(jb.unet_cfg)),
            (os.path.join(model, "text_encoder"), jb.params["clip"], JW.clip_plan(jb.clip_cfg)),
            (cn_dir, jb.params["controlnet"], JW.controlnet_plan(jb.unet_cfg)),
            (taesd_dir, jb.params["taesd"], JW.taesd_plan(jb.taesd_cfg))):
        os.makedirs(path)
        write_safetensors(os.path.join(path, "model.safetensors"), JW.export(params, plan))
    kw = dict(family="tiny-xl", controlnet_dir=cn_dir, taesd_dir=taesd_dir)
    jl = J.ModelBundle.from_pretrained(model, dtype=jnp.float32, **kw)
    pl = P.ModelBundle.from_pretrained(model, dtype=torch.float32, device="cpu", **kw)
    assert "vae" not in pl.models and pl.clip2_cfg == CLIP_PRESETS["tiny"]
    random2 = P.ModelBundle.random("tiny-xl", dtype=torch.float32, device="cpu")
    assert all(torch.equal(v, random2.models["clip2"].state_dict()[k])
               for k, v in pl.models["clip2"].state_dict().items())
    ids = pl.tokenizer(["a fox in the snow"])
    with torch.no_grad():
        ctx1, _ = pl.models["clip"](torch.as_tensor(ids))
    want1, _ = JC.clip_text_apply(jl.params["clip"], jl.clip_cfg, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(ctx1.numpy(), np.asarray(want1), **TOL)
    jctx, jpool = _jax_embeds(jl)
    spec_kw = dict(batch=1, height=SIDE, width=SIDE, steps=2)
    frame = _frame(7)
    want = J.build_frame_program(jl, J.FrameSpec(**spec_kw))(
        jl.params, jnp.asarray(frame), jctx, *map(jnp.asarray, ARGS), pooled_embeds=jpool)
    got = P.frame_program(pl, P.FrameSpec(**spec_kw), frame, np.asarray(jctx), *ARGS,
                          noise=_jax_noise(ARGS[3], 2, (4, 4)), pooled_embeds=np.asarray(jpool))
    _assert_frames_close(got, want)


# ------------------------------------------------------------------ FLOPs


@pytest.mark.parametrize("use_controlnet", [True, False])
def test_tiny_xl_flops_match_jax(bundles, use_controlnet, monkeypatch):
    monkeypatch.setenv("VIDEOSD_ATTN_IMPL", "xla")
    jb, _ = bundles
    spec_kw = dict(batch=1, height=64, width=64, steps=2, use_controlnet=use_controlnet)
    jctx, jpool = _jax_embeds(jb)
    want = program_flops(J.build_frame_program(jb, J.FrameSpec(**spec_kw)), jb.params,
                         jnp.zeros((1, 64, 64, 3), jnp.uint8), jctx,
                         *map(jnp.asarray, ARGS), pooled_embeds=jpool)["logical"]
    meta = P.ModelBundle.random("tiny-xl", dtype=torch.float32, device="meta")
    got = PF.frame_flops(meta, P.FrameSpec(**spec_kw))
    assert got["logical"] == want and got["padded"] == got["logical"]


def test_sdxl_1024_frame_is_jax_count():
    """SDXL 1024x1024 4 steps without ControlNet (tools/sdxl_prod.py's
    frame) on the meta device; K1's d = 64 is an instance width, so padded
    equals logical."""
    meta = P.ModelBundle.random("sdxl", dtype=torch.bfloat16, device="meta",
                                with_controlnet=False)
    r = PF.frame_flops(meta, P.FrameSpec(height=1024, width=1024, steps=4,
                                         use_controlnet=False))
    assert r["logical"] == pytest.approx(SDXL_JAX_TFLOP * 1e12, rel=1e-2)
    assert r["padded"] == r["logical"]


# ------------------------------------------------------------------ SDXL widths


def test_transformer2d_640_depth2_heads_of_64():
    """SDXL's stage-1 Transformer2D: 640 channels, 10 heads of 64, linear
    projections, depth 2, 2048-wide context, over 256 tokens (K1's
    route)."""
    jcfg = JU.UNET_PRESETS["sdxl"]
    params = _np(JU.transformer2d_init(jax.random.PRNGKey(3), jcfg, 640, 2))
    blk = Transformer2DModel(UNET_PRESETS["sdxl"], 640, 2).eval()
    plan = []
    PW._transformer2d_plan(plan, (), "m", 2, linear_proj=True)
    blk.load_state_dict({k[2:]: v for k, v in PW.state_dict_from_jax(params, plan).items()},
                        strict=True)
    assert routes_to_flash(256, 256, False)
    r = np.random.default_rng(4)
    x = r.standard_normal((1, 16, 16, 640)).astype(np.float32)
    ctx = r.standard_normal((1, 77, 2048)).astype(np.float32)
    want = jax.jit(lambda p, a, c: JU.transformer2d_apply(p, jcfg, a, c))(params, x, ctx)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_embedding_2816_to_1280(dtype):
    """The text_time embedder at SDXL widths: the pooled 1280 beside the
    sinusoids (256 each) of time ids up to 1344, 2816 -> 1280 -> 1280, in
    fp32 and in bf16 (the pooled embedding in bf16, the sinusoids fp32, the
    concat cast to the weights' dtype: JAX's casts).  At 256 wide, torch's
    and XLA's fp32 exp give 14 of the 128 frequencies one ulp apart, which
    moves a sinusoid by up to 3.0e-5 at id 1344 (measured on the CPU); the
    embedding meets the 1e-4 bar all the same."""
    cfg = UNET_PRESETS["sdxl"]
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    params = {"add_embedding": {"linear_1": linear_init(k1, 2816, 1280),
                                "linear_2": linear_init(k2, 1280, 1280)}}
    params = _np(params)
    r = np.random.default_rng(10)
    for lin in params["add_embedding"].values():
        lin["bias"] = (0.05 * r.standard_normal(lin["bias"].shape)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    plan = [p for p in PW.unet_plan(cfg) if p[0][0] == "add_embedding"]
    emb = AddEmbedding(cfg).eval()
    emb.load_state_dict({k.split(".", 1)[1]: v for k, v in
                         PW.state_dict_from_jax(params, plan).items()}, strict=True)
    emb = emb.to(tdt)
    pooled = r.standard_normal((2, 1280)).astype(np.float32)
    time_ids = _time_ids([(1024, 1024), (768, 1344)])
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    want = jax.jit(lambda p, a, b: JU.compute_add_embedding(p, JU.UNET_PRESETS["sdxl"], a, b))(
        jp, jnp.asarray(pooled, jdt), time_ids)
    with torch.no_grad():
        got = emb(cfg, torch.from_numpy(pooled).to(tdt), torch.from_numpy(time_ids))
    assert got.dtype == tdt
    tol = TOL if dtype == "float32" else dict(rtol=6e-2, atol=6e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_openclip_bigg_layer_with_projection():
    """One OpenCLIP bigG text layer (1280 wide, 20 heads, 5120 MLP, gelu),
    the penultimate state, the final LN and ``text_projection`` on the
    pooled output."""
    cut = dict(vocab_size=1000, num_layers=2)
    jcfg = dataclasses.replace(JC.CLIP_PRESETS["sdxl-2"], **cut)
    cfg = dataclasses.replace(CLIP_PRESETS["sdxl-2"], **cut)
    assert (cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.projection_dim) == (
        1280, 20, 5120, 1280)
    params = _np(JC.clip_text_init(jax.random.PRNGKey(11), jcfg))
    r = np.random.default_rng(12)
    for ln in (params["layers"][0]["layer_norm1"], params["final_layer_norm"]):
        ln["scale"] = (1 + 0.1 * r.standard_normal(ln["scale"].shape)).astype(np.float32)
        ln["bias"] = (0.1 * r.standard_normal(ln["bias"].shape)).astype(np.float32)
    clip = CLIPTextModel(cfg).eval()
    clip.load_state_dict(PW.state_dict_from_jax(params, PW.clip_plan(cfg)), strict=True)
    ids = r.integers(1, 990, (1, 77)).astype(np.int32)
    ids[0, 12] = 999
    want_ctx, want_pool = jax.jit(lambda p, a: JC.clip_text_apply(p, jcfg, a))(params, ids)
    with torch.no_grad():
        got_ctx, got_pool = clip(torch.from_numpy(ids))
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), **TOL)
    np.testing.assert_allclose(got_pool.numpy(), np.asarray(want_pool), **TOL)


# ------------------------------------------------------------------ the tool


def test_sdxl_prod_report_on_the_cpu():
    report = sdxl_prod.run(family="tiny-xl", size=32, steps=2, frames=2, every=(2,),
                           device="cpu")
    assert json.loads(json.dumps(report)) == report
    for key in ("fps_parity", "p50_ms", "flops_per_frame_tflop_logical", "fps_temporal_n2"):
        assert report[key] > 0, key
    assert report["mfu"] is None and report["card"] == "cpu" and report["power_limit_w"] is None
    assert report["chips_for_20fps_dp"] >= 1
