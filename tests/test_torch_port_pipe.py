"""The port's 2-stage UNet pipeline (fp32, CPU).

Counterparts of ``tests/test_pipeline_parallel.py`` over
``videosd_tpu_torch.parallel.pipe``, on eight repeated CPU slots:

* the split is a partition of the UNet's state dict;
* the encoder and decoder halves against JAX's ``unet_encoder_apply`` /
  ``unet_decoder_apply`` (tiny and tiny-xl; JAX's ``unet_init`` weights
  through the weight plan), and bit for bit the port's own whole pass;
* ``PipelinedUNet`` with the ControlNet against JAX's ``controlnet_apply``
  + ``unet_apply``, its stage weights on their own slots only (by the
  placement record), and a refresh after a weight swap;
* ``PipelinedFrameEngine`` against JAX's single-device frame program (tiny,
  batch 2, 64x64, 2 steps, ``model_parallel=2``; images within 2 levels,
  latents 1e-4, JAX's noise through the seam), ``run_pipelined`` against
  ``run``, the KL VAE and I420 paths against the port's single-device
  program, turbo specs refused with JAX's message;
* the engine under ``mesh_pipe=2``, with the ControlNet on (a turbo option
  coerced) and off, reference mode served unpipelined, and the fallback.
"""

import asyncio
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.models import controlnet as JCN
from videosd_tpu.models import unet as JU
from videosd_tpu.parallel import pipe as JPP
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu_torch.config import ServerConfig
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models.controlnet import ControlNetModel
from videosd_tpu_torch.models.unet import UNet2DConditionModel
from videosd_tpu_torch.parallel.pipe import (
    PipelinedFrameEngine,
    PipelinedUNet,
    split_unet_params,
    unet_decoder_apply,
    unet_encoder_apply,
)
from videosd_tpu_torch.parallel.tensor import TensorParallel
from videosd_tpu_torch.pipelines import lcm_img2img as P

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_module(cls, cfg, params, plan):
    mod = cls(cfg).eval().requires_grad_(False)
    mod.load_state_dict(PW.state_dict_from_jax(_np(params), plan), strict=True)
    return mod


def _unet_inputs(cfg, b=2, hw=8, seed=0):
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((b, hw, hw, cfg.in_channels)).astype(np.float32)
    t = rng.integers(0, 999, (b,)).astype(np.int32)
    ctx = rng.standard_normal((b, 7, cfg.cross_attention_dim)).astype(np.float32)
    kw = {}
    if cfg.time_cond_proj_dim is not None:
        kw["timestep_cond"] = rng.standard_normal((b, cfg.time_cond_proj_dim)).astype(np.float32)
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        kw["added_cond_kwargs"] = {
            "text_embeds": rng.standard_normal((b, pooled)).astype(np.float32),
            "time_ids": np.tile(np.asarray([[8, 8, 0, 0, 8, 8]], np.float32), (b, 1)),
        }
    return sample, t, ctx, kw


def _torch_kw(kw):
    return {k: ({n: torch.from_numpy(a) for n, a in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in kw.items()}


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_split_partition_is_total():
    unet = UNet2DConditionModel(P.UNET_PRESETS["tiny"])
    sd = unet.state_dict()
    s0, s1 = split_unet_params(sd)
    assert set(s0) | set(s1) == set(sd) and not set(s0) & set(s1)
    assert {k.split(".")[0] for k in s1} == {"mid_block", "up_blocks", "conv_norm_out",
                                             "conv_out"}
    with pytest.raises(ValueError, match="unrecognized UNet param keys"):
        split_unet_params({**sd, "mystery.weight": torch.zeros(())})


@pytest.mark.parametrize("family", ["tiny", "tiny-xl"])
def test_split_apply_matches_jax(family):
    """The two halves against JAX's halves, and bit for bit the port's whole
    pass (the split moves no operation)."""
    cfg = P.UNET_PRESETS[family]
    jcfg = JU.UNET_PRESETS[family]
    params = JU.unet_init(jax.random.PRNGKey(0), jcfg)
    unet = _port_module(UNet2DConditionModel, cfg, params, PW.unet_plan(cfg))
    sample, t, ctx, kw = _unet_inputs(cfg)
    p0, p1 = JPP.split_unet_params(params)
    jx, jres, jtemb = jax.jit(lambda p, *a: JPP.unet_encoder_apply(p, jcfg, *a, **kw))(
        p0, sample, t, ctx)
    want = jax.jit(lambda p, *a: JPP.unet_decoder_apply(p, jcfg, *a))(p1, jx, jres, jtemb, ctx)
    with torch.no_grad():
        x, res, temb = unet_encoder_apply(unet, _nchw(sample), torch.from_numpy(t),
                                          torch.from_numpy(ctx), **_torch_kw(kw))
        np.testing.assert_allclose(_nhwc(x), np.asarray(jx), **TOL)
        assert len(res) == len(jres)
        np.testing.assert_allclose(temb.numpy(), np.asarray(jtemb), **TOL)
        got = unet_decoder_apply(unet, x, res, temb, torch.from_numpy(ctx))
        whole = unet(_nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx),
                     **_torch_kw(kw))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    assert torch.equal(got, whole)


@pytest.fixture(scope="module")
def unet_cn():
    cfg, jcfg = P.UNET_PRESETS["tiny"], JU.UNET_PRESETS["tiny"]
    params = JU.unet_init(jax.random.PRNGKey(0), jcfg)
    # the ControlNet's zero-initialized output convs drawn small, so its residuals show
    rng = np.random.default_rng(1)
    cn = jax.tree_util.tree_map_with_path(
        lambda path, a: rng.normal(0, 0.05, a.shape).astype(np.float32) if any(
            getattr(k, "key", None) in ("controlnet_down_blocks", "controlnet_mid_block")
            for k in path) else np.asarray(a),
        _np(JCN.controlnet_init(jax.random.PRNGKey(1), jcfg)))
    return (params, cn, _port_module(UNet2DConditionModel, cfg, params, PW.unet_plan(cfg)),
            _port_module(ControlNetModel, cfg, cn, PW.controlnet_plan(cfg)))


def test_pipelined_unet_with_controlnet_matches(unet_cn):
    """2 stages x (2 data x 2 model) over eight slots, the ControlNet on
    stage 0 and its down residuals added before the transfer, against
    JAX's ControlNet + UNet on one device."""
    params, cn, unet, controlnet = unet_cn
    jcfg = JU.UNET_PRESETS["tiny"]
    sample, t, ctx, kw = _unet_inputs(P.UNET_PRESETS["tiny"], b=4)
    ctrl = np.random.default_rng(3).random((4, 64, 64, 3)).astype(np.float32)
    scale = np.asarray([1.5, 0.5, 2.0, 0.0], np.float32)

    @jax.jit
    def reference(params, cn):
        down, mid = JCN.controlnet_apply(cn, jcfg, sample, t, ctx, ctrl,
                                         conditioning_scale=scale,
                                         timestep_cond=kw["timestep_cond"])
        return JU.unet_apply(params, jcfg, sample, t, ctx, down_block_additional_residuals=down,
                             mid_block_additional_residual=mid, **kw)

    want = reference(params, cn)
    pipe = PipelinedUNet(unet, controlnet=controlnet, devices=CPU8, model_parallel=2)
    assert pipe.mesh0.shape == pipe.mesh1.shape == {"data": 2, "model": 2}
    got = pipe(_nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx),
               ctrl=_nchw(ctrl), cn_scale=torch.from_numpy(scale), **_torch_kw(kw))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    assert any(isinstance(m, TensorParallel) for m in pipe.stage1[1].models["unet"].modules())


def test_stage_params_live_only_on_their_submesh(unet_cn):
    """The capacity claim, by the placement record: stage 0's weights (the
    encoder half and the ControlNet) on slots 0-3 only, stage 1's (the
    decoder half) on 4-7 only, and together the whole UNet once a row."""
    _, _, unet, controlnet = unet_cn
    pipe = PipelinedUNet(unet, controlnet=controlnet, devices=CPU8, model_parallel=2)
    own0, own1 = set(pipe.mesh0.slots.flat), set(pipe.mesh1.slots.flat)
    assert own0 == {0, 1, 2, 3} and own1 == {4, 5, 6, 7}
    for i in range(2):
        assert set(pipe.stage0[i].slots.values()) == set(pipe.mesh0.slots[i])
        assert set(pipe.stage1[i].slots.values()) == set(pipe.mesh1.slots[i])
        assert not hasattr(pipe.stage0[i].models["unet"], "up_blocks")
        assert not hasattr(pipe.stage1[i].models["unet"], "down_blocks")
        unet_bytes = sum(t.numel() * 4 for t in unet.state_dict().values())
        halves = (pipe.stage0[i].nbytes() + pipe.stage1[i].nbytes()
                  - sum(t.numel() * 4 for t in controlnet.state_dict().values()))
        assert halves == unet_bytes


def test_refresh_params_swaps_weights(unet_cn):
    """A swapped checkpoint reaches the stage copies by ``refresh_params``
    (in place), and the pipeline then computes the new weights' UNet."""
    _, _, unet, _ = unet_cn
    cfg = P.UNET_PRESETS["tiny"]
    mine = UNet2DConditionModel(cfg).eval().requires_grad_(False)
    mine.load_state_dict(unet.state_dict())
    pipe = PipelinedUNet(mine, devices=CPU8[:2])
    sample, t, ctx, kw = _unet_inputs(cfg, b=1)
    args = (_nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx))
    before = pipe(*args, **_torch_kw(kw))
    ptr = pipe.stage1[0].models["unet"].conv_out.weight.data_ptr()
    other = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu", seed=5)
    mine.load_state_dict(other.models["unet"].state_dict())
    pipe.refresh_params()
    after = pipe(*args, **_torch_kw(kw))
    assert pipe.stage1[0].models["unet"].conv_out.weight.data_ptr() == ptr
    with torch.no_grad():
        want = mine(*args, **_torch_kw(kw))
    torch.testing.assert_close(after, want, rtol=1e-5, atol=1e-5)
    assert (after - before).abs().max() > 1e-3


# ------------------------------------------------------------- frame engine


@pytest.fixture(scope="module")
def bundles():
    cached = J.ModelBundle._random_cache
    J.ModelBundle._random_cache = {}
    try:
        jb = J.ModelBundle.random("tiny", dtype=jnp.float32, with_controlnet=True)
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
    cfg = P.UNET_PRESETS["tiny"]
    plans = {"unet": PW.unet_plan(cfg), "controlnet": PW.controlnet_plan(cfg),
             "clip": PW.clip_plan(P.CLIP_PRESETS["tiny"]), "taesd": PW.taesd_plan(jb.taesd_cfg)}
    sds = {k: PW.state_dict_from_jax(params[k], plan) for k, plan in plans.items()}
    return jb, P.ModelBundle.from_state_dicts("tiny", sds, dtype=torch.float32, device="cpu")


def _jax_noise(seeds, steps, latent_hw):
    return np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(int(s)), k), (*latent_hw, 4), jnp.float32))
        for s in seeds]) for k in range(steps + 1)])


def _frame_args(b, hw=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8),
            np.linspace(0.5, 0.8, b).astype(np.float32), np.linspace(3.0, 6.0, b).astype(
                np.float32), np.linspace(2.0, 1.0, b).astype(np.float32),
            np.arange(7, 7 + b, dtype=np.int32))


def test_pipelined_frame_engine_matches_jax(bundles):
    """Tiny, batch 2, 64x64, 2 steps, two stages of (1 data x 2 model) over
    four slots, against JAX's single-device program on JAX's noise: images
    within 2 levels, latents 1e-4 (JAX's bars, parallel/verify.py)."""
    jb, pb = bundles
    spec_kw = dict(batch=2, height=64, width=64, steps=2)
    frame, s, g, c, seeds = _frame_args(2)
    jctx, _ = J.build_prompt_encoder(jb)(jb.params, jnp.asarray(jb.tokenizer(["a cat"] * 2), jnp.int32))
    want = J.build_frame_program(jb, J.FrameSpec(**spec_kw))(
        jb.params, jnp.asarray(frame), jctx, *map(jnp.asarray, (s, g, c, seeds)))
    eng = PipelinedFrameEngine(pb, devices=CPU8[:4], model_parallel=2)
    assert eng.data_size == 1
    got = eng.run(P.FrameSpec(**spec_kw), frame, np.asarray(jctx), s, g, c, seeds,
                  noise=_jax_noise(seeds, 2, (8, 8)))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    assert np.abs(got[0].numpy().astype(int) - np.asarray(want[0]).astype(int)).max() <= 2


def test_run_pipelined_equals_run(bundles):
    """Two microbatches interleaved step by step: the outputs of two runs."""
    _, pb = bundles
    eng = PipelinedFrameEngine(pb, devices=CPU8, model_parallel=2)
    spec = P.FrameSpec(batch=2, height=64, width=64, steps=2)
    emb = torch.randn(2, 77, 32, generator=torch.Generator().manual_seed(0))
    ins = [_frame_args(2, seed=k) for k in (0, 1)]
    outs = eng.run_pipelined(spec, [dict(frame_u8=f, embeds=emb, strength=s, guidance=g, cn=c,
                                         seed=sd) for f, s, g, c, sd in ins])
    for (img, lat), args in zip(outs, ins):
        solo = eng.run(spec, args[0], emb, *args[1:])
        assert torch.equal(img, solo[0]) and torch.equal(lat, solo[1])


@pytest.mark.parametrize("variant", ["kl_vae", "i420", "warm_src_box"])
def test_pipelined_engine_alternate_io_paths(variant):
    """The KL VAE's split (``quant_conv`` with the encoder, ``post_quant_conv``
    with the decoder), packed I420 uploads, and a warm start with a source
    box, each equal bit for bit to the port's single-device program: on one
    data row of one device the stages run the same operations on the same
    batch."""
    from videosd_tpu_torch.ops.preprocess import rgb_to_i420_host

    pb = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu", with_kl_vae=True)
    spec_kw = {"kl_vae": dict(vae="kl"), "i420": dict(in_format="i420")}.get(variant, {})
    spec = P.FrameSpec(batch=2, height=64, width=64, steps=2, **spec_kw)
    frame, s, g, c, seeds = _frame_args(2)
    if variant == "i420":
        frame = np.stack([rgb_to_i420_host(f) for f in frame])
    emb = torch.randn(2, 77, 32, generator=torch.Generator().manual_seed(3))
    kw = {}
    if variant == "warm_src_box":
        kw = dict(warm_latents=torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(4)),
                  warm_alpha=np.asarray([0.3, 0.0], np.float32),
                  src_box=np.asarray([[0, 0, 48, 64], [8, 4, 56, 60]], np.int32))
    want = P.build_frame_program(pb, spec)(frame, emb, s, g, c, seeds, **kw)
    got = PipelinedFrameEngine(pb, devices=CPU8[:2]).run(spec, frame, emb, s, g, c, seeds, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pipelined_engine_rejects_turbo_specs(bundles):
    _, pb = bundles
    eng = PipelinedFrameEngine(pb, devices=CPU8[:4], model_parallel=2)
    for kw in (dict(controlnet_interval=2), dict(deepcache_interval=2),
               dict(deepcache_temporal=True)):
        spec = P.FrameSpec(batch=2, height=64, width=64, steps=2, **kw)
        with pytest.raises(ValueError, match="parity-only"):
            eng.run(spec, *_frame_args(2)[:1], torch.zeros(2, 77, 32), *_frame_args(2)[1:])


# ------------------------------------------------------------------- engine


def _serve_one(eng, options):
    async def run():
        eng.start()
        try:
            st = eng.open_stream({"height": 64, "width": 64, "steps": 1, **options})
            frame = np.random.default_rng(3).integers(0, 256, (64, 64, 3), dtype=np.uint8)
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            out = None
            while loop.time() - t0 < 120:
                before = eng.telemetry.frames_out
                out = await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 120)
                if eng.telemetry.frames_out > before:
                    break
                await asyncio.sleep(0.05)
            return out, eng.stats()
        finally:
            await eng.stop()

    return asyncio.run(run())


def _pipe_engine(pb):
    from videosd_tpu_torch.runtime.engine import Engine

    return Engine(ServerConfig(gpus=8, mesh_model=2, mesh_pipe=2), bundle=pb, max_streams=2,
                  max_batch=8, deadline_ms=5, frame_hw=(64, 64), devices=CPU8)


def test_engine_serves_pipelined(bundles, caplog):
    """``mesh_pipe=2`` from config: programs from ``PipelinedFrameEngine``,
    buckets in data-axis multiples, a live ``controlnet_interval`` coerced
    to parity with one warning, stage weights on their own slots."""
    _, pb = bundles
    eng = _pipe_engine(pb)
    assert eng.pipe_engine is not None and eng.mesh is None and eng.data_axis == 2
    with caplog.at_level(logging.WARNING, logger="videosd_tpu_torch.engine"):
        out, stats = _serve_one(eng, {"controlnet_interval": 4})
    assert eng.telemetry.frames_out >= 1
    assert out.shape == (64, 64, 3) and out.dtype == np.uint8 and int(out.sum()) > 0
    assert stats["devices"] == {"data": 2, "model": 2, "pipe": 2}
    assert all(b["batch"] % 2 == 0 for b in stats["ready_buckets"])
    assert all(sp.controlnet_interval == 1 and sp.deepcache_interval == 1
               for sp, _ in eng._ready_specs)
    assert sum("parity-only" in r.getMessage() for r in caplog.records) == 1
    placed = eng.params
    assert all(set(p.slots.values()) <= {0, 1, 2, 3} for p in placed[0])
    assert all(set(p.slots.values()) <= {4, 5, 6, 7} for p in placed[1])


def test_engine_serves_pipelined_controlnet_off(bundles):
    """``controlnet: false`` under ``mesh_pipe``: stage 0 runs no ControlNet
    and a real frame comes back."""
    _, pb = bundles
    eng = _pipe_engine(pb)
    out, _ = _serve_one(eng, {"controlnet": False})
    assert eng.telemetry.frames_out >= 1, eng.stats()
    assert out.shape == (64, 64, 3) and all(not sp.use_controlnet for sp, _ in eng._ready_specs)


def test_engine_pipe_ref_mode_and_fallback(bundles, caplog):
    """Reference mode has no stage split: it serves unpipelined on the
    engine's device, with JAX's warning; more gpus than devices serve
    unpipelined."""
    from videosd_tpu_torch.runtime.engine import Engine

    _, pb = bundles
    eng = _pipe_engine(pb)
    with caplog.at_level(logging.WARNING, logger="videosd_tpu_torch.engine"):
        out, _ = _serve_one(eng, {"ref": True})
        assert eng.telemetry.frames_out >= 1 and int(out.sum()) > 0
        assert any("serves UNPIPELINED" in r.getMessage() for r in caplog.records)
        short = Engine(ServerConfig(gpus=16, mesh_model=1, mesh_pipe=2), bundle=pb,
                       frame_hw=(64, 64), devices=CPU8)
        assert short.pipe_engine is None and short.data_axis >= 1
        assert any("serving unpipelined" in r.getMessage() for r in caplog.records)
