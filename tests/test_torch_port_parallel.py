"""The port's mesh, tensor parallelism and sharded serving (fp32, CPU).

Counterparts of ``tests/test_parallel.py`` over ``videosd_tpu_torch.parallel``,
on meshes of repeated CPU devices (``[torch.device("cpu")] * 8``, as the JAX
tests run on eight virtual CPU devices):

* ``make_mesh`` shapes and errors, against JAX's;
* ``PARAM_RULES``/``param_spec`` against JAX's on the tiny UNet, ControlNet
  and CLIP trees, key by key through the weight plans, the ``[in, out]``
  kernel's dim against the ``[out, in]`` weight's;
* placement by mesh slot: rank r holds heads/m of every attention (its
  rows of ``to_q``/``to_k``/``to_v``, its columns of ``to_out``) and its
  halves of every GEGLU projection;
* the tensor-parallel ``Attention`` and ``FeedForward`` at m = 2 and 4
  against the whole modules within 1e-6 relative (self, cross and banked
  attention), a 5-head layer and the KL VAE's one head that stay whole,
  int8 layers that stay whole;
* ``ShardedFrameEngine`` against JAX's single-device frame program on the
  same noise (JAX's threefry draws through the port's seam): dp = 8 at
  batch 8 (images within 1 level, latents 1e-4), dp x tp (4 x 2) without
  the ControlNet, tiny-xl with pooled embeddings and a warm start;
* the engine at ``gpus=8, mesh_model=2`` over eight CPU slots: served
  replies, ``stats()["devices"]``, data-axis buckets, reference mode, a
  swap re-placing the weights, and the logged fallback.

JAX's zero-initialized biases and ControlNet output convs are drawn small
first, so that a bias added once per rank, or a dropped residual, shows.
"""

import asyncio
import copy
import dataclasses
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import DictKey

from videosd_tpu.parallel import mesh as JM
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu_torch.config import ServerConfig
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models.layers import LinearW8A8
from videosd_tpu_torch.models.unet import Attention, BasicTransformerBlock, FeedForward
from videosd_tpu_torch.parallel.mesh import (
    PARAM_RULES,
    data_sharding,
    make_mesh,
    param_spec,
    replicated,
    shard_params,
)
from videosd_tpu_torch.parallel.serving import ShardedFrameEngine
from videosd_tpu_torch.parallel.tensor import TensorParallel
from videosd_tpu_torch.pipelines import lcm_img2img as P

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
SIDE = 32


def _perturbed(jb, seed=17):
    """``jb`` with its zero biases and ControlNet output convs drawn small."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        zero = path[-1].key == "bias" or any(
            getattr(k, "key", None) in ("controlnet_down_blocks", "controlnet_mid_block")
            for k in path)
        return rng.normal(0, 0.05, a.shape).astype(np.float32) if zero else np.asarray(a)

    params = jax.tree_util.tree_map_with_path(perturb, jax.tree.map(np.asarray, jb.params))
    return J.ModelBundle(**{**vars(jb), "params": jax.tree.map(jnp.asarray, params)}), params


def _crossed(family, params, jb, towers=("clip",)):
    cfg = P.UNET_PRESETS[family]
    plans = {"unet": PW.unet_plan(cfg), "controlnet": PW.controlnet_plan(cfg),
             "taesd": PW.taesd_plan(jb.taesd_cfg)}
    plans.update({t: PW.clip_plan(P.CLIP_PRESETS["tiny"]) for t in towers})
    sds = {k: PW.state_dict_from_jax(params[k], plan) for k, plan in plans.items()}
    return P.ModelBundle.from_state_dicts(family, sds, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    cached = J.ModelBundle._random_cache
    J.ModelBundle._random_cache = {}
    try:
        jb = J.ModelBundle.random("tiny", dtype=jnp.float32, with_controlnet=True)
    finally:
        J.ModelBundle._random_cache = cached
    jb, params = _perturbed(jb)
    return jb, _crossed("tiny", params, jb)


def _jax_noise(seeds, steps, latent_hw):
    """The JAX program's noise in the port's seam layout [S+1, B, h, w, 4]."""
    return np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(int(s)), k), (*latent_hw, 4), jnp.float32))
        for s in seeds]) for k in range(steps + 1)])


def _args(b, seed=0):
    """Per-element inputs that differ row to row (a row mix-up shows)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, SIDE, SIDE, 3), dtype=np.uint8),
            np.linspace(0.3, 0.9, b).astype(np.float32),
            np.linspace(2.0, 7.0, b).astype(np.float32),
            np.linspace(0.5, 2.0, b).astype(np.float32), np.arange(5, 5 + b, dtype=np.int32))


def _jax_embeds(jb, b):
    prompts = [f"prompt {i}" for i in range(b)]
    return J.build_prompt_encoder(jb)(jb.params, jnp.asarray(jb.tokenizer(prompts), jnp.int32))


def _assert_close_to_jax(got, want, levels):
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-4)
    assert np.abs(got[0].numpy().astype(int) - np.asarray(want[0]).astype(int)).max() <= levels


# --------------------------------------------------------------------- mesh


def test_make_mesh_shapes():
    mesh = make_mesh(8, model_parallel=2, devices=CPU8)
    assert mesh.shape == {"data": 4, "model": 2} == dict(JM.make_mesh(8, model_parallel=2).shape)
    assert mesh.row(1) == ([torch.device("cpu")] * 2, [2, 3])
    assert make_mesh(devices=CPU8[:4]).shape == {"data": 4, "model": 1}
    for bad in (3, 16):
        with pytest.raises(ValueError, match="not divisible"):
            make_mesh(8, model_parallel=bad, devices=CPU8)
    with pytest.raises(ValueError):
        JM.make_mesh(8, model_parallel=3)
    assert data_sharding(mesh, 8) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="multiple of data axis 4"):
        data_sharding(mesh, 6)
    assert replicated(mesh) == [torch.device("cpu")] * 4


@pytest.mark.parametrize("model", ["unet", "controlnet", "clip"])
def test_param_rules_follow_jax(model):
    """Every tensor of the tiny trees: the port's spec is JAX's with the
    dims of a linear swapped ([in, out] kernel, [out, in] weight); a
    column-parallel bias shards with its rows, where JAX replicates it and
    GSPMD slices it at use."""
    cfg = P.UNET_PRESETS["tiny"]
    plan = {"unet": PW.unet_plan(cfg), "controlnet": PW.controlnet_plan(cfg),
            "clip": PW.clip_plan(P.CLIP_PRESETS["tiny"])}[model]
    column_bias = r"(ff\.net\.0\.proj|q_proj|k_proj|v_proj|mlp\.fc1)\.bias$"
    sharded = 0
    for jpath, key, kind in plan:
        want = tuple(JM.param_spec(tuple(DictKey(str(p)) for p in jpath), None))
        got = param_spec(key)
        if kind == "linear":
            assert got == want[::-1], (key, got, want)
        elif re.search(column_bias, key):
            assert want == () and got == ("model",), key
        else:
            assert got == want, (key, got, want)
        sharded += "model" in got
    assert sharded > 0
    # JAX's rules (the pre-concatenated wqkv/wkv one included), plus the column biases
    assert len(PARAM_RULES) == len(JM.PARAM_RULES) + 3


def test_placement_by_slot(tiny):
    """Rank r of data row i sits on slot (i, r) with heads/m of each
    attention and its halves of each GEGLU projection; everything else on
    the row's first slot."""
    _, pb = tiny
    unet = pb.models["unet"]
    mesh = make_mesh(devices=CPU8, model_parallel=2)
    rows = shard_params({"unet": unet}, mesh)
    assert len(rows) == 4
    whole = dict(unet.named_parameters())
    for i, placed in enumerate(rows):
        split = placed.models["unet"]
        layers = [(n, m) for n, m in split.named_modules() if isinstance(m, TensorParallel)]
        blocks = sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
        assert len(layers) == 3 * blocks  # attn1, attn2 and ff of every transformer block
        for name, layer in layers:
            for r, shard in enumerate(layer.shards):
                for key, t in shard.named_parameters():
                    assert placed.slots[f"unet.{name}.shards.{r}.{key}"] == mesh.slots[i, r]
            if isinstance(layer.shards[0], Attention):
                c = whole[f"{name}.to_q.weight"].shape[0]
                for r, shard in enumerate(layer.shards):
                    assert shard.heads == 2  # tiny's 4 heads over 2 ranks
                    rows_r = slice(r * c // 2, (r + 1) * c // 2)
                    for proj in ("to_q", "to_k", "to_v"):
                        assert torch.equal(getattr(shard, proj).weight,
                                           whole[f"{name}.{proj}.weight"][rows_r])
                    assert torch.equal(shard.to_out[0].weight,
                                       whole[f"{name}.to_out.0.weight"][:, rows_r])
            else:
                w = whole[f"{name}.net.0.proj.weight"]
                inner = w.shape[0] // 2
                for r, shard in enumerate(layer.shards):
                    own = slice(r * inner // 2, (r + 1) * inner // 2)
                    a, gate = shard.net[0].proj.weight.chunk(2)
                    assert torch.equal(a, w[:inner][own]) and torch.equal(gate, w[inner:][own])
            assert placed.slots[f"unet.{name}.bias"] == mesh.slots[i, 0]
        others = {k: s for k, s in placed.slots.items() if ".shards." not in k}
        assert set(others.values()) == {int(mesh.slots[i, 0])}
        assert placed.nbytes() == sum(t.numel() * 4 for t in whole.values())


# ----------------------------------------------------------- tensor layers


def _randomized(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return module.eval().requires_grad_(False)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("m", [2, 4])
def test_tensor_parallel_attention_and_feedforward(m):
    """Self-attention over 256 tokens (K1's route: its plain version on the
    CPU), cross-attention over 77, the banked READ form (keys over
    [h; bank]) and the GEGLU feed-forward, each split over m slots, against
    the whole module within 1e-6 relative."""
    dim, ctx_dim, heads = 64, 32, 8
    block = _randomized(torch.nn.Module(), 0)
    block.attn = _randomized(Attention(dim, dim, heads), 1)
    block.cross = _randomized(Attention(dim, ctx_dim, heads), 2)
    block.ff = _randomized(FeedForward(dim), 3)
    (placed,) = shard_params({"b": block}, make_mesh(devices=CPU8[:m], model_parallel=m))
    split = placed.models["b"]
    assert all(isinstance(getattr(split, n), TensorParallel) for n in ("attn", "cross", "ff"))
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 256, dim, generator=gen)
    ctx = torch.randn(2, 77, ctx_dim, generator=gen)
    bank = torch.randn(2, 256, dim, generator=gen)
    for got, want in (
        (split.attn(x), block.attn(x)),
        (split.attn(x, torch.cat([x, bank], 1)), block.attn(x, torch.cat([x, bank], 1))),
        (split.cross(x, ctx), block.cross(x, ctx)),
        (split.ff(x), block.ff(x)),
    ):
        assert _rel(got, want) <= 1e-6, _rel(got, want)
    # a contiguous split of the GEGLU projection would hand rank 0 all of a
    proj = block.ff.net[0].proj.weight
    assert not torch.equal(split.ff.shards[0].net[0].proj.weight, proj[: proj.shape[0] // m])


def test_heads_that_do_not_divide_stay_whole():
    """sd21's 5 heads at 320 channels over 2 ranks, and the KL VAE's single
    head: the attention stays whole (the feed-forward's 1280 hidden units
    split), and the block computes what the whole one does."""
    cfg = P.UNET_PRESETS["sd21"]
    block = _randomized(BasicTransformerBlock(cfg, 320, cfg.num_heads(320)), 5)
    (placed,) = shard_params({"b": block}, make_mesh(devices=CPU8[:2], model_parallel=2))
    split = placed.models["b"]
    assert type(split.attn1) is Attention and type(split.attn2) is Attention
    assert split.attn1.heads == 5 and isinstance(split.ff, TensorParallel)
    gen = torch.Generator().manual_seed(6)
    x, ctx = torch.randn(1, 128, 320, generator=gen), torch.randn(1, 77, 1024, generator=gen)
    assert _rel(split(x, ctx), block(x, ctx)) <= 1e-6
    vae = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu",
                               with_kl_vae=True).models["vae"]
    (placed,) = shard_params({"vae": vae}, make_mesh(devices=CPU8[:2], model_parallel=2))
    assert not any(isinstance(m, TensorParallel) for m in placed.models["vae"].modules())
    assert set(placed.slots.values()) == {0}


@pytest.mark.parametrize("min_attn_dim", [640, 32])
def test_quantized_layers_stay_whole(tiny, min_attn_dim):
    """An int8 layer is not split (JAX's rules match ``.../kernel``, so a
    w8a8 tree stays replicated): at the default policy the tiny family's
    feed-forwards are int8 and stay whole while its attentions split; with
    every attention quantized too, none splits.  One data row over two
    model slots equals the single-device int8 frame; over two data rows
    each row equals the single-device frame of that row alone (a w8a8
    linear's activation scale is over the tensor it is given, so over a
    data row's share of the batch: ``parallel/serving.py``)."""
    from videosd_tpu_torch.ops.quant import quantize_bundle_params

    _, pb = tiny
    qb = quantize_bundle_params(_cloned(pb), min_attn_dim=min_attn_dim)
    eng = ShardedFrameEngine(qb, devices=CPU8[:2], model_parallel=2)
    unet = eng.placements[0].models["unet"]
    split = [m for m in unet.modules() if isinstance(m, TensorParallel)]
    whole = [m for m in unet.modules() if isinstance(m, (Attention, FeedForward))
             and any(isinstance(c, LinearW8A8) for c in m.modules())]
    assert whole  # the quantized layers are there, unsplit
    assert not any(isinstance(c, LinearW8A8) for t in split for c in t.modules())
    assert bool(split) == (min_attn_dim == 640)
    spec = P.FrameSpec(batch=2, height=SIDE, width=SIDE, steps=1)
    frame, s, g, c, seeds = _args(2)
    emb = torch.randn(2, 77, 32, generator=torch.Generator().manual_seed(1))
    want = P.build_frame_program(qb, spec)(frame, emb, s, g, c, seeds)
    got = eng.run(spec, frame, emb, s, g, c, seeds)
    assert (got[0].int() - want[0].int()).abs().max() <= 1
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    rows = ShardedFrameEngine(qb, devices=CPU8[:2]).run(spec, frame, emb, s, g, c, seeds)
    one = P.build_frame_program(qb, dataclasses.replace(spec, batch=1))
    for i in range(2):
        alone = one(frame[i:i + 1], emb[i:i + 1], s[i:i + 1], g[i:i + 1], c[i:i + 1],
                    seeds[i:i + 1])
        assert torch.equal(alone[0], rows[0][i:i + 1]) and torch.equal(alone[1], rows[1][i:i + 1])


def _cloned(bundle):
    return dataclasses.replace(bundle, models={k: copy.deepcopy(m)
                                               for k, m in bundle.models.items()})


# ---------------------------------------------------------- sharded frames


def test_sharded_serving_matches_jax_single_device(tiny):
    """dp = 8 at batch 8, each row's own slider values and seed: the port's
    sharded frame against JAX's single-device program, images within 1
    level, latents 1e-4; each row equals the port's own program run on
    that row alone."""
    jb, pb = tiny
    spec_kw = dict(batch=8, height=SIDE, width=SIDE, steps=2)
    frame, s, g, c, seeds = _args(8)
    jctx, _ = _jax_embeds(jb, 8)
    want = J.build_frame_program(jb, J.FrameSpec(**spec_kw))(
        jb.params, jnp.asarray(frame), jctx, *map(jnp.asarray, (s, g, c, seeds)))
    eng = ShardedFrameEngine(pb, devices=CPU8)
    assert eng.data_size == 8 and eng.mesh.shape == {"data": 8, "model": 1}
    noise = _jax_noise(seeds, 2, (4, 4))
    got = eng.run(P.FrameSpec(**spec_kw), frame, np.asarray(jctx), s, g, c, seeds, noise=noise)
    _assert_close_to_jax(got, want, 1)
    one = P.build_frame_program(pb, P.FrameSpec(**{**spec_kw, "batch": 1}))
    row = 5
    alone = one(frame[row:row + 1], np.asarray(jctx)[row:row + 1], s[row:row + 1],
                g[row:row + 1], c[row:row + 1], seeds[row:row + 1], noise=noise[:, row:row + 1])
    assert torch.equal(alone[0], got[0][row:row + 1])
    with pytest.raises(ValueError, match="multiple of data axis 8"):
        eng.program(P.FrameSpec(batch=4, height=SIDE, width=SIDE))


def test_sharded_serving_with_tp_matches_jax(tiny):
    """dp x tp (4 x 2) without the ControlNet, against JAX's single-device
    program: images within 2 levels, latents 1e-4; two heads a rank."""
    jb, pb = tiny
    spec_kw = dict(batch=4, height=SIDE, width=SIDE, steps=2, use_controlnet=False)
    frame, s, g, c, seeds = _args(4, seed=1)
    jctx, _ = _jax_embeds(jb, 4)
    want = J.build_frame_program(jb, J.FrameSpec(**spec_kw))(
        jb.params, jnp.asarray(frame), jctx, *map(jnp.asarray, (s, g, c, seeds)))
    eng = ShardedFrameEngine(pb, devices=CPU8, model_parallel=2)
    assert eng.mesh.shape == {"data": 4, "model": 2}
    got = eng.run(P.FrameSpec(**spec_kw), frame, np.asarray(jctx), s, g, c, seeds,
                  noise=_jax_noise(seeds, 2, (4, 4)))
    _assert_close_to_jax(got, want, 2)
    assert got[0].shape == (4, SIDE, SIDE, 3)


def test_sharded_serving_sdxl_pooled_and_warm():
    """tiny-xl: the pooled embeddings and a warm start from the first
    frame's latents split over the data axis, against JAX's single-device
    program on both frames."""
    cached = J.ModelBundle._random_cache
    J.ModelBundle._random_cache = {}
    try:
        jb = J.ModelBundle.random("tiny-xl", dtype=jnp.float32, with_controlnet=True)
    finally:
        J.ModelBundle._random_cache = cached
    jb, params = _perturbed(jb, seed=3)
    pb = _crossed("tiny-xl", params, jb, towers=("clip", "clip2"))
    spec_kw = dict(batch=4, height=SIDE, width=SIDE, steps=1)
    frame, s, g, c, seeds = _args(4, seed=2)
    jctx, jpool = _jax_embeds(jb, 4)
    jprog = J.build_frame_program(jb, J.FrameSpec(**spec_kw))
    jargs = (jnp.asarray(frame), jctx, *map(jnp.asarray, (s, g, c, seeds)))
    want = jprog(jb.params, *jargs, pooled_embeds=jpool)
    alpha = np.linspace(0.2, 0.8, 4).astype(np.float32)
    want2 = jprog(jb.params, *jargs, pooled_embeds=jpool, warm_latents=want[1],
                  warm_alpha=jnp.asarray(alpha))
    eng = ShardedFrameEngine(pb, devices=CPU8[:4])
    noise = _jax_noise(seeds, 1, (4, 4))
    args = (frame, np.asarray(jctx), s, g, c, seeds)
    got = eng.run(P.FrameSpec(**spec_kw), *args, noise=noise, pooled_embeds=np.asarray(jpool))
    _assert_close_to_jax(got, want, 1)
    got2 = eng.run(P.FrameSpec(**spec_kw), *args, noise=noise, pooled_embeds=np.asarray(jpool),
                   warm_latents=got[1], warm_alpha=alpha)
    _assert_close_to_jax(got2, want2, 1)


# ------------------------------------------------------------------- engine


def _serve_one(eng, options, frame_hw=(SIDE, SIDE)):
    """Submit one stream's frame until a generated one comes back (bounded)."""
    from videosd_tpu_torch.runtime.engine import Engine  # noqa: F401

    async def run():
        eng.start()
        try:
            st = eng.open_stream({"height": frame_hw[0], "width": frame_hw[1], "steps": 1,
                                  **options})
            frame = np.random.default_rng(3).integers(0, 256, (*frame_hw, 3), dtype=np.uint8)
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


def test_engine_serves_sharded_over_mesh(tiny):
    """``gpus=8, mesh_model=2`` over eight CPU slots: the mesh, data-axis
    buckets, a served frame, and ``stats()``."""
    from videosd_tpu_torch.runtime.engine import Engine

    _, pb = tiny
    eng = Engine(ServerConfig(gpus=8, mesh_model=2), bundle=pb, max_streams=4, max_batch=8,
                 deadline_ms=5, frame_hw=(SIDE, SIDE), devices=CPU8)
    assert eng.mesh is not None and eng.mesh.shape == {"data": 4, "model": 2}
    assert eng.data_axis == 4 and eng.pipe_engine is None
    assert eng._bucket_batch(1) == 4 and eng._bucket_batch(5) == 8
    assert len(eng.params) == 4  # one placement a data row
    out, stats = _serve_one(eng, {})
    assert eng.telemetry.frames_out >= 1
    assert out.shape == (SIDE, SIDE, 3) and out.dtype == np.uint8 and int(out.sum()) > 0
    assert stats["devices"] == {"data": 4, "model": 2}
    assert eng._ready_specs and all(s.batch % 4 == 0 for s, _ in eng._ready_specs)


def test_engine_mesh_serves_ref_mode(tiny):
    """Reference-mode streams run sharded too: one reference program a data
    row behind the same split."""
    from videosd_tpu_torch.runtime.engine import Engine

    _, pb = tiny
    eng = Engine(ServerConfig(gpus=8), bundle=pb, max_streams=2, max_batch=8, deadline_ms=5,
                 frame_hw=(SIDE, SIDE), devices=CPU8)
    out, stats = _serve_one(eng, {"ref": True})
    assert eng.telemetry.frames_out >= 1 and int(out.sum()) > 0
    assert any(rm for _, rm in eng._ready_specs)
    assert all(s.batch % 8 == 0 for s, _ in eng._ready_specs)
    assert stats["devices"] == {"data": 8, "model": 1}


def test_engine_mesh_swap_replaces_placed_weights(tiny):
    """``swap_params`` under a mesh copies the new weights into every data
    row's placed copies: a dispatched batch then equals the single-device
    program on the new weights."""
    from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec
    from videosd_tpu_torch.runtime.engine import Engine

    _, pb = tiny
    eng = Engine(ServerConfig(gpus=4, mesh_model=2), bundle=_cloned(pb), frame_hw=(SIDE, SIDE),
                 devices=CPU8[:4])
    spec = FrameSpec(batch=2, height=SIDE, width=SIDE, in_height=SIDE, in_width=SIDE, steps=1)
    other = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu", seed=9)
    frame, s, g, c, seeds = _args(2)
    emb = torch.randn(2, 77, 32, generator=torch.Generator().manual_seed(2))
    before = eng._run_bucket_sync(spec, False, frame, None, emb, s, g, c, seeds)[0]
    eng.swap_params({n: m.state_dict() for n, m in other.models.items()}, source="other")
    after = eng._run_bucket_sync(spec, False, frame, None, emb, s, g, c, seeds)[0]
    want = P.build_frame_program(other, spec)(frame, emb, s, g, c, seeds)[0].numpy()
    assert np.abs(after.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(before.astype(int) - want.astype(int)).max() > 1


def test_engine_mesh_falls_back_when_devices_missing(caplog):
    """``gpus`` above the devices degrades loudly, to the devices there are."""
    from videosd_tpu_torch.runtime.engine import Engine

    eng = Engine(ServerConfig(gpus=16, family="tiny", dtype="float32", weights="random"),
                 frame_hw=(SIDE, SIDE), device="cpu", devices=CPU8)
    with caplog.at_level(logging.WARNING, logger="videosd_tpu_torch.engine"):
        mesh = eng.mesh
    assert mesh is not None and mesh.shape["data"] * mesh.shape["model"] == 8
    assert any("gpus=16 but only 8 device(s) exist; serving on 8" in r.getMessage()
               for r in caplog.records)
    assert eng.stats()["devices"] == {"data": 8, "model": 1}
