"""The frame program's CUDA graphs on the card.

``build_frame_program`` captures one CUDA graph per call signature at its
first call and replays it after.  A capture needs the card, so every test
here is marked ``cuda`` and skips without one.  The file imports neither
JAX nor the JAX package::

    python -m pytest --noconftest -m cuda tests/test_torch_port_graph_cuda.py

The committed tiny checkpoint runs in fp32 at 128x128, where its routed
attentions launch K1's fp32 kernel inside the graph; replays are held to
the eager ``frame_program`` bit for bit, and the reference program's
(whose banked self-attentions read twice the keys) to the eager
``reference_frame_program``.  Also: K1 in bf16 at the reference mode's
banked shapes and at the sd21 and SDXL frames' (heads of 64) against its plain
version, the sd21 topology cut to tiny widths and a random tiny-xl bundle
(replay against eager), one
tick of the serving engine over two streams, and two server protocol
sessions over a card engine.  The last test makes a capture fail on
purpose, so it runs last.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from videosd_tpu_torch.ops.cuda import flash_attention as FA
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.pipelines import reference_attn as R

CKPT = os.path.join(os.path.dirname(__file__), os.pardir, "examples", "toy_tiny_ckpt")
ARGS = ([0.6, 0.3], [5.0, 3.0], [2.0, 0.5])


@pytest.fixture(scope="module")
def tiny():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured on the card")
    bundle = P.ModelBundle.from_dir(CKPT, device="cuda")
    embeds = P.build_prompt_encoder(bundle)(bundle.tokenizer(["a portrait", "a landscape"]))[0]
    return bundle, embeds


def _frames(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("temporal", [False, True], ids=["parity", "temporal"])
def test_replay_equals_eager_on_card(tiny, temporal):
    bundle, embeds = tiny
    spec = P.FrameSpec(batch=2, height=128, width=128, steps=2, deepcache_temporal=temporal)
    program = P.build_frame_program(bundle, spec)
    calls = [(_frames(seed), [seed, seed + 1]) for seed in (1, 2)]
    outs = [program(frame, embeds, *ARGS, seeds) for frame, seeds in calls]
    assert program.last_launches["flash_attention_fp32"] > 0  # K1's fp32 kernel is in the graph
    assert program.last_launches["flash_attention"] == 0
    for out, (frame, seeds) in zip(outs, calls):
        want = P.frame_program(bundle, spec, frame, embeds, *ARGS, seeds)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert not torch.equal(outs[0][1], outs[1][1])
    if temporal:  # the reuse signature is a graph of its own
        out = program(calls[0][0], embeds, *ARGS, calls[0][1], deep_caches=outs[0][2])
        want = P.frame_program(bundle, spec, calls[0][0], embeds, *ARGS, calls[0][1],
                               deep_caches=outs[0][2])
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        assert len(program.buckets) == 2


@pytest.mark.cuda
def test_reference_program_replay_equals_eager_on_card(tiny):
    bundle, embeds = tiny
    spec = P.FrameSpec(batch=2, height=128, width=128, steps=2, use_controlnet=False)
    program = R.build_reference_program(bundle, spec)
    ref = _frames(9)
    sf = [[1.0, 0.5], [0.3, 1.0]]
    calls = [(_frames(seed), [seed, seed + 1]) for seed in (4, 5)]
    outs = [program(frame, ref, embeds, *ARGS[:2], sf, seeds) for frame, seeds in calls]
    # per step: the WRITE pass's 3 routed attentions (down 0's one and up 1's
    # two, at 256 tokens), the READ pass's 3 plain and 3 banked (on 512 keys)
    assert program.last_launches["flash_attention_fp32"] == 2 * 9
    for out, (frame, seeds) in zip(outs, calls):
        want = R.reference_frame_program(bundle, spec, frame, ref, embeds, *ARGS[:2], sf, seeds)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert not torch.equal(outs[0][1], outs[1][1])


# the reference mode's banked self-attentions at sd15 512x512 (B, H, Sq, Sk, d):
# twice the keys of the plain ones
_K1_BANKED = [(1, 8, 4096, 8192, 40), (1, 8, 1024, 2048, 80), (1, 8, 256, 512, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _K1_BANKED, ids=lambda s: "x".join(map(str, s)))
def test_k1_banked_shapes_on_card(tiny, shape):
    b, h, sq, sk, d = shape
    gen = torch.Generator(device="cuda").manual_seed(sq)
    q, k, v = (torch.randn(b, n, h * d, generator=gen, device="cuda").bfloat16()
               for n in (sq, sk, sk))
    before = FA.launches
    out = FA.flash_attention(q, k, v, num_heads=h)
    torch.cuda.synchronize()
    assert FA.launches == before + 1

    def fold(x):
        return x.reshape(b, x.shape[1], h, d).transpose(1, 2).reshape(b * h, x.shape[1], d)

    ref = FA.flash_attention_reference(fold(q), fold(k), fold(v), d ** -0.5)
    ref = ref.reshape(b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d).float()
    err = (out.float() - ref).abs()
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    assert torch.isfinite(out).all()
    assert err.max().item() <= 2 * ulp  # two bf16 ulps of the largest output
    assert err.mean().item() <= ref.abs().mean().item() / 128


@pytest.mark.cuda
def test_engine_tick_of_two_streams_on_card(tiny):
    """Two streams into the engine over the tiny checkpoint: one batch of
    two, replayed from the bucket's CUDA graph, equal bit for bit to the
    frame program called directly with the batch's inputs."""
    from videosd_tpu_torch.runtime.engine import Engine

    bundle, _ = tiny
    eng = Engine(bundle=bundle, max_streams=2, max_batch=2, deadline_ms=5, frame_hw=(128, 128))
    eng.warmup(batch_sizes=(2,), steps=(2,), height=128, width=128)
    calls = []
    get_program = eng._get_program

    def spy(spec, *, ref_mode=False):  # records each program call of a batch
        program = get_program(spec, ref_mode=ref_mode)

        def call(*a, **kw):
            out = program(*a, **kw)
            calls.append((spec, a, kw, out))
            return out

        return call

    eng._get_program = spy
    frames = _frames(6).cpu().numpy()

    async def run():
        eng.start()
        try:
            sts = [eng.open_stream({"height": 128, "width": 128, "steps": 2, "seed": 7 + i,
                                    "prompt": f"p{i}"}) for i in range(2)]
            return await asyncio.wait_for(asyncio.gather(
                *[eng.submit_frame(st.stream_id, frames[i]) for i, st in enumerate(sts)]), 120)
        finally:
            await eng.stop()

    outs = asyncio.run(run())
    spec, args, kwargs, got = calls[-1]
    assert spec.batch == 2 and len(eng._programs) == 1
    (program,) = eng._programs.values()
    assert all(b.graph is not None for b in program.buckets.values())
    want = P.build_frame_program(bundle, spec)(*args, **kwargs)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, want[0][i].cpu().numpy())


# the sd21 frame's K1 shapes at 512x512 (B, H, Sq, Sk, d): heads of 64
_K1_SD21 = [(1, 5, 4096, 4096, 64), (1, 10, 1024, 1024, 64), (1, 20, 256, 256, 64)]
# the SDXL 1024x1024 frame's two shapes (10 and 20 heads of 64)
_K1_SDXL = [(1, 10, 4096, 4096, 64), (1, 20, 1024, 1024, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _K1_SD21, ids=lambda s: "x".join(map(str, s)))
def test_k1_sd21_shapes_on_card(tiny, shape):
    test_k1_banked_shapes_on_card(tiny, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _K1_SDXL, ids=lambda s: "x".join(map(str, s)))
def test_k1_sdxl_shapes_on_card(tiny, shape):
    test_k1_banked_shapes_on_card(tiny, shape)


@pytest.mark.cuda
def test_sd21_tiny_width_program_replay_equals_eager_on_card(tiny):
    """The sd21 topology (heads by dim, linear projections, no guidance
    embedding) cut to widths (32, 64), heads of 8, context 64, in bf16 at
    128x128: its 256-token attentions launch K1 (d = 8) inside the graph,
    and two replays equal the eager frame_program bit for bit."""
    import dataclasses

    from videosd_tpu_torch.models import (
        CLIP_PRESETS,
        UNET_PRESETS,
        CLIPTextModel,
        ControlNetModel,
        UNet2DConditionModel,
    )

    cfg = dataclasses.replace(UNET_PRESETS["sd21"], block_out_channels=(32, 64),
                              attn_down=(True, False), transformer_depth=(1, 1),
                              attention_head_dim=8, cross_attention_dim=64, norm_num_groups=8)
    clip_cfg = dataclasses.replace(CLIP_PRESETS["sd21"], vocab_size=1000, hidden_size=64,
                                   num_layers=1, num_heads=4, intermediate_size=128)
    base = P.ModelBundle.random("tiny", dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    models = dict(base.models)
    for name, ctor in (("unet", lambda: UNet2DConditionModel(cfg)),
                       ("controlnet", lambda: ControlNetModel(cfg)),
                       ("clip", lambda: CLIPTextModel(clip_cfg))):
        models[name] = ctor().to(device="cuda", dtype=torch.bfloat16).eval()
        P.init_like_jax(models[name], gen)
    bundle = dataclasses.replace(base, family="sd21", unet_cfg=cfg, clip_cfg=clip_cfg,
                                 models=models)
    embeds = P.build_prompt_encoder(bundle)(bundle.tokenizer(["a fox", "a castle"]))[0]
    spec = P.FrameSpec(batch=2, height=128, width=128, steps=2)
    program = P.build_frame_program(bundle, spec)
    calls = [(_frames(seed), [seed, seed + 1]) for seed in (1, 2)]
    outs = [program(frame, embeds, *ARGS, seeds) for frame, seeds in calls]
    assert program.last_launches["flash_attention"] > 0
    for out, (frame, seeds) in zip(outs, calls):
        want = P.frame_program(bundle, spec, frame, embeds, *ARGS, seeds)
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
def test_tiny_xl_program_replay_equals_eager_on_card(tiny):
    """A random tiny-xl bundle (SDXL's text_time topology, two text towers)
    in bf16 at 256x256, ControlNet on: its 256-token attentions launch K1
    (d = 16) inside the graph, the time ids are filled on the device in
    the capture, and two replays equal the eager frame_program bit for
    bit."""
    bundle = P.ModelBundle.random("tiny-xl", dtype=torch.bfloat16, device="cuda")
    embeds, pooled = P.build_prompt_encoder(bundle)(bundle.tokenizer(["a fox", "a castle"]))
    spec = P.FrameSpec(batch=2, height=256, width=256, steps=2)
    program = P.build_frame_program(bundle, spec)
    rng = np.random.default_rng(17)
    calls = [(torch.from_numpy(rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)).cuda(),
              [seed, seed + 1]) for seed in (1, 2)]
    outs = [program(frame, embeds, *ARGS, seeds, pooled_embeds=pooled) for frame, seeds in calls]
    assert program.last_launches["flash_attention"] > 0
    for out, (frame, seeds) in zip(outs, calls):
        want = P.frame_program(bundle, spec, frame, embeds, *ARGS, seeds, pooled_embeds=pooled)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert not torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
def test_protocol_session_of_two_streams_on_card(tiny):
    """Two protocol sessions (the per-connection code of the server's /ws)
    over a card engine on the tiny checkpoint: every reply is the RGB24
    framing of what the engine returned for that frame, in the order sent."""
    import json
    import struct

    from videosd_tpu_torch.runtime.engine import Engine
    from videosd_tpu_torch.server.protocol import Session, frame_reply

    bundle, _ = tiny
    eng = Engine(bundle=bundle, max_streams=2, max_batch=2, deadline_ms=5, frame_hw=(128, 128))
    eng.warmup(batch_sizes=(1, 2), steps=(2,), height=128, width=128)
    outputs = {0: [], 1: []}
    submit = eng.submit_frame

    async def spy(sid, frame):
        slot = len(outputs[sid])
        outputs[sid].append(None)
        outputs[sid][slot] = await submit(sid, frame)
        return outputs[sid][slot]

    eng.submit_frame = spy
    frames = _frames(8).cpu().numpy()

    async def run():
        eng.start()
        try:
            got = {0: [], 1: []}

            def sender(i):
                async def send(payload):
                    got[i].append(payload)
                return send

            sessions = [Session(eng, sender(i)) for i in range(2)]
            for i, s in enumerate(sessions):
                await s.on_text(json.dumps({"type": "init", "options": {
                    "height": 128, "width": 128, "steps": 2, "seed": 3 + i}}))
            for n in range(3):
                for i, s in enumerate(sessions):
                    img = np.ascontiguousarray(np.roll(frames[i], 4 * n, 1))
                    await s.on_binary(struct.pack("<HH", 128, 128) + img.tobytes())
            for s in sessions:
                await asyncio.wait_for(s.drain(), 120)
                s.close()
            return got
        finally:
            await eng.stop()

    got = asyncio.run(run())
    for i in range(2):
        assert len(got[i]) == 3
        assert got[i] == [frame_reply(out, eng) for out in outputs[i]]


@pytest.mark.cuda
def test_capture_failure_names_the_hook_on_card(tiny):
    """A safety hook that reads a value back to the host cannot be captured:
    the program raises, naming the hook, and does not fall back to the
    eager program."""
    bundle, embeds = tiny

    def syncing_hook(images):
        return images * float(images.abs().max().item() > 0)

    hooked = P.ModelBundle(**{**vars(bundle), "safety_hook": syncing_hook})
    program = P.build_frame_program(hooked, P.FrameSpec(batch=2, height=64, width=64, steps=2))
    frame = _frames(3)[:, :64, :64].contiguous()
    with pytest.raises(RuntimeError, match="safety_hook.*syncing_hook"):
        program(frame, embeds, *ARGS, [1, 2])
