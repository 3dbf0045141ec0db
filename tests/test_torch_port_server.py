"""The port's server on the CPU: the counterparts of ``tests/test_server.py``
over ``videosd_tpu_torch.server`` with a tiny fp32 engine (``device="cpu"``,
32² frames, ``max_batch`` 2), each under its JAX name, plus the
transport-free protocol (``server/protocol.py``) and the wire pieces held
against the JAX server's on the same bytes.

Left out (ROADMAP.md): ``test_ws_full_stack_on_8_device_mesh`` (one engine
drives one card; mesh serving is queue 1 item 4) and
``test_warm_spec_subprocess_cache_handoff`` (``tools/warm_spec.py`` is not
ported).

A whole server reply is not held against the JAX server's: the noise is
drawn from the JAX package's Threefry bits, which the port does not carry
(its frames draw theirs from ``torch.Generator``; the pipeline tests feed
JAX's noise through the program's noise seam instead).
"""

import asyncio
import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from videosd_tpu_torch.config import ServerConfig

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)


def _tiny_engine(cfg=None, **kw):
    from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle
    from videosd_tpu_torch.runtime.engine import Engine

    bundle = ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    args = dict(max_streams=4, max_batch=2, deadline_ms=5, frame_hw=(32, 32))
    args.update(kw)
    return Engine(cfg or ServerConfig(), bundle=bundle, **args)


async def _make_client(engine=None, cfg=None):
    from videosd_tpu_torch.server.app import create_app

    app = create_app(cfg or ServerConfig(), engine=engine or _tiny_engine())
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def _init(**options):
    return json.dumps({"type": "init", "options": {"height": 32, "width": 32, "steps": 1,
                                                   **options}})


def _raw(frame):
    return struct.pack("<HH", *frame.shape[:2]) + frame.tobytes()


def _jpeg(frame, quality=90):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def test_healthz_and_stats():
    async def run():
        client = await _make_client()
        try:
            r = await client.get("/healthz")
            assert r.status == 200 and (await r.json())["ok"]
            r = await client.get("/stats")
            stats = await r.json()
            assert "frames_in" in stats and "avg_gen_time_s" in stats
            assert stats["jpeg_codec"] in ("native", "pil")
        finally:
            await client.close()

    asyncio.run(run())


def test_cors_headers():
    async def run():
        client = await _make_client()
        try:
            r = await client.get("/healthz")
            assert r.headers["Access-Control-Allow-Origin"] == "*"
            r = await client.options("/healthz")
            assert r.headers["Access-Control-Allow-Origin"] == "*"
        finally:
            await client.close()

    asyncio.run(run())


def test_offer_schema_without_aiortc():
    """POST /offer keeps the {sdp,type,options} schema; without aiortc it
    answers 501 with a pointer to /ws."""
    from videosd_tpu_torch.server.app import HAVE_AIORTC

    async def run():
        client = await _make_client()
        try:
            r = await client.post("/offer", json={"sdp": "v=0", "type": "offer", "options": {}})
            if HAVE_AIORTC:
                assert r.status in (200, 500)
            else:
                assert r.status == 501
                assert "ws" in (await r.json())["error"]
        finally:
            await client.close()

    asyncio.run(run())


def test_ws_frame_roundtrip(rng):
    async def run():
        client = await _make_client()
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_str(_init())
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            await ws.send_bytes(_raw(frame))
            msg = await asyncio.wait_for(ws.receive(), timeout=180)
            assert msg.type.name == "BINARY"
            h, w = struct.unpack("<HH", msg.data[:4])
            out = np.frombuffer(msg.data[4:], np.uint8).reshape(h, w, 3)
            assert out.shape == (32, 32, 3)

            # live option update mid-stream (the data-channel protocol)
            await ws.send_str(json.dumps({"type": "prompt", "strength": "0.9"}))
            await ws.send_str(json.dumps({"type": "stats"}))
            smsg = await asyncio.wait_for(ws.receive_json(), timeout=30)
            assert smsg["type"] == "stats"
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())


def test_ws_jpeg_roundtrip(rng):
    """JPEG frames in (SOI-detected), JPEG blobs out when jpeg option set."""
    from PIL import Image

    async def run():
        client = await _make_client()
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_str(_init(jpeg=True))
            await ws.send_bytes(_jpeg(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)))
            msg = await asyncio.wait_for(ws.receive(), timeout=180)
            assert msg.type.name == "BINARY"
            assert msg.data[:2] == b"\xff\xd8"  # JPEG reply
            assert Image.open(io.BytesIO(msg.data)).size == (32, 32)

            # corrupt JPEG -> error, connection stays up
            await ws.send_bytes(b"\xff\xd8garbage")
            emsg = await asyncio.wait_for(ws.receive_json(), timeout=30)
            assert emsg["type"] == "error"
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())


def _scaled(bundle, f):
    """A copy of ``bundle`` whose models' tensors are scaled by ``f``."""
    import copy
    import dataclasses as dc

    models = {}
    for name, m in bundle.models.items():
        m = copy.deepcopy(m)
        with torch.no_grad():
            for t in m.state_dict().values():
                t.mul_(f)
        models[name] = m
    return dc.replace(bundle, models=models)


def test_reload_weights_endpoint(tmp_path, monkeypatch):
    """Live checkpoint hot-swap endpoint: bad asks 400 without touching the
    engine; a good ask loads off-loop and swaps the serving weights."""

    async def run():
        from videosd_tpu_torch.pipelines import lcm_img2img as L

        engine = _tiny_engine()
        ln = engine.bundle.models["clip"].text_model.final_layer_norm
        old = ln.weight.clone()
        client = await _make_client(engine)
        try:
            r = await client.get("/reload_weights")
            assert (await r.json())["weights_source"] is None

            r = await client.post("/reload_weights", json={"weights": "/no/such/dir"})
            assert r.status == 400
            torch.testing.assert_close(ln.weight, old, rtol=0, atol=0)

            r = await client.post("/reload_weights", data=b"not json")
            assert r.status == 400

            # success path: a fake loader returns a perturbed same-shape bundle
            snapdir = tmp_path / "ckpt"
            snapdir.mkdir()
            perturbed = _scaled(engine.bundle, 1.01)
            monkeypatch.setattr(L.ModelBundle, "from_pretrained",
                                classmethod(lambda cls, *a, **k: perturbed))
            r = await client.post("/reload_weights", json={"weights": str(snapdir)})
            body = await r.json()
            assert r.status == 200 and body["swapped"] is True
            assert body["weights_source"]["model_dir"] == str(snapdir)
            # copied into the serving modules, in place
            want = perturbed.models["clip"].text_model.final_layer_norm.weight
            torch.testing.assert_close(ln.weight, want, rtol=0, atol=0)
            assert engine.weights_source["model_dir"] == str(snapdir)
            r = await client.get("/stats")
            assert (await r.json())["weights_source"]["model_dir"] == str(snapdir)
        finally:
            await client.close()

    asyncio.run(run())


def test_reload_weights_live_swap_from_checkpoint(tmp_path, rng):
    """Full hot-swap path with a real fixture checkpoint: the tiny bundle's
    weights, perturbed, written through the port's plans and
    ``write_safetensors`` into a diffusers-layout dir; serve a frame, POST
    /reload_weights, and the next frame comes from the new weights, with no
    new program."""
    from videosd_tpu_torch.io import weights as W
    from videosd_tpu_torch.io.safetensors import write_safetensors
    from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle
    from videosd_tpu_torch.runtime.engine import Engine

    async def run():
        bundle = ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
        for sub, plan, model in (
            ("unet", W.unet_plan(bundle.unet_cfg), bundle.models["unet"]),
            ("text_encoder", W.clip_plan(bundle.clip_cfg), bundle.models["clip"]),
        ):
            os.makedirs(tmp_path / sub)
            sd = model.state_dict()
            write_safetensors(str(tmp_path / sub / "model.safetensors"),
                              {tk: (sd[tk] * 1.07).numpy() for _, tk, _ in plan})

        cfg = ServerConfig(family="tiny", dtype="float32")
        engine = Engine(cfg, bundle=bundle, max_streams=2, frame_hw=(32, 32))
        client = await _make_client(engine, cfg)
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_str(_init(seed=5))
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)

            async def real_reply():
                for _ in range(400):
                    before = engine.telemetry.frames_out
                    await ws.send_bytes(_raw(frame))
                    msg = await asyncio.wait_for(ws.receive(), timeout=300)
                    out = np.frombuffer(msg.data[4:], np.uint8).reshape(32, 32, 3)
                    if engine.telemetry.frames_out > before and out.std() > 0:
                        return out
                    await asyncio.sleep(0.2)
                raise TimeoutError("no real generation")

            out_a = await real_reply()
            compiled = len(engine._programs)
            r = await client.post("/reload_weights", json={"weights": str(tmp_path)})
            body = await r.json()
            assert r.status == 200 and body["swapped"], body
            out_b = await real_reply()
            assert np.abs(out_b.astype(int) - out_a.astype(int)).max() > 0
            assert len(engine._programs) == compiled
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())


def test_ws_raw_i420_upload(rng):
    """Raw packed-I420 uploads (h*w*3/2 payload): accepted by both engine
    modes (an rgb engine unpacks on the host, an i420 engine takes the
    packed layout); a misaligned packed payload is an error."""
    from videosd_tpu_torch.ops.preprocess import rgb_to_i420_host

    async def run_mode(input_format: str):
        engine = _tiny_engine()
        if input_format == "i420":
            engine.set_input_format("i420")
        client = await _make_client(engine, ServerConfig(input_format=input_format))
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_str(_init())
            packed = rgb_to_i420_host(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
            await ws.send_bytes(struct.pack("<HH", 32, 32) + packed.tobytes())
            msg = await asyncio.wait_for(ws.receive(), timeout=180)
            assert msg.type.name == "BINARY"
            assert struct.unpack("<HH", msg.data[:4]) == (32, 32)
            st = next(iter(engine.streams.values()))
            assert st.in_hw == (32, 32)
            assert st.ref_frame.ndim == 3  # ref is RGB either way

            await ws.send_bytes(struct.pack("<HH", 30, 32) + b"\x00" * (30 * 32 * 3 // 2))
            emsg = await asyncio.wait_for(ws.receive_json(), timeout=30)
            assert emsg["type"] == "error"
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run_mode("rgb"))
    asyncio.run(run_mode("i420"))


def test_ws_bad_frame_size():
    async def run():
        client = await _make_client()
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_bytes(struct.pack("<HH", 32, 32) + b"\x00" * 10)
            msg = await asyncio.wait_for(ws.receive_json(), timeout=30)
            assert msg == {"type": "error", "error": "bad frame size"}
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())


# ------------------------------------------------------------- promptgen


def test_promptgen_invoke_wire_format():
    from videosd_tpu_torch.promptgen.app import create_app as mk_pg

    async def run():
        client = TestClient(TestServer(mk_pg()))
        await client.start_server()
        try:
            r = await client.post("/llama-chat/invoke", json={"input": {"text": "a red fox"}})
            assert r.status == 200
            body = await r.json()
            assert "output" in body and "a red fox" in body["output"]["text"]
            # deterministic per subject
            r2 = await client.post("/llama-chat/invoke", json={"input": {"text": "a red fox"}})
            assert (await r2.json())["output"] == body["output"]
        finally:
            await client.close()

    asyncio.run(run())


def test_promptgen_template_backend_styles():
    from videosd_tpu_torch.promptgen.app import TemplateBackend

    b = TemplateBackend()
    assert b.generate("a castle").startswith("a castle, ")
    assert b.generate("a castle", seed=1) != b.generate("a castle", seed=2)


def test_promptgen_llama2_chain_matches_reference_template():
    """The chat chain renders the reference's template messages in Llama-2
    chat format: the system prompt folded into the first [INST] block, the
    one-shot example as a completed turn, the subject as the open turn."""
    from videosd_tpu_torch.promptgen.app import (
        ONE_SHOT,
        SAMPLING,
        SYSTEM_PROMPT,
        build_llama2_chat_prompt,
    )

    assert build_llama2_chat_prompt("A red fox") == (
        f"<s>[INST] <<SYS>>\n{SYSTEM_PROMPT}\n<</SYS>>\n\n"
        f"{ONE_SHOT[0][0]} [/INST] {ONE_SHOT[0][1]} </s>"
        "<s>[INST] A red fox [/INST]"
    )
    assert "image prompt generator" in SYSTEM_PROMPT
    assert "Keep your response within 20 words" in SYSTEM_PROMPT
    assert ONE_SHOT[0][0] == "A landscape"
    assert ONE_SHOT[0][1].startswith("A painting of a landscape")
    assert SAMPLING == {"max_new_tokens": 30, "temperature": 5.0, "top_k": 60, "top_p": 1.0}


def test_promptgen_discover_causal_lm(tmp_path):
    from videosd_tpu_torch.promptgen.app import discover_causal_lm

    assert discover_causal_lm(cache=str(tmp_path)) is None
    snap = tmp_path / "models--org--lm" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text(json.dumps({"architectures": ["LlamaForCausalLM"]}))
    other = tmp_path / "models--org--vae" / "snapshots" / "def"
    other.mkdir(parents=True)
    (other / "config.json").write_text(json.dumps({"architectures": ["AutoencoderKL"]}))
    assert discover_causal_lm(cache=str(tmp_path)) == str(snap)


def test_stt_session_wav_rendering():
    from videosd_tpu_torch.server.stt import STTSession

    s = STTSession(whisper_url="http://localhost:1/asr")
    s.start()
    assert s.recording
    s.add_frame(np.zeros((2, 480), np.int16), sample_rate=48000)
    s.add_frame(np.ones(480, np.float32) * 0.5, sample_rate=48000)
    assert s._render_wav()[:4] == b"RIFF"

    async def run():
        text = await s.stop_and_transcribe()
        assert text.startswith("[stt unavailable")
        assert not s.recording

    asyncio.run(run())


def test_stt_local_fallback_used_when_sidecar_unreachable():
    """Sidecar down + a local model: the transcript comes from the local
    model (audio handed over as float mono at the captured rate)."""
    from videosd_tpu_torch.server.stt import STTSession

    seen = {}

    def fake_model(audio, rate):
        seen["n"], seen["rate"] = len(audio), rate
        return "hello world"

    s = STTSession(whisper_url="http://localhost:1/asr", local_model=fake_model)
    s.start()
    s.add_frame(np.ones(480, np.float32) * 0.25, sample_rate=48000)

    async def run():
        assert await s.stop_and_transcribe() == "hello world"
        assert seen == {"n": 480, "rate": 48000}

    asyncio.run(run())


def test_stt_resample_length():
    from videosd_tpu_torch.server.stt import _resample

    assert len(_resample(np.zeros(48000, np.float32), 48000, 16000)) == 16000
    assert _resample(np.zeros(0, np.float32), 48000, 16000).size == 1


def test_profile_endpoint_captures_trace(tmp_path, rng):
    """POST /profile traces while a stream runs and answers the summary,
    with its rollup by block (the CPU trace: host operators)."""

    async def run():
        engine = _tiny_engine()
        client = await _make_client(engine)
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_str(_init())
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            for _ in range(400):  # until the bucket is warm
                await ws.send_bytes(_raw(frame))
                await asyncio.wait_for(ws.receive(), timeout=180)
                if engine.telemetry.frames_out:
                    break
                await asyncio.sleep(0.2)

            async def traffic():
                for _ in range(3):
                    await ws.send_bytes(_raw(frame))
                    await asyncio.wait_for(ws.receive(), timeout=180)

            r, _ = await asyncio.gather(
                client.post(f"/profile?seconds=1&dir={tmp_path}/trace"), traffic())
            assert r.status == 200
            body = await r.json()
            assert body["trace_dir"].endswith("trace")
            assert os.path.isdir(body["trace_dir"])
            assert "ops" in body["summary"] or "error" in body["summary"]
            assert "by_block" in body["summary"]
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())


def test_debug_memory_endpoint():
    """tracemalloc ops endpoint: start -> top (diff vs baseline) -> stop."""

    async def run():
        client = await _make_client()
        try:
            r = await client.get("/debug/memory")
            assert "error" in (await r.json())  # not tracing yet
            r = await client.get("/debug/memory?action=start")
            assert (await r.json())["ok"]
            _ = bytearray(512 * 1024)  # some growth to report
            r = await client.get("/debug/memory")
            body = await r.json()
            assert "top" in body and isinstance(body["top"], list)
            r = await client.get("/debug/memory?action=stop")
            assert (await r.json())["ok"]
        finally:
            await client.close()

    asyncio.run(run())


def test_ws_i420_output_mode(rng):
    """config output_format: i420 — batches leave the device packed (the
    stream's last_output is 2-D planar), yet both reply formats are
    unchanged on the wire: raw replies are RGB24, jpeg replies decode at
    the stream size."""
    from PIL import Image

    async def run():
        engine = _tiny_engine()
        engine.output_format = "i420"
        client = await _make_client(engine, ServerConfig(output_format="i420"))
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_str(_init())
            for _ in range(40):
                frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
                await ws.send_bytes(_raw(frame))
                msg = await asyncio.wait_for(ws.receive(), timeout=180)
                assert msg.type.name == "BINARY"
                h, w = struct.unpack("<HH", msg.data[:4])
                assert np.frombuffer(msg.data[4:], np.uint8).reshape(h, w, 3).shape == (32, 32, 3)
                st = next(iter(engine.streams.values()))
                if (st.last_output is not None and st.last_output.ndim == 2
                        and engine.telemetry.frames_out > 0 and st.last_output[:32].std() > 0):
                    break
                await asyncio.sleep(0.25)
            st = next(iter(engine.streams.values()))
            assert st.last_output.ndim == 2  # device output is packed
            assert st.last_output.shape == (48, 32)

            # jpeg replies ride the raw-YCbCr encoder
            await ws.send_str(json.dumps({"type": "prompt", "jpeg": True}))
            await ws.send_bytes(_raw(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)))
            msg = await asyncio.wait_for(ws.receive(), timeout=180)
            assert msg.data[:2] == b"\xff\xd8"
            assert Image.open(io.BytesIO(msg.data)).size == (32, 32)
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())


def test_debug_engine_endpoint():
    """Runtime format toggles: GET reports, POST flips, bad values 400."""

    async def run():
        client = await _make_client()
        try:
            r = await client.get("/debug/engine")
            assert (await r.json())["output_format"] == "rgb"
            r = await client.post("/debug/engine", json={"output_format": "I420"})
            assert (await r.json())["output_format"] == "i420"
            app_engine = client.server.app["engine"]
            assert app_engine.output_format == "i420"
            r = await client.post("/debug/engine", json={"output_format": "bgr"})
            assert r.status == 400
            r = await client.post("/debug/engine", json={"output_format": "rgb"})
            assert (await r.json())["output_format"] == "rgb"
            r = await client.post("/debug/engine", json={"input_format": "i420"})
            assert (await r.json())["input_format"] == "i420"
            assert app_engine.input_format == "i420"
            assert app_engine._mailbox_shape()[0] == app_engine.frame_hw[0] * 3 // 2
            r = await client.post("/debug/engine", json={"input_format": "bgr"})
            assert r.status == 400
            r = await client.post("/debug/engine", json={"input_format": "rgb"})
            assert (await r.json())["input_format"] == "rgb"
        finally:
            await client.close()

    asyncio.run(run())


def test_fit_frame_i420_geometry():
    """Packed-plane mailbox fit: a smaller camera frame lands top-left in
    each plane with black padding, its extent reported even-aligned; RGB
    frames submitted to an i420 engine are host-packed first; larger ones
    center-crop per plane."""
    from videosd_tpu_torch.ops.preprocess import i420_to_rgb_host, rgb_to_i420_host
    from videosd_tpu_torch.runtime.engine import Engine

    eng = Engine(ServerConfig(input_format="i420"), max_streams=2, frame_hw=(64, 64),
                 device="cpu")
    assert eng._mailbox_shape() == (96, 64)

    rng = np.random.default_rng(2)
    base = rng.integers(40, 216, (4, 4, 3)).astype(np.float32)
    img = np.clip(np.stack([np.kron(base[..., c], np.ones((8, 12))) for c in range(3)], -1),
                  0, 255).astype(np.uint8)  # 32x48 smooth
    packed = rgb_to_i420_host(img)

    fitted, ext = eng._fit_frame(packed)
    assert fitted.shape == (96, 64) and ext == (32, 48)
    rgb = i420_to_rgb_host(fitted)
    assert np.abs(rgb[:32, :48].astype(np.float32) - img).mean() < 3.0
    assert rgb[40:, :].max() == 0 and rgb[:, 52:].max() == 0

    fitted2, ext2 = eng._fit_frame(img)
    np.testing.assert_array_equal(fitted2, fitted)
    assert ext2 == (32, 48)

    big = np.clip(np.stack([np.kron(base[..., c], np.ones((17, 18))) for c in range(3)], -1),
                  0, 255).astype(np.uint8)  # 68x72 smooth
    big_packed = rgb_to_i420_host(big)
    fitted3, ext3 = eng._fit_frame(big_packed)
    assert fitted3.shape == (96, 64) and ext3 == (64, 64)
    np.testing.assert_array_equal(fitted3[:64], big_packed[2:66, 4:68])
    crop = i420_to_rgb_host(fitted3).astype(np.float32)
    assert np.abs(crop - big[2:66, 4:68].astype(np.float32)).mean() < 6.0


def test_ws_i420_input_mode(rng):
    """config input_format: i420 — camera frames ride the packed mailbox and
    both the raw-RGB24 and the JPEG upload paths produce replies."""

    async def run():
        engine = _tiny_engine()
        engine.set_input_format("i420")
        client = await _make_client(engine, ServerConfig(input_format="i420"))
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_str(_init())
            got_real = False
            for _ in range(40):
                await ws.send_bytes(_raw(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)))
                msg = await asyncio.wait_for(ws.receive(), timeout=180)
                assert msg.type.name == "BINARY"
                h, w = struct.unpack("<HH", msg.data[:4])
                out = np.frombuffer(msg.data[4:], np.uint8).reshape(h, w, 3)
                assert out.shape == (32, 32, 3)
                st = next(iter(engine.streams.values()))
                if engine.telemetry.frames_out > 0 and st.last_input is not None and out.std() > 0:
                    got_real = True
                    break
                await asyncio.sleep(0.25)
            assert got_real
            st = next(iter(engine.streams.values()))
            assert st.last_input.ndim == 2 and st.last_input.shape == (48, 32)
            assert st.ref_frame.ndim == 3  # ref stays RGB

            # JPEG upload path (decode_i420)
            await ws.send_bytes(_jpeg(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), 85))
            msg = await asyncio.wait_for(ws.receive(), timeout=180)
            assert msg.type.name == "BINARY"
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())


def test_ws_model_option_full_stack(rng):
    """The live "model" option through the whole server: a stream on a
    `models:` registry entry gets that checkpoint's pixels, /stats reports
    the registry, and flipping back restores the default bit for bit (one
    program serves both)."""

    async def run():
        cfg = ServerConfig.from_dict(
            {"family": "tiny", "dtype": "float32", "weights": "random",
             "models": {"alt": "repo/alt"}})
        engine = _tiny_engine(cfg)
        engine.load_models()
        client = await _make_client(engine, cfg)
        try:
            ws = await client.ws_connect("/ws")
            await ws.send_str(_init(seed=7))
            payload = _raw(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))

            async def shot():
                last = None
                for _ in range(300):  # until the output is real and stable
                    await ws.send_bytes(payload)
                    msg = await asyncio.wait_for(ws.receive(), timeout=180)
                    assert msg.type.name == "BINARY"
                    out = np.frombuffer(msg.data[4:], np.uint8).reshape(32, 32, 3)
                    if last is not None and np.array_equal(out, last) and out.any():
                        return out
                    last = out
                    await asyncio.sleep(0.05)
                raise TimeoutError("no stable generation")

            out_def = await shot()
            await ws.send_str(json.dumps({"type": "prompt", "model": "alt"}))
            out_alt = await shot()
            assert np.abs(out_alt.astype(int) - out_def.astype(int)).max() > 0
            await ws.send_str(json.dumps({"type": "prompt", "model": ""}))
            np.testing.assert_array_equal(await shot(), out_def)
            r = await client.get("/stats")
            assert (await r.json())["models"] == {"alt": "loaded"}
            await ws.close()
        finally:
            await client.close()

    asyncio.run(run())


def test_pwa_shell_routes():
    """The PWA app shell serves: / (index with manifest link), /app.js,
    /sw.js at root scope, and the manifest and icon under /client/."""

    async def run():
        client = await _make_client()
        try:
            r = await client.get("/")
            html = await r.text()
            assert r.status == 200
            assert 'rel="manifest"' in html and "manifest.webmanifest" in html
            r = await client.get("/app.js")
            assert r.status == 200 and "serviceWorker" in await r.text()
            r = await client.get("/sw.js")
            assert r.status == 200 and "addEventListener" in await r.text()
            r = await client.get("/client/manifest.webmanifest")
            assert r.status == 200
            man = json.loads(await r.text())
            assert man["display"] == "standalone" and man["icons"]
            r = await client.get("/client/icon.svg")
            assert r.status == 200 and "<svg" in (await r.text())
        finally:
            await client.close()

    asyncio.run(run())


# ------------------------------------------------------------- the protocol alone


class _FakeStream:
    def __init__(self, sid, options):
        self.stream_id, self.options = sid, dict(options)


class _FakeEngine:
    """An engine's surface for a Session: each submitted frame resolves
    when the test sets its future."""

    input_format = "rgb"

    def __init__(self):
        self.pending: list[asyncio.Future] = []
        self.streams = {}

    def open_stream(self, options):
        st = _FakeStream(len(self.streams), options)
        self.streams[st.stream_id] = st
        return st

    def close_stream(self, sid):
        self.streams.pop(sid, None)

    async def submit_frame(self, sid, frame):
        fut = asyncio.get_running_loop().create_future()
        self.pending.append(fut)
        return await fut


def test_protocol_replies_in_order_when_a_later_frame_finishes_first():
    from videosd_tpu_torch.server.protocol import Session

    async def run():
        eng, sent = _FakeEngine(), []

        async def send(payload):
            sent.append(payload)

        s = Session(eng, send)
        frames = [np.full((4, 4, 3), i, np.uint8) for i in range(3)]
        for f in frames:
            await s.on_binary(_raw(f))
        await asyncio.sleep(0.01)  # the frames' tasks start
        assert len(eng.pending) == 3 and not sent
        eng.pending[2].set_result(frames[2])  # the last frame finishes first
        eng.pending[1].set_exception(RuntimeError("boom"))  # the middle one fails
        await asyncio.sleep(0.05)
        assert not sent  # held back behind frame 0
        eng.pending[0].set_result(frames[0])
        await s.drain()
        assert sent == [_raw(frames[0]), {"type": "error", "error": "frame failed"},
                        _raw(frames[2])]
        s.close()
        assert not eng.streams

    asyncio.run(run())


def test_protocol_backlog_cap_of_4():
    from videosd_tpu_torch.server.protocol import MAX_BACKLOG, Session

    async def run():
        eng, sent = _FakeEngine(), []

        async def send(payload):
            sent.append(payload)

        s = Session(eng, send)
        frame = np.zeros((4, 4, 3), np.uint8)
        for _ in range(MAX_BACKLOG):
            await s.on_binary(_raw(frame))
        fifth = asyncio.ensure_future(s.on_binary(_raw(frame)))
        await asyncio.sleep(0.05)
        assert MAX_BACKLOG == 4 and len(s.frame_tasks) == 4 and not fifth.done()
        assert len(eng.pending) == 4
        eng.pending[0].set_result(frame)
        await asyncio.wait_for(fifth, 5)  # in flight once one frame replied
        await asyncio.sleep(0.01)
        assert len(eng.pending) == 5 and len(sent) == 1
        for fut in eng.pending[1:]:
            fut.set_result(frame)
        await s.drain()
        assert len(sent) == 5
        # a bad size is refused before the cap is consulted
        await s.on_binary(struct.pack("<HH", 4, 4) + b"\x00")
        assert sent[-1] == {"type": "error", "error": "bad frame size"}

    asyncio.run(run())


# ------------------------------------------------------------- wire pieces vs JAX's


@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_jpeg_wire_pieces_equal_the_jax_servers(native, monkeypatch):
    """The port's JPEG decode and encode, and the raw reply framing, give
    the JAX server's arrays and bytes on the same input, with the same
    codec on both sides (the native libjpeg one, then PIL)."""
    from types import SimpleNamespace

    from videosd_tpu.runtime import jpegcodec as JJ
    from videosd_tpu.server import app as japp
    from videosd_tpu_torch.ops.preprocess import rgb_to_i420_host
    from videosd_tpu_torch.runtime import jpegcodec as PJ
    from videosd_tpu_torch.runtime.telemetry import StageTimers
    from videosd_tpu_torch.server import protocol as P

    if native and not (PJ.native_available() and JJ.native_available()):
        pytest.skip("no native libjpeg toolchain")
    if not native:
        for mod in (PJ, JJ):
            monkeypatch.setattr(mod, "_load", lambda: None)
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    packed = rgb_to_i420_host(rgb)
    for fmt in ("rgb", "i420"):
        eng = SimpleNamespace(input_format=fmt, telemetry=SimpleNamespace(stages=StageTimers()))
        for out in (rgb, packed):
            ours, theirs = P.jpeg_encode(out, eng), japp._jpeg_encode(out, eng)
            assert ours == theirs and ours[:2] == b"\xff\xd8"
            np.testing.assert_array_equal(P.jpeg_decode(ours, eng), japp._jpeg_decode(ours, eng))
    blob = _jpeg(rgb)
    for fn in ("decode_rgb", "decode_i420"):
        np.testing.assert_array_equal(getattr(PJ, fn)(blob), getattr(JJ, fn)(blob))
    assert P.is_jpeg(blob) and not P.is_jpeg(_raw(rgb))
    # the raw framing the JAX handler builds inline: header + RGB24
    assert P.frame_reply(rgb, None) == struct.pack("<HH", 48, 64) + rgb.tobytes()
    np.testing.assert_array_equal(P.parse_raw_frame(_raw(rgb), "rgb"), rgb)
    assert P.parse_options({"strength": "0.5"}) == japp._parse_ws_options({"strength": "0.5"})
