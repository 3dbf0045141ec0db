"""The port's serving engine on the CPU: counterparts of the engine cases of
``tests/test_runtime.py`` over ``videosd_tpu_torch.runtime`` with a tiny
fp32 bundle (``device="cpu"``: every program runs eagerly; on a card each
bucket is a CUDA graph).  The cases of the copies (FrameQueue, EMA,
pacing, telemetry, DispatchWorker) are in ``test_torch_port_copies.py``.
Left out until their ports (ROADMAP.md queue 1): the two SDXL cases and
the HLO-symbol profile case.  The JAX engine is not run here.

Scheduler contract as the JAX engine's: latest-frame-wins dropping, EMA
pacing, live option mutation, cold buckets served by the nearest ready
one while they warm up in the background.
"""

import asyncio

import numpy as np
import pytest
import torch

from videosd_tpu_torch.config import ServerConfig
from videosd_tpu_torch.ops.preprocess import center_crop_box
from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec, ModelBundle, build_frame_program
from videosd_tpu_torch.runtime.engine import Engine

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)


def _bundle():
    return ModelBundle.random("tiny", dtype=torch.float32, device="cpu")


def _mk_engine():
    return Engine(
        bundle=_bundle(), max_streams=4, max_batch=4, deadline_ms=5, frame_hw=(32, 32)
    )


def _np(t):
    return t.float().cpu().numpy()


async def _first_real(eng, st, frame, timeout=300.0):
    """Submit ``frame`` until the engine has produced at least one REAL
    generation (a cold engine passes frames through as the black init
    frame while the bucket compiles in the background — the reference's
    model-loading behavior, server.py:99,122) and return the output."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    while True:
        before = eng.telemetry.frames_out
        out = await asyncio.wait_for(
            eng.submit_frame(st.stream_id, frame), timeout
        )
        if eng.telemetry.frames_out > before:
            return out
        if loop.time() - t0 > timeout:
            raise TimeoutError("no real generation before timeout")
        await asyncio.sleep(0.2)


def test_engine_single_stream_end_to_end(rng):
    async def run():
        eng = _mk_engine()
        eng.start()
        try:
            st = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            out = await _first_real(eng, st, frame)
            assert out.shape == (32, 32, 3) and out.dtype == np.uint8
            stats = eng.stats()
            assert stats["frames_out"] >= 1
            # the engine's output is the frame program's on the same inputs
            spec = FrameSpec(batch=1, height=32, width=32, in_height=32, in_width=32, steps=1)
            want, _ = build_frame_program(eng.bundle, spec)(
                frame[None], eng._encode_prompt(st.options["prompt"])[0], [0.6], [5.0], [2.0],
                [st.options["seed"]], warm_latents=np.zeros((1, 4, 4, 4), np.float32),
                warm_alpha=[0.0], src_box=[[0, 0, 32, 32]])
            np.testing.assert_array_equal(out, want[0].numpy())
        finally:
            await eng.stop()

    asyncio.run(run())


def test_engine_config_safety_blackout(rng):
    """config safety: true wires the built-in classifier through the
    engine's serving programs — a flagged frame comes back black through
    the FULL stack (mailbox -> program -> reply).  threshold=-1 flags
    every output (random-init outputs have no controllable skin tone)."""
    async def run():
        cfg = ServerConfig(
            family="tiny",
            dtype="float32",
            weights="random",
            safety=True,
            safety_threshold=-1.0,
            frame_hw=(32, 32),
        )
        eng = Engine(cfg, max_streams=2, max_batch=2, deadline_ms=5, device="cpu")
        assert eng.bundle.safety_hook is not None
        eng.start()
        try:
            st = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            out = await _first_real(eng, st, frame)
            assert int(out.sum()) == 0  # blacked out
        finally:
            await eng.stop()

    asyncio.run(run())


def test_engine_live_weight_swap(rng):
    """swap_params under live serving: same-shape state dicts swap with no
    new programs and change the output; mismatched ones are rejected before
    anything changes."""

    async def run():
        eng = _mk_engine()
        eng.start()
        try:
            st = eng.open_stream(
                {"height": 32, "width": 32, "steps": 1, "seed": 7}
            )
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            out_a = await _first_real(eng, st, frame)
            compiled = len(eng._programs)

            # perturb every unet tensor (same shapes/dtypes): a valid swap
            new_params = {n: m.state_dict() for n, m in eng.bundle.models.items()}
            new_params["unet"] = {k: v * 1.05 for k, v in new_params["unet"].items()}
            eng.swap_params(new_params, source="perturbed")
            assert eng.weights_source == "perturbed"
            assert len(eng._prompt_cache) == 0  # text tower may have changed

            out_b = await _first_real(eng, st, frame)
            assert out_b.shape == out_a.shape
            assert np.abs(
                out_b.astype(np.int32) - out_a.astype(np.int32)
            ).max() > 0, "swap did not change the serving weights"
            assert len(eng._programs) == compiled  # zero recompiles

            # wrong structure -> rejected, serving params untouched
            with pytest.raises(ValueError):
                eng.swap_params({"unet": new_params["unet"]})
            # wrong shape -> rejected
            bad = dict(new_params)
            bad["unet"] = {k: torch.zeros(2, 2) for k in new_params["unet"]}
            with pytest.raises(ValueError):
                eng.swap_params(bad)
            out_c = await _first_real(eng, st, frame)
            np.testing.assert_array_equal(out_c, out_b)  # still serving B
        finally:
            await eng.stop()

    asyncio.run(run())


def test_engine_multi_stream_batching(rng):
    async def run():
        eng = _mk_engine()
        eng.start()
        try:
            sts = [
                eng.open_stream({"height": 32, "width": 32, "steps": 1, "prompt": f"p{i}"})
                for i in range(3)
            ]
            frames = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in sts]
            # cold engine: warm the single-stream bucket first, then the
            # multi-stream gather chunks onto it while its own bucket warms
            await _first_real(eng, sts[0], frames[0])
            outs = await asyncio.wait_for(
                asyncio.gather(
                    *[eng.submit_frame(s.stream_id, f) for s, f in zip(sts, frames)]
                ),
                timeout=180,
            )
            assert all(o.shape == (32, 32, 3) for o in outs)
        finally:
            await eng.stop()

    asyncio.run(run())


def test_engine_prompt_interpolation():
    """prompt_blend_frames crossfades embeddings on prompt change
    (BASELINE config 5): starts at the old embedding, converges to the
    new one, monotonically."""
    eng = _mk_engine()
    st = eng.open_stream({"prompt": "a cat", "prompt_blend_frames": 3})
    e_cat = _np(eng._stream_embeds(st)[0])
    e_cat2 = _np(eng._stream_embeds(st)[0])
    np.testing.assert_array_equal(e_cat, e_cat2)  # stable without change

    eng.update_options(st.stream_id, {"prompt": "a dog"})
    e_dog = _np(eng._encode_prompt("a dog")[0])
    seq = [_np(eng._stream_embeds(st)[0]) for _ in range(5)]
    # frame 0 of the blend equals the old embedding; then moves toward new
    np.testing.assert_allclose(seq[0], e_cat, atol=1e-6)
    d = [float(np.linalg.norm(s - e_dog)) for s in seq]
    assert d[0] > d[1] > d[2]
    np.testing.assert_allclose(seq[3], e_dog, atol=1e-6)  # blend done
    np.testing.assert_allclose(seq[4], e_dog, atol=1e-6)

    # blend disabled -> hard cut
    st2 = eng.open_stream({"prompt": "a cat"})
    eng._stream_embeds(st2)
    eng.update_options(st2.stream_id, {"prompt": "a dog"})
    np.testing.assert_allclose(
        _np(eng._stream_embeds(st2)[0]), e_dog, atol=1e-6
    )


def test_phase_split_sync_clients_remerge_into_full_batches(rng):
    """When service time dominates (the chip regime), synchronous clients
    whose phases have drifted apart must RE-MERGE: while a batch is in
    flight, new arrivals are held (accumulating is free — the device is
    busy), so within a service cycle the cohort batches together again.
    A fixed 10 ms cut split them permanently (measured 7 vs 16 aggregate
    FPS at 4 sync streams).  With an idle device, partial batches still
    dispatch immediately (no added latency for single streams)."""
    import time as _time

    async def run():
        eng = _mk_engine()
        eng.warmup(batch_sizes=(1, 2, 4), steps=(1,), height=32, width=32)
        served: list[int] = []
        orig = eng._run_bucket_sync

        def spy(spec, ref_mode, *a, **k):
            served.append(spec.batch)
            _time.sleep(0.25)  # slow service: the phase-split regime
            return orig(spec, ref_mode, *a, **k)

        eng._run_bucket_sync = spy
        eng.start()
        try:
            sts = [
                eng.open_stream(
                    {"height": 32, "width": 32, "steps": 1, "prompt": f"p{i}"}
                )
                for i in range(3)
            ]
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)

            async def sync_client(st, start_delay, n=6):
                await asyncio.sleep(start_delay)  # force phase separation
                for _ in range(n):
                    await eng.submit_frame(st.stream_id, frame)

            await asyncio.wait_for(
                asyncio.gather(
                    *[sync_client(st, i * 0.1) for i, st in enumerate(sts)]
                ),
                120,
            )
            # 18 frames total: without re-merge that is ~18 singleton
            # dispatches; with it, the cohort converges to full batches
            assert len(served) <= 12, served
            assert served.count(4) >= 3, served
        finally:
            await eng.stop()

    asyncio.run(run())


def test_camera_geometry_reaches_device_as_true_extent(rng):
    """A camera frame smaller than the mailbox must reach the program with
    its TRUE extent as the source box (center_crop_box of the real camera
    size — reference crops at full camera resolution,
    videopipeline.py:91-107), not the mailbox shape."""

    async def run():
        eng = Engine(
            bundle=_bundle(), max_streams=2, max_batch=2, deadline_ms=5,
            frame_hw=(48, 48),
        )
        boxes = []
        orig = eng._run_bucket_sync

        def spy(spec, ref_mode, *a, **k):
            boxes.append(np.array(a[10]))  # src_box position in run args
            return orig(spec, ref_mode, *a, **k)

        eng._run_bucket_sync = spy
        eng.start()
        try:
            st = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            # camera delivers 48x36 (w x h = 48 x 36): landscape
            frame = rng.integers(0, 256, (36, 48, 3), dtype=np.uint8)
            await _first_real(eng, st, frame)
            left, top, right, bottom = center_crop_box(48, 36, 32, 32)
            expected = (top, left, bottom - top, right - left)
            assert any(tuple(b[0]) == expected for b in boxes), (
                boxes, expected,
            )
        finally:
            await eng.stop()

    asyncio.run(run())


def test_config_controls_mailbox():
    """ServerConfig.frame_hw drives the engine mailbox."""
    eng = Engine(ServerConfig(frame_hw=(64, 48)))
    assert eng.frame_hw == (64, 48)
    assert Engine(ServerConfig()).frame_hw == (768, 768)
    assert Engine(ServerConfig(), frame_hw=(32, 32)).frame_hw == (32, 32)


def test_prompt_cache_lru_eviction():
    """Cache pressure evicts ONE least-recently-used entry at a time — a
    wholesale clear would drop every active stream's embeddings at once
    and trigger a re-encode burst on the dispatch thread."""
    eng = _mk_engine()
    eng._prompt_cache_max = 4
    for i in range(4):
        eng._encode_prompt(f"p{i}")
    eng._encode_prompt("p0")  # LRU touch
    eng._encode_prompt("p4")  # must evict p1 (oldest untouched), only p1
    # cache keys are (model, prompt); "" = the default checkpoint
    assert ("", "p0") in eng._prompt_cache and ("", "p4") in eng._prompt_cache
    assert ("", "p1") not in eng._prompt_cache
    assert len(eng._prompt_cache) == 4


def test_prompt_blend_total_captured_at_fade_start():
    """The fade divisor is captured when the fade starts: a live change to
    prompt_blend_frames mid-fade must not jump the interpolant."""
    eng = _mk_engine()
    st = eng.open_stream({"prompt": "a", "prompt_blend_frames": 4})
    eng._stream_embeds(st)
    eng._encode_prompt("b")
    eng.update_options(st.stream_id, {"prompt": "b"})
    e_b = _np(eng._encode_prompt("b")[0])
    seq = [_np(eng._stream_embeds(st)[0])]
    st.options["prompt_blend_frames"] = 1  # slider moves mid-fade
    seq += [_np(eng._stream_embeds(st)[0]) for _ in range(4)]
    d = [float(np.linalg.norm(s.astype(np.float32) - e_b)) for s in seq]
    assert d[0] > d[1] > d[2] > d[3]  # smooth, no jump
    np.testing.assert_allclose(seq[4].astype(np.float32), e_b, atol=1e-5)


def test_stream_embeds_never_encodes_on_pack_race():
    """A prompt mutation between the dispatcher pre-encode and the pack
    loop must NOT run the encoder from the event-loop thread: the stream
    serves its previous embedding for one tick instead."""
    eng = _mk_engine()
    st = eng.open_stream({"prompt": "a"})
    first = eng._stream_embeds(st)
    st.options["prompt"] = "never-pre-encoded"

    def boom(*a, **k):  # the encoder must not be invoked on this path
        raise AssertionError("encoder ran on the event loop")

    eng._encoder = boom
    out = eng._stream_embeds(st)
    assert out is first
    assert "never-pre-encoded" not in eng._prompt_cache


def test_engine_resolution_snap():
    """resolution_buckets bounds compiled-program count: requests snap to
    the nearest bucket; empty buckets = exact sizes (reference parity)."""
    eng = Engine(ServerConfig(resolution_buckets=((512, 512), (768, 768))))
    assert eng._snap_resolution(500, 500) == (512, 512)
    assert eng._snap_resolution(768, 512) == (512, 512)  # nearest by area
    assert eng._snap_resolution(720, 720) == (768, 768)
    assert eng._snap_resolution(1024, 1024) == (768, 768)
    eng2 = Engine(ServerConfig())
    assert eng2._snap_resolution(320, 240) == (320, 240)


def test_engine_stream_slots_recycle():
    """Closed streams return their mailbox slot: a long-running server must
    accept unlimited SEQUENTIAL sessions with a bounded concurrent pool."""
    async def run():
        eng = _mk_engine()  # max_streams=4
        for _ in range(10):
            st = eng.open_stream({})
            eng.close_stream(st.stream_id)
        # concurrent limit still enforced
        sts = [eng.open_stream({}) for _ in range(4)]
        import pytest

        with pytest.raises(RuntimeError):
            eng.open_stream({})
        for st in sts:
            eng.close_stream(st.stream_id)

    asyncio.run(run())


def test_engine_option_update_coercion():
    async def run():
        eng = _mk_engine()
        st = eng.open_stream({})
        eng.update_options(st.stream_id, {"strength": "0.8", "steps": "2"})
        assert st.options["strength"] == 0.8 and st.options["steps"] == 2
        st.last_output = np.ones((32, 32, 3), np.uint8)
        eng.update_options(st.stream_id, {"set_ref": True})
        np.testing.assert_array_equal(st.ref_frame, st.last_output)
        assert "set_ref" not in st.options
        await eng.stop()

    asyncio.run(run())


def test_engine_survives_program_failure(rng):
    """A raising frame program must not kill the batch loop (fault
    tolerance: the reference only had try/finally + watchdog resets)."""

    async def run():
        eng = _mk_engine()
        calls = {"n": 0}
        orig = eng._run_bucket_sync

        def flaky(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected failure")
            return orig(*a, **kw)

        eng._run_bucket_sync = flaky
        eng.start()
        try:
            st = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            # the first bucket warm hits the injected failure (resolved as
            # the black init frame); the engine must keep serving and the
            # retry must produce a real generation
            out = await _first_real(eng, st, frame)
            assert calls["n"] >= 2  # loop kept going and ran the real program
            assert out.shape == (32, 32, 3)
        finally:
            await eng.stop()

    asyncio.run(run())


def test_similarity_filter_skips_generation(rng):
    """StreamDiffusion-style skip: near-identical consecutive frames reuse
    the last output without a generation."""

    async def run():
        eng = _mk_engine()
        eng.start()
        try:
            st = eng.open_stream(
                {"height": 32, "width": 32, "steps": 1, "similarity_threshold": 0.05}
            )
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            out1 = await _first_real(eng, st, frame)
            gens = eng.telemetry.frames_out
            out2 = await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 10)
            assert eng.telemetry.frames_out == gens  # no new generation
            np.testing.assert_array_equal(out1, out2)
            # a very different frame does generate
            frame2 = 255 - frame
            await asyncio.wait_for(eng.submit_frame(st.stream_id, frame2), 120)
            assert eng.telemetry.frames_out > gens
        finally:
            await eng.stop()

    asyncio.run(run())


def test_warm_alpha_latents_reused(rng):
    async def run():
        eng = _mk_engine()
        eng.start()
        try:
            st = eng.open_stream(
                {"height": 32, "width": 32, "steps": 1, "warm_alpha": 0.5}
            )
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            await _first_real(eng, st, frame)
            assert st.last_latents is not None
            lat1 = _np(st.last_latents).copy()
            frame2 = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            await asyncio.wait_for(eng.submit_frame(st.stream_id, frame2), 120)
            lat2 = _np(st.last_latents)
            assert np.abs(lat1 - lat2).max() > 0
        finally:
            await eng.stop()

    asyncio.run(run())


def test_steps_change_serves_stale_program_while_compiling(rng):
    """A live steps change (fresh compile bucket) must not stall the stream:
    frames are served with the nearest ready program while the new bucket
    compiles in the background, then dispatch swaps over (the eager-GPU
    reference never stalls on slider moves, server.py:171-187)."""

    async def run():
        eng = _mk_engine()
        served: list[int] = []
        orig = eng._run_bucket_sync

        def spy(spec, ref_mode, *a, **k):
            served.append(spec.steps)
            return orig(spec, ref_mode, *a, **k)

        eng._run_bucket_sync = spy
        eng.start()
        try:
            st = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            await _first_real(eng, st, frame)
            assert set(served) == {1}

            # move the steps slider: a fresh bucket
            st.options["steps"] = 3
            await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 120)
            # dispatch used the ready steps=1 program; the steps=3 compile
            # went to the background (exactly one bg call sees steps=3)
            assert served.count(3) == 1 and served.count(1) >= 2, served

            # once the background compile lands, dispatch swaps to steps=3
            for _ in range(600):
                if not eng._compiling:
                    break
                await asyncio.sleep(0.5)
            assert not eng._compiling
            await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 120)
            assert served.count(3) >= 2, served
            assert eng.stats()["programs_compiled"] >= 2
        finally:
            await eng.stop()

    asyncio.run(run())


def test_resolution_change_serves_stale_program_while_compiling(rng):
    """A live resolution renegotiation also lands in a fresh bucket; the
    stream keeps flowing at the old size while the new program compiles."""

    async def run():
        eng = _mk_engine()
        served: list[tuple] = []
        orig = eng._run_bucket_sync

        def spy(spec, ref_mode, *a, **k):
            served.append((spec.height, spec.width))
            return orig(spec, ref_mode, *a, **k)

        eng._run_bucket_sync = spy
        eng.start()
        try:
            st = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            out = await _first_real(eng, st, frame)
            assert out.shape[:2] == (32, 32)

            eng.update_options(st.stream_id, {"height": 64, "width": 64})
            out = await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 120)
            # served at the old size while 64x64 compiles in the background
            assert out.shape[:2] == (32, 32)
            assert served.count((64, 64)) == 1 and served.count((32, 32)) >= 2

            for _ in range(600):
                if not eng._compiling:
                    break
                await asyncio.sleep(0.5)
            out = await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 120)
            assert out.shape[:2] == (64, 64)
        finally:
            await eng.stop()

    asyncio.run(run())


def test_batch_growth_serves_chunked_while_compiling(rng):
    """More concurrent streams than any compiled batch: the group is served
    as chunks of the largest ready batch while the big bucket compiles."""

    async def run():
        eng = _mk_engine()
        served: list[int] = []
        orig = eng._run_bucket_sync

        def spy(spec, ref_mode, *a, **k):
            served.append(spec.batch)
            return orig(spec, ref_mode, *a, **k)

        eng._run_bucket_sync = spy
        # disable the EMA pacing gate so the concurrent submits coalesce
        # into one group (pacing would otherwise serialize them to batch 1
        # and the fresh-bucket path under test would never be reached)
        eng.queue.pacing_ok = lambda *a, **k: True
        eng.start()
        try:
            st0 = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            await _first_real(eng, st0, frame)
            assert set(served) == {1}

            sts = [
                eng.open_stream(
                    {"height": 32, "width": 32, "steps": 1, "prompt": f"p{i}"}
                )
                for i in range(3)
            ]
            outs = await asyncio.wait_for(
                asyncio.gather(
                    *[eng.submit_frame(s.stream_id, frame) for s in [st0] + sts]
                ),
                timeout=120,
            )
            assert all(o.shape == (32, 32, 3) for o in outs)
            # dispatch chunked the group into batch-1 calls immediately
            assert served.count(1) >= 3, served
            # ... while the big bucket warms in the background (batch 4, or
            # 2 if the deadline cut the group)
            for _ in range(600):
                if not eng._compiling and (
                    served.count(4) + served.count(2) >= 1
                ):
                    break
                await asyncio.sleep(0.5)
            assert max(served.count(4), served.count(2)) >= 1, served
        finally:
            await eng.stop()

    asyncio.run(run())


def test_unfallbackable_bucket_passes_through_while_compiling(rng):
    """A bucket with NO compiled variant (first ref-mode stream) must not
    sync-compile on the dispatch thread (that would stall every stream):
    frames pass through as the last output while the program warms in the
    background (the reference's init-frame-while-loading behavior)."""

    async def run():
        eng = _mk_engine()
        eng.start()
        try:
            st = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            await _first_real(eng, st, frame)

            st2 = eng.open_stream(
                {"height": 32, "width": 32, "steps": 1, "ref": True}
            )
            t0 = asyncio.get_running_loop().time()
            out = await asyncio.wait_for(eng.submit_frame(st2.stream_id, frame), 30)
            # resolved quickly (passthrough), ref program compiling behind
            assert asyncio.get_running_loop().time() - t0 < 30
            assert out.shape == (32, 32, 3)
            assert eng._compiling or ((_spec_ready(eng, ref=True)))
            for _ in range(600):
                if not eng._compiling:
                    break
                await asyncio.sleep(0.5)
            # once ready, ref frames generate for real
            out2 = await asyncio.wait_for(eng.submit_frame(st2.stream_id, frame), 120)
            assert out2.shape == (32, 32, 3)
            assert any(rm for _s, rm in eng._ready_specs)
        finally:
            await eng.stop()

    def _spec_ready(eng, ref):
        return any(rm == ref for _s, rm in eng._ready_specs)

    asyncio.run(run())


def test_engine_controlnet_interval_buckets(rng):
    """The controlnet_interval option must reach the compiled FrameSpec
    (bucket-keyed) and serve real frames through the turbo program."""

    async def run():
        eng = _mk_engine()
        eng.start()
        try:
            st = eng.open_stream(
                {"height": 32, "width": 32, "steps": 2, "controlnet_interval": 2}
            )
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            out = await _first_real(eng, st, frame)
            assert out.shape == (32, 32, 3)
            assert any(
                s.controlnet_interval == 2 and s.steps == 2
                for s, _rm in eng._ready_specs
            ), sorted((s.steps, s.controlnet_interval) for s, _ in eng._ready_specs)
        finally:
            await eng.stop()

    asyncio.run(run())


def test_engine_deepcache_interval_buckets(rng):
    """The deepcache_interval option must reach the compiled FrameSpec
    (bucket-keyed) and serve real frames through the turbo program."""

    async def run():
        eng = _mk_engine()
        eng.start()
        try:
            st = eng.open_stream(
                {"height": 32, "width": 32, "steps": 2, "deepcache_interval": 2}
            )
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            out = await _first_real(eng, st, frame)
            assert out.shape == (32, 32, 3)
            assert any(
                s.deepcache_interval == 2 and s.steps == 2
                for s, _rm in eng._ready_specs
            ), sorted((s.steps, s.deepcache_interval) for s, _ in eng._ready_specs)
        finally:
            await eng.stop()

    asyncio.run(run())


def test_engine_config_option_defaults_merge():
    """config option_defaults sit under each stream's init options (init
    wins; data-channel updates still apply on top)."""
    eng = Engine(
        ServerConfig(option_defaults={"controlnet_interval": 4, "strength": 0.4}),
        bundle=_bundle(),
        max_streams=2,
        frame_hw=(32, 32),
    )
    st = eng.open_stream({})
    assert st.options["controlnet_interval"] == 4
    assert st.options["strength"] == 0.4
    st2 = eng.open_stream({"controlnet_interval": 2})
    assert st2.options["controlnet_interval"] == 2  # init options win


def test_background_compile_concurrency_cap():
    """No more than config.compile_concurrency background compiles may run
    at once (measured: unbounded parallel compiles starve small hosts)."""
    import threading
    import time as _time

    eng = Engine(
        ServerConfig(compile_concurrency=2),
        bundle=_bundle(),
        max_streams=1,
        frame_hw=(32, 32),
    )
    lock = threading.Lock()
    live = {"now": 0, "peak": 0, "total": 0}

    def slow_warm(spec, *, ref_mode):
        with lock:
            live["now"] += 1
            live["peak"] = max(live["peak"], live["now"])
        _time.sleep(0.2)
        with lock:
            live["now"] -= 1
            live["total"] += 1

    eng._warm_spec = slow_warm

    async def run():
        loop = asyncio.get_running_loop()
        for s in range(1, 6):
            spec = FrameSpec(batch=1, height=32, width=32, steps=s)
            eng._compile_spec_background(loop, spec, ref_mode=False)
        t0 = _time.monotonic()
        while live["total"] < 5 and _time.monotonic() - t0 < 10:
            await asyncio.sleep(0.05)

    asyncio.run(run())
    assert live["total"] == 5
    assert live["peak"] <= 2, live["peak"]


def test_engine_option_churn_fuzz(rng):
    """Randomized live-option churn across 4 concurrent streams (the
    data-channel protocol under an adversarial client, server.py:167-197).

    Invariants: traced options (floats, seed, prompt) never add compiled
    programs; bucket-keyed churn (steps, controlnet off) keeps every
    submit resolving via the nearest-ready fallback; every stream keeps
    seeing real generations; shutdown is clean."""
    import random as _random

    fuzz = _random.Random(0)
    prompts = ["a", "b", "c", "watercolor skyline"]

    def traced_mutation():
        return fuzz.choice(
            [
                lambda: {"strength": round(fuzz.uniform(0.05, 1.0), 3)},
                lambda: {"guidance_scale": round(fuzz.uniform(0.0, 12.0), 2)},
                lambda: {"controlnet_scale": round(fuzz.uniform(0.05, 3.0), 2)},
                lambda: {"seed": fuzz.randrange(0, 10_000)},
                lambda: {"prompt": fuzz.choice(prompts)},
                lambda: {"prompt_blend_frames": fuzz.choice([0, 2, 5])},
            ]
        )()

    async def run():
        eng = _mk_engine()
        eng.warmup(batch_sizes=(1, 2, 4), steps=(1,), height=32, width=32)
        eng.start()
        try:
            sts = [
                eng.open_stream(
                    {"height": 32, "width": 32, "steps": 1, "prompt": f"p{i}"}
                )
                for i in range(4)
            ]

            async def churn(st, n, bucket_keyed: bool):
                for _ in range(n):
                    frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
                    msg = traced_mutation()
                    if bucket_keyed and fuzz.random() < 0.3:
                        msg = fuzz.choice(
                            [{"steps": 2}, {"steps": 1}, {"controlnet": False},
                             {"controlnet": True},
                             # temporal DeepCache churn: produce/reuse/off
                             # transitions regroup batches every tick
                             {"deepcache_temporal": 0},
                             {"deepcache_temporal": 2},
                             {"deepcache_temporal": 3}]
                        )
                    eng.update_options(st.stream_id, msg)
                    out = await asyncio.wait_for(
                        eng.submit_frame(st.stream_id, frame), 120
                    )
                    assert out.shape == (32, 32, 3) and out.dtype == np.uint8

            # phase 1: traced-only churn -> ZERO new programs
            warmed = len(eng._programs)
            await asyncio.wait_for(
                asyncio.gather(*[churn(st, 15, False) for st in sts]), 300
            )
            assert len(eng._programs) == warmed, (
                "traced option churn recompiled",
                sorted(eng._programs),
            )
            gen_after_p1 = eng.telemetry.frames_out
            assert gen_after_p1 > 0

            # phase 2: bucket-keyed churn mixed in -> serving never blocks
            # (nearest-ready fallback while fresh buckets compile in the
            # background), and generation keeps advancing
            await asyncio.wait_for(
                asyncio.gather(*[churn(st, 10, True) for st in sts]), 300
            )
            assert eng.telemetry.frames_out > gen_after_p1
        finally:
            await eng.stop()

    asyncio.run(run())


def test_pipelined_streams_never_duplicate_rows(rng):
    """A stream whose resubmit lands during the fill window REPLACES its
    stale row (latest-wins inside the window, like the mailbox): 4
    pipelined clients must never inflate a batch beyond 4 rows — before
    the fix, duplicate rows pushed groups into a phantom batch-8 bucket
    whose cold compile stalled live deployments."""
    import time as _time

    async def run():
        eng = _mk_engine()
        eng.warmup(batch_sizes=(1, 2, 4), steps=(1,), height=32, width=32)
        served: list[int] = []
        orig = eng._run_bucket_sync

        def spy(spec, ref_mode, *a, **k):
            served.append(spec.batch)
            _time.sleep(0.15)  # busy device: arrivals pile into the window
            return orig(spec, ref_mode, *a, **k)

        eng._run_bucket_sync = spy
        eng.start()
        try:
            sts = [
                eng.open_stream(
                    {"height": 32, "width": 32, "steps": 1, "prompt": f"p{i}"}
                )
                for i in range(4)
            ]
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)

            async def pipelined_client(st, n=8, inflight=2):
                pending = []
                for _ in range(n):
                    pending.append(
                        asyncio.create_task(
                            eng.submit_frame(st.stream_id, frame)
                        )
                    )
                    if len(pending) >= inflight:
                        await pending.pop(0)
                    await asyncio.sleep(0.01)
                await asyncio.gather(*pending)

            await asyncio.wait_for(
                asyncio.gather(*[pipelined_client(st) for st in sts]), 120
            )
            assert served and max(served) <= 4, served
        finally:
            await eng.stop()

    asyncio.run(run())


def test_registry_model_swaps_its_weights_in_and_out(rng):
    """A `models:` registry entry serves its own weights through the same
    program (copied into the serving modules at dispatch), and the default
    checkpoint's come back bit for bit after it."""

    async def run():
        cfg = ServerConfig.from_dict({"family": "tiny", "dtype": "float32", "weights": "random",
                                      "models": {"alt": "some/repo"}, "frame_hw": (32, 32)})
        eng = Engine(cfg, bundle=_bundle(), max_streams=2, max_batch=1, deadline_ms=5)
        eng.load_models()
        eng.start()
        try:
            st = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            default = await _first_real(eng, st, frame)
            eng.update_options(st.stream_id, {"model": "alt"})
            alt = await _first_real(eng, st, frame)
            eng.update_options(st.stream_id, {"model": ""})
            back = await _first_real(eng, st, frame)
            assert len(eng._programs) == 1  # one program served both models
            assert np.abs(alt.astype(int) - default.astype(int)).max() > 0
            np.testing.assert_array_equal(back, default)
            assert eng.stats()["models"] == {"alt": "loaded"}
        finally:
            await eng.stop()

    asyncio.run(run())


def test_unported_configurations_raise():
    """More than one device, LoRA and int8 weights wait for their ports."""
    with pytest.raises(NotImplementedError, match="mesh"):
        Engine(ServerConfig(gpus=2), device="cpu")
    with pytest.raises(NotImplementedError, match="LoRA"):
        Engine(ServerConfig(family="tiny", weights="random", lora="a.safetensors"),
               device="cpu").bundle
    with pytest.raises(NotImplementedError, match="int8"):
        Engine(ServerConfig(family="tiny", weights="random", quant="int8"), device="cpu").bundle


def test_trace_summarizes_the_profiled_work(tmp_path):
    """The telemetry's torch.profiler trace around a warm-up's frame, then
    summarize_trace's breakdown (the calling thread's operators on the
    CPU; on a card, the kernels of every thread)."""
    from videosd_tpu_torch.runtime.telemetry import summarize_trace

    eng = _mk_engine()
    eng.telemetry.start_trace(str(tmp_path))
    eng.warmup(batch_sizes=(1,), steps=(1,), height=32, width=32)
    eng.telemetry.stop_trace()
    summary = summarize_trace(str(tmp_path))
    assert summary["device_time_ms"] > 0 and summary["ops"], summary
    assert {"name", "ms", "pct"} <= set(summary["by_type"][0])
    assert any("conv" in op["name"] for op in summary["ops"]), summary["ops"]
    assert "error" in summarize_trace(str(tmp_path / "empty"))
