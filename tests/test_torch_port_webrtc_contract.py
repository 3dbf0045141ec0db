"""WebRTC wiring contract of the port's ``server/webrtc.py``, with the JAX
package's stub aiortc/av modules (``tests/test_webrtc_contract.py``).

aiortc is installed nowhere this runs, so the stubs stand in for the codecs
and ICE, and the port's copy of the wiring runs end to end:
handle_offer -> on_track -> recv (submit/mailbox/passthrough semantics)
-> data-channel option mutation -> record start/stop transcription ->
connection-state cleanup.  The three cases keep their JAX names.
"""

from __future__ import annotations

import asyncio
import json
import sys
import types

import numpy as np
import pytest
from test_webrtc_contract import (
    FakeEngine,
    _FakeAudioTrack,
    _FakeCameraTrack,
    _FakeDataChannel,
    _FakePC,
    _FakeVideoFrame,
)

# a track's recv() waits on the fake camera and the engine: bounded, so a
# lost frame fails the test instead of hanging the run
RECV_TIMEOUT_S = 30


@pytest.fixture()
def webrtc_mod(monkeypatch):
    """Import videosd_tpu_torch.server.webrtc against stub aiortc/av modules."""
    if "aiortc" in sys.modules and not hasattr(sys.modules["aiortc"], "_stub"):
        pytest.skip("real aiortc present; the loopback test covers this")

    aiortc = types.ModuleType("aiortc")
    aiortc._stub = True
    aiortc.RTCConfiguration = lambda iceServers=None: types.SimpleNamespace(
        iceServers=iceServers
    )
    aiortc.RTCIceServer = lambda urls, username=None, credential=None: (
        types.SimpleNamespace(urls=urls, username=username, credential=credential)
    )
    aiortc.RTCPeerConnection = _FakePC
    aiortc.RTCSessionDescription = lambda sdp, type: types.SimpleNamespace(
        sdp=sdp, type=type
    )
    contrib = types.ModuleType("aiortc.contrib")
    media = types.ModuleType("aiortc.contrib.media")

    class _Blackhole:
        def __init__(self):
            self.tracks = []
            self.stopped = False

        def addTrack(self, t):
            self.tracks.append(t)

        async def stop(self):
            self.stopped = True

    media.MediaBlackhole = _Blackhole
    streams = types.ModuleType("aiortc.mediastreams")

    class _MST:
        def __init__(self):
            pass

    streams.MediaStreamTrack = _MST
    av = types.ModuleType("av")
    av.VideoFrame = _FakeVideoFrame

    saved = {
        k: sys.modules.get(k)
        for k in (
            "aiortc",
            "aiortc.contrib",
            "aiortc.contrib.media",
            "aiortc.mediastreams",
            "av",
            "videosd_tpu_torch.server.webrtc",
        )
    }
    sys.modules["aiortc"] = aiortc
    sys.modules["aiortc.contrib"] = contrib
    sys.modules["aiortc.contrib.media"] = media
    sys.modules["aiortc.mediastreams"] = streams
    sys.modules["av"] = av
    sys.modules.pop("videosd_tpu_torch.server.webrtc", None)
    _FakePC.instances.clear()
    import videosd_tpu_torch.server.webrtc as mod

    yield mod
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v


def _mk_app(engine):
    cfg = types.SimpleNamespace(turn_url=None)
    return {
        "engine": engine,
        "config": cfg,
        "sessions": set(),
        "pc_closers": [],
    }


def test_offer_track_recv_and_datachannel_wiring(webrtc_mod, monkeypatch):
    engine = FakeEngine()
    app = _mk_app(engine)

    async def run():
        ans = await webrtc_mod.handle_offer(
            app, {"sdp": "offer-sdp", "type": "offer", "options": {"strength": 0.5}}
        )
        assert ans == {"sdp": "answer-sdp", "type": "answer"}
        pc = _FakePC.instances[-1]
        assert pc in app["sessions"]

        # video track arrives -> VideoSDTrack is added as the OUTPUT track
        cam = _FakeCameraTrack([np.zeros((64, 64, 3), np.uint8)])
        pc.fire_track(cam)
        assert len(pc.added_tracks) == 1
        vtrack = pc.added_tracks[0]
        assert vtrack.stream.options["strength"] == 0.5

        # first recv: passthrough black init frame stamped with the INPUT
        # frame's pts (reference decoupling, server.py:140-143)
        out1 = await asyncio.wait_for(vtrack.recv(), RECV_TIMEOUT_S)
        assert out1.pts == 3000
        assert np.asarray(out1._arr).max() == 0
        # let the submit task complete, then the next recv returns it
        for _ in range(5):
            await asyncio.sleep(0)
        out2 = await asyncio.wait_for(vtrack.recv(), RECV_TIMEOUT_S)
        assert out2.pts == 6000
        assert np.asarray(out2._arr).max() == 200
        assert engine.submitted and engine.submitted[0][0] == vtrack.stream.stream_id
        assert engine.submitted[0][1] == (64, 64, 3)

        # prompt data channel mutates the stream's options live
        ch = _FakeDataChannel("prompt")
        pc.fire_datachannel(ch)
        ch.message(json.dumps({"strength": 0.9, "prompt": "a fox"}))
        assert engine.updates == [
            (vtrack.stream.stream_id, {"strength": 0.9, "prompt": "a fox"})
        ]

        # connection failure -> stream closed, pc closed, session discarded
        await pc.fire_state("failed")
        assert engine.closed_streams == [vtrack.stream.stream_id]
        assert pc.closed and pc not in app["sessions"]
        assert app["pc_closers"] == []

    asyncio.run(run())


def test_record_channel_runs_transcription(webrtc_mod, monkeypatch):
    """The reference's stop handler is a never-driven generator
    (server.py:207); ours must actually transcribe and reply."""
    from videosd_tpu_torch.server.stt import STTSession

    engine = FakeEngine()
    app = _mk_app(engine)

    async def fake_stop(self):
        return "hello world"

    monkeypatch.setattr(STTSession, "stop_and_transcribe", fake_stop)

    async def run():
        await webrtc_mod.handle_offer(app, {"sdp": "o", "type": "offer"})
        pc = _FakePC.instances[-1]

        # audio track tees into the STT session while recording
        audio = _FakeAudioTrack()
        pc.fire_track(audio)
        atrack = None
        # AudioTeeTrack goes to the blackhole, not pc.addTrack
        assert pc.added_tracks == []

        ch = _FakeDataChannel("record")
        pc.fire_datachannel(ch)
        ch.message("start")
        ch.message("stop")
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        assert ch.sent == ["hello world"]

    asyncio.run(run())


def test_i420_engine_gets_planar_frames(webrtc_mod):
    engine = FakeEngine()
    engine.input_format = "i420"
    app = _mk_app(engine)

    async def run():
        await webrtc_mod.handle_offer(app, {"sdp": "o", "type": "offer"})
        pc = _FakePC.instances[-1]
        cam = _FakeCameraTrack([np.zeros((64, 64, 3), np.uint8)])
        pc.fire_track(cam)
        vtrack = pc.added_tracks[0]
        await asyncio.wait_for(vtrack.recv(), RECV_TIMEOUT_S)
        await asyncio.sleep(0)
        # packed planar upload: [h*3/2, w]
        assert engine.submitted[0][1] == (96, 64)

    asyncio.run(run())
