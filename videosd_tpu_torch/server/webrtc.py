"""WebRTC transport (aiortc) — imported only when aiortc is installed.

Implements the reference's peer-connection surface (diffusert/server.py:
145-264): TURN config, "prompt"/"record" data channels, video track whose
output is the diffused stream, audio tee into STT, connection-state
cleanup.  The per-frame GPU-pick/busy-flag scheduling of the reference's
``VideoSDTrack.recv`` (server.py:119-143) is replaced by the engine's
micro-batcher: ``recv`` submits the frame and returns the freshest
completed output, preserving the output-fps == input-fps decoupling.
"""

from __future__ import annotations

import asyncio
import logging
import uuid

import numpy as np
from aiortc import (
    RTCConfiguration,
    RTCIceServer,
    RTCPeerConnection,
    RTCSessionDescription,
)
from aiortc.contrib.media import MediaBlackhole
from aiortc.mediastreams import MediaStreamTrack
from av import VideoFrame

from videosd_tpu_torch.server.stt import STTSession

logger = logging.getLogger("pc")


class VideoSDTrack(MediaStreamTrack):
    """Transforms an incoming camera track into the diffused stream."""

    kind = "video"

    def __init__(self, track, engine, options):
        super().__init__()
        self.track = track
        self.engine = engine
        self.stream = engine.open_stream(options)
        self._pending: asyncio.Task | None = None
        h = int(self.stream.options["height"])
        w = int(self.stream.options["width"])
        # format follows the engine: an i420-mode engine hands us packed
        # planar frames, which VideoFrame consumes natively (yuv420p) —
        # skipping the host RGB->YUV conversion inside the VP8 encoder
        # that the reference pays per frame (server.py:139)
        self._current = engine._black_output(h, w)

    async def recv(self):
        frame = await self.track.recv()
        # an i420-input engine takes the decoder's native planar layout
        # directly — no host YUV->RGB conversion (the reference pays one
        # per frame inside frame.to_image(), server.py:108), and the
        # host->device upload is half the bytes
        if self.engine.input_format == "i420" and frame.width % 2 == 0 and (
            frame.height % 4 == 0
        ):
            arr = frame.to_ndarray(format="yuv420p")
        else:
            arr = frame.to_ndarray(format="rgb24")

        # fire-and-collect: submit the newest frame; the engine's mailbox
        # drops stale ones (reference drop semantics, server.py:140-143)
        if self._pending is None or self._pending.done():
            if self._pending is not None and not self._pending.cancelled():
                exc = self._pending.exception()
                if exc is None:
                    self._current = self._pending.result()
            self._pending = asyncio.ensure_future(
                self.engine.submit_frame(self.stream.stream_id, arr)
            )

        fmt = "yuv420p" if self._current.ndim == 2 else "rgb24"
        out = VideoFrame.from_ndarray(self._current, format=fmt)
        out.pts = frame.pts
        out.time_base = frame.time_base
        return out

    def close(self):
        self.engine.close_stream(self.stream.stream_id)


class AudioTeeTrack(MediaStreamTrack):
    """Passes audio through while teeing samples into the STT session
    (reference STTTrack.recv, server.py:73-79)."""

    kind = "audio"

    def __init__(self, track, stt: STTSession):
        super().__init__()
        self.track = track
        self.stt = stt

    async def recv(self):
        frame = await self.track.recv()
        if self.stt.recording:
            self.stt.add_frame(
                frame.to_ndarray(), sample_rate=frame.sample_rate
            )
        return frame


async def handle_offer(app, params: dict) -> dict:
    """SDP negotiation; returns {sdp, type} (server.py:145-264)."""
    engine = app["engine"]
    offer_sdp = RTCSessionDescription(sdp=params["sdp"], type=params["type"])
    options = params.get("options", {})

    ice_servers = []
    turn = app["config"].__dict__.get("turn_url")
    if turn:
        ice_servers.append(
            RTCIceServer(
                urls=[turn],
                username=getattr(app["config"], "turn_username", None),
                credential=getattr(app["config"], "turn_credential", None),
            )
        )
    pc = RTCPeerConnection(RTCConfiguration(iceServers=ice_servers))
    pc_id = f"PeerConnection({uuid.uuid4()})"
    app["sessions"].add(pc)
    blackhole = MediaBlackhole()
    tracks: dict[str, object] = {"audio": None, "video": None}
    stt = STTSession()

    async def close_pc():
        app["sessions"].discard(pc)
        # unregister so the per-app closer list doesn't grow with every
        # session over the server lifetime
        try:
            app["pc_closers"].remove(close_pc)
        except ValueError:
            pass
        if tracks["video"] is not None:
            tracks["video"].close()
        await pc.close()
        await blackhole.stop()

    app["pc_closers"].append(close_pc)

    @pc.on("datachannel")
    def on_datachannel(channel):
        if channel.label == "prompt":

            @channel.on("message")
            def on_prompt(message):
                import json

                msg = json.loads(message)
                video = tracks.get("video")
                if video is not None:
                    engine.update_options(video.stream.stream_id, msg)

        elif channel.label == "record":

            @channel.on("message")
            def on_record(message):
                # FIXED vs the reference: its stop handler contained a
                # `yield from` making the callback a never-driven generator
                # (server.py:207) — here transcription runs as a real task
                # and sends the transcript back on the channel.
                if message == "start":
                    stt.start()
                elif message == "stop":

                    async def finish():
                        text = await stt.stop_and_transcribe()
                        channel.send(text)

                    asyncio.ensure_future(finish())

    @pc.on("connectionstatechange")
    async def on_state_change():
        logger.info("%s state %s", pc_id, pc.connectionState)
        if pc.connectionState in ("failed", "closed"):
            await close_pc()

    @pc.on("track")
    def on_track(track):
        logger.info("%s track %s", pc_id, track.kind)
        if track.kind == "video":
            tracks["video"] = VideoSDTrack(track, engine, options)
            pc.addTrack(tracks["video"])
        elif track.kind == "audio":
            tracks["audio"] = AudioTeeTrack(track, stt)
            blackhole.addTrack(tracks["audio"])

    await pc.setRemoteDescription(offer_sdp)
    answer = await pc.createAnswer()
    await pc.setLocalDescription(answer)
    return {"sdp": pc.localDescription.sdp, "type": pc.localDescription.type}
