"""The per-connection logic of the WebSocket transport, without a transport.

The JAX server's ``ws_handler`` (``videosd_tpu/server/app.py``) keeps one
connection's state and protocol inside its aiohttp loop.  Here it is a
:class:`Session` that is handed each message and given an
``async send(payload)`` callable (``bytes`` for a binary reply, a ``dict``
for a JSON text reply); ``server/app.py`` drives it from aiohttp, and any
other caller (a benchmark on a card without aiohttp) drives the same code
directly.  Messages, limits and the order of checks are the JAX handler's:

  client -> text JSON {"type":"init","options":{...}}
  client -> text JSON {"type":"prompt", ...changed keys...}
  client -> binary: u16 height, u16 width, raw RGB24 frame (h*w*3 payload
            bytes) OR raw packed planar I420 (h*w*3/2 bytes: Y plane then
            2x2-subsampled U, V; needs h%4==0 and w%2==0) OR a JPEG blob
            (detected by the FFD8 SOI marker)
  server -> binary: u16 height, u16 width, raw RGB24 diffused frame, OR a
            JPEG blob when the stream option "jpeg" is truthy
  client -> text JSON {"type":"record","action":"start"|"stop"}
  server -> text JSON {"type":"transcript","text":...}
  client -> text JSON {"type":"audio","pcm16":<base64>,"rate":...}
  client -> text JSON {"type":"stats"} -> {"type":"stats","stats":{...}}

Frames are processed concurrently, at most :data:`MAX_BACKLOG` in flight
per connection; each awaits its predecessor before it sends, so replies
keep arrival order, and every frame gets a reply or an error message.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import struct
from typing import Any, Awaitable, Callable

import numpy as np

__all__ = [
    "MAX_BACKLOG",
    "Session",
    "frame_reply",
    "is_jpeg",
    "jpeg_decode",
    "jpeg_encode",
    "parse_options",
    "parse_raw_frame",
]

logger = logging.getLogger("videosd_tpu_torch.server")

MAX_BACKLOG = 4  # frames in flight per connection


def is_jpeg(data: bytes) -> bool:
    """A JPEG blob starts with the SOI marker."""
    return data[:2] == b"\xff\xd8"


def parse_raw_frame(data: bytes, input_format: str) -> np.ndarray | None:
    """A raw binary frame: the u16 height, u16 width header, then RGB24
    ([h, w, 3]) or packed I420 ([h*3//2, w], unpacked to RGB on the host
    for an rgb-input engine, so its programs' input layout stays fixed).
    None for a payload of neither size ("bad frame size")."""
    h, w = struct.unpack("<HH", data[:4])
    frame = np.frombuffer(data[4:], np.uint8)
    if frame.size == h * w * 3:
        return frame.reshape(h, w, 3)
    if frame.size == h * w * 3 // 2 and h % 4 == 0 and w % 2 == 0:
        frame = frame.reshape(h * 3 // 2, w)
        if input_format != "i420":
            from videosd_tpu_torch.ops.preprocess import i420_to_rgb_host

            frame = i420_to_rgb_host(frame)
        return frame
    return None


def jpeg_decode(data: bytes, engine) -> np.ndarray:
    """JPEG bytes -> the engine's input layout (packed I420 for an
    i420-input engine: no host colorspace work, half the upload)."""
    from videosd_tpu_torch.runtime import jpegcodec

    with engine.telemetry.stages.time("jpeg_decode"):
        if engine.input_format == "i420":
            return jpegcodec.decode_i420(data)
        return jpegcodec.decode_rgb(data)


def jpeg_encode(out: np.ndarray, engine) -> bytes:
    """An engine output (RGB, or packed I420 from an i420-output engine:
    libjpeg's raw path) -> JPEG bytes at quality 85."""
    from videosd_tpu_torch.runtime import jpegcodec

    with engine.telemetry.stages.time("jpeg_encode"):
        if out.ndim == 2:
            return jpegcodec.encode_i420(out, quality=85)
        return jpegcodec.encode_rgb(out, quality=85)


def frame_reply(out: np.ndarray, engine) -> bytes:
    """The raw binary reply: the u16 height, u16 width header and RGB24
    (a packed I420 output is unpacked on the host first)."""
    if out.ndim == 2:
        out = engine._as_rgb(out)
    oh, ow = out.shape[:2]
    return struct.pack("<HH", oh, ow) + out.tobytes()


def parse_options(raw: dict[str, Any]) -> dict[str, Any]:
    from videosd_tpu_torch.config import coerce_options

    return coerce_options(raw)


class Session:
    """One connection: its stream, its STT recorder and its frames in
    flight.  ``send(payload)`` sends ``bytes`` as a binary message and a
    ``dict`` as JSON text; ``closed()`` says whether the connection has
    closed (no reply is sent then)."""

    def __init__(
        self,
        engine,
        send: Callable[[bytes | dict], Awaitable[None]],
        closed: Callable[[], bool] = lambda: False,
    ):
        self.engine = engine
        self.send = send
        self.closed = closed
        self.stream = None
        self.stt = None
        self.frame_tasks: set[asyncio.Task] = set()
        self.prev_done: asyncio.Future | None = None

    async def on_text(self, text: str) -> None:
        engine = self.engine
        data = json.loads(text)
        mtype = data.pop("type", "prompt")
        if mtype == "init":
            self.stream = engine.open_stream(parse_options(data.get("options", {})))
        elif mtype == "prompt":
            if self.stream is not None:
                engine.update_options(self.stream.stream_id, data)
        elif mtype == "record":
            from videosd_tpu_torch.server.stt import STTSession

            if self.stt is None:
                self.stt = STTSession()
            if data.get("action") == "start":
                self.stt.start()
            elif data.get("action") == "stop":
                text = await self.stt.stop_and_transcribe()
                await self.send({"type": "transcript", "text": text})
        elif mtype == "audio":
            # PCM16 mono chunk (base64) while recording
            if self.stt is not None and self.stt.recording:
                pcm = np.frombuffer(base64.b64decode(data.get("pcm16", "")), np.int16)
                self.stt.add_frame(pcm, sample_rate=int(data.get("rate", 48000)))
        elif mtype == "stats":
            await self.send({"type": "stats", "stats": engine.stats()})

    async def on_binary(self, data: bytes) -> None:
        """Parse one frame and start its task; returns once it is in
        flight (waiting first while :data:`MAX_BACKLOG` frames are)."""
        engine = self.engine
        loop = asyncio.get_running_loop()
        if self.stream is None:
            self.stream = engine.open_stream({})
        if is_jpeg(data):
            # decode in a worker thread: an inline decode would block the
            # event loop (and therefore the batcher) for every frame
            try:
                frame = await loop.run_in_executor(None, jpeg_decode, data, engine)
            except Exception:
                await self.send({"type": "error", "error": "bad jpeg"})
                return
        else:
            frame = parse_raw_frame(data, engine.input_format)
            if frame is None:
                await self.send({"type": "error", "error": "bad frame size"})
                return
        while len(self.frame_tasks) >= MAX_BACKLOG:  # bound the backlog
            await asyncio.wait(set(self.frame_tasks), return_when=asyncio.FIRST_COMPLETED)
        t = loop.create_task(self._handle_frame(frame, self.prev_done))
        self.prev_done = t
        self.frame_tasks.add(t)
        t.add_done_callback(self.frame_tasks.discard)

    async def _handle_frame(self, frame: np.ndarray, prev: asyncio.Future | None):
        engine, stream = self.engine, self.stream
        try:
            out = await engine.submit_frame(stream.stream_id, frame)
            if stream.options.get("jpeg"):
                payload = await asyncio.get_running_loop().run_in_executor(
                    None, jpeg_encode, out, engine
                )
            else:
                payload = frame_reply(out, engine)
        except Exception:
            logger.exception("frame handling failed")
            if prev is not None:
                await asyncio.shield(asyncio.gather(prev, return_exceptions=True))
            if not self.closed():
                await self.send({"type": "error", "error": "frame failed"})
            return
        if prev is not None:  # in-order delivery
            await asyncio.shield(asyncio.gather(prev, return_exceptions=True))
        if not self.closed():
            await self.send(payload)

    async def drain(self) -> None:
        """Wait until every frame in flight has replied."""
        while self.frame_tasks:
            await asyncio.gather(*list(self.frame_tasks), return_exceptions=True)

    def close(self) -> None:
        """Cancel the frames in flight and close the stream."""
        for t in self.frame_tasks:
            t.cancel()
        if self.stream is not None:
            self.engine.close_stream(self.stream.stream_id)
