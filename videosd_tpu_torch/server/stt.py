"""Speech-to-text session — the reference's STT track, implemented working.

The reference buffers audio into an AudioFifo while recording, writes a
WAV to /tmp and POSTs it to a whisper sidecar at
``http://whisper:9000/asr`` (diffusert/server.py:42-79) — but its stop
handler never actually runs (dead ``yield from`` in a callback,
server.py:207; SURVEY.md §3.6 "designed-but-broken").  This implementation
performs the intended flow end-to-end, with the whisper URL configurable,
a local transformers-Whisper fallback when the sidecar is absent
(``WHISPER_LOCAL_DIR`` pointing at a local snapshot — zero-egress safe),
and a graceful error path when neither is available.
"""

from __future__ import annotations

import io
import os
from typing import Callable

import numpy as np

__all__ = ["STTSession", "local_whisper_transcriber"]


def local_whisper_transcriber(model_dir: str) -> "Callable[[np.ndarray, int], str]":
    """Build an in-process transcriber from a local Whisper snapshot dir
    (transformers layout).  Torch runs CPU here; the serving chip stays on
    the diffusion workload.  Raises if the dir/model can't load."""
    import torch
    from transformers import WhisperForConditionalGeneration, WhisperProcessor

    processor = WhisperProcessor.from_pretrained(model_dir, local_files_only=True)
    model = WhisperForConditionalGeneration.from_pretrained(
        model_dir, local_files_only=True
    )
    model.eval()

    def transcribe(audio: np.ndarray, sample_rate: int) -> str:
        if sample_rate != 16000:
            audio = _resample(audio, sample_rate, 16000)
        feats = processor(
            audio, sampling_rate=16000, return_tensors="pt"
        ).input_features
        with torch.no_grad():
            ids = model.generate(feats, max_new_tokens=128)
        return processor.batch_decode(ids, skip_special_tokens=True)[0].strip()

    return transcribe


def _resample(audio: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """Linear-interp resample (mono float) — quality is ample for ASR."""
    n_out = int(round(len(audio) * rate_out / rate_in))
    if n_out <= 0:
        return np.zeros(1, np.float32)
    x_in = np.linspace(0.0, 1.0, num=len(audio), endpoint=False)
    x_out = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
    return np.interp(x_out, x_in, audio).astype(np.float32)


class STTSession:
    def __init__(
        self,
        whisper_url: str | None = None,
        *,
        local_model: "Callable[[np.ndarray, int], str] | None" = None,
    ):
        self.whisper_url = whisper_url or os.environ.get(
            "WHISPER_URL", "http://whisper:9000/asr"
        )
        # injectable for tests; lazily built from WHISPER_LOCAL_DIR otherwise
        self._local_model = local_model
        self._local_tried = local_model is not None
        self.recording = False
        self._chunks: list[np.ndarray] = []
        self._sample_rate = 48000

    def start(self):
        self._chunks = []
        self.recording = True

    def add_frame(self, samples: np.ndarray, *, sample_rate: int = 48000):
        """samples: [channels, n] or [n] int16/float."""
        if not self.recording:
            return
        arr = np.asarray(samples)
        if arr.ndim == 2:
            arr = arr.mean(axis=0)
        self._chunks.append(arr)
        self._sample_rate = sample_rate

    def _render_wav(self) -> bytes:
        from scipy.io import wavfile

        if self._chunks:
            audio = np.concatenate(self._chunks)
        else:
            audio = np.zeros(1, np.int16)
        if audio.dtype != np.int16:
            audio = np.clip(audio, -1.0, 1.0)
            audio = (audio * 32767).astype(np.int16)
        buf = io.BytesIO()
        wavfile.write(buf, self._sample_rate, audio)
        return buf.getvalue()

    def _float_audio(self) -> np.ndarray:
        audio = (
            np.concatenate(self._chunks) if self._chunks else np.zeros(1, np.int16)
        )
        if audio.dtype == np.int16:
            return (audio.astype(np.float32)) / 32768.0
        return np.clip(audio.astype(np.float32), -1.0, 1.0)

    def _get_local_model(self):
        if not self._local_tried:
            self._local_tried = True
            model_dir = os.environ.get("WHISPER_LOCAL_DIR")
            if model_dir and os.path.isdir(model_dir):
                try:
                    self._local_model = local_whisper_transcriber(model_dir)
                except Exception:
                    self._local_model = None
        return self._local_model

    async def stop_and_transcribe(self) -> str:
        """Stop recording, POST WAV to whisper, return the transcript
        (reference fetch(), server.py:63-71: task=transcribe, json out).
        Falls back to a local transformers Whisper when the sidecar is
        unreachable, then to an error string."""
        self.recording = False
        wav = self._render_wav()
        try:
            from aiohttp import ClientSession, ClientTimeout, FormData

            form = FormData()
            form.add_field(
                "audio_file", wav, filename="prompt.wav", content_type="audio/wav"
            )
            url = f"{self.whisper_url}?task=transcribe&language=en&output=json"
            async with ClientSession(timeout=ClientTimeout(total=60)) as session:
                async with session.post(url, data=form) as response:
                    payload = await response.json(content_type=None)
                    return payload.get("text", "")
        except Exception as exc:  # sidecar missing/unreachable
            local = self._get_local_model()
            if local is not None:
                import asyncio

                audio, rate = self._float_audio(), self._sample_rate
                return await asyncio.get_running_loop().run_in_executor(
                    None, local, audio, rate
                )
            return f"[stt unavailable: {type(exc).__name__}]"
