"""Latest-frame mailboxes + pacing: ctypes binding to the native core.

The port's copy of ``videosd_tpu/runtime/framequeue.py`` (held equal by
``tests/test_torch_port_copies.py``).  See ``native/framequeue.cpp`` (a
copy of the JAX package's) for the design.  The native library is compiled
with g++ on first use into the package's ``_build/`` directory; a
pure-Python implementation with identical semantics backs environments
without a toolchain and serves as the behavioral reference in tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np

__all__ = ["FrameQueue", "native_available"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "framequeue.cpp")
# built into the package's git-ignored build directory, not beside the source
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_SO = os.path.join(_BUILD_DIR, "libframequeue.so")
_lib = None
_lib_lock = threading.Lock()


def _build() -> str | None:
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            # build under a private name and rename: processes that build
            # at once never load a half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)
        return _SO
    except Exception:
        return None


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.fq_create.restype = ctypes.c_void_p
        lib.fq_create.argtypes = [ctypes.c_int, ctypes.c_size_t]
        lib.fq_destroy.argtypes = [ctypes.c_void_p]
        lib.fq_put.restype = ctypes.c_uint64
        lib.fq_put.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        lib.fq_take.restype = ctypes.c_uint64
        lib.fq_take.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fq_has_fresh.restype = ctypes.c_int
        lib.fq_has_fresh.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fq_record_gen.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.fq_mark_gen_start.argtypes = [ctypes.c_void_p]
        lib.fq_pacing_ok.restype = ctypes.c_int
        lib.fq_pacing_ok.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.fq_ema.restype = ctypes.c_double
        lib.fq_ema.argtypes = [ctypes.c_void_p]
        lib.fq_stat.restype = ctypes.c_uint64
        lib.fq_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class _PyQueue:
    """Pure-Python reference implementation (same semantics)."""

    def __init__(self, n_streams: int, frame_bytes: int):
        self.n = n_streams
        self.frame_bytes = frame_bytes
        self._slots = [None] * n_streams
        self._ids = [0] * n_streams
        self._ts = [0.0] * n_streams
        self._taken = [0] * n_streams
        self._locks = [threading.Lock() for _ in range(n_streams)]
        self.frames_in = 0
        self.frames_out = 0
        self.frames_dropped = 0
        self.ema = 0.4
        self.last_gen_start = 0.0

    def put(self, stream, data: bytes) -> int:
        with self._locks[stream]:
            self.frames_in += 1
            fid = self.frames_in
            if self._ids[stream] > self._taken[stream]:
                self.frames_dropped += 1
            self._slots[stream] = bytes(data)
            self._ids[stream] = fid
            self._ts[stream] = time.monotonic()
            return fid

    def take(self, stream, out: np.ndarray):
        with self._locks[stream]:
            fid = self._ids[stream]
            if fid == 0 or fid == self._taken[stream]:
                return 0, 0.0
            buf = np.frombuffer(self._slots[stream], np.uint8)
            # clamp: across a live input-format flip one stored frame may
            # be larger than the new take buffer (native core clamps too)
            n = min(len(buf), out.size)
            out.reshape(-1)[:n] = buf[:n]
            self._taken[stream] = fid
            self.frames_out += 1
            return fid, self._ts[stream]

    def has_fresh(self, stream) -> bool:
        return self._ids[stream] not in (0, self._taken[stream])

    def record_gen(self, seconds: float):
        self.ema = 0.95 * self.ema + 0.05 * seconds

    def mark_gen_start(self):
        self.last_gen_start = time.monotonic()

    def pacing_ok(self, sessions: int, executors: int) -> bool:
        return (time.monotonic() - self.last_gen_start) >= self.ema * sessions / max(
            1, executors
        )

    def stats(self):
        return {
            "frames_in": self.frames_in,
            "frames_out": self.frames_out,
            "frames_dropped": self.frames_dropped,
            "ema_gen_time": self.ema,
        }


class FrameQueue:
    """n_streams latest-frame mailboxes of fixed frame_bytes each."""

    def __init__(self, n_streams: int, frame_bytes: int, *, force_python: bool = False):
        self.n_streams = n_streams
        self.frame_bytes = frame_bytes
        lib = None if force_python else _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.fq_create(n_streams, frame_bytes)
            if not self._h:
                raise MemoryError("fq_create failed")
            self._py = None
        else:
            self._h = None
            self._py = _PyQueue(n_streams, frame_bytes)

    @property
    def is_native(self) -> bool:
        return self._h is not None

    def put(self, stream: int, frame: np.ndarray) -> int:
        data = np.ascontiguousarray(frame, np.uint8).tobytes()
        if self._h is not None:
            return self._lib.fq_put(self._h, stream, data, len(data))
        return self._py.put(stream, data)

    def take(self, stream: int, out: np.ndarray) -> tuple[int, float]:
        """Copy the latest untaken frame into ``out``; (frame_id, ts) or (0,0)."""
        if self._h is not None:
            ts = ctypes.c_double(0.0)
            out = np.ascontiguousarray(out)
            fid = self._lib.fq_take(
                self._h,
                stream,
                out.ctypes.data_as(ctypes.c_void_p),
                out.nbytes,
                ctypes.byref(ts),
            )
            return int(fid), ts.value
        return self._py.take(stream, out)

    def has_fresh(self, stream: int) -> bool:
        if self._h is not None:
            return bool(self._lib.fq_has_fresh(self._h, stream))
        return self._py.has_fresh(stream)

    def record_gen(self, seconds: float):
        if self._h is not None:
            self._lib.fq_record_gen(self._h, seconds)
        else:
            self._py.record_gen(seconds)

    def mark_gen_start(self):
        if self._h is not None:
            self._lib.fq_mark_gen_start(self._h)
        else:
            self._py.mark_gen_start()

    def pacing_ok(self, sessions: int, executors: int = 1) -> bool:
        if self._h is not None:
            return bool(self._lib.fq_pacing_ok(self._h, sessions, executors))
        return self._py.pacing_ok(sessions, executors)

    def stats(self) -> dict:
        if self._h is not None:
            return {
                "frames_in": int(self._lib.fq_stat(self._h, 0)),
                "frames_out": int(self._lib.fq_stat(self._h, 1)),
                "frames_dropped": int(self._lib.fq_stat(self._h, 2)),
                "ema_gen_time": float(self._lib.fq_ema(self._h)),
            }
        return self._py.stats()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.fq_destroy(h)
            self._h = None
