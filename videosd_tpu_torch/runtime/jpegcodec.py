"""Native JPEG codec binding (runtime/native/jpegcodec.cpp) with PIL fallback.

The port's copy of ``videosd_tpu/runtime/jpegcodec.py`` (held equal by
``tests/test_torch_port_copies.py``; ``native/jpegcodec.cpp`` is a copy of
the JAX package's).  The native library is compiled with g++ against the
system libjpeg on first use into the package's ``_build/`` directory;
environments without a toolchain (or libjpeg headers) use PIL, and
:func:`native_available` says which codec runs.

ctypes calls release the GIL, so N streams decode/encode truly in parallel
— PIL holds Python-level overhead per call and was the measured host
bottleneck at multi-stream load.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "decode_rgb",
    "decode_i420",
    "encode_rgb",
    "encode_i420",
    "native_available",
]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_SRC = os.path.join(_NATIVE_DIR, "jpegcodec.cpp")
# built into the package's git-ignored build directory, not beside the source
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_SO = os.path.join(_BUILD_DIR, "libjpegcodec.so")
_lib = None
_lib_failed = False
_lib_lock = threading.Lock()


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
                _SRC
            ):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                # build under a private name and rename: processes that
                # build at once never load a half-written library
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    [
                        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        _SRC, "-ljpeg", "-o", tmp,
                    ],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            lib.jc_decode_rgb.restype = ctypes.c_int
            lib.jc_decode_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.jc_decode_i420.restype = ctypes.c_int
            lib.jc_decode_i420.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.jc_encode_rgb.restype = ctypes.c_int
            lib.jc_encode_rgb.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.jc_encode_i420.restype = ctypes.c_int
            lib.jc_encode_i420.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            _lib = lib
        except Exception:
            _lib_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


# camera frames cap at 4K in practice; a fixed decode bound keeps the
# caller-buffer protocol simple.  Buffers are thread-local and reused —
# the codec runs on executor threads at up to ~20 calls/s each.
_MAX_PIXELS = 3840 * 2160
_tls = threading.local()


def _tls_buf(name: str, nbytes: int) -> np.ndarray:
    buf = getattr(_tls, name, None)
    if buf is None or buf.nbytes < nbytes:
        buf = np.empty((nbytes,), np.uint8)
        setattr(_tls, name, buf)
    return buf


def _pil_decode(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def _jpeg_dims(data: bytes) -> tuple[int, int] | None:
    """(height, width) from the SOF marker, or None if unparseable.

    Scanning the markers on the host costs ~µs and lets the decode buffer
    be sized to the actual frame — a fixed 4K bound (24 MB) per executor
    thread pinned ~0.75 GB of host RAM under a 32-thread multi-stream
    load."""
    n = len(data)
    i = 2
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:  # SOI / TEM / RSTn
            i += 2
            continue
        if m == 0xDA:  # SOS: entropy data follows, no SOF seen
            return None
        seg = (data[i + 2] << 8) | data[i + 3]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):  # SOFn
            return ((data[i + 5] << 8) | data[i + 6], (data[i + 7] << 8) | data[i + 8])
        i += 2 + seg
    return None


def decode_rgb(data: bytes) -> np.ndarray:
    """JPEG bytes -> [H,W,3] uint8 (RGB).

    Native path first; anything it rejects (oversized, CMYK/exotic color
    spaces, corrupt) retries through PIL, so the surface accepts exactly
    what PIL accepts — truly corrupt streams raise from PIL."""
    lib = _load()
    if lib is None:
        return _pil_decode(data)
    dims = _jpeg_dims(data)
    if dims is None or dims[0] * dims[1] > _MAX_PIXELS or 0 in dims:
        return _pil_decode(data)
    out = _tls_buf("dec", dims[0] * dims[1] * 3)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.jc_decode_rgb(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
        ctypes.byref(h), ctypes.byref(w),
    )
    if rc != 0:
        return _pil_decode(data)
    return out[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_i420(data: bytes) -> np.ndarray:
    """JPEG bytes -> packed planar I420 ``[H*3//2, W]`` uint8.

    For an i420-input engine: plain 4:2:0 JPEGs (what browsers/PIL emit
    at /16-negotiated sizes) decode through libjpeg's raw-data path —
    no YCbCr->RGB conversion, no chroma upsample on host; the device
    unpacks inside the frame program.  Anything else (4:4:4, non-/16
    dims, no native lib) decodes as RGB and host-packs, so callers
    always receive the packed layout."""
    lib = _load()
    dims = _jpeg_dims(data) if lib is not None else None
    if (
        dims is not None
        and 0 not in dims
        and dims[0] * dims[1] <= _MAX_PIXELS
        and dims[0] % 16 == 0
        and dims[1] % 16 == 0
    ):
        out = _tls_buf("dec", dims[0] * dims[1] * 3 // 2)
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = lib.jc_decode_i420(
            data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
            ctypes.byref(h), ctypes.byref(w),
        )
        if rc == 0:
            return (
                out[: h.value * w.value * 3 // 2]
                .reshape(h.value * 3 // 2, w.value)
                .copy()
            )
    from videosd_tpu_torch.ops.preprocess import rgb_to_i420_host

    rgb = decode_rgb(data)
    fh, fw = rgb.shape[:2]
    if fh % 4 or fw % 2:  # pack needs chroma-grid alignment: trim edge
        rgb = rgb[: fh - fh % 4, : fw - fw % 2]
    return rgb_to_i420_host(rgb)


def _pil_encode(rgb: np.ndarray, quality: int) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def encode_rgb(rgb: np.ndarray, quality: int = 85) -> bytes:
    """[H,W,3] uint8 (RGB) -> JPEG bytes.  Falls back to PIL on any
    native-path failure."""
    lib = _load()
    if lib is None:
        return _pil_encode(rgb, quality)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    cap = h * w * 3 + (1 << 16)  # JPEG never exceeds raw + header slack
    out = _tls_buf("enc", cap)
    n = ctypes.c_size_t()
    rc = lib.jc_encode_rgb(
        rgb.ctypes.data_as(ctypes.c_void_p), h, w, quality,
        out.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(n),
    )
    if rc != 0:
        return _pil_encode(rgb, quality)
    return out[: n.value].tobytes()


def encode_i420(buf: np.ndarray, quality: int = 85) -> bytes:
    """Packed planar I420 ``[H*3//2, W]`` uint8 (ops.rgb_to_i420 layout)
    -> JPEG bytes via libjpeg's raw-data path: no host colorspace
    conversion, no host chroma downsampling — the device already emitted
    4:2:0 YCbCr.  Falls back to unpack + RGB encode when the native lib
    is unavailable or the geometry is not MCU-friendly (w % 16)."""
    buf = np.ascontiguousarray(buf, np.uint8)
    h = (buf.shape[0] * 2) // 3
    w = buf.shape[1]
    lib = _load()
    if lib is None or h % 2 or w % 16:
        from videosd_tpu_torch.ops.preprocess import i420_to_rgb_host

        return _pil_encode(i420_to_rgb_host(buf), quality)
    cap = h * w * 3 + (1 << 16)
    out = _tls_buf("enc", cap)
    n = ctypes.c_size_t()
    rc = lib.jc_encode_i420(
        buf.ctypes.data_as(ctypes.c_void_p), h, w, quality,
        out.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(n),
    )
    if rc != 0:
        from videosd_tpu_torch.ops.preprocess import i420_to_rgb_host

        return _pil_encode(i420_to_rgb_host(buf), quality)
    return out[: n.value].tobytes()
