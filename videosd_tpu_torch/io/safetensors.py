"""Minimal dependency-free safetensors reader/writer.

Zero-egress image has no ``safetensors`` package; the format is trivial:
8-byte little-endian header length, JSON header mapping tensor name ->
{dtype, shape, data_offsets}, then raw little-endian tensor bytes.
"""

from __future__ import annotations

import json
import struct

import numpy as np

__all__ = ["read_safetensors", "write_safetensors"]

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}
_INV_DTYPES = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Load all tensors.  bf16 is widened to fp32 (numpy has no bf16)."""
    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
        data = f.read()
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = data[start:end]
        dt = meta["dtype"]
        if dt == "BF16":
            u16 = np.frombuffer(raw, np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, _DTYPES[dt])
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def write_safetensors(path: str, tensors: dict[str, np.ndarray]) -> None:
    header: dict[str, dict] = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        nbytes = arr.nbytes
        header[name] = {
            "dtype": _INV_DTYPES[arr.dtype],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        blobs.append(arr.tobytes())
        offset += nbytes
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)
