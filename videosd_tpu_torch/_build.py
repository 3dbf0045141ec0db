"""Builds the package's CUDA kernels at first use and loads them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``videosd_tpu_torch/_build/`` under a name that carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is built when the package is imported:
:func:`load_library` runs on the first kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["BuildError", "build", "load_library"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(_BUILD_DIR, f"libvideosd_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the kernels unless an up-to-date library exists.

    Returns ``(library_path, compiler_log)``; the log holds ptxas's
    register, shared-memory and spill report per kernel, and is empty when
    the library was already built.
    """
    lib = _library_path()
    if os.path.isfile(lib):
        return lib, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, os.path.basename(src) + ".o") for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for src, obj in zip(_sources(), objects)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(_sources(), procs, logs):
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed on {os.path.basename(src)} "
                                 f"({proc.returncode}):\n{log}")
        out = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", out, *objects], capture_output=True, text=True
        )
        if link.returncode != 0:
            raise BuildError(f"nvcc failed to link ({link.returncode}):\n{link.stderr}")
        os.replace(out, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, "".join(logs)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.videosd_flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ci, ci,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ci, ci, vp,
    ]
    lib.videosd_flash_attention_fwd.restype = ci
    lib.videosd_flash_attention_fp32_fwd.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ci, ci,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ci, vp,
    ]
    lib.videosd_flash_attention_fp32_fwd.restype = ci
    for fn in (lib.videosd_flash_attention_wide_fwd, lib.videosd_flash_attention_wide_fp32_fwd):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ci, vp]
        fn.restype = ci
    lib.videosd_flash_attention_wide_plan.argtypes = [ci, ctypes.POINTER(ci)]
    lib.videosd_flash_attention_wide_plan.restype = ci
    lib.videosd_taesd_conv3x3.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.videosd_taesd_conv3x3.restype = ci
    lib.videosd_taesd_conv3x3_fp32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.videosd_taesd_conv3x3_fp32.restype = ci
    fl = ctypes.c_float
    lib.videosd_fused_preprocess.argtypes = [vp, vp, ci, vp, vp, ci, ci, ci, fl, fl, ci, vp]
    lib.videosd_fused_preprocess.restype = ci
    pi = ctypes.POINTER(ci)
    lib.videosd_fused_preprocess_grid.argtypes = [ci, ci, ci, ci, pi, pi]
    lib.videosd_fused_preprocess_grid.restype = ci
    lib.videosd_sobel_magnitude.argtypes = [vp, vp, ci, ci, vp]
    lib.videosd_sobel_magnitude.restype = ci
    return lib
