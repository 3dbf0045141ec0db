"""Ablation timings of the 3xTF32 fp32 kernels of K1 (d <= 256) and K3:
copies of a kernel's source with parts changed, built side by side and
timed in turns on one card: K1's copies, then K3's.

    python3 videosd_tpu_torch/kernel_variants.py

The card's machine has no ``ncu``, so what holds a kernel back is found by
timing copies of it that drop or change one part.  Each entry of
:data:`VARIANTS` (K1: ``csrc/flash_attention_fp32.cu``) or
:data:`K3_VARIANTS` (K3: ``csrc/taesd_conv_fp32.cu``) is a list of text
replacements applied to the source (a replacement whose text is missing
fails the run: the list follows the source).  Every copy is compiled by its
own ``nvcc`` into its own library (a kernel's copies all started together),
loaded with ctypes and launched through its C entry: K1's on fp32 ``[1, S, 8*d]``
tensors at the sd15 512x512 frame's three shapes, K3's on fp32 ``[1, H,
W/2, 128]`` at TAESD's four sizes (ReLU, bias) with each size's tile
height; four turns, the copies in order then reversed, 50 launches each
timed by CUDA events.  Prints each copy's registers and spills, its
median-of-turns ms per launch and its largest error relative to the plain
version in fp64 (copies that drop arithmetic are wrong by design), then the
card's name and power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

SHAPES = [(8, 4096, 40), (8, 1024, 80), (8, 256, 160)]  # (heads, S, d)
TURNS, LAUNCHES = 4, 50

_QK = ("                mma_3xtf32(part[n], ab0, as0, kb0, ks0);\n"
       "                mma_3xtf32(part[n], ab1, as1, kb1, ks1);")
_QK_SEP = ("                mma_tf32(psm[n], as0, kb0); mma_tf32(psm[n], ab0, ks0); "
           "mma_tf32(part[n], ab0, kb0);\n"
           "                mma_tf32(psm[n], as1, kb1); mma_tf32(psm[n], ab1, ks1); "
           "mma_tf32(part[n], ab1, kb1);")
_SEP_QK = [
    ("float part[kNK][4];", "float part[kNK][4], psm[kNK][4];"),
    ("for (int i = 0; i < 4; ++i) part[n][i] = 0.f;",
     "for (int i = 0; i < 4; ++i) part[n][i] = psm[n][i] = 0.f;"),
    (_QK, _QK_SEP),
    ("                mma_3xtf32(part[n], ab0, as0, kb0, ks0);",
     "                mma_tf32(psm[n], as0, kb0); mma_tf32(psm[n], ab0, ks0); "
     "mma_tf32(part[n], ab0, kb0);"),
    ("for (int i = 0; i < 4; ++i) s[n][i] += part[n][i];",
     "for (int i = 0; i < 4; ++i) s[n][i] += psm[n][i] + part[n][i];"),
]
_SEP_PV = [
    ("float pv[kNT][4];", "float pv[kNT][4], pvs[kNT][4];"),
    ("for (int i = 0; i < 4; ++i) pv[j][i] = 0.f;",
     "for (int i = 0; i < 4; ++i) pv[j][i] = pvs[j][i] = 0.f;"),
    ("          mma_3xtf32(pv[j], pb, ps, bb, bs);",
     "          mma_tf32(pvs[j], ps, bb); mma_tf32(pvs[j], pb, bs); mma_tf32(pv[j], pb, bb);"),
    ("acc[j][i] = fmaf(acc[j][i], alpha[i / 2], pv[j][i]);",
     "acc[j][i] = fmaf(acc[j][i], alpha[i / 2], pvs[j][i] + pv[j][i]);"),
]
VARIANTS = {
    "as committed": [],
    # the ring sized for one block an SM at W = 40 (more registers, no spill)
    "one block at 40": [("kBlocks = W <= 40 ? 2 : 1", "kBlocks = W <= 16 ? 2 : 1")],
    # big*big alone (the small terms' splits then go too): 1xTF32
    "1xTF32": [("  mma_tf32(d, as, bb);\n  mma_tf32(d, ab, bs);\n  mma_tf32(d, ab, bb);",
                "  mma_tf32(d, ab, bb);")],
    # P V's mma dropped, its loads and splits kept (their bits folded in)
    "no P V mma": [("          mma_3xtf32(pv[j], pb, ps, bb, bs);",
                    "          pv[j][0] += __uint_as_float(bb[0] ^ bs[1] ^ pb[0] ^ ps[3]);")],
    # Q K^T's mma dropped likewise
    "no Q K^T mma": [(_QK, "                part[n][0] += __uint_as_float(ab0[0] ^ as0[1] ^ "
                           "kb0[0] ^ ks0[1] ^ ab1[2] ^ as1[3] ^ kb1[1] ^ ks1[0]);")],
    # P V dropped whole (loads, splits and mma), or Q K^T (the logits then 0)
    "no P V": [("        if (col < d) {", "        if (col < 0) {")],
    "no Q K^T": [("          if (gi < S::kQB && gi < qboxes) {", "          if (gi < 0) {")],
    # the small terms in accumulators of their own (shorter mma chains)
    "split chains Q K^T": _SEP_QK,
    "split chains P V": _SEP_PV,
    "split chains both": _SEP_QK + _SEP_PV,
    "no ex2": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;")],
}

K3_SHAPES = [(1, 512, 256, 128), (1, 256, 128, 128), (1, 128, 64, 128), (1, 64, 32, 128)]
_K3_MMA = ("                mma_tf32(part[m][n], as[m], b0, b1);\n"
           "                mma_tf32(part[m][n], ab[m], s0, s1);\n"
           "                mma_tf32(part[m][n], ab[m], b0, b1);")
K3_VARIANTS = {
    "as committed": [],
    # big*big alone: 1xTF32 (the small terms' loads and splits stay)
    "1xTF32": [(_K3_MMA, "                mma_tf32(part[m][n], ab[m], b0, b1);")],
    # every mma dropped, the loads and splits kept (their bits folded in)
    "no mma": [(_K3_MMA, "                part[m][n][0] += __uint_as_float(as[m][0] ^ ab[m][1] ^ "
                         "b0 ^ s1 ^ ab[m][2] ^ as[m][3] ^ s0 ^ b1);")],
    # one accumulator over all 576 products, no partials
    "no partials": [("            for (int i = 0; i < 4; ++i) part[m][n][i] = 0.f;",
                     "            for (int i = 0; i < 4; ++i) part[m][n][i] = acc[m][n][i];"),
                    ("            for (int i = 0; i < 4; ++i) acc[m][n][i] += part[m][n][i];",
                     "            for (int i = 0; i < 4; ++i) acc[m][n][i] = part[m][n][i];")],
    # the tap-row loop unrolled
    "dy unrolled": [("#pragma unroll 1\n      for (int dy = 0; dy < 3; ++dy) {",
                     "#pragma unroll\n      for (int dy = 0; dy < 3; ++dy) {")],
    # the epilogue's stores dropped but for one lane's (the sums kept live)
    "no stores": [("          *reinterpret_cast<float2*>(a.out + px + 8 * n) = make_float2(v0, v1);",
                   "          if (v0 == 1.2345f && v1 == 5.4321f) a.out[px] = v0;")],
}


def _build(csrc: str, out: str, source: str, variants: dict) -> dict:
    """name -> (ctypes library, registers per instance, spill bytes per instance)
    for each copy of ``source`` in ``variants``."""
    src = open(os.path.join(csrc, source)).read()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    procs = {}
    for i, (name, reps) in enumerate(variants.items()):
        text = src
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"kernel_variants: {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        path = os.path.join(out, f"v{i}.cu")
        shutil.copy(os.path.join(csrc, "tma_sm90.cuh"), out)
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", "-Xptxas", "-v", "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"kernel_variants: nvcc failed on {name!r}:\n{log[-4000:]}")
        libs[name] = (ctypes.CDLL(os.path.join(out, f"v{i}.so")), re.findall(r"Used (\d+) registers", log),
                      re.findall(r"(\d+) bytes spill stores", log))
    return libs


def _turns(torch, libs: dict, run) -> dict:
    """name -> CUDA-event ms per launch of ``run(lib)`` in each of TURNS turns."""
    ms = {name: [] for name in libs}
    for turn in range(TURNS):
        for name in (list(libs) if turn % 2 == 0 else list(libs)[::-1]):
            for _ in range(3):
                run(libs[name][0])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(LAUNCHES):
                run(libs[name][0])
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end) / LAUNCHES)
    return ms


def _k3(torch, csrc: str, out: str) -> None:
    """K3_VARIANTS at K3_SHAPES."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from videosd_tpu_torch.ops.cuda import taesd_conv as k3

    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = _build(csrc, out, "taesd_conv_fp32.cu", K3_VARIANTS)
    for name, (lib, regs, spills) in libs.items():
        lib.videosd_taesd_conv3x3_fp32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        print(f"{name}: registers {regs}, spill bytes {spills} (tile rows 2 and 4, each "
              f"without and with a skip)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = (torch.rand(64, 64, 3, 3, generator=gen, device="cuda") * 2 - 1) / 24.0
    bias = torch.randn(64, generator=gen, device="cuda") * 0.1
    taps = k3._taps_fp32(w)
    for shape in K3_SHAPES:
        b, h, wp, _ = shape
        rows = k3.fp32_tile_rows(b, h, 2 * wp)
        xp = torch.randn(shape, generator=gen, device="cuda")
        o = torch.empty_like(xp)
        exact = k3.packed_conv3x3_reference(w, bias, xp.double(), relu=True).float()
        stream = torch.cuda.current_stream().cuda_stream

        def run(lib):
            err = lib.videosd_taesd_conv3x3_fp32(xp.data_ptr(), taps.data_ptr(), bias.data_ptr(),
                                                 None, o.data_ptr(), b, h, 2 * wp, 1, rows, 0,
                                                 stream)
            if err:
                raise SystemExit(f"kernel_variants: launch failed: cudaError {err}")

        ms = _turns(torch, libs, run)
        for name, (lib, _, _) in libs.items():
            run(lib)
            torch.cuda.synchronize()
            err = ((o - exact).abs().max() / exact.abs().max()).item()
            print(f"{list(shape)} relu, {rows} rows: {name}: {statistics.median(ms[name]):.4f} ms "
                  f"per launch (turns {', '.join(f'{t:.4f}' for t in ms[name])}), max |d| / max "
                  f"|o| from fp64 {err:.2e}")


def _k1(torch, csrc: str, out: str) -> None:
    """VARIANTS at SHAPES."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = _build(csrc, out, "flash_attention_fp32.cu", VARIANTS)
    for name, (lib, regs, spills) in libs.items():
        lib.videosd_flash_attention_fp32_fwd.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ci, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ci, vp]
        print(f"{name}: registers {regs}, spill bytes {spills} (instances 256 .. 8)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, s, d in SHAPES:
        q, k, v = (torch.randn(1, s, h * d, generator=gen, device="cuda") for _ in range(3))
        o = torch.empty_like(q)
        strides = (ctypes.c_longlong * 8)(*(x for t in (q, k, v, o)
                                            for x in (t.stride(0), t.stride(1))))
        qf, kf, vf = (x.reshape(s, h, d).transpose(0, 1).double() for x in (q, k, v))
        exact = (torch.softmax(qf @ kf.transpose(1, 2) * d ** -0.5, -1) @ vf).transpose(
            0, 1).reshape(1, s, h * d).float()
        stream = torch.cuda.current_stream().cuda_stream

        def run(lib):
            err = lib.videosd_flash_attention_fp32_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, h, s, s, d,
                strides, d ** -0.5, 0, stream)
            if err:
                raise SystemExit(f"kernel_variants: launch failed: cudaError {err}")

        ms = _turns(torch, libs, run)
        for name, (lib, _, _) in libs.items():
            run(lib)
            torch.cuda.synchronize()
            err = ((o - exact).abs().max() / exact.abs().max()).item()
            print(f"[{h},{s},{d}] {name}: {statistics.median(ms[name]):.4f} ms per launch "
                  f"(turns {', '.join(f'{t:.4f}' for t in ms[name])}), max |d| / max |o| "
                  f"from fp64 {err:.2e}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
    for ablation in (_k1, _k3):
        with tempfile.TemporaryDirectory() as out:
            ablation(torch, csrc, out)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")


if __name__ == "__main__":
    main()
