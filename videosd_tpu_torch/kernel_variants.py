"""Ablation timings of the 3xTF32 fp32 kernels of K1 (d <= 256) and K3, of
K1's wide bf16 kernel (d > 256) and of the backward kernels of K1' (the
train steps' attention): copies of a kernel's source with parts changed,
built side by side and timed in turns on one card.

    python3 videosd_tpu_torch/kernel_variants.py [k1] [k3] [wide] [bwd]

K1's copies, then K3's, then the wide kernel's, then the backward's (all
four without arguments, else the ones named).  The card's machine has no
``ncu``, so what holds a kernel back is found by timing copies of it that
drop or change one part.  Each entry of :data:`VARIANTS` (K1:
``csrc/flash_attention_fp32.cu``), :data:`K3_VARIANTS` (K3:
``csrc/taesd_conv_fp32.cu``) or :data:`WIDE_VARIANTS` (K1 wide bf16:
``csrc/flash_attention_wide.cu``) is a list of text replacements applied to
the source (a replacement whose text is missing fails the run: the list
follows the source); :data:`BWD_VARIANTS` and :data:`BWD_FP32_VARIANTS` do
the same to ``csrc/flash_attention_bwd.cu`` and
``csrc/flash_attention_bwd_fp32.cu``, timed at :data:`BWD_SHAPES` (one
launch: the dQ kernel, then the dK/dV kernel).  Every copy is compiled by its own ``nvcc`` into its
own library (a kernel's copies all started together), loaded with ctypes
and launched through its C entry: K1's on fp32 ``[1, S, 8*d]`` tensors at
the sd15 512x512 frame's three shapes, K3's on fp32 ``[1, H, W/2, 128]`` at
TAESD's four sizes (ReLU, bias) with each size's tile height, the wide
kernel's on bf16 ``[B, 4096, 512]`` (the KL VAE's mid attention, batch 1
and 4); four turns, the copies in order then reversed, 50 launches each
timed by CUDA events.  Prints each copy's registers and spills, its
median-of-turns ms per launch and its largest error relative to the plain
version (in fp64 for the fp32 kernels; copies that drop arithmetic are
wrong by design), then the card's name and power limit.  Needs a CUDA card
and nvcc.
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

# the backward kernels of K1' at the train steps' shapes: the A fragments of
# K and V (Q and dO) held in registers at d = 80 too, blocks of 16 rows
# (keys) from d = 160 (128 blocks at 256 tokens), blocks of 8 warps, 32
# queries a step in the dK/dV kernel, 32 keys in the dQ kernel, the exp unit
# dropped, launch bounds without a count of blocks an SM, 1xTF32
BWD_SHAPES = [(8, 4096, 40), (8, 1024, 80), (8, 256, 160), (10, 1024, 64)]  # (heads, S, d)
BWD_VARIANTS = {
    "as committed": [],
    "hoist up to 80": [("kHoist = W <= 64", "kHoist = W <= 80")],
    "16 rows a block from 160": [("kKvRW = 4;", "kKvRW = W >= 160 ? 1 : 4;"),
                                 ("kQRW = 4;", "kQRW = W >= 160 ? 1 : 4;")],
    "dK/dV 8 warps": [("kKvRW = 4;", "kKvRW = W <= 80 ? 8 : 4;")],
    "dQ 8 warps": [("kQRW = 4;", "kQRW = W <= 80 ? 8 : 4;")],
    "dK/dV 32 queries": [("static constexpr int kKvQ = W >= 256 ? 32 : 64;",
                          "static constexpr int kKvQ = 32;")],
    "no ex2": [("ex2(fmaf(", "(fmaf(")],  # every exponential of the pair
}
BWD_FP32_VARIANTS = {
    "as committed": [],
    "16 rows a block from 160": [("kKvRW = W >= 256 ? 2 : 4", "kKvRW = W >= 160 ? 1 : 4"),
                                 ("kQRW = W >= 256 ? 2 : 4", "kQRW = W >= 160 ? 1 : 4")],
    "1 block an SM": [("__launch_bounds__(Cfg<W>::kKvThreads, Cfg<W>::kMinBlocks)",
                       "__launch_bounds__(Cfg<W>::kKvThreads)"),
                      ("__launch_bounds__(Cfg<W>::kQThreads, Cfg<W>::kMinBlocks)",
                       "__launch_bounds__(Cfg<W>::kQThreads)")],
    "dK/dV 32 queries": [("static constexpr int kKvQ = W >= 160 ? 32 : 64;",
                          "static constexpr int kKvQ = 32;")],
    "dQ 32 keys": [("static constexpr int kQKeys = W >= 160 ? 32 : 64;",
                    "static constexpr int kQKeys = 32;")],
    "1xTF32": [("  mma_tf32(d, as, bb0, bb1);\n  mma_tf32(d, ab, bs0, bs1);\n  mma_tf32(d, ab, bb0, bb1);",
                "  mma_tf32(d, ab, bb0, bb1);")],
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


WIDE_SHAPES = [(1, 4096, 512), (4, 4096, 512)]  # (batch, S, d), one head
_WIDE_QK = ("          wgmma::ss_m64n64k16(s, kmajor_desc(qa + off, kd), kmajor_desc(ka + off, kd),\n"
            "                              j > d0 || kd > 0);")
_WIDE_PV = ("        for (int kk = 0; kk < kKeys / 16; ++kk) wgmma::Rs<128>::mma(all, pa[kk], "
            "v_desc(va, kk));")
_WIDE_NO_CLUSTER_EXCHANGE = [
    ("    named_barrier_sync(2, 128 * kConsumers);  // both read: the buffers may be written again\n"
     "    if (pl.cs == 1) return;", "    named_barrier_sync(2, 128 * kConsumers);  // both read: the "
     "buffers may be written again\n    if (true) return;"),
    ("  auto finish = [&](float(&s)[32], int t) {\n    if (pl.cs == 1) return;",
     "  auto finish = [&](float(&s)[32], int t) {\n    if (true) return;")]
WIDE_VARIANTS = {
    "as committed": [],
    # each block forms S from its own depth share only: no partials between blocks
    "no cluster exchange": _WIDE_NO_CLUSTER_EXCHANGE,
    # nor between the block's two warpgroups: each forms S from its own half
    "no exchange": _WIDE_NO_CLUSTER_EXCHANGE + [
        ("  auto combine = [&](float(&s)[32], int t) {\n",
         "  auto combine = [&](float(&s)[32], int t) {\n    if (true) return;\n")],
    # P V's wgmma dropped (its waits and releases kept), or Q K^T's
    "no P V": [(_WIDE_PV, "        all[0] += __uint_as_float(pa[0][0] ^ va);")],
    "no Q K^T": [(_WIDE_QK, "          s[kd] += __uint_as_float(qa ^ ka);")],
    # S(j+1) issued after tile j's softmax and O's rescale, not before them
    "S after softmax": [("    int kept = n;\n    if constexpr (next) kept = issue_qk(nxt);\n"
                         "    finish(cur, t);\n    softmax(cur);\n", "    finish(cur, t);\n"
                         "    softmax(cur);\n"),
                        ("        acc[c][i + 3] *= alpha[1];\n      }\n    const int first_v = n;",
                         "        acc[c][i + 3] *= alpha[1];\n      }\n    int kept = n;\n"
                         "    if constexpr (next) kept = issue_qk(nxt);\n    const int first_v = n;")],
    # the softmax (and P's packing) dropped: P V runs on stale P
    "no softmax": [("  auto softmax = [&](float(&s)[32]) {\n",
                    "  auto softmax = [&](float(&s)[32]) {\n    return;\n")],
    # the producer arrives on each full barrier without copying (stale data)
    "no K/V loads": [("        mbar_arrive_expect_tx(ring.full_bar(n), count * kPanelBytes);\n"
                      "        load(", "        mbar_arrive(ring.full_bar(n));\n        if (false)"
                      " load(")],
}


def _build(csrc: str, out: str, source: str, variants: dict, extra: str = "") -> dict:
    """name -> (ctypes library, registers per instance, spill bytes per instance)
    for each copy of ``source`` in ``variants``, ``extra`` appended to each."""
    src = open(os.path.join(csrc, source)).read()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    procs = {}
    for i, (name, reps) in enumerate(variants.items()):
        text = src
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"kernel_variants: {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        text += extra
        path = os.path.join(out, f"v{i}.cu")
        for header in ("tma_sm90.cuh", "wgmma_sm90.cuh", "flash_bwd_common.cuh"):
            shutil.copy(os.path.join(csrc, header), out)
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
            vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, ci, vp]
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
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, 1, h, s, s, d,
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


# appended to each copy of the wide kernel: the clusters of its d = 512 launch
# (the even instance, cq x 2 blocks of its shared memory) the card holds at once
_WIDE_CLUSTERS = r"""
extern "C" int variants_resident_clusters(int cq, int* out) {
  auto kernel = flash_wide_fwd_kernel<true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(64, 2, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cq;
  cluster.val.clusterDim.y = 2;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(out, reinterpret_cast<const void*>(kernel), &cfg);
  return (int)err;
}
"""


def _wide(torch, csrc: str, out: str) -> None:
    """WIDE_VARIANTS at WIDE_SHAPES, after the clusters of 1 x 2 and 2 x 2
    blocks the card holds at once."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from videosd_tpu_torch.ops.cuda import flash_attention as fa

    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = _build(csrc, out, "flash_attention_wide.cu", WIDE_VARIANTS, _WIDE_CLUSTERS)
    for name, (lib, regs, spills) in libs.items():
        lib.videosd_flash_attention_wide_fwd.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ci, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ci, vp]
        print(f"{name}: registers {regs}, spill bytes {spills}")
    for cq in (1, 2):
        n = ctypes.c_int(0)
        err = libs["as committed"][0].variants_resident_clusters(cq, ctypes.byref(n))
        print(f"clusters of {cq} x 2 blocks resident at once: {n.value} ({cq * 2 * n.value} "
              f"blocks; the d = 512 launch at [1, 4096, 512] has 128; cudaError {err})")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, d in WIDE_SHAPES:
        q, k, v = (torch.randn(b, s, d, generator=gen, device="cuda").bfloat16() for _ in range(3))
        o = torch.empty_like(q)
        strides = (ctypes.c_longlong * 8)(*(x for t in (q, k, v, o)
                                            for x in (t.stride(0), t.stride(1))))
        plain = fa.flash_attention_reference(q, k, v, d ** -0.5).float()
        stream = torch.cuda.current_stream().cuda_stream

        def run(lib):
            err = lib.videosd_flash_attention_wide_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, 1, s, s, d, strides,
                d ** -0.5, 0, stream)
            if err:
                raise SystemExit(f"kernel_variants: launch failed: cudaError {err}")

        ms = _turns(torch, libs, run)
        for name, (lib, _, _) in libs.items():
            run(lib)
            torch.cuda.synchronize()
            err = ((o.float() - plain).abs().max() / plain.abs().max()).item()
            print(f"[{b},{s},{d}] {name}: {statistics.median(ms[name]):.4f} ms per launch "
                  f"(turns {', '.join(f'{t:.4f}' for t in ms[name])}), max |d| / max |o| "
                  f"from the plain version {err:.2e}")


def _bwd(torch, csrc: str, out: str) -> None:
    """BWD_VARIANTS and BWD_FP32_VARIANTS at BWD_SHAPES: each copy's dq, dk
    and dv against the committed wrapper's."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from videosd_tpu_torch.ops.cuda import flash_attention as fa

    vp, ci = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, source, variants, entry in (
            (torch.bfloat16, "flash_attention_bwd.cu", BWD_VARIANTS, "videosd_flash_attention_bwd"),
            (torch.float32, "flash_attention_bwd_fp32.cu", BWD_FP32_VARIANTS,
             "videosd_flash_attention_bwd_fp32")):
        os.makedirs(os.path.join(out, source[:-3]))
        libs = _build(csrc, os.path.join(out, source[:-3]), source, variants)
        for name, (lib, regs, spills) in libs.items():
            fn = getattr(lib, entry)
            fn.argtypes = [vp] * 10 + [ci] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                                  ctypes.c_float, ci, vp]
            print(f"{source} {name}: registers {regs}, spill bytes {spills} (dK/dV and dQ, "
                  f"instances 256 .. 8)")
        for h, s, d in BWD_SHAPES:
            q, k, v, do = (torch.randn(1, s, h * d, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            o, lse = fa.flash_attention_lse(q, k, v, num_heads=h)
            want = fa.flash_attention_bwd(q, k, v, o, lse, do, h, d ** -0.5)
            delta = torch.empty_like(lse)
            got = [torch.empty_like(x) for x in (q, k, v)]
            strides = (ctypes.c_longlong * 10)(*(x for t in (q, k, v, o, do)
                                                 for x in (t.stride(0), t.stride(1))))
            args = [t.data_ptr() for t in (q, k, v, o, do, lse, delta, *got)]
            args += [1, h, s, s, d, strides, d ** -0.5, 0, torch.cuda.current_stream().cuda_stream]

            def run(lib):
                err = getattr(lib, entry)(*args)
                if err:
                    raise SystemExit(f"kernel_variants: launch failed: cudaError {err}")

            ms = _turns(torch, libs, run)
            for name, (lib, _, _) in libs.items():
                run(lib)
                torch.cuda.synchronize()
                err = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                          for a, b in zip(got, want))
                print(f"{dtype} [{h},{s},{d}] {name}: {statistics.median(ms[name]):.4f} ms per "
                      f"backward (turns {', '.join(f'{t:.4f}' for t in ms[name])}), max |d| / "
                      f"max |g| from the committed kernels {err:.2e}")


def main(argv=None) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
    ablations = {"k1": _k1, "k3": _k3, "wide": _wide, "bwd": _bwd}
    names = sys.argv[1:] if argv is None else argv
    for name in names or ablations:
        with tempfile.TemporaryDirectory() as out:
            ablations[name](torch, csrc, out)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")


if __name__ == "__main__":
    main()
