"""Two measurements of the card that K1's fp32 wide kernel is built around.

    python3 videosd_tpu_torch/hw_probe.py

* ``mma.sync.m16n8k8`` in TF32: 8 independent accumulator chains per warp,
  1 and 2 warps per scheduler (132 blocks of 4 and 8 warps), TFLOP/s and
  cycles per ``mma`` per scheduler at the card's maximum SM clock; with one
  warp per scheduler the 8 chains are in flight together, so 8 x those
  cycles bounds the latency of one ``mma`` from above.
* Fetching 64 KB tiles (32 rows of 512 fp32, one head of K or V at
  d = 512) into shared memory, 128 blocks x 128 tiles, two tiles in flight:
  32 bulk row copies issued by one warp, and cp.async by every thread, in
  TB/s from L2.

Builds its own small CUDA source with nvcc (``CUDA_HOME`` or
/usr/local/cuda) into a temporary directory, prints one JSON line per
measurement and the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile

import torch

_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void mma_tf32(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b[2] = {threadIdx.x * 11u, threadIdx.x * 13u};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// tiles of 32 rows x 512 floats into two shared buffers (row stride 516)
template <bool kBulk>
__global__ void __launch_bounds__(256, 1) fetch(const float* src, float* sink, int tiles) {
  extern __shared__ float buf[];
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(&bar[i])));
    asm volatile("fence.mbarrier_init.release.cluster;\n");
  }
  __syncthreads();
  auto issue = [&](int i) {
    const float* s = src + (long long)(i % tiles) * 32 * 512;
    float* d = buf + (i & 1) * 32 * 516;
    if (kBulk) {
      if (warp == 0) {
        if (lane == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 65536;\n"
                       ::"r"(smem(&bar[i & 1])));
        __syncwarp();
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                     "[%0], [%1], 2048, [%2];\n" ::"r"(smem(d + lane * 516)),
                     "l"(s + lane * 512), "r"(smem(&bar[i & 1])) : "memory");
      }
    } else {
      for (int k = tid; k < 32 * 128; k += 256)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     ::"r"(smem(d + k / 128 * 516 + 4 * (k % 128))), "l"(s + 4 * k) : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  float acc = 0.f;
  issue(0);
  for (int i = 0; i < tiles; ++i) {
    __syncthreads();  // every thread is done with the buffer refilled next
    if (i + 1 < tiles) issue(i + 1);
    if (kBulk) {
      asm volatile("{\n.reg .pred p;\nW: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
                   "@!p bra W;\n}\n" ::"r"(smem(&bar[i & 1])), "r"((i >> 1) & 1) : "memory");
    } else if (i + 1 < tiles) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    acc += buf[(i & 1) * 32 * 516 + tid];
  }
  sink[blockIdx.x * 256 + tid] = acc;
}

extern "C" int run_mma(float* out, int blocks, int threads, int iters, void* stream) {
  mma_tf32<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int run_fetch(int bulk, const float* src, float* sink, int blocks, int tiles,
                         void* stream) {
  const int bytes = 2 * 32 * 516 * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bulk) {
    cudaFuncSetAttribute(fetch<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    fetch<true><<<blocks, 256, bytes, st>>>(src, sink, tiles);
  } else {
    cudaFuncSetAttribute(fetch<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    fetch<false><<<blocks, 256, bytes, st>>>(src, sink, tiles);
  }
  return (int)cudaGetLastError();
}
"""


def _timed_ms(fn, reps: int = 5) -> float:
    if fn() != 0:
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("hw_probe: needs a CUDA card")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    smi = ["nvidia-smi", "--format=csv,noheader"]
    clock_hz = float(subprocess.run(smi + ["--query-gpu=clocks.max.sm"], capture_output=True,
                                    text=True, check=True).stdout.split()[0]) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.so")
        with open(src, "w") as f:
            f.write(_SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-o", lib, src], check=True)
        probe = ctypes.CDLL(lib)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    probe.run_mma.argtypes = [vp, ci, ci, ci, vp]
    probe.run_fetch.argtypes = [ci, vp, vp, ci, ci, vp]
    stream = torch.cuda.current_stream().cuda_stream
    sms, iters = torch.cuda.get_device_properties(0).multi_processor_count, 4096
    out = torch.empty(sms * 256, device="cuda")
    for warps in (4, 8):
        ms = _timed_ms(lambda: probe.run_mma(out.data_ptr(), sms, 32 * warps, iters, stream))
        mmas = sms * warps * iters * 8
        print(json.dumps({"probe": "mma.sync m16n8k8 tf32", "warps_per_scheduler": warps // 4,
                          "tflops": mmas * 2048 / ms / 1e9,
                          "cycles_per_mma_per_scheduler": ms * 1e-3 * clock_hz * sms * 4 / mmas}))
    tiles = 128
    src_t = torch.randn(tiles * 32 * 512, device="cuda")
    sink = torch.empty(128 * 256, device="cuda")
    for bulk, how in ((1, "32 bulk row copies from one warp"), (0, "cp.async by every thread")):
        ms = _timed_ms(lambda: probe.run_fetch(bulk, src_t.data_ptr(), sink.data_ptr(), 128,
                                               tiles, stream))
        print(json.dumps({"probe": "64 KB tiles into shared memory", "how": how,
                          "tb_per_s_from_l2": 128 * tiles * 65536 / ms / 1e9}))
    card = subprocess.run(smi + ["--query-gpu=name,power.limit"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}")


if __name__ == "__main__":
    main()
