// 3x3 conv of the TAESD residual blocks in fp32 for Hopper (sm_90a), with the
// fused epilogue.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/taesd_conv.py::packed_conv3x3
// (taesd_conv.py:231, body `_conv_kernel`) for fp32 activations: that kernel
// keeps xp.dtype, so an fp32 bundle on the pallas_convs route sends it fp32.
// taesd_conv.cu is the bf16 kernel.  It computes what both compute: a 3x3
// SAME stride-1 conv, 64 -> 64 channels, summed in fp32, then +bias and either
// ReLU, or +skip and ReLU (or neither), in fp32, on the pixel-pair-packed
// [B, H, W/2, 128] activations read as the NHWC [B, H, W, 64] they are.
//
// What bounds it on the H100: 73,728 flops per output pixel on the FFMA pipes
// (no TF32: a 10-bit mantissa would not hold fp32's bar), 67 TFLOP/s at
// 1.98 GHz: 0.29 ms at 512^2, against 0.02 ms of bytes.  This is the simple
// kernel, right first:
//
// * The taps stay resident in shared memory, fp32 [9][64 ci][64 co] (147,456
//   bytes, laid out once per weight by the wrapper), over a persistent grid
//   of one block per SM (as many as there are tiles).
// * A tile is TR output rows x 64 pixels x 64 channels, TR = 4, 2 or 1, the
//   most rows that still give every SM a tile (the caller's choice): one
//   tile is 2.4 MFMA a row on one SM, so at 64^2 four-row tiles left 116 of
//   132 SMs idle and ran at half cuDNN's speed.  Its input halo, TR + 2 rows
//   x 66 pixels, comes through shared memory 16 input channels at a time, in
//   two stages filled by cp.async (zero-filled outside the image: the SAME
//   padding), so the next chunk or tile loads under this one's products.
// * Thread t of 256 owns 2 TR pixels of one row x 8 channels (co = 4 (t % 8)
//   + {0..3} and 32 + the same): per 4 input channels of one tap row it reads
//   2 TR + 2 input float4 (the three taps of the row share them) and 24 tap
//   float4, for 192 TR FFMA.  A warp's 4 pixel groups read 4 input addresses
//   in 4 different bank groups (a halo pixel holds 20 floats, a halo row
//   66), and its 8 channel groups 128 contiguous bytes of a tap row.
// * The epilogue adds the bias, the skip and the ReLU in fp32 in the plain
//   version's order and stores each pixel's 64 channels as 16 float4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;          // input and output channels
constexpr int kTW = 64;         // output pixels of a tile row
constexpr int kHW = kTW + 2;    // halo pixels of a row
constexpr int kCK = 16;         // input channels per stage
constexpr int kPix = kCK + 4;   // floats per halo pixel (padded)
constexpr int kTapsFloats = 9 * kC * kC;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 16;

// A tile of TR output rows: its halo stage and shared memory, and each
// thread's pixels (2 TR of one row).
template <int TR>
struct Plan {
  static constexpr int kStageFloats = (TR + 2) * kHW * kPix;
  static constexpr int kSmem = (kTapsFloats + 2 * kStageFloats) * 4;  // 210,816 bytes at TR = 4
  static constexpr int kPx = 2 * TR;
};

struct Args {
  const float* x;     // [B, H, W, 64]
  const float* taps;  // [9][64 ci][64 co]
  const float* bias;  // [64] or null
  const float* skip;  // [B, H, W, 64] or null
  float* out;         // [B, H, W, 64]
  int batch, h, w, relu;
  int tiles_x, tiles_y, n_tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from src, or zeros where `bytes` is 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int TR>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_fp32_kernel(const Args a) {
  using P = Plan<TR>;
  constexpr int kStageFloats = P::kStageFloats;
  constexpr int kPx = P::kPx;
  extern __shared__ float4 smem4[];
  float* taps_s = reinterpret_cast<float*>(smem4);
  float* halo_s = taps_s + kTapsFloats;  // two stages
  const int tid = threadIdx.x;
  const int cog = tid % 8;                     // channels 4 cog .. + 3 and 32 + 4 cog .. + 3
  const int rr = (tid / 8) % TR;               // output row of the tile
  const int px0 = (tid / (8 * TR)) * kPx;      // first of kPx output pixels

  for (int i = tid; i < kTapsFloats / 4; i += kThreads) cp_async16(taps_s + 4 * i, a.taps + 4 * i, 16);
  cp_async_commit();

  auto origin = [&](int tile, int& b, int& y0, int& x0) {
    x0 = (tile % a.tiles_x) * kTW;
    y0 = (tile / a.tiles_x % a.tiles_y) * TR;
    b = tile / (a.tiles_x * a.tiles_y);
  };
  // step n: channel chunk n % 4 of the block's tile n / 4
  auto load_step = [&](int n) {
    int b, y0, x0;
    origin(blockIdx.x + (n / 4) * gridDim.x, b, y0, x0);
    float* dst = halo_s + (n % 2) * kStageFloats;
    const float* base = a.x + (n % 4) * kCK;
    for (int i = tid; i < (TR + 2) * kHW * 4; i += kThreads) {
      const int q = i % 4, px = i / 4 % kHW, r = i / (4 * kHW);
      const int y = y0 + r - 1, x = x0 + px - 1;
      const bool in = y >= 0 && y < a.h && x >= 0 && x < a.w;
      const float* src = in ? base + (((long long)b * a.h + y) * a.w + x) * kC + 4 * q : a.x;
      cp_async16(dst + (r * kHW + px) * kPix + 4 * q, src, in ? 16 : 0);
    }
  };

  const int my_tiles = (a.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int steps = 4 * my_tiles;
  if (steps > 0) load_step(0);
  cp_async_commit();

  float bias_r[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) bias_r[e] = a.bias ? a.bias[(e / 4) * 32 + 4 * cog + e % 4] : 0.f;

  float acc[kPx][8];  // [pixel][channel]
#pragma unroll
  for (int i = 0; i < kPx; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int n = 0; n < steps; ++n) {
    cp_async_wait0();  // this step's halo (and, at the first, the taps) have landed
    __syncthreads();   // and every thread is done with the other stage
    if (n + 1 < steps) load_step(n + 1);
    cp_async_commit();

    const float* halo = halo_s + (n % 2) * kStageFloats;
    const float* taps = taps_s + (n % 4) * kCK * kC;
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 1
      for (int c4 = 0; c4 < kCK / 4; ++c4) {
        const float* in_row = halo + ((rr + dy) * kHW + px0) * kPix + 4 * c4;
        float4 in[kPx + 2];
#pragma unroll
        for (int i = 0; i < kPx + 2; ++i) in[i] = *reinterpret_cast<const float4*>(in_row + i * kPix);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* wrow = taps + ((dy * 3 + dx) * kC + 4 * c4 + e) * kC + 4 * cog;
            const float4 wa = *reinterpret_cast<const float4*>(wrow);
            const float4 wb = *reinterpret_cast<const float4*>(wrow + 32);
#pragma unroll
            for (int i = 0; i < kPx; ++i) {
              const float xv = lane(in[i + dx], e);
              acc[i][0] = fmaf(xv, wa.x, acc[i][0]);
              acc[i][1] = fmaf(xv, wa.y, acc[i][1]);
              acc[i][2] = fmaf(xv, wa.z, acc[i][2]);
              acc[i][3] = fmaf(xv, wa.w, acc[i][3]);
              acc[i][4] = fmaf(xv, wb.x, acc[i][4]);
              acc[i][5] = fmaf(xv, wb.y, acc[i][5]);
              acc[i][6] = fmaf(xv, wb.z, acc[i][6]);
              acc[i][7] = fmaf(xv, wb.w, acc[i][7]);
            }
          }
        }
      }
    }
    if (n % 4 != 3) continue;

    // ---- epilogue of the tile: (sum + bias) + skip, ReLU, in fp32
    int b, y0, x0;
    origin(blockIdx.x + (n / 4) * gridDim.x, b, y0, x0);
    const int y = y0 + rr;
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      const int x = x0 + px0 + i;
      if (y < a.h && x < a.w) {
        const long long base = (((long long)b * a.h + y) * a.w + x) * kC + 4 * cog;
        float v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = acc[i][c] + bias_r[c];
        if (a.skip) {
          const float4 sa = *reinterpret_cast<const float4*>(a.skip + base);
          const float4 sb = *reinterpret_cast<const float4*>(a.skip + base + 32);
          v[0] += sa.x, v[1] += sa.y, v[2] += sa.z, v[3] += sa.w;
          v[4] += sb.x, v[5] += sb.y, v[6] += sb.z, v[7] += sb.w;
        }
        if (a.relu) {
#pragma unroll
          for (int c = 0; c < 8; ++c) v[c] = fmaxf(v[c], 0.f);
        }
        *reinterpret_cast<float4*>(a.out + base) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(a.out + base + 32) = make_float4(v[4], v[5], v[6], v[7]);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    }
  }
  cp_async_wait0();
}

template <int TR>
cudaError_t launch(Args a, int device, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_fp32_kernel<TR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Plan<TR>::kSmem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  a.tiles_x = (a.w + kTW - 1) / kTW;
  a.tiles_y = (a.h + TR - 1) / TR;
  const long long n_tiles = (long long)a.batch * a.tiles_x * a.tiles_y;
  if (n_tiles > (1ll << 30)) return cudaErrorInvalidValue;
  a.n_tiles = (int)n_tiles;
  const int grid = a.n_tiles < sms[device] ? a.n_tiles : sms[device];
  conv3x3_fp32_kernel<TR><<<grid, kThreads, Plan<TR>::kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, skip, out: NHWC [batch, h, w, 64] fp32, 16-byte aligned; taps [9][64 ci][64
// co] fp32; bias [64] fp32.  skip and bias may be null.  out must not alias x.
// tile_rows, the output rows of a tile, is 4, 2 or 1.  Returns a cudaError_t:
// 0 on a successful launch.
int videosd_taesd_conv3x3_fp32(const void* x, const void* taps, const void* bias, const void* skip,
                               void* out, int batch, int h, int w, int relu, int tile_rows,
                               int device, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(x), static_cast<const float*>(taps),
         static_cast<const float*>(bias), static_cast<const float*>(skip),
         static_cast<float*>(out), batch, h, w, relu, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_rows) {
    case 4: return (int)launch<4>(a, device, s);
    case 2: return (int)launch<2>(a, device, s);
    case 1: return (int)launch<1>(a, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
