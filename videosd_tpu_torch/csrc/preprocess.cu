// Fused frame preprocess with the Sobel stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/preprocess_kernel.py::
// sobel_magnitude_pallas (body `_kernel`) and the XLA math around it in that
// file's `fused_preprocess`: u8 -> x01 = u8 / 255 -> img = x01 * 2 - 1, and
// PIL-floored luma -> zero-padded 3x3 Sobel magnitude -> divide by the image's
// max -> double threshold.  The TPU kernel read a pre-computed fp32 luma plane
// because a [H, W, 3] u8 array cannot be DMA-sliced on the TPU; here one pass
// reads the u8 frame once, and the luma of each block's halo is recomputed
// from the u8 tile instead of being written out and read back.
//
// Two passes, because the threshold needs the max over the whole image and
// blocks run in no order:
//   pass 1 (one block per 32 x 16 pixel tile, 256 threads): luma of the
//     (16+2) x (32+2) halo into shared memory, then per pixel img, gx, gy and
//     |grad|; |grad| goes to the edge buffer, and each block's max goes to
//     one global word by atomicMax on the float's bits (|grad| >= 0, so the
//     bits order like the floats);
//   pass 2 (elementwise): edge = |grad| / max(mx, 1e-12), then >= high -> 1
//     and <= low -> 0, in place.
// It is bound by device memory: 3 bytes in, 6 (bf16) + 4 + 4 + 4 bytes out
// and back per pixel, a few microseconds at 512^2.
//
// Rounding: the plain PyTorch version runs each operation as its own eager
// kernel, so every product and sum is rounded on its own.  nvcc contracts
// a * b + c into one fused multiply-add by default; a fused luma moves the
// floor at integer boundaries, and a fused gx * gx + gy * gy moves |grad| by
// an ulp, either of which can move a thresholded pixel.  So that arithmetic
// is written with the _rn intrinsics, which are never contracted, divisions
// are IEEE (__fdiv_rn) and the square root is correctly rounded
// (__fsqrt_rn), as the plain version's fp64 square root rounded to fp32 is.
// The kernel then matches the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;  // output columns per block (one warp's width)
constexpr int kTileH = 16;  // output rows per block
constexpr int kRowsStep = 8;
constexpr int kThreads = kTileW * kRowsStep;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloH = kTileH + 2;

__device__ __forceinline__ float unit(uint8_t v) { return __fdiv_rn((float)v, 255.f); }

// floor(((299 r + 587 g) + 114 b) * 255 / 1000) / 255, every step rounded
__device__ __forceinline__ float luma(const uint8_t* px) {
  const float l255 = __fadd_rn(__fadd_rn(__fmul_rn(299.f, unit(px[0])), __fmul_rn(587.f, unit(px[1]))),
                               __fmul_rn(114.f, unit(px[2])));
  return __fdiv_rn(floorf(__fdiv_rn(__fmul_rn(l255, 255.f), 1000.f)), 255.f);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// kFrame: read a [H, W, 3] u8 frame, write img and the block maxima;
// otherwise read a [H, W] fp32 gray plane and write only |grad|.
template <bool kFrame, typename OutT>
__global__ void __launch_bounds__(kThreads)
    sobel_pass1(const uint8_t* __restrict__ frame, const float* __restrict__ gray,
                OutT* __restrict__ img, float* __restrict__ mag, unsigned* __restrict__ mx_bits,
                int h, int w) {
  __shared__ float g_s[kHaloH][kHaloW + 1];
  __shared__ float warp_max[kThreads / 32];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  for (int i = tid; i < kHaloH * kHaloW; i += kThreads) {
    const int hy = i / kHaloW, hx = i % kHaloW;
    const int y = y0 + hy - 1, x = x0 + hx - 1;
    float v = 0.f;  // the gray plane is zero-padded
    if (y >= 0 && y < h && x >= 0 && x < w) {
      if constexpr (kFrame) {
        v = luma(frame + ((size_t)y * w + x) * 3);
      } else {
        v = gray[(size_t)y * w + x];
      }
    }
    g_s[hy][hx] = v;
  }
  __syncthreads();

  float local_max = 0.f;
  const int x = x0 + threadIdx.x;
  for (int ty = threadIdx.y; ty < kTileH; ty += kRowsStep) {
    const int y = y0 + ty;
    if (y >= h || x >= w) continue;
    const int sy = ty + 1, sx = threadIdx.x + 1;
    const float tl = g_s[sy - 1][sx - 1], tc = g_s[sy - 1][sx], tr = g_s[sy - 1][sx + 1];
    const float ml = g_s[sy][sx - 1], mr = g_s[sy][sx + 1];
    const float bl = g_s[sy + 1][sx - 1], bc = g_s[sy + 1][sx], br = g_s[sy + 1][sx + 1];
    // (tr + 2 mr + br) - (tl + 2 ml + bl), (bl + 2 bc + br) - (tl + 2 tc + tr)
    const float gx = __fsub_rn(__fadd_rn(__fadd_rn(tr, __fmul_rn(2.f, mr)), br),
                               __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, ml)), bl));
    const float gy = __fsub_rn(__fadd_rn(__fadd_rn(bl, __fmul_rn(2.f, bc)), br),
                               __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, tc)), tr));
    const float m = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
    const size_t p = (size_t)y * w + x;
    mag[p] = m;
    if constexpr (kFrame) {
      local_max = fmaxf(local_max, m);
      const uint8_t* px = frame + p * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) store(img + p * 3 + c, __fsub_rn(__fmul_rn(unit(px[c]), 2.f), 1.f));
    }
  }

  if constexpr (kFrame) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
    if (threadIdx.x == 0) warp_max[threadIdx.y] = local_max;
    __syncthreads();
    if (tid == 0) {
      float m = warp_max[0];
#pragma unroll
      for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, warp_max[i]);
      atomicMax(mx_bits, __float_as_uint(m));
    }
  }
}

__global__ void edge_pass2(float* __restrict__ edge, const unsigned* __restrict__ mx_bits,
                           size_t n, float low, float high) {
  const float mx = fmaxf(__uint_as_float(*mx_bits), 1e-12f);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float e = __fdiv_rn(edge[i], mx);
    if (e >= high) e = 1.f;
    if (e <= low) e = 0.f;
    edge[i] = e;
  }
}

dim3 pass1_grid(int h, int w) { return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH); }

template <typename OutT>
cudaError_t launch_preprocess(const uint8_t* frame, OutT* img, float* edge, unsigned* mx_bits,
                              int h, int w, float low, float high, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(mx_bits, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  sobel_pass1<true, OutT><<<pass1_grid(h, w), dim3(kTileW, kRowsStep), 0, stream>>>(
      frame, nullptr, img, edge, mx_bits, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)h * w;
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  edge_pass2<<<(unsigned)(blocks < 4096 ? blocks : 4096), threads, 0, stream>>>(edge, mx_bits, n,
                                                                                 low, high);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// frame [h, w, 3] u8 -> img [h, w, 3] (img_bf16 ? bf16 : fp32) and edge [h, w]
// fp32; mx_bits is one 32-bit word of scratch.  Returns a cudaError_t.
int videosd_fused_preprocess(const void* frame, void* img, int img_bf16, void* edge,
                             void* mx_bits, int h, int w, float low, float high, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frame);
  float* e = static_cast<float*>(edge);
  unsigned* mx = static_cast<unsigned*>(mx_bits);
  if (img_bf16)
    return (int)launch_preprocess(f, static_cast<__nv_bfloat16*>(img), e, mx, h, w, low, high, s);
  return (int)launch_preprocess(f, static_cast<float*>(img), e, mx, h, w, low, high, s);
}

// gray [h, w] fp32 -> mag [h, w] fp32, the zero-padded Sobel magnitude.
int videosd_sobel_magnitude(const void* gray, void* mag, int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  sobel_pass1<false, float><<<pass1_grid(h, w), dim3(kTileW, kRowsStep), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      nullptr, static_cast<const float*>(gray), nullptr, static_cast<float*>(mag), nullptr, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
