// 3x3 conv of the TAESD residual blocks for Hopper (sm_90a), with the fused
// epilogue.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/taesd_conv.py::packed_conv3x3
// (body `_conv_kernel`), which the TAESD encoder and decoder reach through
// videosd_tpu/models/taesd.py::_block_apply_pallas.  It computes what that
// kernel computes: a 3x3 SAME stride-1 conv, 64 -> 64 channels, then in fp32
// +bias and either ReLU, or +skip and ReLU (or neither), with one rounding to
// bf16 at the end.
//
// The TPU kernel works on pixel-pair-packed activations [B, H, W/2, 128] with
// block-packed [3, 3, 128, 128] taps, half of them zeros, only to fill the
// TPU's 128 lanes.  [B, H, W/2, 128] is the same memory as NHWC [B, H, W, 64],
// so this kernel reads it as NHWC and runs the dense [3, 3, 64, 64] taps:
// 73,728 flops per output pixel, half the TPU kernel's array work.
//
// Work split: the output is cut into tiles of 8 rows x 16 columns x all 64
// channels.  A block of 4 warps stages the 9 x 64 x 64 bf16 taps in shared
// memory once (81 KB with padding, above the 48 KB default: the launcher
// raises the limit), then walks over tiles (grid = the blocks that fit on
// the card at once).  Per tile it stages the (8+2) x (16+2) x 64 input halo,
// zero outside the image on all four sides, and each warp computes 2 output
// rows of 16 pixels x 64 channels as 9 taps x 4 k-steps of
// mma.sync.m16n8k16 bf16 -> fp32: the A operand is 16 neighbouring pixels of
// the halo tile shifted by the tap, the B operand the tap's [64 co][64 ci]
// matrix.  The epilogue stages the skip tile and the rounded output through
// shared memory, so global loads and stores are 16-byte vectors.  Partial
// tiles at the bottom and right edges are masked, so any H and W work.
//
// What bounds it on the H100: at 512^2 one conv is 19.3 GFLOP against
// 64-96 MB of activations in and out, near the ridge point.  This first
// version is simple: no cp.async/TMA pipelining of the halo tiles (two
// blocks per SM overlap one's loads with the other's math), no ldmatrix, no
// wgmma; its fragments come from 32-bit shared-memory loads, which bounds it
// well below the tensor-core peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;  // input and output channels
constexpr int kTileH = 8;
constexpr int kTileW = 16;  // one mma M of 16 pixels per output row
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTileH / kWarps;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kLds = kC + 8;  // shared row stride in bf16: +16 bytes, no bank conflicts
constexpr int kVecs = kC / 8;  // 16-byte vectors per pixel
constexpr int kNT = kC / 8;    // 8-channel output tiles of the mma
constexpr int kKS = kC / 16;   // 16-channel k-steps of the mma
constexpr size_t kTapElems = (size_t)9 * kC * kLds;
constexpr size_t kSmem = (kTapElems + (size_t)kHaloH * kHaloW * kLds) * sizeof(__nv_bfloat16);

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x, skip, out: NHWC [batch, h, w, 64] bf16; taps [9][64 co][64 ci] bf16 (tap =
// 3 * dy + dx); bias [64] fp32.  skip may be null.  out must not alias x.
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ taps,
                   const float* __restrict__ bias, const __nv_bfloat16* __restrict__ skip,
                   __nv_bfloat16* __restrict__ out, int batch, int h, int w, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* x_s = w_s + kTapElems;  // the halo tile, then the output tile

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group

  for (int i = threadIdx.x; i < 9 * kC * kVecs; i += kThreads) {
    const int row = i / kVecs, c = (i % kVecs) * 8;
    *reinterpret_cast<uint4*>(w_s + row * kLds + c) =
        *reinterpret_cast<const uint4*>(taps + (size_t)row * kC + c);
  }
  // this thread's output channels are n * 8 + 2t and n * 8 + 2t + 1
  float bias_r[kNT][2];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    bias_r[n][0] = bias[n * 8 + 2 * t];
    bias_r[n][1] = bias[n * 8 + 2 * t + 1];
  }

  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const int n_tiles = batch * tiles_y * tiles_x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int x0 = (tile % tiles_x) * kTileW;
    const int y0 = ((tile / tiles_x) % tiles_y) * kTileH;
    const size_t img_off = (size_t)(tile / (tiles_x * tiles_y)) * h * w * kC;

    __syncthreads();  // the previous tile's output has left x_s
    for (int i = threadIdx.x; i < kHaloH * kHaloW * kVecs; i += kThreads) {
      const int p = i / kVecs, c = (i % kVecs) * 8;
      const int yy = y0 + p / kHaloW - 1, xx = x0 + p % kHaloW - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);  // SAME padding
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        v = *reinterpret_cast<const uint4*>(x + img_off + ((size_t)yy * w + xx) * kC + c);
      *reinterpret_cast<uint4*>(x_s + p * kLds + c) = v;
    }
    __syncthreads();

    float acc[kRowsPerWarp][kNT][4];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int n = 0; n < kNT; ++n) acc[r][n][0] = acc[r][n][1] = acc[r][n][2] = acc[r][n][3] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const __nv_bfloat16* wt = w_s + tap * kC * kLds;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const int k0 = ks * 16 + 2 * t;
        // A: output pixel (row, col m) reads halo pixel (row + dy, m + dx)
        uint32_t a[kRowsPerWarp][4];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const __nv_bfloat16* ar =
              x_s + ((warp * kRowsPerWarp + r + dy) * kHaloW + dx) * kLds + k0;
          a[r][0] = lds32(ar + g * kLds);
          a[r][1] = lds32(ar + (g + 8) * kLds);
          a[r][2] = lds32(ar + g * kLds + 8);
          a[r][3] = lds32(ar + (g + 8) * kLds + 8);
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const __nv_bfloat16* br = wt + (n * 8 + g) * kLds + k0;
          const uint32_t b0 = lds32(br), b1 = lds32(br + 8);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) mma_bf16_16816(acc[r][n], a[r], b0, b1);
        }
      }
    }

    // epilogue: x_s becomes the [kTileH * kTileW pixels][kLds] output tile
    __syncthreads();  // every warp is done reading the halo
    if (skip != nullptr) {
      for (int i = threadIdx.x; i < kTileH * kTileW * kVecs; i += kThreads) {
        const int p = i / kVecs, c = (i % kVecs) * 8;
        const int yy = y0 + p / kTileW, xx = x0 + p % kTileW;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (yy < h && xx < w)
          v = *reinterpret_cast<const uint4*>(skip + img_off + ((size_t)yy * w + xx) * kC + c);
        *reinterpret_cast<uint4*>(x_s + p * kLds + c) = v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // fragment rows g and g + 8
          const int p = (warp * kRowsPerWarp + r) * kTileW + g + 8 * half;
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(x_s + p * kLds + n * 8 + 2 * t);
          float v0 = acc[r][n][2 * half] + bias_r[n][0];
          float v1 = acc[r][n][2 * half + 1] + bias_r[n][1];
          if (skip != nullptr) {
            const float2 s = __bfloat1622float2(*o);
            v0 += s.x;
            v1 += s.y;
          }
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *o = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTileH * kTileW * kVecs; i += kThreads) {
      const int p = i / kVecs, c = (i % kVecs) * 8;
      const int yy = y0 + p / kTileW, xx = x0 + p % kTileW;
      if (yy < h && xx < w)
        *reinterpret_cast<uint4*>(out + img_off + ((size_t)yy * w + xx) * kC + c) =
            *reinterpret_cast<const uint4*>(x_s + p * kLds + c);
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch.
int videosd_taesd_conv3x3(const void* x, const void* taps, const void* bias, const void* skip,
                          void* out, int batch, int h, int w, int relu, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_kernel, kThreads, kSmem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = (long long)batch * ((h + kTileH - 1) / kTileH) *
                            ((w + kTileW - 1) / kTileW);
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(n_tiles < resident ? n_tiles : resident);
  conv3x3_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(taps),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(skip),
      static_cast<__nv_bfloat16*>(out), batch, h, w, relu);
  return (int)cudaGetLastError();
}

}  // extern "C"
