// Fused frame preprocess with the Sobel stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/preprocess_kernel.py::
// sobel_magnitude_pallas (body `_kernel`) and the XLA math around it in that
// file's `fused_preprocess`: u8 -> x01 = u8 / 255 -> img = x01 * 2 - 1, and
// PIL-floored luma -> zero-padded 3x3 Sobel magnitude -> divide by the image's
// max -> double threshold.  The TPU kernel read a pre-computed fp32 luma plane
// because a [H, W, 3] u8 array cannot be DMA-sliced on the TPU; here the luma
// of each tile's halo is computed from the u8 frame in shared memory.
//
// What bounds it on the H100: by its bytes, device memory: 3 bytes of frame
// in, 6 (bf16) or 12 (fp32) bytes of img and 4 of edge out per pixel, 1.02 us
// at 512^2.  In fact the frame sizes users send are too small for that: the
// kernel is a chain of latencies (the frame's loads, the exactly rounded
// divisions and square roots, the block reductions, a grid barrier, the
// scratch's loads), ~7 us at 512^2 on an H100.  The threshold needs the max
// of |grad| over the whole frame, and blocks run in no order, so the design
// is one cooperative launch with a grid barrier, which a CUDA graph can
// capture (the old design was a memset and two kernels):
//
// * A persistent grid of every block that fits on the card at once (the
//   count per SM comes from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//   at most 8, and the cooperative launch refuses a grid that could not all
//   be resident: no deadlock), launched with cudaLaunchCooperativeKernel.
//   Block i walks the 32 x 16 pixel tiles i, i + grid, ...  Measured on an
//   H100 (PERF.md): two blocks per SM, recomputing |grad| after the
//   barrier, were slower than this; so were halo loads made coalesced or
//   prefetched (more instructions on a chain that is not waiting on bytes).
// * Phase 1: per tile, the luma of the (16+2) x (32+2) halo into shared
//   memory, then per pixel img and |grad|; img is written, |grad| of the
//   block's first kHeld tiles stays in shared memory, and all of it feeds
//   the block's running max, which goes to the block's own slot of a
//   [grid] scratch array: every slot is written, so nothing is zeroed (no
//   memset).
// * grid.sync().
// * Phase 2: every block reduces the slots (max is exact: the order does not
//   matter), then writes the thresholded edge of its tiles once: from the
//   held |grad|, and for a block's tiles past kHeld (frames of more than
//   kHeld x grid tiles: above 3.2 Mpixel at the 6 blocks per SM an H100
//   fits) from |grad|
//   recomputed out of the frame, which stays in the 50 MB L2 (0.79 MB at
//   512^2, 6.2 MB at 1080 x 1920, 24.9 MB at 2160 x 3840).  Device memory
//   sees the frame read once, img and edge written once: the bound's bytes,
//   and no |grad| round trip.
// * u8 / 255 comes from a 256-entry table in shared memory, filled by one
//   division per thread, and so does the luma's last division (its floor is
//   an integer in 0..255): the same correctly rounded values, fewer divisions.
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
//
// sobel_magnitude (gray plane in, |grad| out: the TPU kernel's own output)
// is a second, plain kernel of one launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileW = 32;  // output columns per tile (one warp's width)
constexpr int kTileH = 16;  // output rows per tile
constexpr int kRowsStep = 8;
constexpr int kThreads = kTileW * kRowsStep;  // 256: one per entry of the u8 table
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloH = kTileH + 2;
constexpr int kMaxBlocksPerSm = 8;
constexpr int kHeld = 8;  // tiles per block whose |grad| stays in shared memory
constexpr int kMaxDevices = 16;

__device__ __forceinline__ float unit(uint8_t v) { return __fdiv_rn((float)v, 255.f); }

// floor(((299 r + 587 g) + 114 b) * 255 / 1000) / 255, every step rounded;
// `u` holds unit(0..255)
__device__ __forceinline__ float luma(const uint8_t* px, const float* u) {
  const float l255 = __fadd_rn(__fadd_rn(__fmul_rn(299.f, u[px[0]]), __fmul_rn(587.f, u[px[1]])),
                               __fmul_rn(114.f, u[px[2]]));
  return u[(int)floorf(__fdiv_rn(__fmul_rn(l255, 255.f), 1000.f))];
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// |grad| at halo cell (sy, sx) of a zero-padded plane in shared memory
__device__ __forceinline__ float grad_mag(float (*g)[kHaloW + 1], int sy, int sx) {
  const float tl = g[sy - 1][sx - 1], tc = g[sy - 1][sx], tr = g[sy - 1][sx + 1];
  const float ml = g[sy][sx - 1], mr = g[sy][sx + 1];
  const float bl = g[sy + 1][sx - 1], bc = g[sy + 1][sx], br = g[sy + 1][sx + 1];
  // (tr + 2 mr + br) - (tl + 2 ml + bl), (bl + 2 bc + br) - (tl + 2 tc + tr)
  const float gx = __fsub_rn(__fadd_rn(__fadd_rn(tr, __fmul_rn(2.f, mr)), br),
                             __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, ml)), bl));
  const float gy = __fsub_rn(__fadd_rn(__fadd_rn(bl, __fmul_rn(2.f, bc)), br),
                             __fadd_rn(__fadd_rn(tl, __fmul_rn(2.f, tc)), tr));
  return __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
}

// The luma of a tile's halo at (x0, y0), zero outside the frame, into g.
__device__ __forceinline__ void luma_halo(float (*g)[kHaloW + 1], const uint8_t* frame,
                                          const float* u, int x0, int y0, int h, int w) {
  for (int i = threadIdx.x; i < kHaloH * kHaloW; i += kThreads) {
    const int hy = i / kHaloW, hx = i % kHaloW;
    const int y = y0 + hy - 1, x = x0 + hx - 1;
    g[hy][hx] = y >= 0 && y < h && x >= 0 && x < w ? luma(frame + ((size_t)y * w + x) * 3, u) : 0.f;
  }
}

// the max of v over the block (every thread gets it); v >= 0
__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // scratch is free
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float m = scratch[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, scratch[i]);
  return m;
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    fused_preprocess_kernel(const uint8_t* __restrict__ frame, OutT* __restrict__ img,
                            float* __restrict__ edge, float* __restrict__ slots, int h, int w,
                            int tiles_x, int n_tiles, float low, float high) {
  __shared__ float g_s[kHaloH][kHaloW + 1];
  __shared__ float held_s[kHeld][kTileH][kTileW];  // |grad| of the first kHeld tiles
  __shared__ float u_s[256];
  __shared__ float red[kThreads / 32];
  const int tx = threadIdx.x % kTileW, ty0 = threadIdx.x / kTileW;
  u_s[threadIdx.x] = unit((uint8_t)threadIdx.x);

  // ---- phase 1: img, and the block's max of |grad|
  float local_max = 0.f;
  for (int tile = blockIdx.x, t = 0; tile < n_tiles; tile += gridDim.x, ++t) {
    const int x0 = tile % tiles_x * kTileW, y0 = tile / tiles_x * kTileH;
    __syncthreads();  // the table is filled; the last tile is done with g_s
    luma_halo(g_s, frame, u_s, x0, y0, h, w);
    __syncthreads();
    const int x = x0 + tx;
    for (int ty = ty0; ty < kTileH; ty += kRowsStep) {
      const int y = y0 + ty;
      if (y >= h || x >= w) continue;
      const float mag = grad_mag(g_s, ty + 1, tx + 1);
      local_max = fmaxf(local_max, mag);
      if (t < kHeld) held_s[t][ty][tx] = mag;  // read back by this thread only
      const size_t p = (size_t)y * w + x;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        store(img + p * 3 + c, __fsub_rn(__fmul_rn(u_s[frame[p * 3 + c]], 2.f), 1.f));
    }
  }
  const float mine = block_max(local_max, red);
  if (threadIdx.x == 0) slots[blockIdx.x] = mine;

  cg::this_grid().sync();

  // ---- phase 2: the frame's max, then the edge
  float m = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) m = fmaxf(m, __ldcg(slots + i));
  const float mx = fmaxf(block_max(m, red), 1e-12f);
  for (int tile = blockIdx.x, t = 0; tile < n_tiles; tile += gridDim.x, ++t) {
    const int x0 = tile % tiles_x * kTileW, y0 = tile / tiles_x * kTileH;
    if (t >= kHeld) {  // not held: recompute |grad| from the frame
      __syncthreads();
      luma_halo(g_s, frame, u_s, x0, y0, h, w);
      __syncthreads();
    }
    const int x = x0 + tx;
    for (int ty = ty0; ty < kTileH; ty += kRowsStep) {
      const int y = y0 + ty;
      if (y >= h || x >= w) continue;
      const float mag = t < kHeld ? held_s[t][ty][tx] : grad_mag(g_s, ty + 1, tx + 1);
      float e = __fdiv_rn(mag, mx);
      if (e >= high) e = 1.f;
      if (e <= low) e = 0.f;
      edge[(size_t)y * w + x] = e;
    }
  }
}

// gray [h, w] fp32 -> mag [h, w] fp32, one block per tile
__global__ void __launch_bounds__(kThreads)
    sobel_magnitude_kernel(const float* __restrict__ gray, float* __restrict__ mag, int h, int w) {
  __shared__ float g_s[kHaloH][kHaloW + 1];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  for (int i = threadIdx.x; i < kHaloH * kHaloW; i += kThreads) {
    const int hy = i / kHaloW, hx = i % kHaloW;
    const int y = y0 + hy - 1, x = x0 + hx - 1;
    g_s[hy][hx] = y >= 0 && y < h && x >= 0 && x < w ? gray[(size_t)y * w + x] : 0.f;
  }
  __syncthreads();
  const int tx = threadIdx.x % kTileW, x = x0 + tx;
  for (int ty = threadIdx.x / kTileW; ty < kTileH; ty += kRowsStep) {
    const int y = y0 + ty;
    if (y < h && x < w) mag[(size_t)y * w + x] = grad_mag(g_s, ty + 1, tx + 1);
  }
}

struct Device {
  bool ready = false;
  int per_sm = 0;    // co-resident blocks of the fused kernel per SM: min(8, occupancy)
  int grid_cap = 0;  // and on the card
};

// The fused kernel's grid for an h x w frame on `device` (the current one):
// one block per tile, at most every block that fits at once.
template <typename OutT>
cudaError_t fused_grid(int h, int w, int device, int* grid, int* per_sm) {
  static Device devices[kMaxDevices];
  Device& dev = devices[device];
  if (!dev.ready) {
    int sms = 0, fit = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, fused_preprocess_kernel<OutT>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorCooperativeLaunchTooLarge;
    dev.per_sm = fit < kMaxBlocksPerSm ? fit : kMaxBlocksPerSm;
    dev.grid_cap = sms * dev.per_sm;
    dev.ready = true;
  }
  const long long tiles = (long long)((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  if (tiles > (1ll << 30)) return cudaErrorInvalidValue;
  *grid = (int)(tiles < dev.grid_cap ? tiles : dev.grid_cap);
  *per_sm = dev.per_sm;
  return cudaSuccess;
}

template <typename OutT>
cudaError_t launch_fused(const uint8_t* frame, OutT* img, float* edge, float* slots, int n_slots,
                         int h, int w, float low, float high, int device, cudaStream_t stream) {
  int grid = 0, per_sm = 0;
  cudaError_t err = fused_grid<OutT>(h, w, device, &grid, &per_sm);
  if (err != cudaSuccess) return err;
  if (grid > n_slots) return cudaErrorInvalidValue;  // the caller's scratch has a slot per block
  int tiles_x = (w + kTileW - 1) / kTileW;
  int n_tiles = tiles_x * ((h + kTileH - 1) / kTileH);
  void* args[] = {&frame, &img, &edge, &slots, &h, &w, &tiles_x, &n_tiles, &low, &high};
  return cudaLaunchCooperativeKernel((const void*)fused_preprocess_kernel<OutT>, dim3(grid),
                                     dim3(kThreads), args, 0, stream);
}

}  // namespace

extern "C" {

// The fused kernel's grid for an h x w frame with a bf16 or fp32 img, and
// its co-resident blocks per SM.  Returns a cudaError_t.
int videosd_fused_preprocess_grid(int h, int w, int img_bf16, int device, int* grid, int* per_sm) {
  if (h <= 0 || w <= 0 || device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  return img_bf16 ? (int)fused_grid<__nv_bfloat16>(h, w, device, grid, per_sm)
                  : (int)fused_grid<float>(h, w, device, grid, per_sm);
}

// frame [h, w, 3] u8 -> img [h, w, 3] (img_bf16 ? bf16 : fp32) and edge [h, w]
// fp32; slots is fp32 scratch of n_slots >= 8 x the SM count, none of it read
// before this call writes it.  One cooperative launch.  Returns a cudaError_t.
int videosd_fused_preprocess(const void* frame, void* img, int img_bf16, void* edge, void* slots,
                             int n_slots, int h, int w, float low, float high, int device,
                             void* stream) {
  if (h <= 0 || w <= 0 || device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frame);
  float* e = static_cast<float*>(edge);
  float* sl = static_cast<float*>(slots);
  if (img_bf16)
    return (int)launch_fused(f, static_cast<__nv_bfloat16*>(img), e, sl, n_slots, h, w, low, high,
                             device, s);
  return (int)launch_fused(f, static_cast<float*>(img), e, sl, n_slots, h, w, low, high, device, s);
}

// gray [h, w] fp32 -> mag [h, w] fp32, the zero-padded Sobel magnitude.
int videosd_sobel_magnitude(const void* gray, void* mag, int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  sobel_magnitude_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gray), static_cast<float*>(mag), h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
