// 3x3 conv of the TAESD residual blocks for Hopper (sm_90a), with the fused
// epilogue.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/taesd_conv.py::packed_conv3x3
// (taesd_conv.py:231, body `_conv_kernel`), which the TAESD encoder and
// decoder reach through videosd_tpu/models/taesd.py::_block_apply_pallas.  It
// computes what that kernel computes: a 3x3 SAME stride-1 conv, 64 -> 64
// channels, then in fp32 +bias and either ReLU, or +skip and ReLU (or
// neither), with one rounding to bf16 at the end.
//
// The TPU kernel works on pixel-pair-packed activations [B, H, W/2, 128] with
// block-packed [3, 3, 128, 128] taps, half of them zeros, only to fill the
// TPU's 128 lanes.  [B, H, W/2, 128] is the same memory as NHWC [B, H, W, 64],
// so this kernel reads it as NHWC and runs the dense [3, 3, 64, 64] taps:
// 73,728 flops per output pixel, half the TPU kernel's array work.
//
// What bounds it on the H100: at 512^2 one conv is 19.3 GFLOP (19.5 us at
// 989 TFLOP/s) against 64-96 MB of activations in and out (20.05 / 30.07 us
// at 3.35 TB/s), on the ridge; at 64^2 the work is 0.3 GFLOP and the launch,
// the taps (72 KB into every block) and the first tile's latency bound it.
// What the design does about that:
//
// * wgmma with the 64 output channels on M and the pixels on N: A is a tap's
//   [64 co][64 ci] matrix, B a run of pixels of the input halo, both K-major
//   (one 128-byte row of 64 channels each) in the 128-byte swizzle.  The nine
//   taps stay resident in shared memory (73,728 bytes); a tile is one output
//   row of WT pixels, and one k16 step of one tap over it one m64nWTk16.
// * The halo of a tile is one TMA box of 3 rows x (WT + 2) pixels x 64
//   channels, at (x0 - 1, y - 1) of a 4-D tensor map over [B, H, W, 64];
//   what lies outside the image arrives as zeros, which is the SAME padding
//   on all four sides.  Tap (dy, dx) reads the WT pixels that start at halo
//   pixel dy * (WT + 2) + dx: a descriptor start at a multiple of 128 bytes,
//   which wgmma takes inside a 1024-byte swizzle atom since it swizzles by
//   absolute address (see wgmma_sm90.cuh).  So one copy of the halo serves
//   all nine taps; three column-shifted copies, the TPU kernel's answer,
//   would have cost three times the halo's shared memory.
//   Measured on the H100 (PERF.md): at 512^2 one row of 128 pixels beat two
//   rows of 64 (each tap's A read once per 128 pixels, not per 64) and
//   tiles of 64 and 32; WT = 64 wins at 128^2 and 32 at 64^2, where the
//   wider tiles leave SMs idle.  Skipping the halo loads saved a few per
//   cent; one consumer warpgroup instead of two was clearly slower.
// * Warp specialisation over a persistent grid (one block per SM, as many as
//   there are tiles): one producer thread keeps a ring of halo stages full
//   with TMA, handed over by full/empty mbarriers; two consumer warpgroups
//   take alternate tiles, so one's epilogue runs under the other's wgmma,
//   and each releases its stage as soon as its products are done.
// * The taps come in by nine bulk copies (cp.async.bulk, no tensor map), one
//   mbarrier each, from a layout made once per weight on the host, already
//   swizzled: the first product waits for its own 8 KB, not for 72 KB.
// * The epilogue adds the bias per output channel (an accumulator row), the
//   skip tile (brought by TMA into the consumer's output buffer, in the same
//   swizzle, while its products run), applies ReLU, rounds once to bf16,
//   writes [pixel][channel] into that buffer (a shuffle pairs neighbouring
//   channels into 4-byte stores without bank conflicts) and stores the tile
//   with TMA, which clips the ragged bottom and right edges: any H and W.
// * The tile width WT is the caller's, from the shape, so that the small
//   shapes still spread over the card; the ring holds as many stages as fit
//   beside the taps and the two output buffers, at most 4.  The products run
//   near 50 % of the tensor cores' peak at 512^2.  Shared-memory reads of the
//   A operand are not what holds them: with the taps' A fragments held in
//   registers (RS wgmma, a producer warpgroup and setmaxnreg to make room)
//   tiles of 64 pixels gained a few per cent and stayed behind these tiles
//   of 128, which an RS kernel cannot hold.  Each consumer's 36 products form one
//   dependent chain, and two chains per SM may be too few.
// * The launch is cheap: the shared-memory attribute is set and the SM count
//   read once per device and tile width, tensor maps come from a cache, and a
//   missing bias is a null pointer.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kC = 64;                  // input and output channels
constexpr int kPixelBytes = kC * 2;     // one pixel: one 128-byte swizzle row
constexpr int kTapBytes = kC * kPixelBytes;  // one tap's [64 co][64 ci]
constexpr int kTapsBytes = 9 * kTapBytes;
constexpr int kConsumers = 2;           // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kSmemLimit = 232448;      // bytes of shared memory a block may use
constexpr int kMaxDevices = 16;
constexpr int kMaxStages = 4;

__host__ __device__ constexpr int round1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// A tile of one output row of WT pixels, and the shared memory it needs.
template <int WT>
struct Plan {
  static constexpr int kHaloBytes = 3 * (WT + 2) * kPixelBytes;  // one TMA box
  static constexpr int kStageBytes = round1k(kHaloBytes);
  static constexpr int kOutBytes = WT * kPixelBytes;
  static constexpr int kFit =
      (kSmemLimit - 2048 - kTapsBytes - kConsumers * kOutBytes) / kStageBytes;
  static constexpr int kStages = kFit > kMaxStages ? kMaxStages : kFit;
  // the 1024 bytes of slack align the buffers to the swizzle atom
  static constexpr int kSmem = 1024 + kTapsBytes + kStages * kStageBytes + kConsumers * kOutBytes;
  static_assert(WT % 8 == 0 && WT + 2 <= 256, "TMA box and wgmma N");
  static_assert(kStages >= 2, "the halo ring needs two stages");
};

struct Args {
  const __nv_bfloat16* taps;  // [9][64 co][64 ci], each row swizzled (chunk ^ co % 8)
  const float* bias;          // [64] or null
  int batch, h, w, relu, has_skip;
  int tiles_x, n_tiles;
};

template <int WT>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const Args a, const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_skip,
                   const __grid_constant__ CUtensorMap map_out) {
  using P = Plan<WT>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  // full[S], empty[S], taps[9], skip[kConsumers]
  __shared__ __align__(8) uint64_t bars[2 * S + 9 + kConsumers];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const uint32_t taps_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t stage_s = taps_s + kTapsBytes;
  const uint32_t out_s = stage_s + S * P::kStageBytes;
  const uint32_t full_bar = smem_u32(bars);
  const uint32_t empty_bar = full_bar + 8 * S;
  const uint32_t tap_bar = full_bar + 16 * S;
  const uint32_t skip_bar = tap_bar + 8 * 9;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar + 8 * s, 1);   // the producer's arrival; the bytes do the rest
      mbar_init(empty_bar + 8 * s, 4);  // one lane per warp of the consumer
    }
    for (int i = 0; i < 9; ++i) mbar_init(tap_bar + 8 * i, 1);
    for (int c = 0; c < kConsumers; ++c) mbar_init(skip_bar + 8 * c, 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto origin = [&](int tile, int& x0, int& y, int& b) {
    x0 = (tile % a.tiles_x) * WT;
    y = (tile / a.tiles_x) % a.h;
    b = tile / (a.tiles_x * a.h);
  };

  if (warp == kConsumers * 4) {
    // ------------------------------------------------------------ producer
    if (tid % 32 != 0) return;
    for (int i = 0; i < 9; ++i) {
      mbar_arrive_expect_tx(tap_bar + 8 * i, kTapBytes);
      bulk_load(taps_s + i * kTapBytes, reinterpret_cast<const char*>(a.taps) + i * kTapBytes,
                kTapBytes, tap_bar + 8 * i);
    }
    int n = 0;
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++n) {
      const int s = n % S, use = n / S;
      if (use > 0) mbar_wait(empty_bar + 8 * s, (use - 1) & 1);
      int x0, y, b;
      origin(tile, x0, y, b);
      mbar_arrive_expect_tx(full_bar + 8 * s, P::kHaloBytes);
      tma_load_4d(stage_s + s * P::kStageBytes, &map_x, full_bar + 8 * s, 0, x0 - 1, y - 1, b);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wg = warp / 4;
  const int wt = tid % 128;     // thread in the warpgroup
  const int w4 = warp % 4;      // warp in the warpgroup: accumulator rows 16 w4 ..
  const int lane = tid % 32;
  const int g = lane / 4;       // accumulator row (output channel) 16 w4 + g, and + 8
  const int cq = lane % 4;      // accumulator column pair 2 cq, 2 cq + 1 of each 8
  const bool odd = g & 1;
  const uint32_t my_out = out_s + wg * P::kOutBytes;
  const uint32_t my_skip_bar = skip_bar + 8 * wg;

  float bias_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) bias_r[hh] = a.bias ? a.bias[16 * w4 + g + 8 * hh] : 0.f;

  int n = wg, k = 0;  // the block's tile count n, this warpgroup's k
  for (int tile = blockIdx.x + wg * gridDim.x; tile < a.n_tiles;
       tile += kConsumers * gridDim.x, n += kConsumers, ++k) {
    const int s = n % S;
    int x0, y, b;
    origin(tile, x0, y, b);
    if (wt == 0) {
      bulk_wait_read();  // the last tile's store has left my_out
      if (a.has_skip) {
        mbar_arrive_expect_tx(my_skip_bar, P::kOutBytes);
        tma_load_4d(my_out, &map_skip, my_skip_bar, 0, x0, y, b);
      }
    }
    mbar_wait(full_bar + 8 * s, (n / S) & 1);

    const uint32_t halo = stage_s + s * P::kStageBytes;
    float acc[WT / 2];
    wgmma::pin(acc);
    wgmma::fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      mbar_wait(tap_bar + 8 * tap, 0);  // completed once, at the first tile
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a_desc =
            wgmma::make_desc(taps_s + tap * kTapBytes + kk * 32, 16, 1024, 1);
        const uint32_t start = halo + (dy * (WT + 2) + dx) * kPixelBytes + kk * 32;
        wgmma::Ss<WT>::mma(acc, a_desc, wgmma::make_desc(start, 16, 1024, 1), tap > 0 || kk > 0);
      }
      wgmma::commit();
    }
    wgmma::wait<0>();
    wgmma::pin(acc);
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // this warp is done with the halo

    // ---- epilogue into my_out: [WT pixels][64 channels], 128-byte swizzle
    named_barrier_sync(1 + wg, 128);  // thread 0 has seen the last store leave my_out
    if (a.has_skip) mbar_wait(my_skip_bar, k & 1);
#pragma unroll
    for (int j = 0; j < WT / 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // this thread: channel co = 16 w4 + g + 8 hh, pixels 8j + 2cq (+1).
        // Lanes g and g ^ 1 trade one value, so that the even lane holds
        // channels (co, co + 1) of pixel 8j + 2cq and the odd lane
        // channels (co - 1, co) of pixel 8j + 2cq + 1.
        const float v0 = acc[4 * j + 2 * hh] + bias_r[hh];
        const float v1 = acc[4 * j + 2 * hh + 1] + bias_r[hh];
        const float other = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        float lo = odd ? other : v0, hi = odd ? v1 : other;
        const int px = 8 * j + 2 * cq + odd;
        const int co = 16 * w4 + 8 * hh + (g & ~1);
        const uint32_t addr = my_out + px * kPixelBytes + (((co >> 3) ^ (px & 7)) << 4) +
                              (co & 7) * 2;
        if (a.has_skip) {
          uint32_t sk;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(sk) : "r"(addr));
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&sk));
          lo += f.x;
          hi += f.y;
        }
        if (a.relu) {
          lo = fmaxf(lo, 0.f);
          hi = fmaxf(hi, 0.f);
        }
        __nv_bfloat162 o = __floats2bfloat162_rn(lo, hi);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                     "r"(*reinterpret_cast<uint32_t*>(&o))
                     : "memory");
      }
    }
    fence_proxy_async();  // the writes above, before the TMA store reads them
    named_barrier_sync(1 + wg, 128);
    if (wt == 0) {
      tma_store_4d(&map_out, my_out, 0, x0, y, b);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait();
}

// ---------------------------------------------------------------- launch

struct Device {
  bool ready = false;
  int sms = 0;
};

// A [batch, h, w, 64] NHWC bf16 tensor in boxes of `rows` x `cols` pixels.
cudaError_t nhwc_map(const void* ptr, int batch, int h, int w, int rows, int cols,
                     CUtensorMap* out) {
  const long long row = (long long)w * kPixelBytes;
  MapKey key{ptr, 4, {kC, w, h, batch}, {kPixelBytes, row, row * h}, {kC, cols, rows, 1}};
  return tensor_map(key, out);
}

template <int WT>
cudaError_t launch(const void* x, const void* skip, void* out, Args a, int device,
                   cudaStream_t stream) {
  using P = Plan<WT>;
  static Device devices[kMaxDevices];
  Device& dev = devices[device];
  if (!dev.ready) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<WT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&dev.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    dev.ready = true;
  }
  a.tiles_x = (a.w + WT - 1) / WT;
  const long long n_tiles = (long long)a.batch * a.h * a.tiles_x;
  if (n_tiles > (1ll << 30)) return cudaErrorInvalidValue;
  a.n_tiles = (int)n_tiles;
  CUtensorMap map_x, map_skip, map_out;
  cudaError_t err = nhwc_map(x, a.batch, a.h, a.w, 3, WT + 2, &map_x);
  if (err == cudaSuccess) err = nhwc_map(out, a.batch, a.h, a.w, 1, WT, &map_out);
  map_skip = map_out;  // not read without a skip
  if (err == cudaSuccess && skip) err = nhwc_map(skip, a.batch, a.h, a.w, 1, WT, &map_skip);
  if (err != cudaSuccess) return err;
  const int grid = a.n_tiles < dev.sms ? a.n_tiles : dev.sms;
  conv3x3_kernel<WT><<<grid, kThreads, P::kSmem, stream>>>(a, map_x, map_skip, map_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, skip, out: NHWC [batch, h, w, 64] bf16, 16-byte aligned; taps [9][64 co][64
// ci] bf16 with each 128-byte row swizzled (16-byte chunk c of row co stored
// at chunk c ^ (co % 8)); bias [64] fp32.  skip and bias may be null.  out
// must not alias x.  tile_w, the pixels of the one output row a tile holds,
// is 128, 64 or 32.  Returns a cudaError_t: 0 on a successful launch.
int videosd_taesd_conv3x3(const void* x, const void* taps, const void* bias, const void* skip,
                          void* out, int batch, int h, int w, int relu, int tile_w, int device,
                          void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(taps), static_cast<const float*>(bias), batch, h, w,
         relu, skip != nullptr, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_w) {
    case 128: return (int)launch<128>(x, skip, out, a, device, s);
    case 64: return (int)launch<64>(x, skip, out, a, device, s);
    case 32: return (int)launch<32>(x, skip, out, a, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
