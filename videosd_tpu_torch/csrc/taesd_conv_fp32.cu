// 3x3 conv of the TAESD residual blocks in fp32 for Hopper (sm_90a), with the
// fused epilogue: an implicit GEMM in 3xTF32 on the tensor cores.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/taesd_conv.py::packed_conv3x3
// (taesd_conv.py:231, body `_conv_kernel`) for fp32 activations: that kernel
// keeps xp.dtype, so an fp32 bundle on the pallas_convs route sends it fp32.
// taesd_conv.cu is the bf16 kernel.  It computes what both compute: a 3x3
// SAME stride-1 conv, 64 -> 64 channels, summed in fp32, then +bias and either
// ReLU, or +skip and ReLU (or neither), in fp32, on the pixel-pair-packed
// [B, H, W/2, 128] activations read as the NHWC [B, H, W, 64] they are.
//
// The GEMM: M = output pixels, N = the 64 output channels, K = 9 taps x 64
// input channels, on mma.sync.m16n8k8 TF32.  3xTF32, as in K1's fp32 kernels:
// each fp32 operand x splits into big (x plus half a TF32 ulp, which the mma
// reads rounded to nearest, ties away) and small = x - big (exact, read
// truncated); each product is small*big + big*small + big*big, the dropped
// small*small ~2^-22 relative.  The tensor cores' fp32 sums truncate, so no
// accumulator runs long: the products of one input-channel chunk (16) and one
// tap row dy (three taps, 48 products, 18 mma) are summed into a partial that
// an fp32 add takes into the output's sum.  tests/test_torch_port_tf32x3.py
// emulates this order on the CPU.  (kernel_variants.py's copy with one
// accumulator over all 576 products ran 3 % faster at 512^2 on an H100, and
// its largest error from fp64 was 10x this order's.)
//
// What bounds it on the H100: 73,728 flops per output pixel, as 3 TF32
// products at 494.7 / 3 TFLOP/s: at 512^2 19.3 GFLOP, 0.117 ms, against
// 0.02-0.04 ms of bytes.  mma.sync reaches 316 of the 495 TFLOP/s
// (hw_probe.py), so 3xTF32 on it issues at most ~105: 0.184 ms at 512^2.
// kernel_variants.py on an H100 at 512^2: 0.254 ms as built, 0.143 with
// every mma dropped (the fragment loads, 6 LDS.128 a warp per 24 mma, and
// the splits), 0.124 in 1xTF32; so the mma run at ~72 % of that rate with
// the loads' shared-memory traffic beside them.  The design keeps the
// instructions beside each mma few:
//
// * Shared memory.  The taps' big and small planes of all 64 output channels
//   (294,912 bytes) do not fit a block's 232,448.  So each block owns one half
//   of the output channels (32), and its half's taps sit resident in shared
//   memory already split, big and small planes (147,456 bytes), laid out once
//   per weight by the wrapper in the fragment order: for tap, channel chunk
//   and n8 tile, lane l's four input channels of each plane are one float4,
//   so a k-step pair's B fragment is two conflict-free LDS.128 and the kernel
//   never splits a tap.  The two halves of a tile are neighbouring work items
//   that read the same halo, the second from L2.
// * The halo of a tile of TR rows x 64 pixels comes as TMA boxes of 16 input
//   channels x 66 pixels x (TR + 2) rows from a 4-D tensor map over [B, H, W,
//   64] at (c0, x0 - 1, y0 - 1, b): what lies outside the image arrives as
//   zeros, the SAME padding on all four sides.  One lane keeps a ring of
//   such stages full (full and empty mbarriers); the taps come first, by
//   nine bulk copies on their own mbarrier.  A pixel of a stage is 64
//   contiguous bytes, so a quarter warp's A-fragment float4s (two pixels x
//   four lanes) cover 128 contiguous bytes: free of bank conflicts, with no
//   padding or swizzle.
// * Warps: 2 TR consumer warps, each 32 pixels of one row x 32 channels: two
//   m16 tiles x four n8 tiles.  Input channels 4t .. 4t + 3 of a k-step pair
//   are one float4 per fragment row (k-step 0 takes 4t and 4t + 1 into slots
//   t and t + 4, k-step 1 the other two), so per k-step a warp loads a float4
//   per row pair, splits 8 floats (3 integer / float instructions each) and
//   issues 24 mma: ~1 split instruction per mma, each A split reused over the
//   four n8 tiles.  The accumulators and partials take 64 registers.
// * Lane 0 of warp 0 is also the producer, so a block of 4 rows is 8 warps,
//   2 a scheduler, with up to 255 registers a thread (a producer warp of its
//   own made it 9, and 3 warps on one scheduler cap them at 168: the skip's
//   registers spilled and its convs ran 10 % slower).
// * A persistent grid of an even number of blocks, at most one per SM; work
//   items are (tile, half) with the half fastest, so a block keeps one half
//   (blockIdx.x % 2) and loads its taps once.  TR = 4 or 2 is the caller's
//   choice from the shape (ops/cuda/taesd_conv.py::fp32_tile_rows): 8 or 4
//   consumer warps, so that 64^2 still spreads over the SMs.
// * The epilogue adds the bias, the skip and the ReLU in fp32 in the plain
//   version's order, (sum + bias) + skip, then ReLU, straight from the
//   accumulators: a float2 of two channels per pixel and n8 tile.  The
//   skip's float2s are loaded into registers when the item starts, so their
//   latency passes under its products; the kernel is instantiated with and
//   without a skip, so that the convs without one do not carry those 32
//   registers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kC = 64;           // input and output channels
constexpr int kCoB = 32;         // output channels of a block: one half
constexpr int kTW = 64;          // output pixels of a tile row
constexpr int kHW = kTW + 2;     // halo pixels of a row
constexpr int kCK = 16;          // input channels of a stage (a chunk)
constexpr int kChunks = kC / kCK;
constexpr int kMT = 2;           // m16 tiles of a warp: 32 pixels of one row
constexpr int kNT = kCoB / 8;    // n8 tiles of a warp: the block's 32 channels
// one half's taps: [9 taps][4 chunks][4 n8 tiles][2 planes][32 lanes][4]
constexpr int kTapFloats = 9 * kChunks * kNT * 2 * 32 * 4;
constexpr int kTapBytes = kTapFloats * 4;  // 147,456
constexpr int kSmLimit = 232448;           // shared memory a block may use
constexpr int kMaxStages = 4;
constexpr int kMaxDevices = 16;

// A tile of TR output rows: its warps, its halo stage and shared memory.
template <int TR>
struct Plan {
  static constexpr int kConsumers = 2 * TR;  // warps, the first also the producer
  static constexpr int kThreads = 32 * kConsumers;
  static constexpr int kStageBytes = (TR + 2) * kHW * kCK * 4;  // one TMA box
  static constexpr int kFit = (kSmLimit - 1024 - kTapBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // 1 KB of slack aligns the taps and the ring
  static constexpr int kSmem = 1024 + kTapBytes + kStages * kStageBytes;
  static_assert(kStageBytes % 128 == 0, "stages on 128-byte bounds for TMA");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

struct Args {
  const float* taps;  // [2 halves] of kTapFloats, big and small planes
  const float* bias;  // [64] or null
  const float* skip;  // [B, H, W, 64] or null
  float* out;         // [B, H, W, 64]
  int batch, h, w, relu;
  int tiles_x, tiles_y, n_items;  // n_items = 2 x tiles
};

// x as TF32 big + small (flash_attention_fp32.cu::split): big = x plus half a
// TF32 ulp, which the mma reads as x rounded to nearest with ties away; small
// = x - big, exact, which it reads truncated.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// d += a b on one m16n8k8 tile (a: rows g, g + 8 at k slots t, t + 4; b: k
// slots t, t + 4 at column g; d: rows g, g + 8 at columns 2t, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (image, first row, first pixel) of work item `item`'s tile
__device__ __forceinline__ void origin(const Args& a, int item, int TR, int& b, int& y0,
                                       int& x0) {
  const int tile = item / 2;
  x0 = (tile % a.tiles_x) * kTW;
  y0 = (tile / a.tiles_x % a.tiles_y) * TR;
  b = tile / (a.tiles_x * a.tiles_y);
}

// kSkip: whether a skip is added (its registers cost the kernels without one)
template <int TR, bool kSkip>
__global__ void __launch_bounds__(Plan<TR>::kThreads, 1)
    conv3x3_fp32_kernel(const Args a, const __grid_constant__ CUtensorMap map_x) {
  using P = Plan<TR>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages + 1];  // full, empty, the taps'
  unsigned char* base =
      smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  unsigned char* ring = base + kTapBytes;
  const uint32_t full = smem_u32(&bars[0]), empty = full + 8 * kMaxStages;
  const uint32_t taps_bar = empty + 8 * kMaxStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = blockIdx.x % 2;  // the grid is even: every item of the block has this half
  const int items = (a.n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int steps = items * kChunks;

  if (tid == 0) {
    for (int i = 0; i < P::kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, P::kConsumers);  // one arrival per consumer warp
    }
    mbar_init(taps_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // Lane 0 of warp 0 is also the producer: the half's taps and the first
  // kStages - 1 steps now; then, a third into step n, step n + kStages - 1
  // into the stage step n - 1 held, once every warp has emptied it.  Step n
  // is chunk n % 4 of the block's item n / 4.
  auto produce = [&](int n) {
    const int slot = n % P::kStages;
    if (n >= P::kStages) mbar_wait(empty + 8 * slot, (n / P::kStages - 1) & 1);
    int b, y0, x0;
    origin(a, (int)blockIdx.x + (n / kChunks) * (int)gridDim.x, TR, b, y0, x0);
    mbar_arrive_expect_tx(full + 8 * slot, P::kStageBytes);
    tma_load_4d(smem_u32(ring + slot * P::kStageBytes), &map_x, full + 8 * slot,
                (n % kChunks) * kCK, x0 - 1, y0 - 1, b);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(taps_bar, kTapBytes);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(a.taps) + (size_t)half * kTapBytes;
    for (int i = 0; i < 9; ++i)
      bulk_load(smem_u32(base) + i * (kTapBytes / 9), src + i * (kTapBytes / 9), kTapBytes / 9,
                taps_bar);
    for (int n = 0; n < P::kStages - 1 && n < steps; ++n) produce(n);
  }

  const int g = lane / 4, t = lane % 4;  // fragment row and k slot / column pair
  const int rr = warp / 2;               // the warp's output row of the tile
  const int xw = (warp % 2) * 32;        // its first pixel of the row
  const int co0 = half * kCoB;
  float bias_r[kNT][2];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias_r[n][e] = a.bias ? a.bias[co0 + 8 * n + 2 * t + e] : 0.f;
  // this lane's float4 of a (tap, chunk, n8 tile, plane) of the taps
  const float4* taps_l = reinterpret_cast<const float4*>(base) + lane;

  mbar_wait(taps_bar, 0);
  for (int it = 0; it < items; ++it) {
    int b, y0, x0;
    origin(a, (int)blockIdx.x + it * (int)gridDim.x, TR, b, y0, x0);
    const int y = y0 + rr;
    // the item's skip, loaded now so that its latency passes under the products
    float2 skv[kMT][2][kNT];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = x0 + xw + 16 * m + 8 * r + g;
        const bool in = kSkip && y < a.h && x < a.w;
        const float2* sp = reinterpret_cast<const float2*>(
            a.skip + (((long long)b * a.h + y) * a.w + x) * kC + co0 + 2 * t);
#pragma unroll
        for (int n = 0; n < kNT; ++n) skv[m][r][n] = in ? __ldg(sp + 4 * n) : make_float2(0.f, 0.f);
      }
    float acc[kMT][kNT][4];  // rows g, g + 8 of each m16 tile at columns 2t, 2t + 1
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

    for (int c = 0; c < kChunks; ++c) {
      const int step = it * kChunks + c, slot = step % P::kStages;
      mbar_wait(full + 8 * slot, (step / P::kStages) & 1);
      const float* halo = reinterpret_cast<const float*>(ring + slot * P::kStageBytes);
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        if (dy == 1 && warp == 0) {
          if (lane == 0 && step + P::kStages - 1 < steps) produce(step + P::kStages - 1);
          __syncwarp();
        }
        float part[kMT][kNT][4];
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[m][n][i] = 0.f;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          // A: halo pixel xw + 16 m + dx + g (+ 8) of row rr + dy, channels 4t .. 4t + 3
          const float* arow = halo + ((rr + dy) * kHW + xw + dx + g) * kCK + 4 * t;
          float4 lo[kMT], hi[kMT];
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            lo[m] = *reinterpret_cast<const float4*>(arow + 16 * m * kCK);
            hi[m] = *reinterpret_cast<const float4*>(arow + (16 * m + 8) * kCK);
          }
          // B: tap 3 dy + dx, chunk c, each n8 tile's big and small float4
          const float4* tb = taps_l + ((dy * 3 + dx) * kChunks + c) * kNT * 2 * 32;
          float4 bb[kNT], bs[kNT];
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            bb[n] = tb[(2 * n) * 32];
            bs[n] = tb[(2 * n + 1) * 32];
          }
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t ab[kMT][4], as[kMT][4];
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
              const float v[4] = {kk ? lo[m].z : lo[m].x, kk ? hi[m].z : hi[m].x,
                                  kk ? lo[m].w : lo[m].y, kk ? hi[m].w : hi[m].y};
#pragma unroll
              for (int i = 0; i < 4; ++i) split(v[i], ab[m][i], as[m][i]);
            }
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              const uint32_t b0 = __float_as_uint(kk ? bb[n].z : bb[n].x);
              const uint32_t b1 = __float_as_uint(kk ? bb[n].w : bb[n].y);
              const uint32_t s0 = __float_as_uint(kk ? bs[n].z : bs[n].x);
              const uint32_t s1 = __float_as_uint(kk ? bs[n].w : bs[n].y);
#pragma unroll
              for (int m = 0; m < kMT; ++m) {
                // small terms first, then big * big
                mma_tf32(part[m][n], as[m], b0, b1);
                mma_tf32(part[m][n], ab[m], s0, s1);
                mma_tf32(part[m][n], ab[m], b0, b1);
              }
            }
          }
        }
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][n][i] += part[m][n][i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    }

    // ---- epilogue of the item: (sum + bias) + skip, ReLU, in fp32
    if (y >= a.h) continue;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = x0 + xw + 16 * m + 8 * r + g;
        if (x >= a.w) continue;
        const long long px = (((long long)b * a.h + y) * a.w + x) * kC + co0 + 2 * t;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          float v0 = acc[m][n][2 * r] + bias_r[n][0];
          float v1 = acc[m][n][2 * r + 1] + bias_r[n][1];
          if (kSkip) v0 += skv[m][r][n].x, v1 += skv[m][r][n].y;
          if (a.relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          *reinterpret_cast<float2*>(a.out + px + 8 * n) = make_float2(v0, v1);
        }
      }
  }
}

// [batch, h, w, 64] fp32 in boxes of 16 channels x 66 pixels x `rows` rows
cudaError_t halo_map(const void* x, int batch, int h, int w, int rows, CUtensorMap* out) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)batch};
  const cuuint64_t pixel = 4ull * kC;
  const cuuint64_t strides[3] = {pixel, pixel * w, pixel * w * h};
  const cuuint32_t box[4] = {(cuuint32_t)kCK, (cuuint32_t)kHW, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

struct Device {
  bool ready = false;
  int sms = 0;
};

template <int TR, bool kSkip>
cudaError_t launch(const void* x, Args a, int device, cudaStream_t stream) {
  using P = Plan<TR>;
  static Device devices[kMaxDevices];
  Device& dev = devices[device];
  if (!dev.ready) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_fp32_kernel<TR, kSkip>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&dev.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    dev.ready = true;
  }
  a.tiles_x = (a.w + kTW - 1) / kTW;
  a.tiles_y = (a.h + TR - 1) / TR;
  const long long n_items = 2ll * a.batch * a.tiles_x * a.tiles_y;
  if (n_items > (1ll << 30)) return cudaErrorInvalidValue;
  a.n_items = (int)n_items;
  CUtensorMap map_x;
  const cudaError_t err = halo_map(x, a.batch, a.h, a.w, TR + 2, &map_x);
  if (err != cudaSuccess) return err;
  const int even = dev.sms & ~1;  // an even grid: a block's items share a half
  const int grid = a.n_items < even ? a.n_items : even;
  conv3x3_fp32_kernel<TR, kSkip><<<grid, P::kThreads, P::kSmem, stream>>>(a, map_x);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, skip, out: NHWC [batch, h, w, 64] fp32, 16-byte aligned; taps: two
// halves of [9 taps][4 chunks][4 n8 tiles][2 planes][32 lanes][4] fp32, where
// half h, tap 3 dy + dx, chunk c, tile n, lane 4 g + t, element e hold the
// TF32 big (plane 0) and small (plane 1) parts of weight[32 h + 8 n + g][16 c
// + 4 t + e][dy][dx] (ops/cuda/taesd_conv.py::_taps_fp32); bias [64] fp32.
// skip and bias may be null.  out must not alias x.  tile_rows, the output
// rows of a tile, is 4 or 2.  Returns a cudaError_t: 0 on a successful
// launch.
int videosd_taesd_conv3x3_fp32(const void* x, const void* taps, const void* bias, const void* skip,
                               void* out, int batch, int h, int w, int relu, int tile_rows,
                               int device, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(taps), static_cast<const float*>(bias),
         static_cast<const float*>(skip), static_cast<float*>(out), batch, h, w, relu, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sk = skip != nullptr;
  switch (tile_rows) {
    case 4: return (int)(sk ? launch<4, true>(x, a, device, s) : launch<4, false>(x, a, device, s));
    case 2: return (int)(sk ? launch<2, true>(x, a, device, s) : launch<2, false>(x, a, device, s));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
