// Flash attention forward in fp32 for Hopper (sm_90a), head dims up to 256:
// softmax(q k^T * sm_scale) v, both products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/flash_attention.py::mha_flash
// (body `_kernel`) for fp32 inputs, which the JAX package sends it from an
// fp32 bundle (the kernel keeps the input dtype: p.astype(v.dtype) is fp32,
// so P V is an fp32 product).  flash_attention.cu is the bf16 kernel and
// flash_attention_wide_fp32.cu the fp32 one above d = 256.  Same numerics as
// those: fp32 logits, running max, sum and accumulator (online softmax), P V
// on the unnormalized probabilities, ex2.approx in the log2 domain (p =
// 2^(s * scale * log2 e - m)), and a row with l == 0 left unscaled.
//
// Layout: heads in place.  q and o are [B, Sq, H*d], k and v [B, Sk, H*d],
// fp32, the last axis contiguous; batch and row strides are arguments.  d is
// a multiple of 4 up to 256 (rows of 16 bytes, as TMA reads them; the
// wrapper zero-pads any other d in a folded copy), Sq and Sk multiples of 64.
//
// 3xTF32, as in the wide kernel: each fp32 operand x splits into big (x plus
// half a TF32 ulp, which the mma reads rounded to nearest, ties away) and
// small = x - big (exact, read truncated); each product is small*big +
// big*small + big*big on mma.sync.m16n8k8.tf32, the dropped small*small
// ~2^-22 relative.  The tensor cores' fp32 sums truncate, so no accumulator
// runs long: a key tile's logits are summed per depth chunk of 32 (4
// k-steps, 12 mma) and added in fp32, and P V is summed per key tile (its
// k-steps, 3 mma each) into a partial that an fp32 fma adds to O.
// tests/test_torch_port_tf32x3.py emulates this order on the CPU.
//
// What bounds it on the H100: 4 Sq Sk d flops per head, as 3 TF32 products
// at 494.7 / 3 TFLOP/s (at [8, 4096, 40] 21.5 GFLOP: 0.130 ms); mma.sync
// reaches 316 of the 495 (hw_probe.py).  Beside each mma the kernel issues
// its share of splits and fragment loads from shared memory (~5
// instructions per mma at d = 40), and those take as long as the mma:
// copies of this file with parts dropped (kernel_variants.py) ran
// [8, 4096, 40] in 0.46 ms, 0.35 without P V's mma, 0.23 without P V at
// all; the softmax and the copies are the small rest.  The kernel is
// latency-bound: it wants many warps a scheduler.  So:
//
// * Warps: consumers do the arithmetic and a producer warp issues every
//   copy as TMA, through a ring of stages (K and V of one key tile each)
//   handed over by full and empty mbarriers.  Q is resident, one copy.
// * Partition, by instance width W (the narrowest of 8, 16, 40, 64, 80, 128,
//   160, 256 that holds d):
//   - W <= 128: a block owns 64 query rows and 8 consumer warps, two per 16
//     rows, each over one half of every key tile and all d output columns
//     (O: W / 2 registers a thread, and a P V partial as large).  A warp
//     keeps its own online softmax over its key halves; the two meet once,
//     at the end, through shared memory.  So the softmax stays in the warp
//     (rows g and g + 8 over the 4 lanes of a quad) with no barrier per
//     tile, and P goes from the logits' accumulator layout straight into P
//     V's A fragments: slots t and t + 4 of a k-step hold keys 2t and 2t +
//     1, as the accumulator does.  Up to W = 40 two blocks an SM (96
//     registers, a few spilled): four warps a scheduler; one block took 1.4x
//     as long at [8, 4096, 40].  Above, one block: two warps a scheduler
//     (with four consumers a block, one, [8, 1024, 80] took 1.6x as long).
//     Key tiles of 64 (of 32 at W = 128, for a ring of 3 stages).
//   - W = 160, 256: a block owns 16 query rows, and 4 consumer warps split both
//     products: in Q K^T each forms 8 keys of a 32-key tile over the whole
//     depth; the row maxima meet in shared memory (a barrier), then P (a
//     second barrier); in P V each warp owns W / 4 output columns.  A
//     16 x 256 O and its partial would not fit one warp's registers, and at
//     sd15's [8, 256, 160] the grid is 128 blocks on 132 SMs (64-row blocks
//     would give 32).
// * Depth runs in groups of 16 floats: k-step 0 of a group takes depths 4t
//   and 4t + 1 into slots t and t + 4, k-step 1 depths 4t + 2 and 4t + 3, so
//   one float4 per row serves two k-steps; a last group of 8 or fewer takes
//   one k-step from a float2.  Depth pads to 8, O's columns to 8.  (wgmma
//   for Q K^T, fed by a pass that split each K tile in shared memory once
//   per block, was right but no faster on an H100, and is not kept.)
// * Shared memory: Q and K in boxes of [rows][16 floats], no swizzle (a
//   quarter warp's float4 loads cover one 128-byte line); V in boxes of
//   [keys][32 floats] in the 128-byte swizzle (P V's B fragments of a warp on
//   32 distinct banks).  The 4-D tensor maps [B, S, H, d] make every column
//   past d arrive as zeros, never the next head's.  The ring is sized for 2
//   blocks an SM at W <= 40 and one above: at least 3 stages.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBoxK = 16;                        // floats per Q / K box row
constexpr int kBoxV = 32;                        // floats per V box row: the 128-byte swizzle
constexpr int kChunk = 32;                       // depth per logit chunk (two groups)
constexpr int kMaxStages = 8;
constexpr int kMaxDevices = 16;
constexpr int kSmLimit = 232448;  // shared memory a block may use
constexpr int kSmPerSm = 233472;  // an SM's, of which 1 KB per resident block is reserved

template <int W>
struct Shape {
  static constexpr int kCG = W > 128 ? 4 : 1;  // warps splitting a row group's columns
  static constexpr int kKH = W > 128 ? 1 : 2;   // key halves of a tile, each its own softmax
  static constexpr int kConsumers = kCG == 1 ? 4 * kKH : 4;  // consumer warps
  static constexpr int kThreads = 32 * (kConsumers + 1);      // and a producer warp
  static constexpr int kRows = kCG == 1 ? 64 : 16;            // query rows per block
  static constexpr int kKeys = W >= 128 ? 32 : 64;            // keys per tile
  static constexpr int kNK = kKeys / kKH / kCG / 8;           // key n-tiles of a warp's logits
  static constexpr int kCols = W / kCG;                 // output columns per warp
  static constexpr int kNT = (kCols + 7) / 8;           // their n-tiles
  static constexpr int kQB = (W + kBoxK - 1) / kBoxK;   // Q / K boxes (depth groups)
  static constexpr int kVB = (W + kBoxV - 1) / kBoxV;   // V boxes
  static constexpr int kQBytes = kQB * kBoxK * kRows * 4;
  static constexpr int kKBytes = kQB * kBoxK * kKeys * 4;
  static constexpr int kVBytes = kVB * kBoxV * kKeys * 4;
  static constexpr int kStage = kVBytes + kKBytes;  // V first: its boxes on 1024-byte bounds
  static constexpr int kBlocks = W <= 40 ? 2 : 1;  // blocks an SM the ring is sized for
  // 1 KB of alignment slack and 3 KB for the static arrays
  static constexpr int kBudget =
      (kBlocks == 2 ? kSmPerSm / 2 - 1024 : kSmLimit) - 1024 - 3072 - kQBytes;
  static constexpr int kStages = kBudget / kStage < kMaxStages ? kBudget / kStage : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStage + kQBytes;
  static constexpr int kPStride = kKeys + 8;  // P in shared memory (kCG > 1): 8 mod 32
  static_assert(kStages >= 3, "a ring of at least 3 stages");
  static_assert(kKBytes % 1024 == 0 && kVBytes % 1024 == 0, "boxes on 1024-byte bounds");
  static_assert(kKH == 1 || 4 * (kNT + 1) * 32 * 16 <= kStages * kStage,
                "the key halves meet in the ring's memory");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long o_bs, o_rs;  // o's batch and row strides in elements (q, k, v: tensor maps)
  int heads, sq, sk, d;
  float scale_log2;  // sm_scale * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x as TF32 big + small (flash_attention_wide_fp32.cu::split): big = x plus
// half a TF32 ulp, which the mma reads as x rounded to nearest with ties
// away; small = x - big, exact, which it reads truncated.  No cvt.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N], uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
}

// d += a b on one m16n8k8 tile (a: rows g, g + 8 at k slots t, t + 4; b: k
// slots t, t + 4 at column g; d: rows g, g + 8 at columns 2t, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the three TF32 products of a b, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

template <int W>
__global__ void __launch_bounds__(Shape<W>::kThreads, Shape<W>::kBlocks)
    flash_fwd_fp32_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v) {
  using S = Shape<W>;
  constexpr int kCG = S::kCG, kKeys = S::kKeys, kNK = S::kNK, kNT = S::kNT;
  constexpr int kConsumers = S::kConsumers;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages + 1];  // full, empty, Q's
  __shared__ float red[kCG][16];                    // row maxima, then row sums (kCG > 1)
  __shared__ float p_sh[kCG > 1 ? 16 * S::kPStride : 1];  // P (kCG > 1)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and k slot / column pair
  // row group (16 rows), column group, key half
  const int rg = kCG == 1 ? warp % 4 : 0, cg = kCG == 1 ? 0 : warp, kh = kCG == 1 ? warp / 4 : 0;
  const int m0 = blockIdx.x * S::kRows;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int d = p.d;
  const int qboxes = (d + kBoxK - 1) / kBoxK, vboxes = (d + kBoxV - 1) / kBoxV;
  const int n_tiles = p.sk / kKeys;

  // the ring: stage i holds a key tile's V boxes, then its K boxes; then Q
  unsigned char* base =
      smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  const float* q_s = reinterpret_cast<const float*>(base + S::kStages * S::kStage);
  const uint32_t full = smem_u32(&bars[0]), empty = full + 8 * kMaxStages;
  const uint32_t q_bar = empty + 8 * kMaxStages;

  if (tid == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // The producer: Q once, then each key tile's K and V boxes into stage
    // tile % kStages, once the consumers have emptied it.  Only the boxes
    // that hold columns below d are copied; columns past d arrive as zeros.
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, qboxes * S::kRows * kBoxK * 4);
      for (int i = 0; i < qboxes; ++i)
        tma_load_4d(smem_u32(q_s) + 4 * i * S::kRows * kBoxK, &map_q, q_bar, i * kBoxK, h, m0,
                    b);
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int slot = tile % S::kStages;
        if (tile >= S::kStages) mbar_wait(empty + 8 * slot, (tile / S::kStages - 1) & 1);
        const uint32_t bar = full + 8 * slot, dst = smem_u32(base + slot * S::kStage);
        mbar_arrive_expect_tx(bar, (qboxes * kBoxK + vboxes * kBoxV) * kKeys * 4);
        for (int i = 0; i < vboxes; ++i)
          tma_load_4d(dst + 4 * i * kKeys * kBoxV, &map_v, bar, i * kBoxV, h, tile * kKeys, b);
        for (int i = 0; i < qboxes; ++i)
          tma_load_4d(dst + S::kVBytes + 4 * i * kKeys * kBoxK, &map_k, bar, i * kBoxK, h,
                      tile * kKeys, b);
      }
    }
    return;
  }

  mbar_wait(q_bar, 0);
  // this warp's Q rows 16 rg + g (+ 8) at depth 4t of group 0 (2t in a last half group)
  const float* qa = q_s + (16 * rg + g) * kBoxK;
  const int kn0 = (cg + kh) * kNK * 8;  // the warp's first key of a tile in Q K^T
  const int c0 = cg * S::kCols;  // its first output column

  float acc[kNT][4];  // O: rows g, g + 8 at columns c0 + 8 j + 2t, + 1
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in the log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's share of their sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int slot = tile % S::kStages;
    mbar_wait(full + 8 * slot, (tile / S::kStages) & 1);
    const float* v_s = reinterpret_cast<const float*>(base + slot * S::kStage);
    const float* k_s = reinterpret_cast<const float*>(base + slot * S::kStage + S::kVBytes);

    // S = Q K^T: rows g, g + 8 at keys kn0 + 8 n + 2t, + 1, summed per depth chunk
    float s[kNK][4];
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    const float* kb = k_s + (kn0 + g) * kBoxK;
#pragma unroll
    for (int c = 0; c < (S::kQB + 1) / 2; ++c) {
      if (c * kChunk < d) {
        float part[kNK][4];
#pragma unroll
        for (int n = 0; n < kNK; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
        for (int gg = 0; gg < 2; ++gg) {
          const int gi = 2 * c + gg;
          if (gi < S::kQB && gi < qboxes) {
            const float* qg = qa + gi * S::kRows * kBoxK;
            const float* kg = kb + gi * kKeys * kBoxK;
            if (d - gi * kBoxK > 8) {  // two k-steps from a float4 per row
              const float4 lo = *reinterpret_cast<const float4*>(qg + 4 * t);
              const float4 hi = *reinterpret_cast<const float4*>(qg + 8 * kBoxK + 4 * t);
              const float a0[4] = {lo.x, hi.x, lo.y, hi.y}, a1[4] = {lo.z, hi.z, lo.w, hi.w};
              uint32_t ab0[4], as0[4], ab1[4], as1[4];
              split_frag(a0, ab0, as0);
              split_frag(a1, ab1, as1);
#pragma unroll
              for (int n = 0; n < kNK; ++n) {
                const float4 bk = *reinterpret_cast<const float4*>(kg + 8 * n * kBoxK + 4 * t);
                const float b0[2] = {bk.x, bk.y}, b1[2] = {bk.z, bk.w};
                uint32_t kb0[2], ks0[2], kb1[2], ks1[2];
                split_frag(b0, kb0, ks0);
                split_frag(b1, kb1, ks1);
                mma_3xtf32(part[n], ab0, as0, kb0, ks0);
                mma_3xtf32(part[n], ab1, as1, kb1, ks1);
              }
            } else {  // the last 8 or fewer: one k-step from a float2 per row
              const float2 lo = *reinterpret_cast<const float2*>(qg + 2 * t);
              const float2 hi = *reinterpret_cast<const float2*>(qg + 8 * kBoxK + 2 * t);
              const float a0[4] = {lo.x, hi.x, lo.y, hi.y};
              uint32_t ab0[4], as0[4];
              split_frag(a0, ab0, as0);
#pragma unroll
              for (int n = 0; n < kNK; ++n) {
                const float2 bk = *reinterpret_cast<const float2*>(kg + 8 * n * kBoxK + 2 * t);
                const float b0[2] = {bk.x, bk.y};
                uint32_t kb0[2], ks0[2];
                split_frag(b0, kb0, ks0);
                mma_3xtf32(part[n], ab0, as0, kb0, ks0);
              }
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kNK; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] += part[n][i];
      }
    }

    // online softmax of rows g and g + 8 over the tile's keys
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNK; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if constexpr (kCG > 1) {  // the four warps' key slices meet in shared memory
      if (t == 0) red[cg][g] = mx[0], red[cg][g + 8] = mx[1];
      named_barrier_sync(1, 32 * kConsumers);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = red[0][g + 8 * r];
#pragma unroll
        for (int w = 1; w < kCG; ++w) mx[r] = fmaxf(mx[r], red[w][g + 8 * r]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r] * p.scale_log2);  // scale > 0
      alpha[r] = ex2(m_run[r] - m_new);  // 2^-inf = 0 on the first tile
      m_run[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = ex2(fmaf(s[n][i], p.scale_log2, -m_run[i / 2]));
        sum[i / 2] += s[n][i];
      }
    l_run[0] = fmaf(l_run[0], alpha[0], sum[0]);
    l_run[1] = fmaf(l_run[1], alpha[1], sum[1]);
    if constexpr (kCG > 1) {  // P to shared memory, for every warp's columns
#pragma unroll
      for (int n = 0; n < kNK; ++n) {
        float* pw = p_sh + g * S::kPStride + kn0 + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(pw) = make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(pw + 8 * S::kPStride) = make_float2(s[n][2], s[n][3]);
      }
      named_barrier_sync(1, 32 * kConsumers);
    }

    // O = alpha O + P V[:, c0 .. c0 + kCols) over the warp's keys (its key
    // half; with kCG > 1 the whole tile): k slots t and t + 4 of k-step ks
    // hold keys kv0 + 8 ks + 2t and + 1; V row 8 ks + 2t (+ 1) keeps
    // column 8 jj + g of a box in 16-byte chunk 2 jj + g / 4 at position
    // chunk ^ (row % 8), the 128-byte swizzle
    float pv[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[j][i] = 0.f;
    const int kv0 = kCG == 1 ? kn0 : 0;
    const float* vb = v_s + (kv0 + 2 * t) * kBoxV + (g & 3);
#pragma unroll
    for (int ks = 0; ks < (kCG == 1 ? kNK : kKeys / 8); ++ks) {
      float a[4];
      if constexpr (kCG == 1) {  // the logits' accumulator is P V's A fragment
        a[0] = s[ks][0], a[1] = s[ks][2], a[2] = s[ks][1], a[3] = s[ks][3];
      } else {
        const float2 lo = *reinterpret_cast<const float2*>(p_sh + g * S::kPStride + 8 * ks + 2 * t);
        const float2 hi =
            *reinterpret_cast<const float2*>(p_sh + (g + 8) * S::kPStride + 8 * ks + 2 * t);
        a[0] = lo.x, a[1] = hi.x, a[2] = lo.y, a[3] = hi.y;
      }
      uint32_t pb[4], ps[4];
      split_frag(a, pb, ps);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = c0 + 8 * j;
        if (col < d) {
          const int jj = (col >> 3) & 3;
          const float* vp = vb + (col >> 5) * kKeys * kBoxV + 8 * ks * kBoxV;
          const float bv[2] = {vp[(2 * (jj ^ t) + (g >> 2)) << 2],
                               vp[kBoxV + ((2 * (jj ^ t) + ((g >> 2) ^ 1)) << 2)]};
          uint32_t bb[2], bs[2];
          split_frag(bv, bb, bs);
          mma_3xtf32(pv[j], pb, ps, bb, bs);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(acc[j][i], alpha[i / 2], pv[j][i]);
    __syncwarp();  // every lane is done with the stage
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  }

  // the row sums: over the four lanes of a row, then over the warps' key slices
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if constexpr (S::kKH == 2) {
    // the two key halves' softmax states meet in the ring's memory, once
    // every warp is done with the ring: the second half's (m, l, O) goes
    // there, the first half's warp rescales both to the larger max and adds
    float4* xs = reinterpret_cast<float4*>(base) + rg * (kNT + 1) * 32 + lane;
    named_barrier_sync(1, 32 * kConsumers);
    if (kh == 1) {
      xs[0] = make_float4(m_run[0], m_run[1], l_run[0], l_run[1]);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        xs[32 * (j + 1)] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    named_barrier_sync(1, 32 * kConsumers);
    if (kh == 1) return;
    const float4 other = xs[0];
    const float m_o[2] = {other.x, other.y}, l_o[2] = {other.z, other.w};
    float mine[2], theirs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(m_run[r], m_o[r]);
      mine[r] = ex2(m_run[r] - m), theirs[r] = ex2(m_o[r] - m);
      l_run[r] = fmaf(l_o[r], theirs[r], l_run[r] * mine[r]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float4 o = xs[32 * (j + 1)];
      const float oj[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(oj[i], theirs[i / 2], acc[j][i] * mine[i / 2]);
    }
  }
  if constexpr (kCG > 1) {
    // (every warp read the last tile's maxima before the P barrier it passed)
    if (t == 0) red[cg][g] = l_run[0], red[cg][g + 8] = l_run[1];
    named_barrier_sync(1, 32 * kConsumers);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = red[0][g + 8 * r];
#pragma unroll
      for (int w = 1; w < kCG; ++w) l_run[r] += red[w][g + 8 * r];
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
  float* og = p.o + (long long)b * p.o_bs + (long long)(m0 + 16 * rg + g) * p.o_rs +
              (long long)h * d + c0 + 2 * t;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (c0 + 8 * j + 2 * t < d) {  // d is a multiple of 4: a column pair is in or out
      *reinterpret_cast<float2*>(og + 8 * j) =
          make_float2(acc[j][0] * inv[0], acc[j][1] * inv[0]);
      *reinterpret_cast<float2*>(og + 8 * p.o_rs + 8 * j) =
          make_float2(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
  }
}

// [batch, rows, heads, d] read in boxes of `box_rows` rows x `box` floats of one head
cudaError_t fp32_map(const void* ptr, long long bs, long long rs, int batch, int rows,
                       int heads, int d, int box, int box_rows, CUtensorMapSwizzle swizzle,
                       CUtensorMap* out) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t gstrides[3] = {4ull * d, 4ull * rs, 4ull * (batch == 1 ? rows * rs : bs)};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, gstrides,
                boxes, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int W>
cudaError_t launch(const Params& p, int batch, const long long* strides, int device,
                   cudaStream_t stream) {
  using S = Shape<W>;
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_fp32_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = fp32_map(p.q, strides[0], strides[1], batch, p.sq, p.heads, p.d, kBoxK,
                               S::kRows, CU_TENSOR_MAP_SWIZZLE_NONE, &map_q);
  if (err == cudaSuccess)
    err = fp32_map(p.k, strides[2], strides[3], batch, p.sk, p.heads, p.d, kBoxK, S::kKeys,
                     CU_TENSOR_MAP_SWIZZLE_NONE, &map_k);
  if (err == cudaSuccess)
    err = fp32_map(p.v, strides[4], strides[5], batch, p.sk, p.heads, p.d, kBoxV, S::kKeys,
                     CU_TENSOR_MAP_SWIZZLE_128B, &map_v);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.sq / S::kRows, batch * p.heads);
  flash_fwd_fp32_kernel<W><<<grid, S::kThreads, S::kSmem, stream>>>(p, map_q, map_k, map_v);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: [batch, sq, heads*d]; k, v: [batch, sk, heads*d]; fp32 with unit inner
// stride, every row 16-byte aligned; d a multiple of 4 up to 256; sq and sk
// multiples of 64; `strides` holds the batch and row strides of q, k, v, o in
// elements.  Returns a cudaError_t: 0 on a successful launch.
int videosd_flash_attention_fp32_fwd(const void* q, const void* k, const void* v, void* o,
                                     int batch, int heads, int sq, int sk, int d,
                                     const long long* strides, float sm_scale, int device,
                                     void* stream) {
  if (!(batch > 0 && heads > 0 && sq > 0 && sk > 0 && device >= 0 && device < kMaxDevices &&
        sq % 64 == 0 && sk % 64 == 0 && sm_scale > 0.f && d > 0 && d % 4 == 0 && d <= 256 &&
        batch * heads <= 65535))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.o_bs = strides[6], p.o_rs = strides[7];
  p.heads = heads, p.sq = sq, p.sk = sk, p.d = d;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instance: the narrowest width that holds d (ops/cuda/flash_attention.py::FP32_WIDTHS)
  if (d <= 8) return (int)launch<8>(p, batch, strides, device, s);
  if (d <= 16) return (int)launch<16>(p, batch, strides, device, s);
  if (d <= 40) return (int)launch<40>(p, batch, strides, device, s);
  if (d <= 64) return (int)launch<64>(p, batch, strides, device, s);
  if (d <= 80) return (int)launch<80>(p, batch, strides, device, s);
  if (d <= 128) return (int)launch<128>(p, batch, strides, device, s);
  if (d <= 160) return (int)launch<160>(p, batch, strides, device, s);
  return (int)launch<256>(p, batch, strides, device, s);
}

}  // extern "C"
