// Flash attention forward for head dims above 256 on Hopper (sm_90a) in fp32:
// softmax(q k^T * sm_scale) v, both products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/flash_attention.py::mha_flash
// (body `_kernel`) in fp32 at the head dims its wrapper takes above 256.  The
// one caller in the repo is the KL VAE's mid attention (one head of 512
// channels over the 64x64 latent of a 512x512 frame: [B, 4096, 512], in encode
// and in decode) in an fp32 bundle.  flash_attention_fp32.cu takes d <= 256 and
// flash_attention_wide.cu the bf16 heads above 256.  Same numerics as those:
// fp32 logits, running max, sum and accumulator (online softmax), P V on the
// unnormalized probabilities, ex2.approx in the log2 domain, and a row with
// l == 0 left unscaled.
//
// Layout: heads in place.  q and o are [B, Sq, H*d], k and v [B, Sk, H*d], the
// last axis contiguous; batch and row strides are arguments.  Rows 16-byte
// aligned (d a multiple of 4; the wrapper zero-pads any other d in a folded
// copy), Sq and Sk multiples of 64, any d above 256.
//
// 3xTF32: each fp32 operand x splits into big = tf32_rna(x) and small =
// tf32(x - big) (x - big is exact), and each product is the sum of three
// TF32 products, small*big + big*small + big*big (CUTLASS's
// OpMultiplyAddFastF32); the dropped small*small is ~2^-22 relative, so the
// result stays near fp32 rounding, where one TF32 product (10-bit mantissa)
// would be ~1e-3 off.  Each product is mma.sync.m16n8k8.tf32 with fragments
// loaded from shared memory by each thread (wgmma would take V K-major only,
// after a transpose in shared memory).  The tensor cores' fp32 sums are
// truncated, not rounded, so no accumulator runs long: the logits are summed
// in fp32 per depth chunk, and P V per key tile before an fp32 fma into O
// (one accumulator over 4096 keys missed the mean bar).
//
// What bounds it on the H100: 4 Sq Sk d flops per head; at [1, 4096, 512]
// 34.4 GFLOP, which as 3 TF32 products run at 494.7 / 3 TFLOP/s: 0.208 ms,
// far above the 17 MB of q, k, v and o (5 us).  mma.sync reaches 316 of
// those 495 TFLOP/s on an H100 (hw_probe.py), and beside it the kernel
// issues the splits and fragment loads (~5 instructions per mma); every
// block reads all of K and V from L2 (2.1 GB at [1, 4096, 512]).
// So:
//
// * A block owns 32 query rows and a slice of up to 512 output columns:
//   grid (Sq / 32, ceil(d / 512), B * H).  At the VAE's d = 512 the whole
//   output sits in one block, so the logits are formed once per key tile,
//   and one head at batch 1 still gives 128 blocks.  Above 512 each slice
//   forms them again.
// * Eight consumer warps do the arithmetic.  Warp w = 4 rg + wq owns rows
//   16 rg .. 16 rg + 15.  In S = Q K^T over a key tile of 32 it forms all 32
//   keys (four m16n8 tiles) over a quarter of the depth, depths 32 wq .. 32
//   wq + 31 of every chunk, so that each A fragment it splits serves four
//   products; the four quarters' partials meet in shared memory, where each
//   warp sums keys 8 wq .. 8 wq + 7 for the softmax.  In O it owns the 16 x
//   128 columns 128 wq .. (16 m16n8 accumulators, 64 registers), four
//   column tiles' mma chains in flight at a time.  The four warps of a row
//   group trade their row maxima through shared memory; each forms the same
//   running max.  They meet at a named barrier, without the producer.
// * The reduction order inside a k-step is free, so a thread's k slots t and
//   t + 4 take depths 4t and 4t + 1 (then 4t + 2 and 4t + 3): one float4 per
//   row serves two k-steps.
// * A ninth warp, the producer, issues every copy as TMA (one thread:
//   issued from the consumers, the requests held them at the copy engine's
//   queue; and the copy engine writes shared memory without the load pipe,
//   where cp.async from every thread slowed the products though they
//   rarely waited for data).  K streams in depth chunks of 128 floats, as 8 boxes of 32 rows x
//   16 floats in the 64-byte swizzle, through a ring of up to 8 slots
//   handed over by full and empty mbarriers; a key tile's V (32 keys x the
//   slice, 64 KB at d = 512), 16 boxes of 32 x 32 floats in the 128-byte
//   swizzle, follows its last chunk once the consumers are done with the
//   last tile's.  Columns past d arrive as zeros.  In these swizzles every
//   fragment load of a quarter warp (K) or warp (V) hits distinct banks.
//   Q stays resident in shared memory (32 rows at a stride of 16 mod 32
//   floats, a bulk copy per row), loaded once, while a ring of 4 chunks
//   fits beside it (d <= 576); a wider Q streams through the ring beside K.
// * P goes through shared memory from the accumulator layout (columns 2t and
//   2t + 1) to the A-fragment layout of P V (keys 2t and 2t + 1 for slots t
//   and t + 4).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 32;     // query rows per block
constexpr int kKeys = 32;     // keys per tile
constexpr int kSlice = 512;   // output columns per block
constexpr int kWarps = 8;     // consumers: two row groups x four key / column groups
constexpr int kThreads = 32 * (kWarps + 1);  // and a producer warp that issues the copies
constexpr int kChunk = 128;                 // floats of depth per streamed chunk
constexpr int kBoxK = 16;                   // floats per row of a K (or Q) box: the 64-byte swizzle
constexpr int kBoxV = 32;                   // floats per row of a V box: the 128-byte swizzle
constexpr int kChunkFloats = kKeys * kChunk;  // a K (or Q) chunk: 8 boxes of 32 rows
constexpr int kVFloats = kKeys * kSlice;      // the V tile: 16 boxes of 32 rows
constexpr int kPStride = kKeys + 8;         // 8 mod 32: S partials and P
constexpr int kMaxSlots = 8;                // ring slots of depth chunks
constexpr int kMinSlots = 4;                // kept beside a resident Q
constexpr int kGroup = 4;                   // column tiles of P V in flight
constexpr int kMaxDevices = 16;
// dynamic shared memory, from a 1024-byte boundary (the swizzles' atoms): the
// V tile, the ring of depth chunks (K's, then Q's when Q streams), the S
// partials of the four depth quarters, P, and Q when it is resident (32 rows
// of q_stride)
constexpr int kPartFloats = 4 * kRows * kPStride;
constexpr int kFixedSmem = 1024 + 4 * (kVFloats + kPartFloats + kRows * kPStride);
constexpr int kChunkBytes = 4 * kChunkFloats;
constexpr int kMaxSmem = 232448 - 1024;  // the block's limit, less room for the static arrays

struct Plan {
  int q_stride;  // floats per resident Q row (16 mod 32), or 0 when Q streams
  int slots;     // ring slots
  int smem;      // dynamic shared memory bytes
};

// Q resident while a ring of kMinSlots chunks fits beside it
Plan plan(int d) {
  Plan pl;
  const int stride = (d + 31) / 32 * 32 + 16;
  const int q_bytes = 4 * kRows * stride;
  const bool res = kFixedSmem + q_bytes + kMinSlots * kChunkBytes <= kMaxSmem;
  const int item = res ? kChunkBytes : 2 * kChunkBytes;
  pl.q_stride = res ? stride : 0;
  pl.slots = min(kMaxSlots, (kMaxSmem - kFixedSmem - (res ? q_bytes : 0)) / item);
  pl.smem = kFixedSmem + (res ? q_bytes : 0) + pl.slots * item;
  return pl;
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // strides in elements
  int heads, sq, sk, d;
  int q_stride;  // floats per resident Q row; 0: Q streams with K
  int slots;     // ring slots
  float scale_log2;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x as TF32 big + small for the mma, which reads a TF32 operand's top 19
// bits and ignores the low 13 (as CUTLASS's fast fp32 converters rely on):
// big = x plus half a TF32 ulp, which the mma then reads as x rounded to
// nearest with ties away (cvt.rna), and small = x - big, exact, which the
// mma reads truncated.  Integer and fp32 ops only: two cvt.rna.tf32 per
// value made the kernel slower.
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

__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_fwd_fp32_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ unsigned char smem_raw[];
  // the ring's full and empty barriers, V's full and empty, Q's
  __shared__ __align__(8) uint64_t bars[2 * kMaxSlots + 3];
  __shared__ float red[2][4][16];  // [row group][key warp][row]: tile maxima, then row sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and k slot / column pair
  const int rg = warp / 4;  // rows 16 rg .. 16 rg + 15 of the block
  // in Q K^T depths 32 wq .. 32 wq + 31 of each chunk; in the softmax keys
  // 8 wq .. 8 wq + 7 of the tile; in O columns 128 wq .. of the slice
  const int wq = warp % 4;
  const int m0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kSlice;
  const int bh = blockIdx.z;
  const int b = bh / p.heads, h = bh % p.heads;
  const bool q_res = p.q_stride > 0;
  const int slots = p.slots;
  const int nc = (p.d + kChunk - 1) / kChunk;  // depth chunks
  const int vw = min(kSlice, p.d - c0);        // columns of this slice below d
  const int n_tiles = p.sk / kKeys;
  const int n_items = n_tiles * nc;  // (key tile, depth chunk) pairs

  // the V tile: 16 boxes of [kKeys][kBoxV] in the 128-byte swizzle; the ring:
  // slot n holds item n's K chunk, 8 boxes of [kKeys][kBoxK] in the 64-byte
  // swizzle, then, when Q streams, its Q chunk likewise
  float* v_s = reinterpret_cast<float*>(smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) -
                                                    smem_u32(smem_raw)));
  float* ring = v_s + kVFloats;
  const int slot_floats = (q_res ? 1 : 2) * kChunkFloats;
  float* part = ring + slots * slot_floats;  // S partials [depth quarter][kRows][kPStride]
  float* p_s = part + kPartFloats;           // P [kRows][kPStride]
  float* q_s = p_s + kRows * kPStride;       // resident Q: [kRows][q_stride]
  const float* qg = p.q + (long long)b * p.q_bs + (long long)m0 * p.q_rs + (long long)h * p.d;
  const uint32_t full = smem_u32(&bars[0]), empty = full + 8 * kMaxSlots;
  const uint32_t v_full = empty + 8 * kMaxSlots, v_empty = v_full + 8, q_bar = v_empty + 8;

  if (tid == 0) {
    for (int i = 0; i < slots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kWarps);  // one arrival per consumer warp
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, kWarps);
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // The producer: every copy is TMA, issued from this warp (issued from the
    // consumers, the requests held them at the copy engine's queue).  Boxes
    // of 32 rows; columns past d arrive as
    // zeros.  Item n, depth chunk n % nc of key tile n / nc (and of Q when it
    // streams), goes into ring slot n % slots and completes phase n / slots
    // of its full barrier, once the consumers have emptied the slot; a key
    // tile's V follows its last chunk, once the consumers are done with the
    // last tile's.
    if (q_res) {  // Q once: a bulk copy per row
      if (lane == 0) mbar_arrive_expect_tx(q_bar, kRows * p.d * 4);
      __syncwarp();
      bulk_load(smem_u32(q_s + lane * p.q_stride), qg + (long long)lane * p.q_rs, p.d * 4, q_bar);
    }
    if (lane == 0) {
      for (int item = 0; item < n_items; ++item) {
        const int tile = item / nc, c = item % nc, slot = item % slots;
        if (item >= slots) mbar_wait(empty + 8 * slot, (item / slots - 1) & 1);
        const int boxes = (min(kChunk, p.d - c * kChunk) + kBoxK - 1) / kBoxK;
        const uint32_t dst = smem_u32(ring + slot * slot_floats), bar = full + 8 * slot;
        mbar_arrive_expect_tx(bar, (q_res ? 1 : 2) * boxes * kKeys * kBoxK * 4);
        for (int i = 0; i < boxes; ++i) {
          const uint32_t box = dst + 4 * i * kKeys * kBoxK;
          const int col = c * kChunk + i * kBoxK;
          tma_load_4d(box, &map_k, bar, col, h, tile * kKeys, b);
          if (!q_res) tma_load_4d(box + 4 * kChunkFloats, &map_q, bar, col, h, m0, b);
        }
        if (c == nc - 1) {  // the tile's V
          const int v_boxes = (vw + kBoxV - 1) / kBoxV;
          if (tile > 0) mbar_wait(v_empty, (tile - 1) & 1);
          mbar_arrive_expect_tx(v_full, v_boxes * kKeys * kBoxV * 4);
          for (int i = 0; i < v_boxes; ++i)
            tma_load_4d(smem_u32(v_s + i * kKeys * kBoxV), &map_v, v_full, c0 + i * kBoxV, h,
                        tile * kKeys, b);
        }
      }
    }
    return;
  }
  // the consumers' own barrier (the producer is not in it)
  auto consumers_sync = [] { named_barrier_sync(1, 32 * kWarps); };
  if (q_res) mbar_wait(q_bar, 0);

  float acc[16][4];  // O: rows g, g + 8 of the row group at columns 128 wq + 8 j + 2t, + 1
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in the log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's share of their sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    // this warp's share of S = Q K^T: rows 16 rg + g, + 8 at keys 8 n + 2t, + 1
    // (n = 0 .. 3), over depths 32 wq .. 32 wq + 31 of every chunk
    float sp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sp[n][i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int item = tile * nc + c;
      mbar_wait(full + 8 * (item % slots), (item / slots) & 1);
      const float* slot = ring + (item % slots) * slot_floats;
      const int w = min(kChunk, p.d - c * kChunk);  // floats of depth in this chunk
      // boxes 2 wq + gi hold depths 32 wq + 16 gi ..; a thread's 16 bytes of
      // row r sit at 16-byte position t ^ (r / 2 % 4), the 64-byte swizzle
      // (rows 8 n + g and 16 rg + g (+ 8) all give (g / 2) % 4)
      const int box_row = g * kBoxK + ((t ^ ((g >> 1) & 3)) << 2);
      const float* kb = slot + 2 * wq * kKeys * kBoxK + box_row;
      const int qs = q_res ? p.q_stride : kBoxK;  // row step; a box step is kRows * kBoxK
      const float* qa = q_res ? q_s + c * kChunk + (16 * rg + g) * qs + 32 * wq + 4 * t
                              : slot + kChunkFloats + 2 * wq * kRows * kBoxK + 16 * rg * kBoxK +
                                    box_row;
      const int q_box = q_res ? 16 : kRows * kBoxK;  // from depth group gi to gi + 1
      float bb[4][4], sm[4][4];  // [key tile][C fragment]: big*big, and the small terms
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) bb[n][i] = sm[n][i] = 0.f;
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        const int col = 32 * wq + 16 * gi;
        if (col >= w) break;
        const bool in = col + 4 * t < w;  // d is a multiple of 4: all in or all out
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 a_lo = in ? *reinterpret_cast<const float4*>(qa + q_box * gi) : z;
        const float4 a_hi = in ? *reinterpret_cast<const float4*>(qa + 8 * qs + q_box * gi) : z;
        // k-step 0: slots t and t + 4 hold depths 4t and 4t + 1; k-step 1: 4t + 2, 4t + 3
        const float a0[4] = {a_lo.x, a_hi.x, a_lo.y, a_hi.y};
        const float a1[4] = {a_lo.z, a_hi.z, a_lo.w, a_hi.w};
        uint32_t ab0[4], as0[4], ab1[4], as1[4];
        split_frag(a0, ab0, as0);
        split_frag(a1, ab1, as1);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float4 bk = *reinterpret_cast<const float4*>(kb + (gi * kKeys + 8 * n) * kBoxK);
          const float b0[2] = {bk.x, bk.y};
          const float b1[2] = {bk.z, bk.w};
          uint32_t kb0[2], ks0[2], kb1[2], ks1[2];
          split_frag(b0, kb0, ks0);
          split_frag(b1, kb1, ks1);
          mma_tf32(sm[n], as0, kb0);
          mma_tf32(sm[n], ab0, ks0);
          mma_tf32(bb[n], ab0, kb0);
          mma_tf32(sm[n], as1, kb1);
          mma_tf32(sm[n], ab1, ks1);
          mma_tf32(bb[n], ab1, kb1);
        }
      }
      __syncwarp();  // every lane is done with the slot
      if (lane == 0) mbar_arrive(empty + 8 * (item % slots));
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sp[n][i] += sm[n][i] + bb[n][i];  // small terms first
    }
    // the four depth quarters' partials, summed in shared memory into this
    // warp's keys of the softmax: 8 wq + 2t, + 1
    {
      float* pw = part + (wq * kRows + 16 * rg + g) * kPStride + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<float2*>(pw + 8 * n) = make_float2(sp[n][0], sp[n][1]);
        *reinterpret_cast<float2*>(pw + 8 * kPStride + 8 * n) = make_float2(sp[n][2], sp[n][3]);
      }
    }
    consumers_sync();
    float s[4] = {0.f, 0.f, 0.f, 0.f};  // rows g (0, 1) and g + 8 (2, 3) at keys 8 wq + 2t, + 1
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const float* pr = part + (q4 * kRows + 16 * rg + g) * kPStride + 8 * wq + 2 * t;
      const float2 lo = *reinterpret_cast<const float2*>(pr);
      const float2 hi = *reinterpret_cast<const float2*>(pr + 8 * kPStride);
      s[0] += lo.x, s[1] += lo.y, s[2] += hi.x, s[3] += hi.y;
    }

    // online softmax of rows g and g + 8 over the tile's 32 keys: the tile's
    // row maxima traded between the four warps of the row group
    float mx[2] = {fmaxf(s[0], s[1]), fmaxf(s[2], s[3])};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (t == 0) {
      red[rg][wq][g] = mx[0];
      red[rg][wq][g + 8] = mx[1];
    }
    consumers_sync();
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      const float m_tile = fmaxf(fmaxf(red[rg][0][row], red[rg][1][row]),
                                 fmaxf(red[rg][2][row], red[rg][3][row]));
      const float m_new = fmaxf(m_run[r], m_tile * p.scale_log2);  // scale > 0
      alpha[r] = ex2(m_run[r] - m_new);  // 2^-inf = 0 on the first tile
      m_run[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = ex2(fmaf(s[i], p.scale_log2, -m_run[i / 2]));
    l_run[0] = fmaf(l_run[0], alpha[0], s[0] + s[1]);
    l_run[1] = fmaf(l_run[1], alpha[1], s[2] + s[3]);
    {
      float* pw = p_s + (16 * rg + g) * kPStride + 8 * wq + 2 * t;
      *reinterpret_cast<float2*>(pw) = make_float2(s[0], s[1]);
      *reinterpret_cast<float2*>(pw + 8 * kPStride) = make_float2(s[2], s[3]);
    }

    mbar_wait(v_full, tile & 1);  // this tile's V has landed
    consumers_sync();             // and P is written

    // O[:, slice] = alpha O + P V[:, slice]: k slots t and t + 4 of k-step ks
    // hold keys 8 ks + 2t and 8 ks + 2t + 1
    uint32_t pb[kKeys / 8][4], ps[kKeys / 8][4];  // P as A fragments, big and small
    const float* pr = p_s + (16 * rg + g) * kPStride + 2 * t;
#pragma unroll
    for (int ks = 0; ks < kKeys / 8; ++ks) {
      const float2 p_lo = *reinterpret_cast<const float2*>(pr + 8 * ks);
      const float2 p_hi = *reinterpret_cast<const float2*>(pr + 8 * kPStride + 8 * ks);
      const float a[4] = {p_lo.x, p_hi.x, p_lo.y, p_hi.y};
      split_frag(a, pb[ks], ps[ks]);
    }
    // kGroup column tiles at a time, the key steps inside: kGroup independent
    // mma chains in flight.  Column 128 wq + 8 j + g is float 8 (j % 4) + g of
    // box 4 wq + j / 4: 16-byte chunk c = 2 (j % 4) + g / 4, which row r keeps
    // at position c ^ (r % 8), the 128-byte swizzle; rows 2t (b0) and 2t + 1
    // (b1) of a k-step
    const float* vb = v_s + 4 * wq * kKeys * kBoxV + 2 * t * kBoxV + (g & 3);
    int vx[4][2];  // [j % 4][b0, b1]: the swizzled chunk's float offset
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      vx[jj][0] = (2 * (jj ^ t) + (g >> 2)) << 2;
      vx[jj][1] = kBoxV + ((2 * (jj ^ t) + ((g >> 2) ^ 1)) << 2);
    }
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += kGroup) {
      if (128 * wq + 8 * j0 < vw) {
        float pv[kGroup][4];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[j][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKeys / 8; ++ks) {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const float* vp = vb + (j0 + j) / 4 * kKeys * kBoxV + 8 * ks * kBoxV;
            const float bv[2] = {vp[vx[(j0 + j) % 4][0]], vp[vx[(j0 + j) % 4][1]]};
            uint32_t bb[2], bs[2];
            split_frag(bv, bb, bs);
            mma_tf32(pv[j], ps[ks], bb);
            mma_tf32(pv[j], pb[ks], bs);
            mma_tf32(pv[j], pb[ks], bb);
          }
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[j0 + j][i] = fmaf(acc[j0 + j][i], alpha[i / 2], pv[j][i]);
      }
    }
    __syncwarp();  // every lane is done with V
    if (lane == 0) mbar_arrive(v_empty);
  }

  // the row sums: over the four lanes of a row, then over the row group's four warps
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // (every warp read the last tile's maxima before the P barrier it passed)
  if (t == 0) {
    red[rg][wq][g] = l_run[0];
    red[rg][wq][g + 8] = l_run[1];
  }
  consumers_sync();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    const float l = (red[rg][0][row] + red[rg][1][row]) + (red[rg][2][row] + red[rg][3][row]);
    inv[r] = l == 0.f ? 1.f : 1.f / l;
  }
  float* og = p.o + (long long)b * p.o_bs + (long long)(m0 + 16 * rg + g) * p.o_rs +
              (long long)h * p.d + c0 + 128 * wq + 2 * t;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (128 * wq + 8 * j + 2 * t < vw) {  // d is a multiple of 4: a column pair is in or out
      *reinterpret_cast<float2*>(og + 8 * j) =
          make_float2(acc[j][0] * inv[0], acc[j][1] * inv[0]);
      *reinterpret_cast<float2*>(og + 8 * p.o_rs + 8 * j) =
          make_float2(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
  }
}

}  // namespace

extern "C" {

// q, o: [batch, sq, heads*d]; k, v: [batch, sk, heads*d]; fp32 with unit inner
// stride, every row 16-byte aligned; d a multiple of 4 above 256; sq and sk
// multiples of 64; `strides` holds the batch and row strides of q, k, v, o in
// elements.  Returns a cudaError_t: 0 on a successful launch.
int videosd_flash_attention_wide_fp32_fwd(const void* q, const void* k, const void* v, void* o,
                                          int batch, int heads, int sq, int sk, int d,
                                          const long long* strides, float sm_scale, int device,
                                          void* stream) {
  if (!(batch > 0 && heads > 0 && sq > 0 && sk > 0 && device >= 0 && device < kMaxDevices &&
        sq % 64 == 0 && sk % 64 == 0 && sm_scale > 0.f && d > 256 && d % 4 == 0 &&
        batch * heads <= 65535))
    return (int)cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wide_fwd_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured[device] = true;
  }
  const Plan pl = plan(d);
  // [batch, rows, heads, d] read in boxes of 32 rows x box floats of one head
  auto tensor_map = [&](const void* ptr, long long bs, long long rs, int rows, int box,
                        CUtensorMapSwizzle swizzle, CUtensorMap* out) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows,
                                (cuuint64_t)batch};
    const cuuint64_t gstrides[3] = {4ull * d, 4ull * rs, 4ull * (batch == 1 ? rows * rs : bs)};
    const cuuint32_t boxes[4] = {(cuuint32_t)box, 1, 32, 1}, ones[4] = {1, 1, 1, 1};
    return encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, gstrides,
                  boxes, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
               ? cudaSuccess
               : cudaErrorInvalidValue;
  };
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = tensor_map(q, strides[0], strides[1], sq, kBoxK, CU_TENSOR_MAP_SWIZZLE_64B,
                               &map_q);
  if (err == cudaSuccess)
    err = tensor_map(k, strides[2], strides[3], sk, kBoxK, CU_TENSOR_MAP_SWIZZLE_64B, &map_k);
  if (err == cudaSuccess)
    err = tensor_map(v, strides[4], strides[5], sk, kBoxV, CU_TENSOR_MAP_SWIZZLE_128B, &map_v);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.q_bs = strides[0], p.q_rs = strides[1];
  p.k_bs = strides[2], p.k_rs = strides[3];
  p.v_bs = strides[4], p.v_rs = strides[5];
  p.o_bs = strides[6], p.o_rs = strides[7];
  p.heads = heads, p.sq = sq, p.sk = sk, p.d = d;
  p.q_stride = pl.q_stride, p.slots = pl.slots;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  const dim3 grid(sq / kRows, (d + kSlice - 1) / kSlice, batch * heads);
  flash_wide_fwd_fp32_kernel<<<grid, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      p, map_q, map_k, map_v);
  return (int)cudaGetLastError();
}

}  // extern "C"
