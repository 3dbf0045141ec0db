// Flash attention backward for Hopper (sm_90a), fp32, head dims up to 256:
// the gradients of o = softmax(q k^T * sm_scale) v for q, k and v, every
// product in 3xTF32 on the tensor cores.
//
// The fp32 backward of kernel K1' (videosd_tpu_torch/models/layers.py::
// FlashAttentionRecompute), whose forward is K1's fp32 kernel
// (flash_attention_fp32.cu): the train steps' dtype.  The JAX package has no
// backward kernel (its custom_vjp, videosd_tpu/models/layers.py::
// _attention_pallas_diff, differentiates the plain XLA attention,
// recomputed); flash_attention_bwd.cu is the bf16 kernel pair and says what
// the plain recompute costs on the card and what this design keeps out of
// device memory.  The same two kernels and partitions, the same formula
// (ops/cuda/flash_attention.py::flash_attention_bwd_reference) with nothing
// rounded but the products' operands:
//   D = rowsum(dO o); P = exp(q k^T * sm_scale - lse); dV = P^T dO;
//   dP = dO v^T; dS = P (dP - D); dQ = dS k * sm_scale; dK = dS^T q * sm_scale.
//
// 3xTF32, as in flash_attention_fp32.cu: each fp32 operand x splits into big
// (x plus half a TF32 ulp, which the mma reads rounded to nearest) and small
// = x - big (exact, read truncated); a product is small*big + big*small +
// big*big on mma.sync.m16n8k8.tf32, the dropped small*small ~2^-22 relative.
// The tensor cores' fp32 sums truncate, so no accumulator runs long: the
// logits and dP^T sum over at most 32 k-steps of the depth, and dV, dK and dQ
// over one tile (8 k-steps) into a partial that an fp32 add takes into the
// register accumulator.
//
// What bounds it on the H100: 14 Sq Sk d flops a head (the dQ kernel's
// recomputed logits and dP included), as 3 TF32 products at 494.7 / 3
// TFLOP/s; beside each mma the splits and fragment loads.  Operands from
// shared memory: A fragments ([m][k] storage) and B fragments of [n][k]
// storage through ldmatrix (on 32-bit data an 8 x 8 b16 matrix is 8 rows of
// 4 floats, so a thread receives float (g, t): the TF32 A and B layouts); the
// [k][n] operands (dO and Q in dV and dK, K in dQ) by scalar loads, with the
// key order inside a k-step that the accumulator gives (slots t and t + 4
// hold keys 2t and 2t + 1), so P^T and dS^T go from the accumulators
// straight into A fragments.  Rows in shared memory are 4 x an odd number of
// floats: ldmatrix's 8 rows on 8 distinct bank groups, and the scalar loads of
// rows 2t (+ 1) at columns g on 32 distinct banks.
//
// Layout: heads in place.  q, o, dO are [B, Sq, H*d], k, v [B, Sk, H*d],
// fp32, last axis contiguous, batch and row strides as arguments; dq, dk, dv
// contiguous [B, S, H*d]; lse and delta [B*H, Sq].  d a multiple of 4 up to
// 256, on the instance of the next width of 8, 16, 40, 64, 80, 160, 256; Sq
// and Sk multiples of 64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_common.cuh"

namespace {

using namespace flash_bwd;
using Params = BwdParams<float>;

constexpr int kGroup = 8;  // n-tiles of a partial sum

template <int W>
struct Cfg {
  static constexpr int kDP = (W + 7) / 8 * 8;  // depth padded to the k8 step
  static constexpr int kKSteps = kDP / 8;
  // 16-byte chunks (4 floats) a row takes in shared memory: odd
  static constexpr int kSC = (kDP / 4) % 2 == 1 ? kDP / 4 : kDP / 4 + 1;
  static constexpr int kSF = 4 * kSC;  // floats a row
  static constexpr int kRowBytes = kSC * 16;
  static constexpr int kNTAll = kDP / 8;  // n-tiles of the depth
  // dK/dV kernel: warps of 16 keys, column slices of dK and dV, queries a step
  static constexpr int kKvRW = W >= 256 ? 2 : 4;
  static constexpr int kKvCS = W >= 160 ? 2 : 1;
  static constexpr int kKvThreads = 32 * kKvRW * kKvCS;
  static constexpr int kKvKeys = 16 * kKvRW;
  static constexpr int kKvQ = W >= 160 ? 32 : 64;
  static constexpr int kKvNT = kNTAll / kKvCS;
  static constexpr int kKvSmem = (2 * kKvKeys + 4 * kKvQ) * kRowBytes + 4 * kKvQ * 4;
  // dQ kernel: warps of 16 query rows, keys a step
  static constexpr int kQRW = W >= 256 ? 2 : 4;
  static constexpr int kQThreads = 32 * kQRW;
  static constexpr int kQRows = 16 * kQRW;
  static constexpr int kQKeys = W >= 160 ? 32 : 64;
  static constexpr int kQSmem = (2 * kQRows + 4 * kQKeys) * kRowBytes + kQRows * 4;
  // launch bounds of 2 blocks an SM up to W = 80: a register allocation that
  // ran [8, 4096, 40] in 0.86-0.87 of the time of the compiler's own choice
  // (kernel_variants.py bwd, "1 block an SM", two runs on an H100)
  static constexpr int kMinBlocks = W <= 80 ? 2 : 1;
  static_assert(kNTAll % kKvCS == 0, "column slices of whole n-tiles");
  static_assert(kKvSmem <= 232448 && kQSmem <= 232448, "shared memory of a block");
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}
// x as TF32 big + small (flash_attention_fp32.cu::split)
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
template <int N>
__device__ __forceinline__ void split_bits(const uint32_t (&x)[N], uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(__uint_as_float(x[i]), big[i], small[i]);
}

// d += a b on one m16n8k8 tile (a: rows g, g + 8 at k slots t, t + 4; b: k
// slots t, t + 4 at column g; d: rows g, g + 8 at columns 2t, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the three TF32 products of a b, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// acc[n] += A B over k-steps ks < KS for the n-tiles of one warp: A from the
// accumulator tiles x[ks] (rows g, g + 8 at columns 2t, 2t + 1: slot t holds
// column 2t, slot t + 4 column 2t + 1), B from [k][n] storage at `src` (rows
// of SF floats; k-step ks at rows 8 ks + 2t and + 1, n-tile n at columns
// c0 + 8 n + g), NT n-tiles, in partials of kGroup n-tiles per tile.
template <int KS, int NT, int SF>
__device__ __forceinline__ void acc_ab(float (&acc)[NT][4], const float (&x)[KS][4],
                                       uint32_t src, int c0, int g, int t) {
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += kGroup) {
    constexpr int kG = NT < kGroup ? NT : kGroup;
    float part[kG][4];
#pragma unroll
    for (int n = 0; n < kG; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float a[4] = {x[ks][0], x[ks][2], x[ks][1], x[ks][3]};
      uint32_t ab[4], as[4];
      split_frag(a, ab, as);
      const uint32_t row = src + 4 * ((8 * ks + 2 * t) * SF + c0 + g);
#pragma unroll
      for (int n = 0; n < kG; ++n) {
        if (n0 + n < NT) {
          uint32_t bb0, bs0, bb1, bs1;
          split(lds(row + 4 * 8 * (n0 + n)), bb0, bs0);
          split(lds(row + 4 * (SF + 8 * (n0 + n))), bb1, bs1);
          mma_3xtf32(part[n], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kG; ++n)
      if (n0 + n < NT)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n0 + n][i] += part[n][i];
  }
}

// s += A B^T and dp += A' B'^T over the depth: A, A' the 16 rows from r0 of
// tiles a_s, a2_s ([m][k]); B, B' the NK x 8 rows of b_s, b2_s ([n][k])
template <int NK, int KSTEPS, int SC>
__device__ __forceinline__ void two_logits(float (&s)[NK][4], float (&dp)[NK][4], uint32_t a_s,
                                           uint32_t a2_s, int r0, uint32_t b_s, uint32_t b2_s,
                                           int lane) {
#pragma unroll
  for (int kd = 0; kd < KSTEPS; ++kd) {
    uint32_t a[4], a2[4], ab[4], as[4], a2b[4], a2s[4];
    ldsm_x4(a_s + a_off<SC>(r0, kd, lane), a);
    ldsm_x4(a2_s + a_off<SC>(r0, kd, lane), a2);
    split_bits(a, ab, as);
    split_bits(a2, a2b, a2s);
#pragma unroll
    for (int n2 = 0; n2 < NK / 2; ++n2) {
      uint32_t b[4], bb[4], bs[4];
      ldsm_x4(b_s + b_off<SC>(16 * n2, kd, lane), b);
      split_bits(b, bb, bs);
      mma_3xtf32(s[2 * n2], ab, as, bb[0], bb[1], bs[0], bs[1]);
      mma_3xtf32(s[2 * n2 + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
      ldsm_x4(b2_s + b_off<SC>(16 * n2, kd, lane), b);
      split_bits(b, bb, bs);
      mma_3xtf32(dp[2 * n2], a2b, a2s, bb[0], bb[1], bs[0], bs[1]);
      mma_3xtf32(dp[2 * n2 + 1], a2b, a2s, bb[2], bb[3], bs[2], bs[3]);
    }
  }
}

// ---------------------------------------------------------------- dQ (and D)

template <int W>
__global__ void __launch_bounds__(Cfg<W>::kQThreads, Cfg<W>::kMinBlocks)
    flash_bwd_fp32_dq_kernel(const Params p) {
  using C = Cfg<W>;
  constexpr int kRows = C::kQRows, kKeys = C::kQKeys, kNT = C::kNTAll, kSC = C::kSC;
  constexpr int kThreads = C::kQThreads, kRB = C::kRowBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_s = smem_addr(smem);
  const uint32_t do_s = q_s + kRows * kRB;
  const uint32_t k_s = do_s + kRows * kRB;  // 2 buffers of kKeys rows
  const uint32_t v_s = k_s + 2 * kKeys * kRB;
  float* dl_s = reinterpret_cast<float*>(smem + (2 * kRows + 4 * kKeys) * kRB);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int chunks = p.d / 4;
  const long long lrow = (long long)bh * p.sq + q0;

  zero_chunks(q_s, (2 * kRows + 4 * kKeys) * kSC, tid, kThreads);
  __syncthreads();

  const float* kg = p.k + (long long)b * p.k_bs + (long long)h * p.d;
  const float* vg = p.v + (long long)b * p.v_bs + (long long)h * p.d;
  copy_rows<kSC>(q_s, p.q + (long long)b * p.q_bs + (long long)q0 * p.q_rs + (long long)h * p.d,
                 p.q_rs, kRows, chunks, tid, kThreads);
  copy_rows<kSC>(do_s,
                 p.dout + (long long)b * p.do_bs + (long long)q0 * p.do_rs + (long long)h * p.d,
                 p.do_rs, kRows, chunks, tid, kThreads);
  auto load_kv = [&](int j, int buf) {
    const long long k0 = (long long)j * kKeys;
    copy_rows<kSC>(k_s + buf * kKeys * kRB, kg + k0 * p.k_rs, p.k_rs, kKeys, chunks, tid,
                   kThreads);
    copy_rows<kSC>(v_s + buf * kKeys * kRB, vg + k0 * p.v_rs, p.v_rs, kKeys, chunks, tid,
                   kThreads);
  };
  load_kv(0, 0);
  cp_async_commit();

  // D for this warp's 16 rows
  rowsum_do_o(p.o + (long long)b * p.o_bs + (long long)q0 * p.o_rs + (long long)h * p.d, p.o_rs,
              p.dout + (long long)b * p.do_bs + (long long)q0 * p.do_rs + (long long)h * p.d,
              p.do_rs, 16 * warp, chunks, lane, dl_s, p.delta + lrow);
  __syncwarp();
  const float dd0 = dl_s[16 * warp + g], dd1 = dl_s[16 * warp + g + 8];
  const float l0 = p.lse[lrow + 16 * warp + g] * kLog2e;
  const float l1 = p.lse[lrow + 16 * warp + g + 8] * kLog2e;

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int n_tiles = p.sk / kKeys;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_kv(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kb = k_s + buf * kKeys * kRB, vb = v_s + buf * kKeys * kRB;

    // S = Q K^T, dP = dO V^T: rows g, g + 8 at keys 8 n + 2t, + 1
    float s[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    two_logits<kKeys / 8, C::kKSteps, kSC>(s, dp, q_s, do_s, 16 * warp, kb, vb, lane);
    // dS = P (dP - D), left in dp
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      dp[n][0] = ex2(fmaf(s[n][0], p.scale_log2, -l0)) * (dp[n][0] - dd0);
      dp[n][1] = ex2(fmaf(s[n][1], p.scale_log2, -l0)) * (dp[n][1] - dd0);
      dp[n][2] = ex2(fmaf(s[n][2], p.scale_log2, -l1)) * (dp[n][2] - dd1);
      dp[n][3] = ex2(fmaf(s[n][3], p.scale_log2, -l1)) * (dp[n][3] - dd1);
    }
    // dQ += dS K: K as the [k][n] operand
    acc_ab<kKeys / 8, kNT, C::kSF>(acc, dp, kb, 0, g, t);
    __syncthreads();  // the buffer is refilled in the next step
  }

  const long long rs = (long long)p.heads * p.d;
  float* dqg = p.dq + ((long long)b * p.sq + q0 + 16 * warp + g) * rs + (long long)h * p.d + 2 * t;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (8 * n + 2 * t < p.d) {  // d is a multiple of 4: a column pair is in or out
      *reinterpret_cast<float2*>(dqg + 8 * n) =
          make_float2(acc[n][0] * p.scale, acc[n][1] * p.scale);
      *reinterpret_cast<float2*>(dqg + 8 * rs + 8 * n) =
          make_float2(acc[n][2] * p.scale, acc[n][3] * p.scale);
    }
  }
}

// ---------------------------------------------------------------- dK and dV

template <int W>
__global__ void __launch_bounds__(Cfg<W>::kKvThreads, Cfg<W>::kMinBlocks)
    flash_bwd_fp32_dkdv_kernel(const Params p) {
  using C = Cfg<W>;
  constexpr int kKeys = C::kKvKeys, kQ = C::kKvQ, kNT = C::kKvNT, kSC = C::kSC;
  constexpr int kThreads = C::kKvThreads, kRB = C::kRowBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t k_s = smem_addr(smem);
  const uint32_t v_s = k_s + kKeys * kRB;
  const uint32_t q_s = v_s + kKeys * kRB;  // 2 buffers of kQ rows
  const uint32_t do_s = q_s + 2 * kQ * kRB;
  float* lse_s = reinterpret_cast<float*>(smem + (2 * kKeys + 4 * kQ) * kRB);  // 2 x kQ
  float* dl_s = lse_s + 2 * kQ;                                               // 2 x kQ

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = warp % C::kKvRW, cs = warp / C::kKvRW;  // 16-key group, column slice
  const int key0 = blockIdx.x * kKeys;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int chunks = p.d / 4;
  const long long lrow = (long long)bh * p.sq;

  zero_chunks(k_s, (2 * kKeys + 4 * kQ) * kSC, tid, kThreads);
  __syncthreads();

  copy_rows<kSC>(k_s, p.k + (long long)b * p.k_bs + (long long)key0 * p.k_rs + (long long)h * p.d,
                 p.k_rs, kKeys, chunks, tid, kThreads);
  copy_rows<kSC>(v_s, p.v + (long long)b * p.v_bs + (long long)key0 * p.v_rs + (long long)h * p.d,
                 p.v_rs, kKeys, chunks, tid, kThreads);
  const float* qg = p.q + (long long)b * p.q_bs + (long long)h * p.d;
  const float* dog = p.dout + (long long)b * p.do_bs + (long long)h * p.d;
  auto load_q = [&](int j, int buf) {
    const long long r0 = (long long)j * kQ;
    copy_rows<kSC>(q_s + buf * kQ * kRB, qg + r0 * p.q_rs, p.q_rs, kQ, chunks, tid, kThreads);
    copy_rows<kSC>(do_s + buf * kQ * kRB, dog + r0 * p.do_rs, p.do_rs, kQ, chunks, tid,
                   kThreads);
    if (tid < kQ / 4)
      cp_async16(smem_addr(lse_s + buf * kQ + 4 * tid), p.lse + lrow + r0 + 4 * tid);
    else if (tid < kQ / 2)
      cp_async16(smem_addr(dl_s + buf * kQ + 4 * (tid - kQ / 4)),
                 p.delta + lrow + r0 + 4 * (tid - kQ / 4));
  };
  load_q(0, 0);
  cp_async_commit();

  float dk[kNT][4], dv[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  const int n_tiles = p.sq / kQ;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_q(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t qb = q_s + buf * kQ * kRB, dob = do_s + buf * kQ * kRB;

    // S^T = K Q^T, dP^T = V dO^T: keys g, g + 8 at queries 8 n + 2t, + 1
    float s[kQ / 8][4], dp[kQ / 8][4];
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    two_logits<kQ / 8, C::kKSteps, kSC>(s, dp, k_s, v_s, 16 * rw, qb, dob, lane);
    // P^T into s, dS^T = P^T (dP^T - D) into dp
    const float* lb = lse_s + buf * kQ;
    const float* db = dl_s + buf * kQ;
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(lb + 8 * n + 2 * t);
      const float2 dd = *reinterpret_cast<const float2*>(db + 8 * n + 2 * t);
      const float la = l.x * kLog2e, lc = l.y * kLog2e;
      s[n][0] = ex2(fmaf(s[n][0], p.scale_log2, -la));
      s[n][1] = ex2(fmaf(s[n][1], p.scale_log2, -lc));
      s[n][2] = ex2(fmaf(s[n][2], p.scale_log2, -la));
      s[n][3] = ex2(fmaf(s[n][3], p.scale_log2, -lc));
      dp[n][0] = s[n][0] * (dp[n][0] - dd.x);
      dp[n][1] = s[n][1] * (dp[n][1] - dd.y);
      dp[n][2] = s[n][2] * (dp[n][2] - dd.x);
      dp[n][3] = s[n][3] * (dp[n][3] - dd.y);
    }
    // dV += P^T dO, dK += dS^T Q over this warp's columns
    acc_ab<kQ / 8, kNT, C::kSF>(dv, s, dob, cs * kNT * 8, g, t);
    acc_ab<kQ / 8, kNT, C::kSF>(dk, dp, qb, cs * kNT * 8, g, t);
    __syncthreads();  // the buffer is refilled in the next step
  }

  const long long rs = (long long)p.heads * p.d;
  const long long at = ((long long)b * p.sk + key0 + 16 * rw + g) * rs + (long long)h * p.d + 2 * t;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = 8 * (cs * kNT + n);
    if (col + 2 * t < p.d) {
      *reinterpret_cast<float2*>(p.dk + at + col) =
          make_float2(dk[n][0] * p.scale, dk[n][1] * p.scale);
      *reinterpret_cast<float2*>(p.dk + at + 8 * rs + col) =
          make_float2(dk[n][2] * p.scale, dk[n][3] * p.scale);
      *reinterpret_cast<float2*>(p.dv + at + col) = make_float2(dv[n][0], dv[n][1]);
      *reinterpret_cast<float2*>(p.dv + at + 8 * rs + col) = make_float2(dv[n][2], dv[n][3]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <int W>
cudaError_t launch(const Params& p, int batch, int device, cudaStream_t stream) {
  using C = Cfg<W>;
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_fp32_dq_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kQSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_fp32_dkdv_kernel<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, C::kKvSmem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  flash_bwd_fp32_dq_kernel<W>
      <<<dim3(p.sq / C::kQRows, batch * p.heads), C::kQThreads, C::kQSmem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_fp32_dkdv_kernel<W>
      <<<dim3(p.sk / C::kKvKeys, batch * p.heads), C::kKvThreads, C::kKvSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// As videosd_flash_attention_bwd (flash_attention_bwd.cu) on fp32 tensors: d a
// multiple of 4 up to 256, every row 16-byte aligned.
int videosd_flash_attention_bwd_fp32(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* delta, void* dq,
                                     void* dk, void* dv, int batch, int heads, int sq, int sk,
                                     int d, const long long* strides, float sm_scale, int device,
                                     void* stream) {
  Params p;
  if (!make_params(p, q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, sq, sk, d, strides,
                   sm_scale, device))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 8) return (int)launch<8>(p, batch, device, s);
  if (d <= 16) return (int)launch<16>(p, batch, device, s);
  if (d <= 40) return (int)launch<40>(p, batch, device, s);
  if (d <= 64) return (int)launch<64>(p, batch, device, s);
  if (d <= 80) return (int)launch<80>(p, batch, device, s);
  if (d <= 160) return (int)launch<160>(p, batch, device, s);
  return (int)launch<256>(p, batch, device, s);
}

}  // extern "C"
