// Flash attention backward for Hopper (sm_90a), bf16, head dims up to 256:
// the gradients of o = softmax(q k^T * sm_scale) v for q, k and v.
//
// The backward of kernel K1' (videosd_tpu_torch/models/layers.py::
// FlashAttentionRecompute), whose forward is K1 (flash_attention.cu).  The
// JAX package has no backward kernel: its custom_vjp
// (videosd_tpu/models/layers.py::_attention_pallas_diff, the Pallas forward
// videosd_tpu/ops/pallas/flash_attention.py) differentiates the plain XLA
// attention, recomputed.  That recompute materializes the fp32 logits, the
// softmax and its gradient as [B*H, Sq, Sk] tensors in device memory (1 GiB
// each at batch 2 and 4096 tokens), so on the card it is bound by the traffic
// of those tensors.  This kernel pair never writes them: it takes the
// forward's row log-sum-exp (lse) and recomputes P tile by tile on the tensor
// cores (FlashAttention-2's backward, deterministic, no atomics).
//
// Numerics, those of ops/cuda/flash_attention.py::flash_attention_bwd_reference:
//   D  = rowsum(dO o)                       fp32, from the forward's bf16 o
//   P  = exp(q k^T * sm_scale - lse)        fp32 (ex2.approx in the log2 domain)
//   dV = bf16(P)^T dO                       fp32 sums
//   dP = dO v^T                             fp32 sums
//   dS = P (dP - D)                         fp32
//   dQ = bf16(dS) k * sm_scale, dK = bf16(dS)^T q * sm_scale
// P and dS are rounded to bf16 before their products, as the plain function
// rounds its weights to the input dtype; the outputs are rounded once.
//
// Two kernels, launched in that order on one stream:
// * dQ: a block owns 64 query rows of one head (4 warps, 16 rows each) and
//   loops over the key tiles; it first forms D for its rows (written to
//   `delta` for the second kernel), keeps dQ in fp32 registers and writes it
//   once.
// * dK/dV: a block owns 64 keys of one head (4 warps, 16 keys each; above
//   d = 80 two warps per 16 keys, each over half of dK's and dV's columns,
//   both forming the same logits) and loops over the query tiles, with the
//   transposed products: S^T = K Q^T, dP^T = V dO^T, so that P^T and dS^T
//   leave the accumulators as the A operands of dV += P^T dO and dK += dS^T Q.
//
// What bounds it on the H100: 10 Sq Sk d flops a head for the two kernels'
// 5 products (the recomputed logits and dP^T counted once) plus one more
// Q K^T and dO V^T in the dQ kernel: the tensor cores, and at d = 40 the exp
// unit and the fp32 lanes (two exponentials and ~10 fp32 operations per
// logit).  The design: every product on mma.sync m16n8k16 (bf16 -> fp32) with
// operands from shared memory through ldmatrix (.trans for the [k][n]
// operands), so no transposed copy is ever made; the K and V fragments held in
// registers up to d = 64 (Q and dO in the dQ kernel); the next tile copied by
// cp.async into a second buffer while the current one is used.  Rows in
// shared memory take an odd number of 16-byte chunks, so the 8 rows an
// ldmatrix reads land on 8 distinct bank groups; the depth is padded to the
// k16 step (40 -> 48) with zeros that no copy writes.
//
// Layout: heads in place.  q, o, dO are [B, Sq, H*d], k, v [B, Sk, H*d],
// bf16, last axis contiguous, batch and row strides as arguments; dq, dk, dv
// contiguous [B, S, H*d]; lse and delta [B*H, Sq] fp32.  d a multiple of 8 up
// to 256, on the instance of the next width of 8, 16, 40, 64, 80, 160, 256
// (ops/cuda/flash_attention.py::instance_width); Sq and Sk multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_common.cuh"

namespace {

using namespace flash_bwd;
using Params = BwdParams<__nv_bfloat16>;

template <int W>
struct Cfg {
  static constexpr int kDP = (W + 15) / 16 * 16;  // depth padded to the k16 step
  static constexpr int kKSteps = kDP / 16;
  // 16-byte chunks a row takes in shared memory: odd, so ldmatrix's 8 rows
  // fall on 8 distinct bank groups
  static constexpr int kSC = (kDP / 8) % 2 == 1 ? kDP / 8 : kDP / 8 + 1;
  static constexpr int kRowBytes = kSC * 16;
  // dK/dV kernel: warps of 16 keys, column slices of dK and dV, queries a step
  static constexpr int kKvRW = 4;
  static constexpr int kKvCS = W >= 160 ? 2 : 1;
  static constexpr int kKvThreads = 32 * kKvRW * kKvCS;
  static constexpr int kKvKeys = 16 * kKvRW;
  static constexpr int kKvQ = W >= 256 ? 32 : 64;
  static constexpr int kKvNT = kDP / 8 / kKvCS;  // n-tiles of a warp's dK, dV columns
  static constexpr int kKvSmem = (2 * kKvKeys + 4 * kKvQ) * kRowBytes + 4 * kKvQ * 4;
  // dQ kernel: warps of 16 query rows, keys a step
  static constexpr int kQRW = 4;
  static constexpr int kQThreads = 32 * kQRW;
  static constexpr int kQRows = 16 * kQRW;
  static constexpr int kQKeys = W >= 256 ? 32 : 64;
  static constexpr int kQNT = kDP / 8;
  static constexpr int kQSmem = (2 * kQRows + 4 * kQKeys) * kRowBytes + kQRows * 4;
  // the A fragments of the resident rows (K, V; Q, dO) held in registers
  static constexpr bool kHoist = W <= 64;
  static_assert(kKvNT % 2 == 0 && kQNT % 2 == 0, "n-tiles in pairs (ldmatrix x4)");
  static_assert(kKvSmem <= 232448 && kQSmem <= 232448, "shared memory of a block");
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a b on one m16n8k16 tile (a: rows g, g + 8 at k 2t, 2t + 1 and 2t + 8,
// 2t + 9; b: k 2t, 2t + 1 and 2t + 8, 2t + 9 at column g; d: rows g, g + 8 at
// columns 2t, 2t + 1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the ldmatrix .trans offsets of B fragments from [k][n] storage (a tile of
// rows of SC chunks): k rows from k0, n-tiles at chunks c0 and c0 + 1
template <int SC>
__device__ __forceinline__ uint32_t bt_off(int k0, int c0, int lane) {
  return ((k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * SC + c0 + (lane >> 4)) * 16;
}

// ---------------------------------------------------------------- dQ (and D)

template <int W>
__global__ void __launch_bounds__(Cfg<W>::kQThreads) flash_bwd_dq_kernel(const Params p) {
  using C = Cfg<W>;
  constexpr int kRows = C::kQRows, kKeys = C::kQKeys, kNT = C::kQNT, kSC = C::kSC;
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
  const int chunks = p.d / 8;
  const long long lrow = (long long)bh * p.sq + q0;

  zero_chunks(q_s, (2 * kRows + 4 * kKeys) * kSC, tid, kThreads);
  __syncthreads();

  const __nv_bfloat16* kg = p.k + (long long)b * p.k_bs + (long long)h * p.d;
  const __nv_bfloat16* vg = p.v + (long long)b * p.v_bs + (long long)h * p.d;
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
  // rows g and g + 8 of this warp: D and lse in the log2 domain
  const float dd0 = dl_s[16 * warp + g], dd1 = dl_s[16 * warp + g + 8];
  const float l0 = p.lse[lrow + 16 * warp + g] * kLog2e;
  const float l1 = p.lse[lrow + 16 * warp + g + 8] * kLog2e;

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  uint32_t qa[C::kHoist ? C::kKSteps : 1][4], oa[C::kHoist ? C::kKSteps : 1][4];

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
    if constexpr (C::kHoist) {
      if (j == 0) {
#pragma unroll
        for (int kd = 0; kd < C::kKSteps; ++kd) {
          ldsm_x4(q_s + a_off<kSC>(16 * warp, kd, lane), qa[kd]);
          ldsm_x4(do_s + a_off<kSC>(16 * warp, kd, lane), oa[kd]);
        }
      }
    }
    const uint32_t kb = k_s + buf * kKeys * kRB, vb = v_s + buf * kKeys * kRB;

    // S = Q K^T and dP = dO V^T: rows g, g + 8 at keys 8 n + 2t, + 1
    float s[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < C::kKSteps; ++kd) {
      uint32_t aq[4], ao[4];
      if constexpr (C::kHoist) {
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[i] = qa[kd][i], ao[i] = oa[kd][i];
      } else {
        ldsm_x4(q_s + a_off<kSC>(16 * warp, kd, lane), aq);
        ldsm_x4(do_s + a_off<kSC>(16 * warp, kd, lane), ao);
      }
#pragma unroll
      for (int n2 = 0; n2 < kKeys / 16; ++n2) {
        uint32_t bk[4], bv[4];
        ldsm_x4(kb + b_off<kSC>(16 * n2, kd, lane), bk);
        ldsm_x4(vb + b_off<kSC>(16 * n2, kd, lane), bv);
        mma_bf16(s[2 * n2], aq, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * n2], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * n2 + 1], ao, bv[2], bv[3]);
      }
    }
    // dS = P (dP - D), rounded to bf16 as dQ's A operand: n-tiles 2 kk and
    // 2 kk + 1 make k16 step kk
    uint32_t da[kKeys / 16][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      const float p0 = ex2(fmaf(s[n][0], p.scale_log2, -l0));
      const float p1 = ex2(fmaf(s[n][1], p.scale_log2, -l0));
      const float p2 = ex2(fmaf(s[n][2], p.scale_log2, -l1));
      const float p3 = ex2(fmaf(s[n][3], p.scale_log2, -l1));
      da[n / 2][2 * (n % 2)] = pack_bf16(p0 * (dp[n][0] - dd0), p1 * (dp[n][1] - dd0));
      da[n / 2][2 * (n % 2) + 1] = pack_bf16(p2 * (dp[n][2] - dd1), p3 * (dp[n][3] - dd1));
    }
    // dQ += dS K: K as the [k][n] operand
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t bk[4];
        ldsm_x4_t(kb + bt_off<kSC>(16 * kk, 2 * n2, lane), bk);
        mma_bf16(acc[2 * n2], da[kk], bk[0], bk[1]);
        mma_bf16(acc[2 * n2 + 1], da[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // the buffer is refilled in the next step
  }

  const long long rs = (long long)p.heads * p.d;
  __nv_bfloat16* dqg = p.dq + ((long long)b * p.sq + q0 + 16 * warp + g) * rs +
                       (long long)h * p.d + 2 * t;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (8 * n + 2 * t < p.d) {
      *reinterpret_cast<__nv_bfloat162*>(dqg + 8 * n) =
          __floats2bfloat162_rn(acc[n][0] * p.scale, acc[n][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dqg + 8 * rs + 8 * n) =
          __floats2bfloat162_rn(acc[n][2] * p.scale, acc[n][3] * p.scale);
    }
  }
}

// ---------------------------------------------------------------- dK and dV

template <int W>
__global__ void __launch_bounds__(Cfg<W>::kKvThreads) flash_bwd_dkdv_kernel(const Params p) {
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
  const int chunks = p.d / 8;
  const long long lrow = (long long)bh * p.sq;

  zero_chunks(k_s, (2 * kKeys + 4 * kQ) * kSC, tid, kThreads);
  __syncthreads();

  copy_rows<kSC>(k_s, p.k + (long long)b * p.k_bs + (long long)key0 * p.k_rs + (long long)h * p.d,
                 p.k_rs, kKeys, chunks, tid, kThreads);
  copy_rows<kSC>(v_s, p.v + (long long)b * p.v_bs + (long long)key0 * p.v_rs + (long long)h * p.d,
                 p.v_rs, kKeys, chunks, tid, kThreads);
  const __nv_bfloat16* qg = p.q + (long long)b * p.q_bs + (long long)h * p.d;
  const __nv_bfloat16* dog = p.dout + (long long)b * p.do_bs + (long long)h * p.d;
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
  uint32_t ka[C::kHoist ? C::kKSteps : 1][4], va[C::kHoist ? C::kKSteps : 1][4];

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
    if constexpr (C::kHoist) {
      if (j == 0) {
#pragma unroll
        for (int kd = 0; kd < C::kKSteps; ++kd) {
          ldsm_x4(k_s + a_off<kSC>(16 * rw, kd, lane), ka[kd]);
          ldsm_x4(v_s + a_off<kSC>(16 * rw, kd, lane), va[kd]);
        }
      }
    }
    const uint32_t qb = q_s + buf * kQ * kRB, dob = do_s + buf * kQ * kRB;

    // S^T = K Q^T and dP^T = V dO^T: keys g, g + 8 at queries 8 n + 2t, + 1
    float s[kQ / 8][4], dp[kQ / 8][4];
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < C::kKSteps; ++kd) {
      uint32_t ak[4], av[4];
      if constexpr (C::kHoist) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ak[i] = ka[kd][i], av[i] = va[kd][i];
      } else {
        ldsm_x4(k_s + a_off<kSC>(16 * rw, kd, lane), ak);
        ldsm_x4(v_s + a_off<kSC>(16 * rw, kd, lane), av);
      }
#pragma unroll
      for (int n2 = 0; n2 < kQ / 16; ++n2) {
        uint32_t bq[4], bo[4];
        ldsm_x4(qb + b_off<kSC>(16 * n2, kd, lane), bq);
        ldsm_x4(dob + b_off<kSC>(16 * n2, kd, lane), bo);
        mma_bf16(s[2 * n2], ak, bq[0], bq[1]);
        mma_bf16(s[2 * n2 + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * n2], av, bo[0], bo[1]);
        mma_bf16(dp[2 * n2 + 1], av, bo[2], bo[3]);
      }
    }
    // P^T and dS^T = P^T (dP^T - D), rounded to bf16 as the A operands
    const float* lb = lse_s + buf * kQ;
    const float* db = dl_s + buf * kQ;
    uint32_t pa[kQ / 16][4], da[kQ / 16][4];
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(lb + 8 * n + 2 * t);
      const float2 dd = *reinterpret_cast<const float2*>(db + 8 * n + 2 * t);
      const float la = l.x * kLog2e, lc = l.y * kLog2e;
      const float p0 = ex2(fmaf(s[n][0], p.scale_log2, -la));
      const float p1 = ex2(fmaf(s[n][1], p.scale_log2, -lc));
      const float p2 = ex2(fmaf(s[n][2], p.scale_log2, -la));
      const float p3 = ex2(fmaf(s[n][3], p.scale_log2, -lc));
      pa[n / 2][2 * (n % 2)] = pack_bf16(p0, p1);
      pa[n / 2][2 * (n % 2) + 1] = pack_bf16(p2, p3);
      da[n / 2][2 * (n % 2)] = pack_bf16(p0 * (dp[n][0] - dd.x), p1 * (dp[n][1] - dd.y));
      da[n / 2][2 * (n % 2) + 1] = pack_bf16(p2 * (dp[n][2] - dd.x), p3 * (dp[n][3] - dd.y));
    }
    // dV += P^T dO and dK += dS^T Q over this warp's columns: dO and Q as
    // the [k][n] operands
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        const uint32_t off = bt_off<kSC>(16 * kk, cs * kNT + 2 * n2, lane);
        uint32_t bo[4], bq[4];
        ldsm_x4_t(dob + off, bo);
        ldsm_x4_t(qb + off, bq);
        mma_bf16(dv[2 * n2], pa[kk], bo[0], bo[1]);
        mma_bf16(dv[2 * n2 + 1], pa[kk], bo[2], bo[3]);
        mma_bf16(dk[2 * n2], da[kk], bq[0], bq[1]);
        mma_bf16(dk[2 * n2 + 1], da[kk], bq[2], bq[3]);
      }
    }
    __syncthreads();  // the buffer is refilled in the next step
  }

  const long long rs = (long long)p.heads * p.d;
  const long long at = ((long long)b * p.sk + key0 + 16 * rw + g) * rs + (long long)h * p.d + 2 * t;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = 8 * (cs * kNT + n);
    if (col + 2 * t < p.d) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + at + col) =
          __floats2bfloat162_rn(dk[n][0] * p.scale, dk[n][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dk + at + 8 * rs + col) =
          __floats2bfloat162_rn(dk[n][2] * p.scale, dk[n][3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + at + col) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + at + 8 * rs + col) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
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
        flash_bwd_dq_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kQSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, C::kKvSmem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  flash_bwd_dq_kernel<W>
      <<<dim3(p.sq / C::kQRows, batch * p.heads), C::kQThreads, C::kQSmem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<W>
      <<<dim3(p.sk / C::kKvKeys, batch * p.heads), C::kKvThreads, C::kKvSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout: [batch, sq, heads*d]; k, v: [batch, sk, heads*d]; bf16 with unit
// inner stride, every row 16-byte aligned; `strides` holds the batch and row
// strides of q, k, v, o, dout in elements.  lse: [batch*heads, sq] fp32 (the
// forward's natural-log row log-sum-exp of the scaled logits); delta: scratch
// of the same shape.  dq, dk, dv: contiguous, shaped as q, k, v.  d a multiple
// of 8 up to 256; sq and sk multiples of 64.  Launches the dQ kernel, then the
// dK/dV kernel, on `stream`.  Returns a cudaError_t: 0 on successful launches.
int videosd_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* delta, void* dq,
                                void* dk, void* dv, int batch, int heads, int sq, int sk, int d,
                                const long long* strides, float sm_scale, int device,
                                void* stream) {
  Params p;
  if (!make_params(p, q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, sq, sk, d, strides,
                   sm_scale, device))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instance of the next width >= d (flash_attention.py::instance_width)
  if (d <= 8) return (int)launch<8>(p, batch, device, s);
  if (d <= 16) return (int)launch<16>(p, batch, device, s);
  if (d <= 40) return (int)launch<40>(p, batch, device, s);
  if (d <= 64) return (int)launch<64>(p, batch, device, s);
  if (d <= 80) return (int)launch<80>(p, batch, device, s);
  if (d <= 160) return (int)launch<160>(p, batch, device, s);
  return (int)launch<256>(p, batch, device, s);
}

}  // extern "C"
