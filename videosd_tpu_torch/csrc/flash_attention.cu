// Flash attention forward for Hopper (sm_90a): softmax(q k^T * sm_scale) v.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/flash_attention.py::mha_flash
// (body `_kernel`), which the UNet and ControlNet self-attention reach through
// videosd_tpu/models/layers.py::attention.  Same numerics: fp32 logits, fp32
// running max / sum / accumulator (online softmax), the probabilities rounded
// to bf16 before P.V (the reference's `p.astype(v.dtype)`), and a guard that
// leaves a row with l == 0 unscaled.
//
// Layout: heads in place.  q and o are [B, Sq, H*d], k and v [B, Sk, H*d],
// bf16, the last axis contiguous; batch and row strides are arguments, so a
// folded [B*H, S, d] tensor is the case H = 1.  Nothing is copied or padded
// in device memory.  Any head dim d that is a multiple of 8 up to 256 (rows
// of 16 bytes, as cp.async and TMA read them): it runs on the template
// instance of the next width W >= d among 8, 16, 40, 64, 80, 160 and 256,
// whose extra columns hold zeros in shared memory (the wrapper zero-pads any
// other d in a folded copy, as the TPU kernel's wrapper pads to 128 lanes).
// The fp32 kernel is flash_attention_fp32.cu.
//
// What bounds it on the H100: at the UNet's shapes (S = 4096/1024/256, d_head
// 40/80/160, 8 heads) the work is 4 S^2 d flops per head against 8 S d bytes,
// far above the ridge point, so the tensor cores bound it, and at d = 40 the
// exp unit as well (one exp per 160 tensor-core flops; at the tiny family's
// d = 8 and 16, one per 32 and 64, the exp unit alone bounds it).  What the
// design does about that:
//
// * Both products on wgmma (m64nNk16, bf16 -> fp32).  S = Q K^T takes Q and K
//   from shared memory, K-major.  P V takes P straight from the S accumulator
//   registers (the A operand of an "rs" wgmma has the accumulator's layout)
//   and V from shared memory as the MN-major B operand: no transposed gather.
//   N = W; the depth of Q K^T is padded to the k16 step (8 -> 16, 40 -> 48),
//   and a d below W to W, with zeros in shared memory only.  P V's output
//   columns past d are never stored.
// * A ring of K/V stages handed over by "full" and "empty" mbarriers, filled
//   asynchronously by a producer while the consumers compute.  One tile of 64
//   keys serves K as a K-major operand and V as an MN-major one.  Two ways
//   of filling it, chosen per head dim:
//   - W = 64, 80, 160, 256: TMA.  One thread starts cp.async.bulk.tensor
//     loads of 64 rows x 64 columns (128 bytes a row) through 4-D tensor maps
//     over [B, S, H, d], written in the 128-byte swizzle wgmma reads.  The
//     head is a dimension of its own, so the columns a 64-wide box reads past
//     d lie outside the tensor and arrive as zeros: never the next head's
//     values.  cp.async could not keep enough bytes in flight per SM, which
//     made the producer the bottleneck at these widths (20 and 40 KB a tile).
//   - W = 8, 16, 40: cp.async by the 128 threads of the producer warpgroup
//     into wgmma's layout without swizzle (core matrices of 8 rows x 16
//     bytes, stored contiguously).  A row of 80 bytes does not fill a
//     128-byte swizzle span: a 64-column box would fetch 60 % more.  Only
//     the d / 8 chunks of the head are copied; the chunks from d / 8 to the
//     padded depth are zeroed once, before the ring starts, and no copy ever
//     writes them.  A warp's copy reads 64 contiguous bytes of each of 8
//     rows and writes 512 contiguous bytes; the producer orders its copies
//     before the async proxy (fence.proxy.async) before it signals "full",
//     and keeps two stages of slack so that no signal queues behind a wait
//     for a release.
// * One or two consumer warpgroups, each owning 64 query rows: two share
//   every K/V tile, halving the traffic from L2.  Inside a warpgroup the
//   Q K^T of tile j+1 and the P V of tile j are started together and the
//   softmax of tile j+1 runs under P(j) V(j), so the tensor cores work
//   during the exp pass; between warpgroups the hardware overlaps one's
//   softmax with the other's wgmma.
// * Softmax in the log2 domain with the scale folded in: the running max is
//   kept as m * scale * log2(e), and each probability is one FFMA and one
//   ex2.approx: p = 2^(s * c - m_c).
// * The caller picks the query rows per block (64, 128 or 256) from Sq and
//   B*H, so that the short shapes still spread over the card: [8,1024,80]
//   runs on 128 blocks of 64 rows, not 64 of 128.  The keys of one query tile
//   are not split over blocks: at the 4 key tiles of [8,256,160] a second
//   pass that merges partial results cost more than the idle SMs.
// * The shared-memory attribute of each template instance is set once per
//   device, not per launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockN = 64;      // keys per K/V tile
constexpr int kRowsPerWg = 64;   // q rows per consumer warpgroup (wgmma M)
constexpr int kMaxDevices = 16;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // strides in elements
  int heads, sq, sk, d;  // d: the head dim, a multiple of 8 up to the instance width
  float scale_log2;  // sm_scale * log2(e)
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- tiles

// Geometry of a 64-row tile of D bf16 columns in shared memory (D is the
// instance width: the head's d columns, then zeros), and the wgmma
// descriptors that read it.
//   kTma (D >= 64): panels of 64 columns, each 64 rows x 128 bytes in the
//     128-byte swizzle, as a TMA box lands.
//   else: no swizzle; 16-byte chunk c of row r lies at
//     (r / 8) * kGroup + c * 128 + (r % 8) * 16 bytes.
template <int D>
struct Tile {
  static constexpr bool kTma = D >= 64;
  static constexpr int kDP = (D + 15) / 16 * 16;  // depth padded to the wgmma k of 16
  static constexpr int kSteps = kDP / 16;         // k16 steps over the depth
  static constexpr int kMaxChunks = D / 8;        // 16-byte chunks of a row of width D
  static constexpr int kGroup = kDP / 8 * 128;    // no swizzle: bytes of 8 rows
  static constexpr int kPanels = (D + 63) / 64;   // swizzled: 64-column panels
  static constexpr int kPanelBytes = 64 * 128;
  static constexpr int kBytes = kTma ? kPanels * kPanelBytes : 8 * kGroup;  // 64 rows

  // K/V ring depth: what fits beside the Q tiles, at most 8
  static __host__ __device__ constexpr int stages(int nwg) {
    const int fit = (kSmemLimit - 2048 - nwg * kBytes) / (2 * kBytes);
    return fit > 8 ? 8 : fit;
  }

  // Q or K as a K-major operand, k16 step kd over the depth
  static __device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kd) {
    if constexpr (kTma)
      return wgmma::make_desc(base + (kd / 4) * kPanelBytes + (kd % 4) * 32, 16, 1024, 1);
    else
      return wgmma::make_desc(base + kd * 256, 128, kGroup);
  }
  // V as the MN-major B operand, k16 step kk over the keys: the reduction axis
  // runs over 8-key groups, N over the chunks (and panels) of D
  static __device__ __forceinline__ uint64_t v_desc(uint32_t base, int kk) {
    if constexpr (kTma)
      return wgmma::make_desc(base + kk * 2048, kPanelBytes, 1024, 1);
    else
      return wgmma::make_desc(base + kk * 2 * kGroup, kGroup, 128);
  }
};

// Starts cp.async copies of 64 rows x (8 * chunks) columns by one warpgroup
// into the layout without swizzle.  Thread t of its 128 takes row (t % 8) of
// the row groups t / 32 and t / 32 + 4, and in each the chunks (t / 8) % 4,
// + 4, ...: a warp's copy reads 64 contiguous bytes of each of 8 rows and
// writes 512 contiguous bytes, and after two row addresses per tile every
// copy differs from the last by constants only.
template <int D>
__device__ __forceinline__ void copy_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                long long row_stride, int t, int chunks) {
  using T = Tile<D>;
  const int r8 = t % 8;
  const int cq = (t / 8) % 4;
  const int rg = t / 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t d0 = dst + (rg + 4 * half) * T::kGroup + cq * 128 + r8 * 16;
    const __nv_bfloat16* s0 = src + (long long)((rg + 4 * half) * 8 + r8) * row_stride + cq * 8;
#pragma unroll
    for (int it = 0; it < (T::kMaxChunks + 3) / 4; ++it)
      if (cq + 4 * it < chunks) cp_async16(d0 + it * 512, s0 + it * 32);
  }
}

// Starts the TMA loads of one 64-row tile: a box of 64 columns per panel, of
// head `h` at row `row` of batch `b`.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int row, int b) {
#pragma unroll
  for (int pn = 0; pn < Tile<D>::kPanels; ++pn)
    tma_load_4d(dst + pn * Tile<D>::kPanelBytes, map, bar, pn * 64, h, row, b);
}

// Registers a consumer thread may hold under each number of consumer
// warpgroups (what setmaxnreg gives it below), and a plan's fit: the O
// accumulator (D / 2), the S tile (32) and bf16 P (16) beside 44 for
// addresses, statistics and loop state, and a K/V ring of three stages.
// videosd_tpu_torch/ops/cuda/flash_attention.py::row_plans mirrors it.
__host__ __device__ constexpr int consumer_regs(int nwg) {
  return nwg == 4 ? 112 : nwg == 2 ? 224 : 255;
}
template <int D, int NWG>
__host__ __device__ constexpr bool plan_fits() {
  return D / 2 + 48 + 44 <= consumer_regs(NWG) && Tile<D>::stages(NWG) >= 3;
}

// ---------------------------------------------------------------- the kernel

template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
    flash_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v) {
  using T = Tile<D>;
  constexpr int STAGES = T::stages(NWG);
  static_assert(STAGES >= 3, "the K/V ring needs three stages");
  constexpr int kConsumerWarps = NWG * 4;
  constexpr int kSRegs = kBlockN / 2;  // S accumulator floats per thread
  constexpr int kORegs = D / 2;        // O accumulator floats per thread

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];  // full[], empty[], Q

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // swizzle atoms are 1024 bytes: the tiles start at a multiple of that
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + NWG * T::kBytes;  // stage s: K at 2s, V at 2s+1 tiles
  const uint32_t full_bar = smem_u32(bars);
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const uint32_t q_bar = full_bar + 16 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int m0 = blockIdx.x * (NWG * kRowsPerWg);
  const int n_tiles = p.sk / kBlockN;
  const int chunks = p.d / 8;  // 16-byte chunks of a head's row

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // TMA: the thread that starts the loads arrives once and the bytes do the rest;
      // cp.async: every producer thread arrives when its copies have landed
      mbar_init(full_bar + 8 * s, T::kTma ? 1 : 128);
      mbar_init(empty_bar + 8 * s, kConsumerWarps);  // one lane per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!T::kTma) {
    // the chunks past the head, up to the padded depth, of Q and of every K
    // and V tile stay zero: no copy writes them
    constexpr int kTiles = NWG + 2 * STAGES;
    const int pad = T::kDP / 8 - chunks;
    for (int i = tid; i < kTiles * 64 * pad; i += (NWG + 1) * 128) {
      const int tile = i / (64 * pad), r = i / pad % 64, c = chunks + i % pad;
      const uint32_t dst = q_s + tile * T::kBytes + (r / 8) * T::kGroup + c * 128 + (r % 8) * 16;
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(0) : "memory");
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------------ producer
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if constexpr (NWG == 4) asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    const int ptid = tid - kConsumerWarps * 32;
    if constexpr (T::kTma) {
      if (ptid == 0) {
        mbar_arrive_expect_tx(q_bar, NWG * T::kBytes);
#pragma unroll
        for (int w = 0; w < NWG; ++w)
          tma_tile<D>(q_s + w * T::kBytes, &map_q, q_bar, h, m0 + w * kRowsPerWg, b);
        int stage = 0, use = 0;
        for (int t = 0; t < n_tiles; ++t) {
          if (use > 0) mbar_wait(empty_bar + 8 * stage, (use - 1) & 1);
          const uint32_t bar = full_bar + 8 * stage;
          const uint32_t dst = kv_s + stage * 2 * T::kBytes;
          const int key0 = t * kBlockN;
          mbar_arrive_expect_tx(bar, 2 * T::kBytes);
          tma_tile<D>(dst, &map_k, bar, h, key0, b);
          tma_tile<D>(dst + T::kBytes, &map_v, bar, h, key0, b);
          if (++stage == STAGES) {
            stage = 0;
            ++use;
          }
        }
      }
    } else {
      const __nv_bfloat16* kg = p.k + (long long)b * p.k_bs + (long long)h * p.d;
      const __nv_bfloat16* vg = p.v + (long long)b * p.v_bs + (long long)h * p.d;
      // Copy groups in flight.  Two stages of slack: a stage is refilled only
      // after its release, and with STAGES - 1 in flight every "full" signal
      // would queue behind the wait for a release, in lock-step with the
      // consumers.
      constexpr int kAhead = STAGES - 2;
      int stage = 0, use = 0;
      for (int t = 0; t < n_tiles; ++t) {
        // hand over the oldest tile in flight before blocking on a free stage:
        // the consumers release tile j only after they have seen tile j + 1
        if (t >= kAhead) {
          cp_async_wait<kAhead - 1>();  // tile t - kAhead has landed
          fence_proxy_async();
          mbar_arrive(full_bar + 8 * ((t - kAhead) % STAGES));
        }
        if (use > 0) mbar_wait(empty_bar + 8 * stage, (use - 1) & 1);
        const long long key0 = (long long)t * kBlockN;
        const uint32_t dst = kv_s + stage * 2 * T::kBytes;
        copy_tile_async<D>(dst, kg + key0 * p.k_rs, p.k_rs, ptid, chunks);
        copy_tile_async<D>(dst + T::kBytes, vg + key0 * p.v_rs, p.v_rs, ptid, chunks);
        cp_async_commit();
        if (++stage == STAGES) {
          stage = 0;
          ++use;
        }
      }
      cp_async_wait<0>();
      fence_proxy_async();
      for (int t = max(n_tiles - kAhead, 0); t < n_tiles; ++t)
        mbar_arrive(full_bar + 8 * (t % STAGES));
    }
  } else {
    // ------------------------------------------------------------ consumers
    // The warpgroups trade registers inside what the block was given at
    // launch, threads x the kernel's own count: 384 x 168 = 128 x (2 x 224 +
    // 56), and 640 x 96 = 128 x (4 x 112 + 32).  Asking for more than that
    // never returns.
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    if constexpr (NWG == 4) asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
    const int wg = warp / 4;
    const int g = lane / 4;   // accumulator row within the warp's 16 (and g + 8)
    const int tq = lane % 4;  // accumulator column pair within an 8-column tile
    const int row0 = m0 + wg * kRowsPerWg;

    const uint32_t my_q = q_s + wg * T::kBytes;
    if constexpr (T::kTma) {
      mbar_wait(q_bar, 0);
    } else {
      copy_tile_async<D>(
          my_q, p.q + (long long)b * p.q_bs + (long long)row0 * p.q_rs + (long long)h * p.d,
          p.q_rs, tid % 128, chunks);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
    }

    float acc[kORegs];
#pragma unroll
    for (int i = 0; i < kORegs; ++i) acc[i] = 0.f;
    float s[kSRegs];                // logits, then fp32 probabilities, of one tile
    uint32_t pa[kBlockN / 16][4];   // bf16(P) of the tile whose P V is next or in flight
    // running max in the log2 domain (m * scale * log2 e) and this thread's
    // partial row sum, for rows g and g + 8
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];

    auto start_qk = [&](int stage) {
      const uint32_t k_tile = kv_s + stage * 2 * T::kBytes;
      wgmma::pin(s);
      wgmma::fence();
#pragma unroll
      for (int kd = 0; kd < T::kSteps; ++kd)
        wgmma::ss_m64n64k16(s, T::kmajor_desc(my_q, kd), T::kmajor_desc(k_tile, kd), kd > 0);
      wgmma::commit();
    };
    auto start_pv = [&](int stage) {
      const uint32_t v_tile = kv_s + (stage * 2 + 1) * T::kBytes;
      wgmma::pin(acc);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma::Rs<D>::mma(acc, pa[kk], T::v_desc(v_tile, kk));
      wgmma::commit();
    };
    // Online softmax of the logits in s: leaves the fp32 probabilities in s,
    // updates m_run and l_run, and sets alpha, the factor the accumulator of
    // the earlier tiles still has to take.
    auto softmax = [&]() {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kSRegs; i += 4) {
        mx[0] = fmaxf(mx[0], fmaxf(s[i], s[i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[i + 2], s[i + 3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r] * p.scale_log2);  // scale > 0
        alpha[r] = ex2(m_run[r] - m_new);  // 2^-inf = 0 on the first tile
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kSRegs; i += 4) {
        s[i] = ex2(fmaf(s[i], p.scale_log2, -m_run[0]));
        s[i + 1] = ex2(fmaf(s[i + 1], p.scale_log2, -m_run[0]));
        s[i + 2] = ex2(fmaf(s[i + 2], p.scale_log2, -m_run[1]));
        s[i + 3] = ex2(fmaf(s[i + 3], p.scale_log2, -m_run[1]));
        l_run[0] += s[i] + s[i + 1];
        l_run[1] += s[i + 2] + s[i + 3];
      }
    };
    // bf16(P) as the A operand: accumulator tiles 2kk and 2kk+1 make k16 step kk
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    mbar_wait(full_bar, 0);
    start_qk(0);
    wgmma::wait<0>();
    wgmma::pin(s);
    softmax();  // acc is still 0: alpha is not applied
    pack_p();

    // Per tile j: the logits of tile j+1 and P(j) V(j) are started together;
    // the softmax of tile j+1 runs while the tensor cores do P(j) V(j).  The
    // last tile's P V is peeled off so that the loop body has no branch
    // around a wgmma (ptxas serializes the pipeline otherwise).
    int stage = 0, use = 0;
    for (int j = 0; j + 1 < n_tiles; ++j) {
      int nstage = stage + 1, nuse = use;
      if (nstage == STAGES) {
        nstage = 0;
        ++nuse;
      }
      mbar_wait(full_bar + 8 * nstage, nuse & 1);
      start_qk(nstage);
      start_pv(stage);
      wgmma::wait<1>();  // the logits are ready; P V may still run
      wgmma::pin(s);
      softmax();
      // the compiler may not sink the exp pass below the wait for P V
      wgmma::pin(s);
      wgmma::wait<0>();
      wgmma::pin(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * stage);  // this warp is done with the stage
#pragma unroll
      for (int i = 0; i < kORegs; i += 4) {
        acc[i] *= alpha[0];
        acc[i + 1] *= alpha[0];
        acc[i + 2] *= alpha[1];
        acc[i + 3] *= alpha[1];
      }
      pack_p();
      stage = nstage;
      use = nuse;
    }
    start_pv(stage);
    wgmma::wait<0>();
    wgmma::pin(acc);

    // finish the row sums across the 4 threads that share a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const int row = row0 + (warp % 4) * 16 + g;  // and row + 8
    const float inv0 = l_run[0] == 0.f ? 1.f : 1.f / l_run[0];
    const float inv1 = l_run[1] == 0.f ? 1.f : 1.f / l_run[1];
    __nv_bfloat16* og =
        p.o + (long long)b * p.o_bs + (long long)row * p.o_rs + (long long)h * p.d + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (n >= chunks) break;  // columns past d: zeros times P, never stored
      *reinterpret_cast<__nv_bfloat162*>(og + n * 8) =
          __floats2bfloat162_rn(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * p.o_rs + n * 8) =
          __floats2bfloat162_rn(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------- tensor maps

// A [batch, rows, heads, d] bf16 tensor with unit inner stride (heads of d
// columns side by side in each row), read in boxes of 64 rows x 64 columns
// of one head, written in the 128-byte swizzle; what a box reads outside the
// tensor, such as the columns past d, comes as zeros.
cudaError_t tile_map(const void* ptr, long long batch_stride, long long row_stride, int batch,
                     int rows, int heads, int d, CUtensorMap* out) {
  // a batch of one may carry any stride: give the map a valid one
  const long long bs = batch == 1 ? rows * row_stride : batch_stride;
  MapKey key{ptr, 4, {d, heads, rows, batch}, {d * 2ll, row_stride * 2, bs * 2}, {64, 1, 64, 1}};
  return tensor_map(key, out);
}

// ---------------------------------------------------------------- launch

template <int D, int NWG>
cudaError_t launch(const Params& p, int batch, int device, cudaStream_t stream) {
  using T = Tile<D>;
  // the tiles, and the slack to start them at a multiple of 1024 bytes
  constexpr size_t kSmem = (size_t)(NWG + 2 * T::stages(NWG)) * T::kBytes + 1024;
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, NWG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  CUtensorMap map_q{}, map_k{}, map_v{};
  if constexpr (T::kTma) {
    cudaError_t err = tile_map(p.q, p.q_bs, p.q_rs, batch, p.sq, p.heads, p.d, &map_q);
    if (err == cudaSuccess)
      err = tile_map(p.k, p.k_bs, p.k_rs, batch, p.sk, p.heads, p.d, &map_k);
    if (err == cudaSuccess)
      err = tile_map(p.v, p.v_bs, p.v_rs, batch, p.sk, p.heads, p.d, &map_v);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.sq / (NWG * kRowsPerWg), batch * p.heads);
  flash_fwd_kernel<D, NWG><<<grid, (NWG + 1) * 128, kSmem, stream>>>(p, map_q, map_k, map_v);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int batch, int block_m, int device, cudaStream_t stream) {
  if constexpr (plan_fits<D, 4>()) {  // D <= 40
    if (block_m == 256) return launch<D, 4>(p, batch, device, stream);
  }
  if constexpr (plan_fits<D, 2>()) {  // D <= 160
    if (block_m == 128) return launch<D, 2>(p, batch, device, stream);
  }
  static_assert(plan_fits<D, 1>(), "every instance runs 64 rows per block");
  if (block_m == 64) return launch<D, 1>(p, batch, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o: [batch, sq, heads*d]; k, v: [batch, sk, heads*d]; bf16 with unit inner
// stride, every row 16-byte aligned; d a multiple of 8 up to 256; `strides`
// holds the batch and row strides of q, k, v, o in elements.  block_m is 64,
// 128 (d <= 160) or 256 (d <= 40) query rows per block and divides sq.
// Returns a cudaError_t: 0 on a successful launch.
int videosd_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                int heads, int sq, int sk, int d, const long long* strides,
                                float sm_scale, int block_m, int device, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || device < 0 || device >= kMaxDevices ||
      block_m <= 0 || sq % block_m != 0 || sk % kBlockN != 0 || !(sm_scale > 0.f) || d <= 0 ||
      d % 8 != 0 || d > 256)
    return (int)cudaErrorInvalidValue;

  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_bs = strides[0], p.q_rs = strides[1];
  p.k_bs = strides[2], p.k_rs = strides[3];
  p.v_bs = strides[4], p.v_rs = strides[5];
  p.o_bs = strides[6], p.o_rs = strides[7];
  p.heads = heads, p.sq = sq, p.sk = sk, p.d = d;
  p.scale_log2 = sm_scale * 1.4426950408889634f;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instance of the next width >= d (flash_attention.py::instance_width)
  if (d <= 8) return (int)launch_d<8>(p, batch, block_m, device, s);
  if (d <= 16) return (int)launch_d<16>(p, batch, block_m, device, s);
  if (d <= 40) return (int)launch_d<40>(p, batch, block_m, device, s);
  if (d <= 64) return (int)launch_d<64>(p, batch, block_m, device, s);
  if (d <= 80) return (int)launch_d<80>(p, batch, block_m, device, s);
  if (d <= 160) return (int)launch_d<160>(p, batch, block_m, device, s);
  return (int)launch_d<256>(p, batch, block_m, device, s);
}

}  // extern "C"
