// Flash attention forward for Hopper (sm_90a): softmax(q k^T * sm_scale) v.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/flash_attention.py::mha_flash
// (body `_kernel`), which the UNet and ControlNet self-attention reach through
// videosd_tpu/models/layers.py::attention.  Same numerics: fp32 logits, fp32
// running max / sum / accumulator (online softmax), the probabilities rounded
// to bf16 before P.V (the reference's `p.astype(v.dtype)`), and a guard that
// leaves a row with l == 0 unscaled.
//
// Layout: q [BH, Sq, D], k and v [BH, Sk, D], o [BH, Sq, D], bf16, contiguous,
// D in {40, 64, 80, 160}.  D is NOT padded to 128 in memory as the TPU wrapper
// does (that is a lane constraint of the TPU and would triple the work at
// d_head 40); it is padded to the tensor-core depth of 16 only inside shared
// memory, with zeros.
//
// Work split: one block of 4 warps owns one (bh, 64-row q tile); each warp owns
// 16 q rows.  A loop inside the block walks over 64-key K/V tiles staged in
// shared memory; it takes the place of the TPU grid's sequential kv axis.
// Both products run on the tensor cores as mma.sync m16n8k16 bf16 -> fp32:
// S = Q K^T from shared memory, then P V with P taken straight from the S
// accumulator registers (the C fragment of two 8-key tiles is the A fragment
// of one 16-key step).
//
// What bounds it on the H100: at the UNet's shapes (S = 4096/1024/256,
// d_head 40/80/160, 8 heads) the work is 4 S^2 d flops per head against
// 4 S d bytes of q/k/v/o, so it is far above the ridge point and bound by
// tensor-core throughput and by the exp() and shuffle work of the softmax.  This
// first version is simple: no cp.async/TMA pipelining of the K/V tiles, no
// wgmma, no warp specialisation; those are later work.  d = 160 needs more
// than 48 KB of shared memory, so the launcher raises the dynamic limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;  // q rows per block
constexpr int kBlockN = 64;           // keys per K/V tile

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Copy `rows` x D bf16 from global (row stride D) into shared (row stride LDS).
template <int D, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows) {
  constexpr int kVecs = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDS + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int sq, int sk, float scale_log2) {
  constexpr int DP = (D + 15) / 16 * 16;  // depth padded to the mma k of 16
  constexpr int LDS = DP + 8;             // +16 bytes per row: no bank conflicts
  constexpr int KD = DP / 16;             // k-steps of S = Q K^T
  constexpr int ND = D / 8;               // 8-wide output column tiles
  constexpr int NN = kBlockN / 8;         // 8-key tiles of S

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBlockM * LDS;
  __nv_bfloat16* v_s = k_s + kBlockN * LDS;

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group

  const __nv_bfloat16* qg = q + ((size_t)bh * sq + m0) * D;
  const __nv_bfloat16* kg = k + (size_t)bh * sk * D;
  const __nv_bfloat16* vg = v + (size_t)bh * sk * D;

  // zero all of shared memory once: the padded columns D..DP stay zero
  {
    constexpr int kWords = (kBlockM + 2 * kBlockN) * LDS / 2;
    uint32_t* w = reinterpret_cast<uint32_t*>(smem_raw);
    for (int i = threadIdx.x; i < kWords; i += kThreads) w[i] = 0u;
  }
  __syncthreads();
  load_tile<D, LDS>(q_s, qg, kBlockM);
  __syncthreads();

  // this warp's Q rows as A fragments, kept in registers for the whole loop
  uint32_t qa[KD][4];
  {
    const __nv_bfloat16* qr = q_s + (warp * 16) * LDS;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = kd * 16 + 2 * t;
      qa[kd][0] = *reinterpret_cast<const uint32_t*>(qr + g * LDS + c);
      qa[kd][1] = *reinterpret_cast<const uint32_t*>(qr + (g + 8) * LDS + c);
      qa[kd][2] = *reinterpret_cast<const uint32_t*>(qr + g * LDS + c + 8);
      qa[kd][3] = *reinterpret_cast<const uint32_t*>(qr + (g + 8) * LDS + c + 8);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (log2 domain) and this thread's partial row sum, rows g, g+8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < sk; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, LDS>(k_s, kg + (size_t)n0 * D, kBlockN);
    load_tile<D, LDS>(v_s, vg + (size_t)n0 * D, kBlockN);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys, fp32
    float s[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (j * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kd * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kd * 16 + 8);
        mma_bf16_16816(s[j], qa[kd], b0, b1);
      }
    }

    // online softmax in the log2 domain: exp(x*scale) == exp2(x*scale*log2 e)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);  // exp2(-inf) = 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      s[j][0] = exp2f(s[j][0] - m_run[0]);
      s[j][1] = exp2f(s[j][1] - m_run[0]);
      s[j][2] = exp2f(s[j][2] - m_run[1]);
      s[j][3] = exp2f(s[j][3] - m_run[1]);
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += bf16(P) V, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = v_s + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        const uint32_t b0 = pack_raw(vc[0], vc[LDS]);
        const uint32_t b1 = pack_raw(vc[8 * LDS], vc[9 * LDS]);
        mma_bf16_16816(acc[n], pa, b0, b1);
      }
    }
  }

  // finish the row sums across the 4 threads that share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = l_run[0] == 0.f ? 1.f : 1.f / l_run[0];
  const float inv1 = l_run[1] == 0.f ? 1.f : 1.f / l_run[1];

  __nv_bfloat16* og = o + ((size_t)bh * sq + m0 + warp * 16) * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(og + (size_t)g * D + c) =
        __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(og + (size_t)(g + 8) * D + c) =
        __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                   int sk, float sm_scale, cudaStream_t stream) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LDS = DP + 8;
  constexpr size_t kSmem = (size_t)(kBlockM + 2 * kBlockN) * LDS * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(sq / kBlockM, bh);
  const float log2e = 1.4426950408889634f;
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk,
      sm_scale * log2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Row tiles of the kernel: the caller guarantees sq % 64 == 0 and sk % 64 == 0.
int videosd_flash_block_m() { return kBlockM; }
int videosd_flash_block_n() { return kBlockN; }

// Returns a cudaError_t: 0 on a successful launch.
int videosd_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                                int sq, int sk, int d, float sm_scale, void* stream) {
  if (sq % kBlockM != 0 || sk % kBlockN != 0 || bh <= 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return (int)launch<40>(q, k, v, o, bh, sq, sk, sm_scale, s);
    case 64: return (int)launch<64>(q, k, v, o, bh, sq, sk, sm_scale, s);
    case 80: return (int)launch<80>(q, k, v, o, bh, sq, sk, sm_scale, s);
    case 160: return (int)launch<160>(q, k, v, o, bh, sq, sk, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
