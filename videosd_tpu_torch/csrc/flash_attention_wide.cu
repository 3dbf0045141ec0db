// Flash attention forward for head dims above 256 on Hopper (sm_90a), in bf16
// and fp32: softmax(q k^T * sm_scale) v.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/flash_attention.py::mha_flash
// (body `_kernel`) at the head dims its wrapper takes above 256 (it pads d to
// a multiple of 128 and runs the same body).  The one caller in the repo is
// the KL VAE's mid attention (videosd_tpu/models/vae.py, one head of 512
// channels over the 64x64 latent of a 512x512 frame: [B, 4096, 512], in encode
// and in decode).  flash_attention.cu (bf16) and flash_attention_fp32.cu take
// d <= 256.  Same numerics as those: fp32 logits, fp32 running max, sum and
// accumulator (online softmax), P V on the unnormalized probabilities (bf16 P
// in the bf16 kernel, as the reference's p.astype(v.dtype)), ex2.approx in the
// log2 domain, and a row with l == 0 left unscaled.
//
// Layout: heads in place, as in flash_attention.cu.  q and o are [B, Sq, H*d],
// k and v [B, Sk, H*d], the last axis contiguous; batch and row strides are
// arguments.  Rows 16-byte aligned (d a multiple of 8 in bf16, of 4 in fp32;
// the wrapper zero-pads any other d in a folded copy), Sq and Sk multiples of
// 64, any d above 256.
//
// What bounds it on the H100: 4 Sq Sk d flops per head, on the tensor cores
// in bf16 and on the FFMA pipes in fp32 (no TF32): at [1, 4096, 512] 34 GFLOP,
// 35 us at 989 TFLOP/s bf16 and 0.51 ms in fp32, far above the 5 us of its
// 17 MB.  Why the d <= 256 designs do not stretch: an O accumulator of 64 rows
// x 512 fp32 columns is 256 registers a thread in one warpgroup (above the 255
// a thread may hold), and a resident 64 x 512 Q tile with one K and one V tile
// is 192 KB in bf16 (no room for a ring) and 384 KB in fp32.  So:
//
// * A block owns 64 query rows and one slice of at most 256 output columns:
//   grid (Sq / 64, ceil(d / 256), B * H).  Every slice forms the whole logit
//   tile S = Q K^T over the full depth, in panels of 64 columns, and keeps only
//   its own columns of O.  That reuses the d <= 256 register plan, takes any d
//   and doubles the blocks at d = 512 (one head at batch 1 gives 64 query
//   tiles, half the SMs), at the price of recomputing S once per slice: at
//   d = 512, 1.5x the logical products (2 x Q K^T + P V).
// * bf16: one consumer warpgroup (wgmma: S from two K-major swizzled panels,
//   P V with P from registers and V as the MN-major operand, one m64n64 per
//   V panel) and one producer warp that keeps TMA loads of 64 x 64 panels
//   (8 KB, the 128-byte swizzle) in flight through a ring of up to 27 slots
//   handed over by full/empty mbarriers.  Q stays resident in shared memory
//   (its panels loaded once) while it fits beside a ring of 8 slots (d up to
//   1216); a wider Q streams its panels through the ring beside K's.  The
//   product of one panel pair overlaps the wait for the next; the softmax and
//   the three phases of a key tile (S, softmax, P V) run in sequence: the
//   simple kernel, right first.
// * fp32: 256 threads, each holding the logits of 4 rows x 4 keys and the
//   output of the same 4 rows at 4 float4 columns (as flash_attention_fp32.cu
//   at d = 256); Q and K stream in depth chunks of 64 floats through a
//   double buffer filled by cp.async, the V slice of a key tile (64 keys x
//   256 floats, 64 KB) loads while the logits are formed, and P goes through
//   shared memory from the logit layout to the row layout of P V.
// * The shared-memory attribute of each kernel is set once per device.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 64;    // query rows per block
constexpr int kKeys = 64;    // keys per tile
constexpr int kSlice = 256;  // output columns per block
constexpr int kMaxDevices = 16;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ================================================================ bf16

constexpr int kPanelBytes = 64 * 128;  // 64 rows x 64 bf16 columns
constexpr int kMaxSlots = 27;          // panels of shared memory a block holds
constexpr int kMinRing = 8;            // ring slots kept when Q is resident
constexpr int kBf16Threads = 160;      // one consumer warpgroup, one producer warp
constexpr size_t kBf16Smem = (size_t)kMaxSlots * kPanelBytes + 1024;  // + alignment slack

struct Bf16Params {
  __nv_bfloat16* o;
  long long o_bs, o_rs;  // strides in elements
  int heads, sq, sk, d;
  int panels;  // ceil(d / 64): depth panels of Q K^T
  float scale_log2;  // sm_scale * log2(e)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A K-major operand at k16 step kd of a swizzled 64-column panel
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t panel, int kd) {
  return wgmma::make_desc(panel + kd * 32, 16, 1024, 1);
}
// V as the MN-major B operand, k16 step kk over the panel's 64 keys
__device__ __forceinline__ uint64_t v_desc(uint32_t panel, int kk) {
  return wgmma::make_desc(panel + kk * 2048, kPanelBytes, 1024, 1);
}

// The ring of panels: item n (in the order the producer issues them) lives in
// slot n % slots; its use u = n / slots of that slot completes phase u of the
// slot's full barrier, and its release phase u of the empty barrier.
struct Ring {
  uint32_t base, full, empty;
  int slots;
  __device__ __forceinline__ uint32_t slot(int n) const { return base + (n % slots) * kPanelBytes; }
  __device__ __forceinline__ uint32_t full_bar(int n) const { return full + 8 * (n % slots); }
  __device__ __forceinline__ uint32_t empty_bar(int n) const { return empty + 8 * (n % slots); }
  __device__ __forceinline__ uint32_t parity(int n) const { return (n / slots) & 1; }
};

__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_wide_fwd_kernel(const Bf16Params p, const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxSlots + 1];  // full[], empty[], Q

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kSlice;  // this block's first output column
  const int bh = blockIdx.z;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int n_tiles = p.sk / kKeys;
  const int np = p.panels;
  // V panels of this slice: those holding a column below d
  const int nv = min(kSlice / 64, (p.d - c0 + 63) / 64);
  const bool q_res = np + kMinRing <= kMaxSlots;  // Q resident beside the ring

  // swizzle atoms are 1024 bytes: the panels start at a multiple of that
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Ring ring;
  ring.base = q_res ? q_s + np * kPanelBytes : q_s;
  ring.slots = q_res ? kMaxSlots - np : kMaxSlots;
  ring.full = smem_u32(bars);
  ring.empty = ring.full + 8 * kMaxSlots;
  const uint32_t q_bar = ring.full + 16 * kMaxSlots;

  if (tid == 0) {
    for (int s = 0; s < ring.slots; ++s) {
      mbar_init(ring.full + 8 * s, 1);   // the producer's arrival and the bytes
      mbar_init(ring.empty + 8 * s, 4);  // one lane per consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      if (q_res) {
        mbar_arrive_expect_tx(q_bar, np * kPanelBytes);
        for (int pn = 0; pn < np; ++pn)
          tma_load_4d(q_s + pn * kPanelBytes, &map_q, q_bar, pn * 64, h, m0, b);
      }
      int n = 0;
      auto push = [&](const CUtensorMap* map, int col, int row) {
        if (n >= ring.slots) mbar_wait(ring.empty_bar(n), ring.parity(n) ^ 1);
        mbar_arrive_expect_tx(ring.full_bar(n), kPanelBytes);
        tma_load_4d(ring.slot(n), map, ring.full_bar(n), col, h, row, b);
        ++n;
      };
      for (int t = 0; t < n_tiles; ++t) {
        const int key0 = t * kKeys;
        for (int pn = 0; pn < np; ++pn) {
          if (!q_res) push(&map_q, pn * 64, m0);
          push(&map_k, pn * 64, key0);
        }
        for (int c = 0; c < nv; ++c) push(&map_v, c0 + c * 64, key0);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int g = lane / 4;   // accumulator row within the warp's 16 (and g + 8)
  const int tq = lane % 4;  // accumulator column pair within an 8-column tile

  float acc[kSlice / 64][32];  // O: one m64n64 accumulator per V panel
#pragma unroll
  for (int c = 0; c < kSlice / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float s[32];                 // logits, then fp32 probabilities, of one tile
  uint32_t pa[kKeys / 16][4];  // bf16(P) as wgmma's A operand
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in the log2 domain
  float l_run[2] = {0.f, 0.f};

  if (q_res) mbar_wait(q_bar, 0);
  int n = 0;  // ring items consumed
  auto release = [&](int item) {
    if (lane == 0) mbar_arrive(ring.empty_bar(item));
  };

  for (int t = 0; t < n_tiles; ++t) {
    // S = Q K^T over the depth, one panel pair at a time; the product of a
    // pair runs while the next pair's arrival is awaited
    int prev_q = -1, prev_k = -1;
    wgmma::pin(s);
    for (int pn = 0; pn < np; ++pn) {
      uint32_t qa = q_s + pn * kPanelBytes;
      int item_q = -1;
      if (!q_res) {
        item_q = n++;
        mbar_wait(ring.full_bar(item_q), ring.parity(item_q));
        qa = ring.slot(item_q);
      }
      const int item_k = n++;
      mbar_wait(ring.full_bar(item_k), ring.parity(item_k));
      const uint32_t ka = ring.slot(item_k);
      wgmma::fence();
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        wgmma::ss_m64n64k16(s, kmajor_desc(qa, kd), kmajor_desc(ka, kd), pn > 0 || kd > 0);
      wgmma::commit();
      if (pn > 0) {
        wgmma::wait<1>();  // the previous pair's product is done
        if (prev_q >= 0) release(prev_q);
        release(prev_k);
      }
      prev_q = item_q;
      prev_k = item_k;
    }
    wgmma::wait<0>();
    wgmma::pin(s);
    if (prev_q >= 0) release(prev_q);
    release(prev_k);

    // online softmax of rows g and g + 8 over this tile's 64 keys
    float alpha[2];
    {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
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
      for (int i = 0; i < 32; i += 4) {
        s[i] = ex2(fmaf(s[i], p.scale_log2, -m_run[0]));
        s[i + 1] = ex2(fmaf(s[i + 1], p.scale_log2, -m_run[0]));
        s[i + 2] = ex2(fmaf(s[i + 2], p.scale_log2, -m_run[1]));
        s[i + 3] = ex2(fmaf(s[i + 3], p.scale_log2, -m_run[1]));
        l_run[0] += s[i] + s[i + 1];
        l_run[1] += s[i + 2] + s[i + 3];
      }
    }
#pragma unroll
    for (int c = 0; c < kSlice / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        acc[c][i] *= alpha[0];
        acc[c][i + 1] *= alpha[0];
        acc[c][i + 2] *= alpha[1];
        acc[c][i + 3] *= alpha[1];
      }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O[:, slice] += P V[:, slice], one 64-column V panel at a time
    const int first_v = n;
#pragma unroll
    for (int c = 0; c < kSlice / 64; ++c) {
      if (c < nv) {
        const int item = n++;
        mbar_wait(ring.full_bar(item), ring.parity(item));
        const uint32_t va = ring.slot(item);
        wgmma::pin(acc[c]);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) wgmma::Rs<64>::mma(acc[c], pa[kk], v_desc(va, kk));
        wgmma::commit();
      }
    }
    wgmma::wait<0>();
#pragma unroll
    for (int c = 0; c < kSlice / 64; ++c) wgmma::pin(acc[c]);
    for (int item = first_v; item < n; ++item) release(item);
  }

  // finish the row sums across the 4 threads that share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = l_run[0] == 0.f ? 1.f : 1.f / l_run[0];
  const float inv1 = l_run[1] == 0.f ? 1.f : 1.f / l_run[1];
  const int row = m0 + warp * 16 + g;  // and row + 8
  __nv_bfloat16* og = p.o + (long long)b * p.o_bs + (long long)row * p.o_rs +
                      (long long)h * p.d + c0 + 2 * tq;
#pragma unroll
  for (int c = 0; c < kSlice / 64; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * 64 + 8 * j;  // d is a multiple of 8: a chunk is all in or all out
      if (c0 + col >= p.d) break;
      *reinterpret_cast<__nv_bfloat162*>(og + col) =
          __floats2bfloat162_rn(acc[c][4 * j] * inv0, acc[c][4 * j + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * p.o_rs + col) =
          __floats2bfloat162_rn(acc[c][4 * j + 2] * inv1, acc[c][4 * j + 3] * inv1);
    }
}

// A [batch, rows, heads, d] bf16 tensor read in boxes of 64 rows x 64 columns
// of one head, in the 128-byte swizzle; columns past d arrive as zeros (the
// same maps as flash_attention.cu's).
cudaError_t tile_map(const void* ptr, long long batch_stride, long long row_stride, int batch,
                     int rows, int heads, int d, CUtensorMap* out) {
  const long long bs = batch == 1 ? rows * row_stride : batch_stride;
  MapKey key{ptr, 4, {d, heads, rows, batch}, {d * 2ll, row_stride * 2, bs * 2}, {64, 1, 64, 1}};
  return tensor_map(key, out);
}

// ================================================================ fp32

constexpr int kF32Threads = 256;
constexpr int kChunk4 = 16;               // float4 of depth per chunk (64 floats)
constexpr int kChunkStride4 = kChunk4 | 1;  // odd row stride: no bank conflict
constexpr int kSlice4 = kSlice / 4;       // float4 of V and O per slice row
constexpr int kPStride = kKeys + 4;       // floats per row of P
// Q and K chunks (double buffer), the V slice, P
constexpr size_t kF32Smem = (size_t)2 * 2 * kRows * kChunkStride4 * 16 +
                            (size_t)kKeys * kSlice4 * 16 + (size_t)kRows * kPStride * 4;

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // strides in elements
  int heads, sq, sk, d;
  float scale_log2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts cp.async copies of 64 rows of w4 float4 from `src` (row stride `rs`
// floats) into `dst` (row stride `stride4` float4).
__device__ __forceinline__ void load_rows(float4* dst, int stride4, const float* src, long long rs,
                                          int w4) {
  for (int i = threadIdx.x; i < 64 * w4; i += kF32Threads) {
    const int r = i / w4, c = i % w4;
    cp_async16(dst + r * stride4 + c, src + (long long)r * rs + 4 * c);
  }
}

__global__ void __launch_bounds__(kF32Threads, 1) flash_wide_fwd_fp32_kernel(const F32Params p) {
  extern __shared__ float4 smem4[];
  float4* qk_s = smem4;  // [2 buffers][Q, K][64][kChunkStride4]
  float4* v_s = qk_s + 2 * 2 * kRows * kChunkStride4;  // [64][kSlice4]
  float* p_s = reinterpret_cast<float*>(v_s + kKeys * kSlice4);  // [64][kPStride]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kSlice;
  const int bh = blockIdx.z;
  const int b = bh / p.heads, h = bh % p.heads;
  const int d4 = p.d / 4;
  const int nc = (d4 + kChunk4 - 1) / kChunk4;  // depth chunks
  const int vw4 = min(kSlice4, d4 - c0 / 4);     // float4 columns of this slice below d
  const float* qg = p.q + (long long)b * p.q_bs + (long long)m0 * p.q_rs + (long long)h * p.d;
  const float* kg = p.k + (long long)b * p.k_bs + (long long)h * p.d;
  const float* vg = p.v + (long long)b * p.v_bs + (long long)h * p.d + c0;
  const int n_tiles = p.sk / kKeys;
  const int n_items = n_tiles * nc;  // (key tile, depth chunk) pairs

  // item n: chunk n % nc of Q and of key tile n / nc, into buffer n % 2
  auto issue = [&](int item) {
    const int t = item / nc, c = item % nc;
    const int w4 = min(kChunk4, d4 - c * kChunk4);
    float4* buf = qk_s + (item % 2) * 2 * kRows * kChunkStride4;
    load_rows(buf, kChunkStride4, qg + c * 64, p.q_rs, w4);
    load_rows(buf + kRows * kChunkStride4, kChunkStride4,
              kg + (long long)t * kKeys * p.k_rs + c * 64, p.k_rs, w4);
  };
  issue(0);
  cp_async_commit();

  float4 acc[4][kSlice4 / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kSlice4 / 16; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run[4], l_run[4];  // running max in the log2 domain; this thread's partial sum
#pragma unroll
  for (int i = 0; i < 4; ++i) m_run[i] = -INFINITY, l_run[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int item = t * nc + c;
      if (c == 0) {  // the V slice of this tile: v_s is free since the last P V
        load_rows(v_s, kSlice4, vg + (long long)t * kKeys * p.v_rs, p.v_rs, vw4);
        cp_async_commit();
      }
      if (item + 1 < n_items) issue(item + 1);
      cp_async_commit();  // (empty after the last item: the group count stays in step)
      // this item has landed; the next (and, at c == 0, the V slice) may not
      if (c == 0)
        cp_async_wait<2>();
      else
        cp_async_wait<1>();
      __syncthreads();
      const float4* q_c = qk_s + (item % 2) * 2 * kRows * kChunkStride4;
      const float4* k_c = q_c + kRows * kChunkStride4;
      const int w4 = min(kChunk4, d4 - c * kChunk4);
      for (int j = 0; j < w4; ++j) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q_c[(ty + 16 * i) * kChunkStride4 + j];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) kv[jj] = k_c[(tx + 16 * jj) * kChunkStride4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
          }
      }
      __syncthreads();  // every thread is done with this buffer before it is refilled
    }

    // online softmax of rows ty + 16 i over this tile's 64 keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx * p.scale_log2);  // scale > 0
      const float alpha = ex2(m_run[i] - m_new);               // 2^-inf = 0 on the first tile
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float e = ex2(fmaf(s[i][jj], p.scale_log2, -m_new));
        sum += e;
        p_s[(ty + 16 * i) * kPStride + tx + 16 * jj] = e;
      }
      l_run[i] = fmaf(l_run[i], alpha, sum);
#pragma unroll
      for (int c = 0; c < kSlice4 / 16; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    cp_async_wait<1>();  // the V slice has landed (only the next item may be in flight)
    __syncthreads();     // and P is written
#pragma unroll 2
    for (int kk = 0; kk < kKeys; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPStride + kk);
#pragma unroll
      for (int c = 0; c < kSlice4 / 16; ++c) {
        const int col = tx + 16 * c;
        if (col >= vw4) break;
        const float4 v0 = v_s[(kk + 0) * kSlice4 + col], v1 = v_s[(kk + 1) * kSlice4 + col];
        const float4 v2 = v_s[(kk + 2) * kSlice4 + col], v3 = v_s[(kk + 3) * kSlice4 + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4& a = acc[i][c];
          a.x = fmaf(pv[i].x, v0.x, a.x), a.y = fmaf(pv[i].x, v0.y, a.y);
          a.z = fmaf(pv[i].x, v0.z, a.z), a.w = fmaf(pv[i].x, v0.w, a.w);
          a.x = fmaf(pv[i].y, v1.x, a.x), a.y = fmaf(pv[i].y, v1.y, a.y);
          a.z = fmaf(pv[i].y, v1.z, a.z), a.w = fmaf(pv[i].y, v1.w, a.w);
          a.x = fmaf(pv[i].z, v2.x, a.x), a.y = fmaf(pv[i].z, v2.y, a.y);
          a.z = fmaf(pv[i].z, v2.z, a.z), a.w = fmaf(pv[i].z, v2.w, a.w);
          a.x = fmaf(pv[i].w, v3.x, a.x), a.y = fmaf(pv[i].w, v3.y, a.y);
          a.z = fmaf(pv[i].w, v3.z, a.z), a.w = fmaf(pv[i].w, v3.w, a.w);
        }
      }
    }
    __syncthreads();  // every thread is done with V and P of this tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const float inv = l == 0.f ? 1.f : 1.f / l;
    float* og = p.o + (long long)b * p.o_bs + (long long)(m0 + ty + 16 * i) * p.o_rs +
                (long long)h * p.d + c0;
#pragma unroll
    for (int c = 0; c < kSlice4 / 16; ++c) {
      const int col = tx + 16 * c;
      if (col >= vw4) break;
      const float4 a = acc[i][c];
      *reinterpret_cast<float4*>(og + 4 * col) =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    }
  }
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool (&configured)[kMaxDevices], int device) {
  if (configured[device]) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured[device] = true;
  return err;
}

bool valid(int batch, int heads, int sq, int sk, int d, float sm_scale, int device, int align) {
  return batch > 0 && heads > 0 && sq > 0 && sk > 0 && device >= 0 && device < kMaxDevices &&
         sq % kRows == 0 && sk % kKeys == 0 && sm_scale > 0.f && d > 256 && d % align == 0 &&
         batch * heads <= 65535;
}

}  // namespace

extern "C" {

// q, o: [batch, sq, heads*d]; k, v: [batch, sk, heads*d]; bf16 with unit inner
// stride, every row 16-byte aligned; d a multiple of 8 above 256; sq and sk
// multiples of 64; `strides` holds the batch and row strides of q, k, v, o in
// elements.  Returns a cudaError_t: 0 on a successful launch.
int videosd_flash_attention_wide_fwd(const void* q, const void* k, const void* v, void* o,
                                     int batch, int heads, int sq, int sk, int d,
                                     const long long* strides, float sm_scale, int device,
                                     void* stream) {
  if (!valid(batch, heads, sq, sk, d, sm_scale, device, 8)) return (int)cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = configure(flash_wide_fwd_kernel, kBf16Smem, configured, device);
  CUtensorMap map_q{}, map_k{}, map_v{};
  if (err == cudaSuccess) err = tile_map(q, strides[0], strides[1], batch, sq, heads, d, &map_q);
  if (err == cudaSuccess) err = tile_map(k, strides[2], strides[3], batch, sk, heads, d, &map_k);
  if (err == cudaSuccess) err = tile_map(v, strides[4], strides[5], batch, sk, heads, d, &map_v);
  if (err != cudaSuccess) return (int)err;
  Bf16Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_bs = strides[6], p.o_rs = strides[7];
  p.heads = heads, p.sq = sq, p.sk = sk, p.d = d;
  p.panels = (d + 63) / 64;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  const dim3 grid(sq / kRows, (d + kSlice - 1) / kSlice, batch * heads);
  flash_wide_fwd_kernel<<<grid, kBf16Threads, kBf16Smem, static_cast<cudaStream_t>(stream)>>>(
      p, map_q, map_k, map_v);
  return (int)cudaGetLastError();
}

// The same in fp32: d a multiple of 4 above 256.
int videosd_flash_attention_wide_fp32_fwd(const void* q, const void* k, const void* v, void* o,
                                          int batch, int heads, int sq, int sk, int d,
                                          const long long* strides, float sm_scale, int device,
                                          void* stream) {
  if (!valid(batch, heads, sq, sk, d, sm_scale, device, 4)) return (int)cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = configure(flash_wide_fwd_fp32_kernel, kF32Smem, configured, device);
  if (err != cudaSuccess) return (int)err;
  F32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.q_bs = strides[0], p.q_rs = strides[1];
  p.k_bs = strides[2], p.k_rs = strides[3];
  p.v_bs = strides[4], p.v_rs = strides[5];
  p.o_bs = strides[6], p.o_rs = strides[7];
  p.heads = heads, p.sq = sq, p.sk = sk, p.d = d;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  const dim3 grid(sq / kRows, (d + kSlice - 1) / kSlice, batch * heads);
  flash_wide_fwd_fp32_kernel<<<grid, kF32Threads, kF32Smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
