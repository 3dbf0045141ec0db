// What the two backward kernel pairs of K1' share (flash_attention_bwd.cu in
// bf16, flash_attention_bwd_fp32.cu in fp32): cp.async copies of a head's
// rows into shared memory, ldmatrix and its fragment addresses, and the pass
// D = rowsum(dO o).
//
// Shared-memory tiles hold rows of SC 16-byte chunks, SC odd: the 8 rows an
// ldmatrix reads fall on 8 distinct bank groups.  Chunks past the head's d,
// up to the padded depth the products read, are zeroed once and no copy
// writes them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_bwd {

constexpr int kMaxDevices = 16;
constexpr float kLog2e = 1.4426950408889634f;

// q, o, dO: [B, Sq, H*d]; k, v: [B, Sk, H*d]; dq, dk, dv contiguous and
// shaped as q, k, v; lse and delta [B*H, Sq] fp32.
template <typename T>
struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;  // natural log
  float* delta;      // rowsum(dO o), written by the dQ kernel
  T* dq;
  T* dk;
  T* dv;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs;  // in elements
  int heads, sq, sk, d;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

// Fills BwdParams from the C entry's arguments (`strides`: the batch and row
// strides of q, k, v, o, dout); false on what no instance takes.
template <typename T>
inline bool make_params(BwdParams<T>& p, const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, int batch, int heads, int sq, int sk, int d,
                        const long long* strides, float sm_scale, int device) {
  constexpr int kAlign = 16 / sizeof(T);  // elements of a 16-byte chunk
  if (!(batch > 0 && heads > 0 && sq > 0 && sk > 0 && device >= 0 && device < kMaxDevices &&
        sq % 64 == 0 && sk % 64 == 0 && sm_scale > 0.f && d > 0 && d % kAlign == 0 &&
        d <= 256 && batch * heads <= 65535))
    return false;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.q_bs = strides[0], p.q_rs = strides[1];
  p.k_bs = strides[2], p.k_rs = strides[3];
  p.v_bs = strides[4], p.v_rs = strides[5];
  p.o_bs = strides[6], p.o_rs = strides[7];
  p.do_bs = strides[8], p.do_rs = strides[9];
  p.heads = heads, p.sq = sq, p.sk = sk, p.d = d;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return true;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Zeroes `chunks` 16-byte chunks from `dst`.
__device__ __forceinline__ void zero_chunks(uint32_t dst, int chunks, int tid, int threads) {
  for (int i = tid; i < chunks; i += threads)
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst + 16 * i), "r"(0)
                 : "memory");
}

// Starts cp.async copies of `rows` rows of one head (`chunks` 16-byte chunks
// each, from `src` at row stride `rs`) into rows of SC chunks at `dst`.  The
// thread's first (row, chunk) and its step come from one division each.
template <int SC, typename T>
__device__ __forceinline__ void copy_rows(uint32_t dst, const T* src, long long rs, int rows,
                                          int chunks, int tid, int threads) {
  int r = tid / chunks, c = tid - r * chunks;
  const int dr = threads / chunks, dc = threads - dr * chunks;
  for (; r < rows; r += dr, c += dc) {
    if (c >= chunks) c -= chunks, ++r;
    if (r >= rows) break;
    cp_async16(dst + (r * SC + c) * 16, src + r * rs + c * (16 / sizeof(T)));
  }
}

// ldmatrix byte offsets in a tile of rows of SC chunks, for lane `lane`; a
// k-step spans two chunks (16 bf16 or 8 fp32 values).  On 32-bit data an
// 8 x 8 b16 matrix is 8 rows of 4 floats and a thread receives float (g, t):
// the TF32 fragment layouts.
//   the A fragment of 16 rows from r0 at k-step kd ([m][k] storage)
template <int SC>
__device__ __forceinline__ uint32_t a_off(int r0, int kd, int lane) {
  return ((r0 + (lane & 15)) * SC + 2 * kd + (lane >> 4)) * 16;
}
//   the B fragments of n-tiles n0 / 8 and n0 / 8 + 1 at k-step kd ([n][k]
//   storage): x4 gives b0, b1 of the first, then of the second
template <int SC>
__device__ __forceinline__ uint32_t b_off(int n0, int kd, int lane) {
  return ((n0 + (lane & 7) + ((lane >> 4) << 3)) * SC + 2 * kd + ((lane >> 3) & 1)) * 16;
}

// D = rowsum(dO o) in fp32 of rows r .. r + 15 of a tile of one head (og
// and dog at the tile's first row, the head's first column): 8 lanes a row,
// 4 rows at a time.  Row i's sum goes to out_s[i] (shared memory) and
// out_g[i] (device memory).
template <typename T>
__device__ __forceinline__ void rowsum_do_o(const T* og, long long o_rs, const T* dog,
                                            long long do_rs, int r, int chunks, int lane,
                                            float* out_s, float* out_g) {
  constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte chunk
#pragma unroll
  for (int rr = 0; rr < 16; rr += 4) {
    const int row = r + rr + (lane >> 3);
    float acc = 0.f;
    for (int c = lane & 7; c < chunks; c += 8) {
      const uint4 ob = *reinterpret_cast<const uint4*>(og + row * o_rs + c * kPer);
      const uint4 db = *reinterpret_cast<const uint4*>(dog + row * do_rs + c * kPer);
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ob);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&db);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      } else {
        const float* of = reinterpret_cast<const float*>(&ob);
        const float* df = reinterpret_cast<const float*>(&db);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc = fmaf(of[i], df[i], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if ((lane & 7) == 0) {
      out_s[row] = acc;
      out_g[row] = acc;
    }
  }
}

}  // namespace flash_bwd
