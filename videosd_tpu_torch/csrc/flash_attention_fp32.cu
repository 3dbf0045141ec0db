// Flash attention forward in fp32 for Hopper (sm_90a): softmax(q k^T * sm_scale) v.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/flash_attention.py::mha_flash
// (body `_kernel`) for fp32 inputs, which the JAX package sends it from an
// fp32 bundle (the kernel keeps the input dtype: p.astype(v.dtype) is fp32,
// so P V is an fp32 product).  flash_attention.cu is the bf16 kernel.
// Same numerics as that one otherwise: fp32 logits, fp32 running max, sum and
// accumulator (online softmax), P V on the unnormalized probabilities, and a
// guard that leaves a row with l == 0 unscaled.  The exponentials are
// ex2.approx in the log2 domain (p = 2^(s * scale * log2 e - m)), as in the
// bf16 kernel: a relative error of about 2^-22 per probability.
//
// Layout: heads in place.  q and o are [B, Sq, H*d], k and v [B, Sk, H*d],
// fp32, the last axis contiguous; batch and row strides are arguments.  d is
// a multiple of 4 up to 256 (rows of 16 bytes, as cp.async reads them; the
// wrapper zero-pads any other d in a folded copy), Sq and Sk multiples of 64.
//
// What bounds it on the H100: 4 Sq Sk d flops per head on the FFMA pipes
// (no TF32: a 10-bit mantissa would not hold fp32's bar), 67 TFLOP/s at
// 1.98 GHz, and one exponential per logit on the 16-a-clock exp unit; at the
// UNet's shapes far above the byte bound.  This is the simple kernel, right
// first:
//
// * A block of 256 threads owns 64 query rows of one head.  Thread (ty, tx),
//   ty = t / 16 and tx = t % 16, holds the logits of rows ty + 16 i and keys
//   tx + 16 j (i, j < 4) of each 64-key tile, and the output of the same rows
//   at the float4 columns tx + 16 c (c < NC, d <= 64 NC): the softmax
//   statistics of a row never leave the 16 lanes that share it.
// * Q, and one tile of K and V, sit in shared memory, filled by cp.async:
//   Q K^T reads a float4 of depth from 4 Q rows (two distinct rows a warp:
//   a broadcast) and 4 K rows (16 distinct rows a warp, at an odd stride in
//   16-byte units: no bank conflict), 64 FFMA per 8 loads.  Q stays in
//   shared memory, not registers: at d = 256 a thread's four rows would
//   take 1,024 registers.
// * P goes through shared memory (fp32) from the logit layout to the row
//   layout of P V; P V reads a float4 of P per row and a float4 of V per key
//   and column chunk.
// * One K and one V buffer: K of tile j + 1 loads while tile j's softmax and
//   P V run, V of tile j + 1 while the logits of j + 1 are formed.
// Shared memory: 64 rows each of Q and K at d + 4 floats, V at d, P at 68:
// 214 KB at d = 256, 50 KB at d = 40.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;   // query rows per block
constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kThreads = 256;
constexpr int kPStride = kKeys + 4;  // floats per row of P in shared memory
constexpr int kMaxDevices = 16;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // strides in elements
  int heads, sq, sk, d;
  float scale_log2;  // sm_scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory row stride, in float4, of Q and K: odd, so that 8 rows at the
// same column fall in 8 different groups of 4 banks.
__host__ __device__ constexpr int qk_stride4(int d4) { return d4 | 1; }

__host__ __device__ constexpr size_t smem_bytes(int d) {
  return (size_t)(2 * kRows * qk_stride4(d / 4) + kKeys * (d / 4)) * 16 +
         (size_t)kRows * kPStride * 4;
}

// Starts cp.async copies of 64 rows of d4 float4 from `src` (row stride `rs`
// floats) into `dst` (row stride `stride4` float4).
__device__ __forceinline__ void load_rows(float4* dst, int stride4, const float* src, long long rs,
                                          int d4) {
  for (int i = threadIdx.x; i < 64 * d4; i += kThreads) {
    const int r = i / d4, c = i % d4;
    cp_async16(dst + r * stride4 + c, src + (long long)r * rs + 4 * c);
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, NC == 1 ? 2 : 1)
    flash_fwd_fp32_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int d4 = p.d / 4;
  const int ks = qk_stride4(d4);
  float4* q_s = smem4;             // [64][ks]
  float4* k_s = q_s + kRows * ks;  // [64][ks]
  float4* v_s = k_s + kKeys * ks;  // [64][d4]
  float* p_s = reinterpret_cast<float*>(v_s + kKeys * d4);  // [64][kPStride]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int m0 = blockIdx.x * kRows;
  const float* kg = p.k + (long long)b * p.k_bs + (long long)h * p.d;
  const float* vg = p.v + (long long)b * p.v_bs + (long long)h * p.d;

  load_rows(q_s, ks, p.q + (long long)b * p.q_bs + (long long)m0 * p.q_rs + (long long)h * p.d,
            p.q_rs, d4);
  load_rows(k_s, ks, kg, p.k_rs, d4);
  cp_async_commit();  // Q and K of tile 0
  load_rows(v_s, d4, vg, p.v_rs, d4);
  cp_async_commit();  // V of tile 0

  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run[4], l_run[4];  // running max in the log2 domain; this thread's partial sum
#pragma unroll
  for (int i = 0; i < 4; ++i) m_run[i] = -INFINITY, l_run[i] = 0.f;

  const int n_tiles = p.sk / kKeys;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait1();  // K of tile j (and Q) have landed; V of tile j may not
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int c = 0; c < d4; ++c) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * ks + c];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = k_s[(tx + 16 * jj) * ks + c];
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
    __syncthreads();  // every thread is done with K of tile j
    if (j + 1 < n_tiles) load_rows(k_s, ks, kg + (long long)(j + 1) * kKeys * p.k_rs, p.k_rs, d4);
    cp_async_commit();  // (empty after the last tile: the group count stays in step)

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
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    cp_async_wait1();  // V of tile j has landed; K of tile j + 1 may not
    __syncthreads();   // and P is written
#pragma unroll 2
    for (int kk = 0; kk < kKeys; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPStride + kk);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col >= d4) break;
        const float4 v0 = v_s[(kk + 0) * d4 + col], v1 = v_s[(kk + 1) * d4 + col];
        const float4 v2 = v_s[(kk + 2) * d4 + col], v3 = v_s[(kk + 3) * d4 + col];
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
    __syncthreads();  // every thread is done with V of tile j and with P
    if (j + 1 < n_tiles) load_rows(v_s, d4, vg + (long long)(j + 1) * kKeys * p.v_rs, p.v_rs, d4);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const float inv = l == 0.f ? 1.f : 1.f / l;
    float* og = p.o + (long long)b * p.o_bs + (long long)(m0 + ty + 16 * i) * p.o_rs +
                (long long)h * p.d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col >= d4) break;
      const float4 a = acc[i][c];
      *reinterpret_cast<float4*>(og + 4 * col) =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    }
  }
}

template <int NC>
cudaError_t launch(const Params& p, int batch, int device, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_fp32_kernel<NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes(64 * NC));
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  const dim3 grid(p.sq / kRows, batch * p.heads);
  flash_fwd_fp32_kernel<NC><<<grid, kThreads, smem_bytes(p.d), stream>>>(p);
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
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || device < 0 || device >= kMaxDevices ||
      sq % kRows != 0 || sk % kKeys != 0 || !(sm_scale > 0.f) || d <= 0 || d % 4 != 0 ||
      d > 256)
    return (int)cudaErrorInvalidValue;
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
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // output float4 columns per thread: d <= 64 NC
  if (d <= 64) return (int)launch<1>(p, batch, device, s);
  if (d <= 128) return (int)launch<2>(p, batch, device, s);
  if (d <= 192) return (int)launch<3>(p, batch, device, s);
  return (int)launch<4>(p, batch, device, s);
}

}  // extern "C"
