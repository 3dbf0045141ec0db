// Flash attention forward for head dims above 256 on Hopper (sm_90a) in bf16:
// softmax(q k^T * sm_scale) v.
//
// Replaces the TPU kernel videosd_tpu/ops/pallas/flash_attention.py::mha_flash
// (body `_kernel`) at the head dims its wrapper takes above 256 (it pads d to
// a multiple of 128 and runs the same body).  The one caller in the repo is
// the KL VAE's mid attention (videosd_tpu/models/vae.py, one head of 512
// channels over the 64x64 latent of a 512x512 frame: [B, 4096, 512], in encode
// and in decode).  flash_attention.cu (bf16) and flash_attention_fp32.cu take
// d <= 256, flash_attention_wide_fp32.cu the fp32 heads above 256.  Same
// numerics as those: fp32 logits, fp32 running max, sum and accumulator
// (online softmax), P V on bf16 P (as the reference's p.astype(v.dtype)),
// ex2.approx in the log2 domain, and a row with l == 0 left unscaled.
//
// Layout: heads in place, as in flash_attention.cu.  q and o are [B, Sq, H*d],
// k and v [B, Sk, H*d], the last axis contiguous; batch and row strides are
// arguments.  Rows 16-byte aligned (d a multiple of 8; the wrapper zero-pads
// any other d in a folded copy), Sq and Sk multiples of 64, any d above 256.
//
// What bounds it on the H100: 4 Sq Sk d flops per head on the tensor cores:
// at [1, 4096, 512] 34 GFLOP, 35 us at 989 TFLOP/s, far above the 5 us of its
// 17 MB.  Why the d <= 256 design does not stretch: a resident 64 x 512 Q tile
// with one K and one V tile is 192 KB (no room for a ring).  So:
//
// * A block owns 64 query rows and one slice of at most 256 output columns:
//   grid (Sq / 64, ceil(d / 256), B * H).  Every slice forms the whole logit
//   tile S = Q K^T over the full depth, in panels of 64 columns, and keeps only
//   its own columns of O.  That reuses the d <= 256 register plan, takes any d
//   and doubles the blocks at d = 512 (one head at batch 1 gives 64 query
//   tiles, half the SMs), at the price of recomputing S once per slice: at
//   d = 512, 1.5x the logical products (2 x Q K^T + P V).
// * One consumer warpgroup (wgmma: S from two K-major swizzled panels, P V
//   with P from registers and V as the MN-major operand, one m64n64 per V
//   panel) and one producer warp that keeps TMA loads of 64 x 64 panels
//   (8 KB, the 128-byte swizzle) in flight through a ring of up to 27 slots
//   handed over by full/empty mbarriers.  Q stays resident in shared memory
//   (its panels loaded once) while it fits beside a ring of 8 slots (d up to
//   1216); a wider Q streams its panels through the ring beside K's.  The
//   product of one panel pair overlaps the wait for the next; the softmax and
//   the three phases of a key tile (S, softmax, P V) run in sequence: the
//   simple kernel, right first.
// * The shared-memory attribute is set once per device.

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

}  // extern "C"
