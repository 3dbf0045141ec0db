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
// 17 MB.  A block's registers hold 64 rows x 256 columns of fp32 O, so a
// query tile's d = 512 columns take two blocks; formed in each of them, the
// logits would cost 1.5x the products, and every K/V tile would reach each
// block's shared memory whole.  So the blocks of a query tile share that
// work in a thread-block cluster:
//
// * A block owns 64 query rows and one slice of at most 256 output columns;
//   the grid is (Sq / 64, slices, B * H), the slices of a query tile (2 at
//   d = 512) form the cluster (at most 8 a cluster: above d = 2048 the
//   slices split into several clusters, each forming the logits alone,
//   padded with blocks that own no columns).  The cluster's blocks split the
//   depth of S = Q K^T: each loads only its share of Q's and K's 64-column
//   panels (4 at d = 512) and forms a 64 x 64 fp32 partial of S; the
//   partials meet in distributed shared memory, and every block adds them in
//   the same order (own + peer for a pair: fp32 addition commutes; rank
//   order for more), so all hold the same logits bit for bit, hence the same
//   max, sum and P, and each runs P V on its own V columns.  The logits are
//   formed once per query tile, and a block reads 64 KB of panels per key
//   tile, not 96.
// * A pair pushes its partials into each other's shared memory (st.async,
//   counted in bytes on the receiver's mbarrier, two buffers alternating by
//   key tile: a block pushes into a buffer again only after the peer's next
//   partial arrived, which the peer sends after reading this one).  More
//   blocks leave their partial in their own buffer, announce it with one
//   arrival on each peer's mbarrier (release at cluster scope) and read the
//   others' (the same alternation).
// * Two consumer warpgroups, each with half the block's depth panels and
//   half its columns (O 64 x 128: 64 registers, which leaves room for two
//   logit tiles), so the tensor cores hold two independent chains; their
//   partials are added through shared memory (the same bits in both) before
//   the cluster's exchange.  In each key tile j a warpgroup issues S(j+1),
//   finishes tile j's logits and runs its softmax while S(j+1) is on the
//   tensor cores, then issues P(j) V(j) (one m64n128 product per 16 keys, P
//   from registers, V as the MN-major operand) and hands S(j+1) to the
//   cluster while P(j) V(j) runs.
// * A producer warpgroup (one thread busy; setmaxnreg gives its registers to
//   the consumers) keeps TMA loads of 64 x 64 panels (8 KB, the 128-byte
//   swizzle) in flight through a ring of 32 KB slots, a slot per group of up
//   to 4 panels (one mbarrier handshake per group, not per panel), handed
//   over by full/empty mbarriers.  The ring holds tile j+1's K panels
//   before tile j's V panels, the order the consumers take them in.  Q's
//   share stays resident while it fits beside a ring of 3 slots; a wider
//   share streams through the ring beside K's.
// * Launched with cudaLaunchKernelExC and the cluster's shape as an
//   attribute; a block waits for its peers before it exits, since they
//   write its shared memory and arrive on its barriers until their end.
// * Not done: two neighbouring query tiles in one cluster, each K/V group
//   loaded once by TMA multicast into both.  It halves the bytes from L2,
//   but on the H100 only 30 clusters of 4 blocks are resident at once (120
//   blocks; [1, 4096, 512] has 128), and the lockstep of four blocks cost
//   more than the bytes saved: 2.1x slower at [1, 4096, 512] (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 64;    // query rows per block
constexpr int kKeys = 64;    // keys per tile
constexpr int kSlice = 256;  // output columns per block
constexpr int kHalf = kSlice / 2;  // output columns per consumer warpgroup
constexpr int kMaxDevices = 16;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kPanelBytes = 64 * 128;          // 64 rows x 64 bf16 columns
constexpr int kGroup = 4;                      // panels of a ring item (one slot)
constexpr int kSlotBytes = kGroup * kPanelBytes;
static_assert(kGroup * 64 >= 256, "a slot holds a slice's V panels");
constexpr int kPartBytes = kRows * kKeys * 4;  // one fp32 64 x 64 tile of S
constexpr int kPanels = 20;     // panels a block holds: Q's resident share and the ring
constexpr int kMinSlots = 3;    // ring slots kept when Q's share is resident
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kConsumers = 2;  // warpgroups, each half the depth share and half the columns
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup (one thread busy)
// the block's partial of S from each warpgroup, and the cluster's exchange
// buffers (two, alternating by tile), beside Q's share and the ring
constexpr size_t kSmem = 1024 + (size_t)(kConsumers + 2) * kPartBytes +
                         (size_t)kPanels * kPanelBytes;

// The launch's shape, mirrored by ops/cuda/flash_attention.py::wide_plan.
struct Plan {
  int cs;       // slice blocks a cluster spans
  int grid_y;   // slice blocks per query tile, a multiple of cs (those past d own no columns)
  int share;    // the most depth panels of Q K^T a block forms
  int q_res;    // Q's share resident (else streamed through the ring)
  int slots;    // ring slots of kGroup panels
};

Plan make_plan(int d) {
  Plan pl;
  const int slices = (d + kSlice - 1) / kSlice;
  const int clusters = (slices + kMaxCluster - 1) / kMaxCluster;
  pl.cs = (slices + clusters - 1) / clusters;
  pl.grid_y = clusters * pl.cs;
  pl.share = ((d + 63) / 64 + pl.cs - 1) / pl.cs;
  pl.q_res = pl.share + kGroup * kMinSlots <= kPanels;
  pl.slots = (pl.q_res ? kPanels - pl.share : kPanels) / kGroup;
  return pl;
}

struct Params {
  __nv_bfloat16* o;
  long long o_bs, o_rs;  // strides in elements
  int heads, sq, sk, d;
  int panels;        // ceil(d / 64): depth panels of Q K^T
  float scale_log2;  // sm_scale * log2(e)
  Plan plan;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A K-major operand at k16 step kd of a swizzled 64-column panel
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t panel, int kd) {
  return wgmma::make_desc(panel + kd * 32, 16, 1024, 1);
}
// V as the MN-major B operand, k16 step kk over the panel's 64 keys (N may
// run on over the next panels)
__device__ __forceinline__ uint64_t v_desc(uint32_t panel, int kk) {
  return wgmma::make_desc(panel + kk * 2048, kPanelBytes, 1024, 1);
}

// The ring of items, each up to kGroup panels: item n (in the order the
// producer issues them) lives in slot n % slots; its use u = n / slots of that
// slot completes phase u of the slot's full barrier, and its release phase u
// of the empty barrier.
struct Ring {
  uint32_t base, full, empty;
  int slots;
  __device__ __forceinline__ uint32_t slot(int n) const { return base + (n % slots) * kSlotBytes; }
  __device__ __forceinline__ uint32_t full_bar(int n) const { return full + 8 * (n % slots); }
  __device__ __forceinline__ uint32_t empty_bar(int n) const { return empty + 8 * (n % slots); }
  __device__ __forceinline__ uint32_t parity(int n) const { return (n / slots) & 1; }
};

// kEven: every block of the launch has 4 depth panels and 4 V panels (d a
// multiple of 256 in one cluster), so each warpgroup takes 2 of each and
// nothing it issues a wgmma under depends on the thread: ptxas serializes
// every wgmma of a kernel that branches on the thread around one.
template <bool kEven>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kMaxSlots = kPanels / kGroup;
  __shared__ __align__(8) uint64_t bars[2 * kMaxSlots + 3];  // full[], empty[], Q, ready[2]

  const Plan pl = p.plan;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cy = blockIdx.y % pl.cs;  // the block's rank in its cluster, which spans y alone
  const int m0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kSlice;  // this block's first output column
  const int bh = blockIdx.z;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int n_tiles = p.sk / kKeys;
  const int p0 = cy * p.panels / pl.cs;  // this block's share of the depth panels
  const int sp = (cy + 1) * p.panels / pl.cs - p0;
  // V panels of this slice: those holding a column below d
  const int nv = c0 < p.d ? min(kSlice / 64, (p.d - c0 + 63) / 64) : 0;
  const int groups = (sp + kGroup - 1) / kGroup;  // K items per tile (and Q's, streamed)
  const int per = pl.q_res ? 1 : 2;               // ring items per group of S
  // S's items are released all at once after the product where the ring
  // holds a tile's S and P V items together, else one by one
  const bool whole = kEven || per * groups + 1 <= pl.slots;

  // swizzle atoms are 1024 bytes: the panels start at a multiple of that
  const uint32_t xbuf = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the cluster's exchange, x2
  const uint32_t part = xbuf + 2 * kPartBytes;                   // each warpgroup's partial
  const uint32_t q_s = part + kConsumers * kPartBytes;
  Ring ring;
  ring.base = pl.q_res ? q_s + pl.share * kPanelBytes : q_s;
  ring.slots = pl.slots;
  ring.full = smem_u32(bars);
  ring.empty = ring.full + 8 * kMaxSlots;
  const uint32_t q_bar = ring.full + 16 * kMaxSlots;
  const uint32_t ready = q_bar + 8;  // ready[i]: the peers' partials of S in buffer i are there

  if (tid == 0) {
    for (int s = 0; s < ring.slots; ++s) {
      mbar_init(ring.full + 8 * s, 1);  // this block's producer and the bytes
      mbar_init(ring.empty + 8 * s, 4 * kConsumers);  // one lane per consumer warp
    }
    mbar_init(q_bar, 1);
    // a pair's peer pushes its partial and counts the bytes; more peers
    // arrive once each when theirs is in their own buffer
    mbar_init(ready, pl.cs == 2 ? 1 : pl.cs - 1);
    mbar_init(ready + 8, pl.cs == 2 ? 1 : pl.cs - 1);
    mbar_init_fence();
  }
  cluster_sync();  // no block signals a peer's barrier before the peer set it up

  if (warp >= 4 * kConsumers) {
    // ------------------------------------------------------------ producer
    // The warpgroups trade registers inside what the block was given at
    // launch, threads x the kernel's own count: 384 x 168 = 128 x (2 x 224 +
    // 56).  Asking for more than that never returns.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (tid == 128 * kConsumers) {
      // panels [first, first + count) of one 64-row tile of q, k or v into the
      // shared memory at dst, counted on bar
      auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar, int first, int count,
                      int row) {
        for (int j = 0; j < count; ++j)
          tma_load_4d(dst + j * kPanelBytes, map, bar, (first + j) * 64, h, row, b);
      };
      if (pl.q_res) {
        mbar_arrive_expect_tx(q_bar, sp * kPanelBytes);
        load(&map_q, q_s, q_bar, p0, sp, m0);
      }
      int n = 0;
      auto push = [&](const CUtensorMap* map, int first, int count, int row) {
        if (n >= ring.slots) mbar_wait(ring.empty_bar(n), ring.parity(n) ^ 1);
        mbar_arrive_expect_tx(ring.full_bar(n), count * kPanelBytes);
        load(map, ring.slot(n), ring.full_bar(n), first, count, row);
        ++n;
      };
      // tile u's K groups, then tile u-1's V panels: the order they are consumed in
      for (int u = 0; u <= n_tiles; ++u) {
        if (u < n_tiles)
          for (int i = 0; i < groups; ++i) {
            const int first = p0 + i * kGroup, count = min(kGroup, sp - i * kGroup);
            if (!pl.q_res) push(&map_q, first, count, m0);
            push(&map_k, first, count, u * kKeys);
          }
        if (u > 0 && nv > 0) push(&map_v, c0 / 64, nv, (u - 1) * kKeys);
      }
    }
    __syncwarp();
  } else {
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = tid / 128;   // this warpgroup: its half of the depth share and of the columns
  const int wt = tid % 128;   // thread within it
  const int g = lane / 4;     // accumulator row within the warp's 16 (and g + 8)
  const int tq = lane % 4;    // accumulator column pair within an 8-column tile
  const int d0 = wg * sp / kConsumers, d1 = (wg + 1) * sp / kConsumers;  // its depth panels
  const int nw = kEven ? 2 : min(max(nv - 2 * wg, 0), 2);  // its V panels (64 columns each)

  float acc[2][32];           // O: this warpgroup's 128 columns, two m64n64 accumulators
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float sa[32], sb[32];       // logits of two tiles: one in softmax, the next in the making
  uint32_t pa[kKeys / 16][4];  // bf16(P) as wgmma's A operand
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in the log2 domain
  float l_run[2] = {0.f, 0.f};
  float alpha[2] = {0.f, 0.f};

  if (pl.q_res) mbar_wait(q_bar, 0);
  int n = 0;  // ring items consumed
  auto release = [&](int item) {
    if (lane == 0) mbar_arrive(ring.empty_bar(item));
  };

  // This warpgroup's partial of S = Q K^T over its depth panels, issued into
  // s; returns the first ring item not yet released (items are released one
  // by one unless `whole`).
  auto issue_qk = [&](float(&s)[32]) -> int {
    int kept = n;
    wgmma::pin(s);
    for (int i = 0; i < groups; ++i) {
      const int lo = max(d0, i * kGroup), hi = min(d1, (i + 1) * kGroup);
      uint32_t qa = q_s + i * kSlotBytes;
      if (!kEven && !pl.q_res) {
        const int item_q = n++;
        mbar_wait(ring.full_bar(item_q), ring.parity(item_q));
        qa = ring.slot(item_q);
      }
      const int item_k = n++;
      mbar_wait(ring.full_bar(item_k), ring.parity(item_k));
      const uint32_t ka = ring.slot(item_k);
      wgmma::fence();
      for (int jj = 0; jj < (kEven ? 2 : hi - lo); ++jj) {
        const int j = lo + jj;
        const uint32_t off = (j - i * kGroup) * kPanelBytes;
#pragma unroll
        for (int kd = 0; kd < 4; ++kd)
          wgmma::ss_m64n64k16(s, kmajor_desc(qa + off, kd), kmajor_desc(ka + off, kd),
                              j > d0 || kd > 0);
      }
      wgmma::commit();
      if (!whole && i > 0) {
        // the previous group's product is done (an empty group may not count)
        if (lo < hi)
          wgmma::wait<1>();
        else
          wgmma::wait<0>();
        for (; kept < n - per; ++kept) release(kept);
      }
    }
    return kept;
  };

  // The block's partial of tile t's S (the warpgroups' added in s, the same
  // bits in both) handed to the cluster's other blocks.
  auto combine = [&](float(&s)[32], int t) {
    const uint32_t mine = part + wg * kPartBytes + wt * 16;
    const uint32_t other = part + (1 - wg) * kPartBytes + wt * 16;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      st_shared_v4(mine + q * 2048, s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    named_barrier_sync(1, 128 * kConsumers);
#pragma unroll
    for (int q = 0; q < 8; ++q) {  // fp32 addition commutes: both get the same sums
      const float4 v = ld_shared_v4(other + q * 2048);
      s[4 * q] += v.x, s[4 * q + 1] += v.y, s[4 * q + 2] += v.z, s[4 * q + 3] += v.w;
    }
    named_barrier_sync(2, 128 * kConsumers);  // both read: the buffers may be written again
    if (pl.cs == 1) return;
    const uint32_t buf = xbuf + (t & 1) * kPartBytes + wt * 16;
    const uint32_t bar = ready + 8 * (t & 1);
    if (pl.cs == 2) {
      // push into the peer's buffer, counted on its barrier: half by each warpgroup
      const uint32_t peer = 1 - cy;
      const uint32_t dst = mapa(buf, peer), dst_bar = mapa(bar, peer);
      if (tid == 0) mbar_arrive_expect_tx(bar, kPartBytes);
#pragma unroll
      for (int q = 0; q < 8; ++q)  // (q static: s stays in registers)
        if (q / 4 == wg)
          st_async_v4(dst + q * 2048, s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3],
                      dst_bar);
      return;
    }
    // more peers: the partial stays in this block's buffer, announced to the
    // peers, which read it; a block announces its next partial only after
    // reading this one, so a buffer is written again only after every peer
    // read it
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q / 4 == wg)
        st_shared_v4(buf + q * 2048, s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    named_barrier_sync(1, 128 * kConsumers);
    if (tid == 0) {
      fence_acq_rel_cluster();
      for (int y = 0; y < pl.cs; ++y)
        if (y != cy) mbar_arrive_cluster(mapa(bar, y));
    }
  };

  // S of tile t = the cluster's partials added in rank order in every block
  // (own + peer for a pair): the same logits bit for bit in each.
  auto finish = [&](float(&s)[32], int t) {
    if (pl.cs == 1) return;
    const uint32_t buf = xbuf + (t & 1) * kPartBytes + wt * 16;
    mbar_wait_cluster(ready + 8 * (t & 1), (t >> 1) & 1);
    if (pl.cs == 2) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = ld_shared_v4(buf + q * 2048);
        s[4 * q] += v.x, s[4 * q + 1] += v.y, s[4 * q + 2] += v.z, s[4 * q + 3] += v.w;
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint32_t off = buf + q * 2048;
      const float4 own = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      float4 sum = cy == 0 ? own : ld_cluster_v4(mapa(off, 0));
      for (int y = 1; y < pl.cs; ++y) {
        const float4 v = y == cy ? own : ld_cluster_v4(mapa(off, y));
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
      s[4 * q] = sum.x, s[4 * q + 1] = sum.y, s[4 * q + 2] = sum.z, s[4 * q + 3] = sum.w;
    }
  };

  // online softmax of rows g and g + 8 over the tile's 64 keys: bf16 P into
  // pa, alpha the rescale of O
  auto softmax = [&](float(&s)[32]) {
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
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Tile t: S(t+1) is formed while tile t's logits are finished and its
  // softmax runs; then O = alpha O + P(t) V(t), while S(t+1) is combined.
  // The last tile's step (`has_next` a type) is compiled apart, so that no
  // wgmma is issued under a condition.  (ptxas reports that it serializes
  // the wgmma of this order, since O's rescale writes the accumulator of
  // P(t) V(t) after S(t+1) is issued; orders with the rescale before S(t+1)'s
  // issue avoid that but were slower on the H100: kernel_variants.py's
  // "S after softmax".)
  auto step = [&](float(&cur)[32], float(&nxt)[32], int t, auto has_next) {
    constexpr bool next = decltype(has_next)::value;
    int kept = n;
    if constexpr (next) kept = issue_qk(nxt);
    finish(cur, t);
    softmax(cur);
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        acc[c][i] *= alpha[0];
        acc[c][i + 1] *= alpha[0];
        acc[c][i + 2] *= alpha[1];
        acc[c][i + 3] *= alpha[1];
      }
    const int first_v = n;
    if (kEven || nv > 0) {
      const int item = n++;
      mbar_wait(ring.full_bar(item), ring.parity(item));
      const uint32_t va = ring.slot(item) + 2 * wg * kPanelBytes;
      if (nw == 2) {
        // one m64n128 product per k16 step over this warpgroup's 2 panels (its
        // accumulator is the 2 m64n64 ones side by side)
        float(&all)[64] = *reinterpret_cast<float(*)[64]>(&acc[0][0]);
        wgmma::pin(all);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) wgmma::Rs<128>::mma(all, pa[kk], v_desc(va, kk));
      } else if (nw == 1) {
        wgmma::pin(acc[0]);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wgmma::Rs<64>::mma(acc[0], pa[kk], v_desc(va, kk));
      }
    }
    wgmma::commit();
    if constexpr (next) {
      if (nw > 0)
        wgmma::wait<1>();  // S(t+1) is done; P V may still run
      else
        wgmma::wait<0>();
      wgmma::pin(nxt);
      for (; kept < first_v; ++kept) release(kept);
      combine(nxt, t + 1);
    }
    wgmma::wait<0>();
#pragma unroll
    for (int c = 0; c < 2; ++c) wgmma::pin(acc[c]);
    wgmma::pin(pa);  // read by P V until here: its registers hold nothing else
    for (int item = first_v; item < n; ++item) release(item);
  };

  {
    // tile 0's logits
    int kept = issue_qk(sa);
    wgmma::wait<0>();
    wgmma::pin(sa);
    for (; kept < n; ++kept) release(kept);
    combine(sa, 0);
  }
  int t = 0;
  for (; t + 2 < n_tiles; t += 2) {
    step(sa, sb, t, std::true_type{});
    step(sb, sa, t + 1, std::true_type{});
  }
  if (t + 1 < n_tiles) {
    step(sa, sb, t, std::true_type{});
    step(sb, sa, t + 1, std::false_type{});
  } else {
    step(sa, sb, t, std::false_type{});
  }

  // finish the row sums across the 4 threads that share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = l_run[0] == 0.f ? 1.f : 1.f / l_run[0];
  const float inv1 = l_run[1] == 0.f ? 1.f : 1.f / l_run[1];
  const int row = m0 + (warp % 4) * 16 + g;  // and row + 8
  const int cw = c0 + wg * kHalf;           // this warpgroup's first column
  __nv_bfloat16* og = p.o + (long long)b * p.o_bs + (long long)row * p.o_rs +
                      (long long)h * p.d + cw + 2 * tq;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * 64 + 8 * j;  // d is a multiple of 8: a chunk is all in or all out
      if (cw + col >= p.d) break;
      *reinterpret_cast<__nv_bfloat162*>(og + col) =
          __floats2bfloat162_rn(acc[c][4 * j] * inv0, acc[c][4 * j + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * p.o_rs + col) =
          __floats2bfloat162_rn(acc[c][4 * j + 2] * inv1, acc[c][4 * j + 3] * inv1);
    }
  }
  cluster_sync();  // the peers read this block's shared memory until their end
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
  const Plan plan = make_plan(d);
  const bool even = d % kSlice == 0 && d <= kMaxCluster * kSlice;  // one cluster: 4 panels a block
  static bool configured[2][kMaxDevices] = {};
  auto kernel = even ? flash_wide_fwd_kernel<true> : flash_wide_fwd_kernel<false>;
  cudaError_t err = configure(kernel, kSmem, configured[even], device);
  CUtensorMap map_q{}, map_k{}, map_v{};
  if (err == cudaSuccess) err = tile_map(q, strides[0], strides[1], batch, sq, heads, d, &map_q);
  if (err == cudaSuccess) err = tile_map(k, strides[2], strides[3], batch, sk, heads, d, &map_k);
  if (err == cudaSuccess) err = tile_map(v, strides[4], strides[5], batch, sk, heads, d, &map_v);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_bs = strides[6], p.o_rs = strides[7];
  p.heads = heads, p.sq = sq, p.sk = sk, p.d = d;
  p.panels = (d + 63) / 64;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  p.plan = plan;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sq / kRows, p.plan.grid_y, batch * heads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = p.plan.cs;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  void* args[] = {&p, &map_q, &map_k, &map_v};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster and grid of a launch at head dim d, as make_plan gives them:
// out = {cs, grid_y, share, q_res, slots, smem bytes}.  For the tests on the
// card, which hold ops/cuda/flash_attention.py::wide_plan to it.
int videosd_flash_attention_wide_plan(int d, int* out) {
  if (d <= 256) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(d);
  const int vals[6] = {pl.cs, pl.grid_y, pl.share, pl.q_res, pl.slots, (int)kSmem};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

}  // extern "C"
