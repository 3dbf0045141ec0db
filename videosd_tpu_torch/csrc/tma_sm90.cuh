// TMA, bulk copies, mbarriers and thread-block clusters for sm_90a, shared by
// the kernels that use them (flash_attention.cu, taesd_conv.cu, ...).
//
// Device side: thin inline-PTX wrappers.  Host side: cuTensorMapEncodeTiled,
// looked up in libcuda once (nothing links it), and a cache of tensor maps
// keyed by tensor geometry and box, since the callers send the same few
// buffers from the allocator's pool again and again.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace sm90 {

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Makes this thread's earlier shared-memory writes visible to the async proxy
// (wgmma and TMA read shared memory through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the barriers' initialisation visible to the async proxy and the other threads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spins until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// TMA: one box of a 4-D tensor map at (c0, c1, c2, c3), innermost first, into
// shared memory; completion is counted in bytes on the mbarrier.  Coordinates
// may be negative or past the end, and what lies outside the tensor arrives
// as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------- clusters (sm_90)

// Every thread of every block of the cluster: earlier writes are seen after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// The address of the shared-memory location `addr` of this block in the block
// of rank `rank` of the cluster (distributed shared memory).
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// One arrival on an mbarrier of any block of the cluster (an address from
// mapa), releasing this thread's earlier memory accesses at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// mbar_wait that acquires at cluster scope: what the threads of other blocks
// released with their arrivals is seen after it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void fence_acq_rel_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}
__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
// 16 bytes into another block's shared memory (an address from mapa), counted
// in bytes on that block's mbarrier `bar` (also from mapa), as a TMA load is.
__device__ __forceinline__ void st_async_v4(uint32_t addr, float a, float b, float c, float d,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}
// 16 bytes of another block's shared memory (an address from mapa).
__device__ __forceinline__ float4 ld_cluster_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// TMA store of one box from shared memory; what falls outside the tensor is
// not written.  Completion is tracked by bulk groups of the issuing thread.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until the issuing thread's bulk groups have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until the issuing thread's bulk groups have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, counted on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- host

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda once.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      sym = nullptr;
    return reinterpret_cast<EncodeTiledFn>(sym);
  }();
  return fn;
}

// A bf16 tensor of `rank` <= 4 dimensions, innermost first, with a unit
// inner stride, read or written in boxes whose inner extent is 64 elements
// (128 bytes) in the 128-byte swizzle; what a load reads outside the tensor
// comes as zeros.
struct MapKey {
  const void* ptr;
  int rank;
  long long dims[4];     // elements
  long long strides[3];  // bytes between steps of dims 1..rank-1
  int box[4];
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || rank != o.rank) return false;
    for (int i = 0; i < rank; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i] || (i > 0 && strides[i - 1] != o.strides[i - 1]))
        return false;
    return true;
  }
};

// The tensor map for `key`, from the cache or encoded once.
inline cudaError_t tensor_map(const MapKey& key, CUtensorMap* out) {
  constexpr int kSlots = 128;
  static MapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static int used = 0, next = 0;
  static std::mutex mutex;
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *out = maps[i];
      return cudaSuccess;
    }
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem_strides[4];
  for (int i = 0; i < key.rank; ++i) {
    dims[i] = (cuuint64_t)key.dims[i];
    box[i] = (cuuint32_t)key.box[i];
    elem_strides[i] = 1;
    if (i > 0) strides[i - 1] = (cuuint64_t)key.strides[i - 1];
  }
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, key.rank, const_cast<void*>(key.ptr), dims,
             strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int slot = used < kSlots ? used++ : (next = (next + 1) % kSlots);
  keys[slot] = key;
  maps[slot] = map;
  *out = map;
  return cudaSuccess;
}

}  // namespace sm90
