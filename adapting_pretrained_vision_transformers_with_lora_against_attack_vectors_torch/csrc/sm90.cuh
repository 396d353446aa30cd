// Hopper (sm_90a) building blocks shared by the kernels of this directory
// that run their products on wgmma with operands brought in by the Tensor
// Memory Accelerator: mbarriers, thread-block-cluster helpers, TMA tile loads
// and stores through tensor maps, shared-memory matrix descriptors for
// 128-byte-swizzled tiles, the wgmma fences, named barriers, and (host side)
// the tensor-map encoder.
// Header only; each .cu file is its own library.
//
// The one tile format used everywhere: rows of 64 bf16 (128 bytes), stacked
// at a 128-byte pitch in a buffer aligned to 1024 bytes, the eight 16-byte
// chunks of a row XOR-swizzled with the row index modulo 8 (TMA's
// SWIZZLE_128B, wgmma's layout type 1). Element (r, c) of such a tile lies
// at byte r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma_mma.cuh"

namespace apvt {
namespace sm90 {

constexpr int kTileRowBytes = 128;   // 64 bf16
constexpr int kAtomBytes = 1024;     // 8 rows: the swizzle's period

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c), c < 64, in a swizzled tile.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kTileRowBytes + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}
// After the inits, before any thread or copy uses a barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}
// Spin until the barrier has left the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Credit `bytes` to the barrier's transaction count without a copy.
__device__ __forceinline__ void mbar_complete_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.complete_tx.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(bytes)
               : "memory");
}

// --- thread block clusters -----------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// All threads of all CTAs of the cluster (of this CTA, where the launch named no cluster).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// The address, in the cluster's shared window, of `local` in the CTA of rank `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
// Arrive on the barrier `bar` of the CTA of rank `rank`, releasing this
// thread's (and, through a preceding barrier, its warp's) writes cluster-wide.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   mapa(saddr(bar), rank))
               : "memory");
}
// mbar_wait that acquires writes released anywhere in the cluster.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// Orders ordinary writes to any shared memory of the cluster before async-proxy reads.
__device__ __forceinline__ void fence_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// Registers per thread of this warpgroup, given up (producers) or taken (consumers).
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- TMA ---------------------------------------------------------------------

// One box of a rank-3 (rank-2) tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// One box of a rank-4 tensor map; the start may be negative or past the
// end: what lies outside the tensor arrives as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// `bytes` (a multiple of 16) of contiguous global memory into shared memory,
// both 16-byte aligned, by the bulk-copy engine; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(saddr(bar))
      : "memory");
}
// One box from shared memory to the tensor (elements outside it are dropped).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(saddr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(saddr(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(saddr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until the committed stores (all but the newest N groups) have read their shared memory.
template <int N = 0>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Orders ordinary shared-memory writes before a TMA store or a wgmma that reads them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma -------------------------------------------------------------------

// Descriptor of a swizzled tile (or a stack of them) at `p`. K-major operand
// (rows = the M or N index, a row holds 64 values of K): `sbo` = bytes
// between 8-row groups (1024), `lbo` unused; 16 values further along K is 32
// bytes further. MN-major operand (rows = K, a row holds 64 values of M or
// N): `sbo` = bytes between 8-row groups of K (1024), `lbo` = bytes between
// 64-wide column blocks; 16 values further along K is 2048 bytes further.
__device__ __forceinline__ uint64_t mdesc(const void* p, int lbo = kAtomBytes,
                                          int sbo = kAtomBytes) {
  return (uint64_t)((saddr(p) & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// The same operand `bytes` further on (a multiple of 16).
__device__ __forceinline__ uint64_t madvance(uint64_t desc, int bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) among `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the four lanes of a quad: the threads that share a row of
// a wgmma accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The first 1024-byte boundary at or after p (dynamic shared memory is only
// 16-byte aligned).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (saddr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- host: tensor maps ---------------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime the library
// links: the entry point is taken from the libcuda the process has already
// loaded.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

constexpr int kMapError = -2;   // what a launcher returns when a map cannot be encoded

// A bf16 tensor of `rank` (2 or 3) dimensions, innermost first: sizes
// `dims`, byte strides of dimensions 1.. in `strides`, read or written in
// boxes of 64 values x `box_rows` rows (x 1), 128-byte swizzle, zeros for
// what lies outside. False if libcuda refuses.
inline bool make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                     const uint64_t* strides, uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t gd[3] = {dims[0], dims[1], rank > 2 ? dims[2] : 1};
  cuuint64_t gs[2] = {strides[0], rank > 2 ? strides[1] : 0};
  cuuint32_t box[3] = {64, box_rows, 1};
  cuuint32_t es[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base), gd,
            gs, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor of 4 dimensions, innermost first: sizes `dims`, byte strides
// of dimensions 1-3 in `strides`, read in boxes of `box` elements, no
// swizzle (a box lands in shared memory as a dense array, innermost
// fastest), zeros for what lies outside. False if libcuda refuses.
inline bool make_map_4d(CUtensorMap* map, const void* base, const uint64_t* dims,
                        const uint64_t* strides, const uint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t gd[4] = {dims[0], dims[1], dims[2], dims[3]};
  cuuint64_t gs[3] = {strides[0], strides[1], strides[2]};
  cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  cuuint32_t es[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gd, gs, bx, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace apvt
