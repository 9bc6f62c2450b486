// Hopper (sm_90a) building blocks shared by the port's kernels: wgmma
// shared-memory descriptors, mbarriers, TMA tile loads and named barriers.
// Included by fused_matching.cu and qmm.cu; kernels/build.py hashes this
// header into every library's name, so an edit here rebuilds both.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

typedef unsigned long long u64;

// A K-major wgmma operand in the 128-byte swizzle: rows of 128 bytes whose
// 16-byte chunk c lies at chunk c ^ (row % 8), 8-row groups 1024 bytes apart
// (SBO), the tile 1024-byte aligned. Stepping the start address 32 bytes
// moves one k-step (16 bf16 or 32 int8 values) along the row.
__device__ __forceinline__ u64 smem_desc(uint32_t addr) {
  return (u64)((addr & 0x3FFFF) >> 4) | ((u64)(16 >> 4) << 16) | ((u64)(1024 >> 4) << 32) |
         ((u64)1 << 62);
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

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// every barrier initialised before any thread (or the TMA unit) uses one
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the producer's arrival, announcing `bytes` that TMA copies will deliver
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------------- TMA

// the box at (c0 along the inner dimension, c1 along the outer one) of the
// 2-D tensor map into shared memory; the copy's bytes complete on `bar`.
// Boxes past the tensor's edges are filled with zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<u64>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same box into the same shared-memory offset of every CTA of the
// cluster in `mask`, completing on the mbarrier at `bar`'s offset in each
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const void* map, uint32_t bar,
                                                      int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<u64>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// ---------------------------------------------------------------- clusters

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// arrive on the mbarrier at `bar`'s offset in CTA `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, unsigned cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// hand registers from a warpgroup that needs few to one that needs many;
// every warp of the warpgroup executes it, on a path that never rejoins
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// -------------------------------------------------------- named barriers

// id 0 is __syncthreads'; `threads` a multiple of 32
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace hopper
