// Asynchronous copies and thread-block-cluster exchange on Hopper (sm_90a),
// shared by the port's kernels: the tile kernel (rns_common.cuh) streams
// weights and reduces its K split through them, the split route of flash
// attention (flash_split.cu) streams keys and values and merges its key
// split through them.
//
//   * cp_async16: a 16-byte global -> shared copy that bypasses L1, with
//     zero fill (and no read) for an element outside the tensor; grouped
//     by cp_async_commit and waited for by cp_async_wait<pending groups>.
//   * A cluster barrier in two halves (arrive, wait), so a block works
//     between them.  The arrive is relaxed: a release would fence all of
//     device memory.  It orders only the mbarrier's initialization
//     (fence_mbarrier_init).
//   * bulk_to_rank: one bulk copy from this block's shared memory into
//     another rank's, its bytes counted on that rank's mbarrier
//     (mbar_init / mbar_expect / mbar_wait); fence_proxy_async first makes
//     the block's own writes visible to the copy engine.
#pragma once

#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// The address of the same shared-memory location in cluster rank `rank`.
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(unsigned mbar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mbar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(mbar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
  }
}
// Generic-proxy writes to shared memory made visible to the bulk copy
// engine (async proxy) that reads them next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// One bulk copy of `bytes` (a multiple of 16) from this block's shared
// memory into another rank's, counted as bytes on that rank's mbarrier.
__device__ __forceinline__ void bulk_to_rank(unsigned dst, unsigned src,
                                             unsigned bytes,
                                             unsigned mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src), "r"(bytes),
      "r"(mbar)
      : "memory");
}

}  // namespace hopper
