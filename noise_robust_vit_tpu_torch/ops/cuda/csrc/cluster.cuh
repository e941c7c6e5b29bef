// Thread-block cluster pieces shared by the kernels whose blocks exchange
// data through distributed shared memory: the fused q/k/v resident kernels
// (fused_resident.cuh, clusters of two), the talking-heads cluster kernels
// (talking_heads_cluster.cuh, a cluster of one block a head) and the packed
// resident backward (packed_resident_bwd.cu, clusters of two): the
// shared::cluster address of a block's shared memory (mapa), stores into
// another block's shared memory that complete its mbarrier's byte count
// (st.async), an arrival on another block's mbarrier, the wait on such an
// mbarrier with cluster-wide acquire, and the set-up of mbarriers before
// any block of the cluster sends.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "hopper.cuh"

namespace nrv {

namespace cg = cooperative_groups;

// Thread 0 sets up `count` mbarriers (one arrival a phase); all threads of
// every block of the cluster then pass a cluster barrier, so no st.async
// can reach an uninitialized mbarrier.
__device__ __forceinline__ void exchange_init(uint64_t* bars, int count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_mbar_init();
  }
  cg::this_cluster().sync();
}

// The shared::cluster address of `p`'s counterpart in block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(hopper::smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}
// One arrival on the mbarrier at shared::cluster address `addr` (another
// block's), releasing this thread's earlier accesses at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}
// st_async when `pred` holds, as one predicated instruction (no branch).
__device__ __forceinline__ void st_async_if(bool pred, uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %3, 0;\n"
      "@p st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      "}\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar), "r"((int)pred)
      : "memory");
}
// Spin until the phase with parity `phase` has completed, with cluster-wide
// acquire (the other blocks' st.async data are then visible).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(hopper::smem_u32(bar)),
      "r"(phase)
      : "memory");
}

}  // namespace nrv
