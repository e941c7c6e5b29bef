// Warp-level pieces of the resident kernels, which hold an item's matrix in
// registers in the accumulator layout of mma.sync m16n8 (lane (g, t) =
// (lane / 4, lane % 4) holds rows g and g + 8 at columns 8·nt + 2t,
// 8·nt + 2t + 1 of each 8-column tile nt): the MMAs and ldmatrix loads that
// feed them, movmatrix, cp.async, the SFU's 2^x, the sums across a row's
// four lanes and across the warp's 8 row groups. The fused q/k/v kernels
// (fused_resident.cuh) and the biased ones (biased_resident.cuh) share
// them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "sinkhorn_chain.cuh"

namespace nrv {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// d += a·b: a 16×8 bf16 (row-major fragment), b 8×8.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// ldmatrix: each lane of the group that feeds matrix m (lanes 8m..8m + 7)
// gives the shared address of one 16-byte row of it. Without .trans, lane
// (g, t) then holds row g, columns 2t, 2t + 1 of each matrix; with .trans,
// rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(row))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(row))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(hopper::smem_u32(row))
               : "memory");
}

// The 8×8 b16 matrix whose row lane / 4, columns 2·(lane % 4) + {0, 1} this
// lane holds, transposed: afterwards it holds rows 2·(lane % 4) + {0, 1} of
// column lane / 4 of the original.
__device__ __forceinline__ uint32_t mov_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// 16 bytes global → shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global → shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One arrival on `bar` once all of this thread's earlier cp.async copies
// have landed (the arrival is not counted in advance: the mbarrier's count
// includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// Wait until at most `Pending` of this thread's groups are in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// recip_clamped (sinkhorn_chain.cuh) with the correctly rounded reciprocal
// instruction sequence in place of a division: the same bits.
__device__ __forceinline__ float recip_rn(float x) {
  return x == 0.f ? 1.f : __frcp_rn(fmaxf(x, 1e-8f));
}

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 lds_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One halving step of a reduce-scatter across the lanes `mask` apart: the
// lane with the bit set keeps the upper H values, its partner the lower H,
// each adding the other's; `base` counts the values dropped below.
template <int H>
__device__ __forceinline__ void rs_step(float* v, int mask, int& base) {
  const bool up = threadIdx.x & mask;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
  if (up) base += H;
}

// This warp's column sums of its entries weighted by the row scalars (w0 at
// row g, w1 at row g + 8) into row[0..NC): a reduce-scatter over the 8 row
// groups (lane bits 4, 3, 2), so that each lane ends with the full sums of
// NC / 32 columns (a butterfly on the last bit at NC = 16).
template <int NC>
__device__ __forceinline__ void col_partials(const float (&e)[NC / 8][4], float w0, float w1,
                                             float* row) {
  constexpr int V = NC / 4;  // values a lane holds: columns 8·nt + 2t + {0, 1}
  const int lane = threadIdx.x % 32, t = lane % 4;
  float v[V];
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) {
    v[2 * nt] = fmaf(e[nt][0], w0, e[nt][2] * w1);
    v[2 * nt + 1] = fmaf(e[nt][1], w0, e[nt][3] * w1);
  }
  int base = 0;
  rs_step<V / 2>(v, 16, base);
  rs_step<V / 4>(v, 8, base);
  if constexpr (V >= 8) {
    rs_step<V / 8>(v, 4, base);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 4);
    if (lane & 4) return;
  }
  constexpr int kLeft = V >= 8 ? V / 8 : 1;
#pragma unroll
  for (int i = 0; i < kLeft; ++i) {
    const int idx = base + i;
    row[8 * (idx >> 1) + 2 * t + (idx & 1)] = v[i];
  }
}

// Row sums of the entries weighted by a column vector s: (row g, row g + 8).
template <int NC>
__device__ __forceinline__ float2 row_pass(const float (&e)[NC / 8][4], const float* s) {
  const int t = threadIdx.x % 4;
  float r0 = 0.f, r1 = 0.f, q0 = 0.f, q1 = 0.f;  // even and odd columns apart
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) {
    const float2 sv = lds_f2(s + 8 * nt + 2 * t);
    r0 = fmaf(e[nt][0], sv.x, r0);
    q0 = fmaf(e[nt][1], sv.y, q0);
    r1 = fmaf(e[nt][2], sv.x, r1);
    q1 = fmaf(e[nt][3], sv.y, q1);
  }
  return make_float2(quad_sum(r0 + q0), quad_sum(r1 + q1));
}

}  // namespace nrv
