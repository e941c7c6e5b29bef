// Pieces shared by the forward and backward logits-interface Sinkhorn
// kernels (sinkhorn_softmax_{fwd,bwd}.cu): where an item's residual rows
// live, and whole-matrix loads and stores in runs of four elements.
#pragma once

#include "sinkhorn_chain.cuh"

namespace nrv {

// One item's residual rows. Square (rect == 0): one stack [R, N] of the
// ka a-rows, the iters b-rows and lse. Rectangular: va [ka + 1, nr] (the
// a-rows, then lse) and vb [iters, nc] (the b-rows).
template <typename P>  // float, or const float for the backward
struct ResidualRows {
  P* a;
  P* b;
  P* lse;
};

template <typename P>
__device__ inline ResidualRows<P> residual_rows(P* va, P* vb, int item, int nr, int nc,
                                                int iters, int ka, int rect) {
  if (rect) {
    P* a = va + (size_t)item * (ka + 1) * nr;
    return {a, vb + (size_t)item * iters * nc, a + (size_t)ka * nr};
  }
  P* a = va + (size_t)item * (ka + iters + 1) * nr;
  return {a, a + (size_t)ka * nr, a + (size_t)(ka + iters) * nr};
}

// Four values to 16-byte aligned float32 or 8-byte aligned bfloat16 storage.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// E[i, j] = op(i, s[i, j]) in float32 for the contiguous item s [nr, nc],
// E with row stride ld (a multiple of 4). Runs of four along a row when nc
// is a multiple of 4 (the caller keeps s aligned for them), else one
// element a thread. Ends with a barrier.
template <typename T, class Op>
__device__ inline void load_matrix(const T* s, int nr, int nc, int ld, float* E, Op op) {
  if (nc % 4 == 0) {
    for (int r = threadIdx.x; r < nr * nc / 4; r += kThreads) {
      const int f = 4 * r, i = f / nc, j = f - i * nc;
      const float4 x = value(run4(s + f));
      *reinterpret_cast<float4*>(E + (size_t)i * ld + j) =
          make_float4(op(i, x.x), op(i, x.y), op(i, x.z), op(i, x.w));
    }
  } else {
    for (int f = threadIdx.x; f < nr * nc; f += kThreads) {
      const int i = f / nc, j = f - i * nc;
      E[(size_t)i * ld + j] = op(i, to_f(s[f]));
    }
  }
  __syncthreads();
}

}  // namespace nrv
