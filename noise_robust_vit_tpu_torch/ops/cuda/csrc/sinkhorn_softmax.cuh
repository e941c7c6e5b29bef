// Pieces shared by the logits-interface Sinkhorn kernels
// (sinkhorn_softmax_{fwd,bwd}.cu) and the talking-heads kernels
// (talking_heads_{fwd,bwd}.cu): where an item's residual rows live,
// whole-matrix loads and stores in runs of four elements, and the
// backward's vector work on one item.
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

// post(j, Σ_i f(i, j)) for every column j < nc: the rows are dealt out to
// groups of whole warps, as in cols_partials, and each column's group
// partials are added in a fixed order. `part` holds kThreads floats.
template <class F, class Post>
__device__ void cols_sum(int nr, int nc, float* part, F f, Post post) {
  const int cw = min((nc + 31) / 32 * 32, kThreads);
  const int groups = kThreads / cw;
  const int jj = threadIdx.x % cw, grp = threadIdx.x / cw;
  for (int j0 = 0; j0 < nc; j0 += cw) {
    const int j = j0 + jj;
    float s = 0.f;
    if (grp < groups && j < nc)
      for (int i = grp; i < nr; i += groups) s += f(i, j);
    part[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < cw && j < nc) {
      float t = 0.f;
      for (int g = 0; g < groups; ++g) t += part[g * cw + threadIdx.x];
      post(j, t);
    }
    __syncthreads();
  }
}

// The backward's vectors in shared memory, after the matrix: ones
// (max(nr, nc)), the ka a-rows (nr), the iters b-rows (nc), lse, da (nr),
// db_row (nc), svec, m_dc, row_term (nr), the iters dc (nc) and iters dr
// (nr) vectors. The rank-1 terms are offsets from `ones`.
__host__ __device__ inline size_t bwd_vector_floats(int nr, int nc, int iters, int ka) {
  return (size_t)(nr > nc ? nr : nc) + (size_t)(ka + iters + 5) * nr +
         (size_t)(2 * iters + 1) * nc;
}

struct BwdVectors {
  float *ones, *arows, *brows, *lse, *da, *db_row, *svec, *m_dc, *row_term, *dcs, *drs;
  const float* a_fin;  // the last a-row (ones without one)
  const float* b_fin;  // the last b-row
};

__device__ inline BwdVectors bwd_vectors(float* base, int nr, int nc, int iters, int ka) {
  BwdVectors v;
  v.ones = base;
  v.arows = v.ones + (nr > nc ? nr : nc);
  v.brows = v.arows + (size_t)ka * nr;
  v.lse = v.brows + (size_t)iters * nc;
  v.da = v.lse + nr;
  v.db_row = v.da + nr;
  v.svec = v.db_row + nc;
  v.m_dc = v.svec + nr;
  v.row_term = v.m_dc + nr;
  v.dcs = v.row_term + nr;
  v.drs = v.dcs + (size_t)iters * nc;
  v.a_fin = ka > 0 ? v.arows + (size_t)(ka - 1) * nr : v.ones;
  v.b_fin = v.brows + (size_t)(iters - 1) * nc;
  return v;
}

// One item's scaling vectors and lse from its residual rows into `v`
// (_restore_vec_rows). Ends with a barrier.
__device__ inline void load_residual_rows(const ResidualRows<const float>& res, const BwdVectors& v,
                                          int nr, int nc, int iters, int ka) {
  for (int idx = threadIdx.x; idx < ka * nr; idx += kThreads) v.arows[idx] = res.a[idx];
  for (int idx = threadIdx.x; idx < iters * nc; idx += kThreads) v.brows[idx] = res.b[idx];
  for (int i = threadIdx.x; i < nr; i += kThreads) v.lse[i] = res.lse[i];
  __syncthreads();
}

// Everything of one item's backward that runs on vectors, from A in P and
// the upstream gradient g [nr, nc] (contiguous, float32 or bfloat16):
// da = (A ⊙ g)·b (a warp per row), db = (A ⊙ g)ᵀ·a (cols_sum), the reverse
// chain, and row_term = a ⊙ da + svec. Leaves the rank-1 terms' offsets in
// tu and tv and returns their count; then
//   ds = A ⊙ ((a ⊙ g ⊙ bᵀ − row_term) + Σ_k u_k v_kᵀ)   (ds_entry).
// `part` holds kThreads floats.
template <typename G>
__device__ int sinkhorn_bwd_vectors(const float* P, const G* g, int nr, int nc, int ld,
                                    int iters, int final_row, const BwdVectors& v,
                                    float* part, int* tu, int* tv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* a_fin = v.a_fin;
  const float* b_fin = v.b_fin;
  for (int i = warp; i < nr; i += kWarps) {
    const float* p = P + (size_t)i * ld;
    const G* gi = g + (size_t)i * nc;
    float acc = 0.f;
    for (int j = lane; j < nc; j += 32) acc = fmaf(p[j] * to_f(gi[j]), b_fin[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) v.da[i] = acc;
  }
  float* db_row = v.db_row;
  cols_sum(
      nr, nc, part,
      [=](int i, int j) { return P[(size_t)i * ld + j] * to_f(g[(size_t)i * nc + j]) * a_fin[i]; },
      [=](int j, float t) { db_row[j] = t; });
  const int nt = sinkhorn_reverse_chain(P, nr, nc, ld, iters, final_row != 0, v.ones, v.ones,
                                        v.arows, v.brows, v.da, v.db_row, v.svec, v.m_dc, v.dcs,
                                        v.drs, tu, tv);
  for (int i = threadIdx.x; i < nr; i += kThreads) v.row_term[i] = a_fin[i] * v.da[i] + v.svec[i];
  __syncthreads();
  return nt;
}

// One entry of ds for A's entry p and the upstream gradient's gij.
__device__ __forceinline__ float ds_entry(const BwdVectors& v, const int* tu, const int* tv,
                                          int nt, int i, int j, float p, float gij) {
  float r1 = 0.f;
  for (int t = 0; t < nt; ++t) r1 = fmaf(v.ones[tu[t] + i], v.ones[tv[t] + j], r1);
  return p * ((v.a_fin[i] * gij * v.b_fin[j] - v.row_term[i]) + r1);
}

}  // namespace nrv
