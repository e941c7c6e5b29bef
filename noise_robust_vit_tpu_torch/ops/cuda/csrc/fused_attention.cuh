// Fused q/k/v attention for narrow heads: what the forward and backward
// kernels of the recompute branch (fused_attention_{fwd,bwd}.cu) share.
// They take every shape the gate takes; bf16 at D = DV = 8 and N ≤ 256
// goes to the resident branch instead (fused_resident.cuh).
//
// Counterpart of noise_robust_vit_tpu/ops/pallas/sinkhorn_attention.py::
// fused_attention: plain softmax, or softmax + Sinkhorn in scaling-vector
// form, of s = scale·q·kᵀ, then ·v, for q, k [K, N, D] and v [K, N, DV]
// (K = image × head items). Its first caller is MobileViT: 4 heads of
// width 8 at N = 256, 64 and 16, 2048 items a call at batch 128.
//
// Design: recompute, no matrix. An item's N×N matrix does not fit in a
// block's shared memory at N = 256 in float32 (256 KB), and at D = 8 an
// entry A_ij = exp(scale·q_i·k_j − lse_i) costs 8 FMAs and one exp to form
// again. So the kernels never store it: every pass over the matrix forms
// its entries anew from q, k and lse, which live in shared memory (as
// float32) with v, g and the item's vectors. Each pass is either
//   * a row pass: thread t of the item owns rows i ≡ t (mod P), holds q_i
//     (and g_i) in registers and walks the keys j in order, reading k_j, v_j
//     and the column vectors as broadcasts (every thread of a warp reads the
//     same address); or
//   * a column pass: thread t owns columns j ≡ t (mod P), holds k_j (and
//     v_j) in registers and walks the rows i in order.
// Every sum is taken by one thread in a fixed order: there are no atomics
// and no cross-thread reductions, so two runs give the same bits. A row
// and a column pass form A_ij with the same FMAs in the same order, so
// they agree bit for bit on every entry.
//
// Parallelism: P = the smallest power of two ≥ N threads serve one item (at
// most kThreads), and a block of kThreads holds kThreads / P items side by
// side (16 at N = 16, 4 at N = 64, 1 at N = 256), so that a small N does
// not leave the SM idle. Their shared-memory regions lie one after the
// other; the gate (fused_attention_supported in ops/cuda/fused_attention.py,
// mirrored by fused_check here) keeps the block inside 227 KB.
//
// What bounds it on the card (H100): instruction issue. At MobileViT's
// stage 1, [2048, 256, 8] bf16, the bytes each direction must move are
// ~48 MB forward and ~66 MB backward (~15 and ~20 µs at 3.35 TB/s); the
// kernels form each of the 134 M entries 6 times forward and 9 times
// backward (robust, 3 iterations and a final row norm) at ~20 to ~40 issued
// instructions an entry on the CUDA cores.
#pragma once

#include "sinkhorn_chain.cuh"

namespace nrv {

// Widest D and DV the kernels take; a row of q, k, v or g lives in DM
// registers (DM = 8, 16 or 32, the least ≥ max(D, DV)).
constexpr int kFusedMaxD = 32;

// Threads that serve one item: the least power of two ≥ n, at most kThreads.
__host__ __device__ inline int fused_threads_per_item(int n) {
  int p = 1;
  while (p < n && p < kThreads) p *= 2;
  return p;
}

// Floats of one item's shared-memory region. Forward: q, k [N, D], v [N,
// DV], then lse, the row scale a and the column scale b. Backward: q, k,
// v, g, then lse, ones, da, svec, the row term, and four groups of
// `it` vectors (it = iters when robust, else 0): the a-rows, the b-rows,
// the dc-vectors and the dr-vectors of the reverse chain. Each vector
// takes padded_ld(N) floats, so every region starts 16-byte aligned.
__host__ __device__ inline size_t fused_fwd_item_floats(int n, int d, int dv) {
  return (size_t)n * (2 * d + dv) + 3 * (size_t)padded_ld(n);
}
__host__ __device__ inline size_t fused_bwd_item_floats(int n, int d, int dv, int it) {
  return (size_t)n * (2 * d + 2 * dv) + (5 + 4 * (size_t)it) * padded_ld(n);
}

// Shared memory of a block: its items' regions side by side.
__host__ __device__ inline size_t fused_fwd_smem_bytes(int n, int d, int dv) {
  return sizeof(float) * (kThreads / fused_threads_per_item(n)) * fused_fwd_item_floats(n, d, dv);
}
__host__ __device__ inline size_t fused_bwd_smem_bytes(int n, int d, int dv, int it) {
  return sizeof(float) * (kThreads / fused_threads_per_item(n)) *
         fused_bwd_item_floats(n, d, dv, it);
}

// The kernels' gate: at least one item and row, D and DV multiples of 4
// (16-byte rows) from 4 to kFusedMaxD, 1 to kMaxIters iterations when
// robust, and both directions' shared memory within `limit` bytes.
inline bool fused_check(int K, int N, int D, int DV, int robust, int iters, size_t limit) {
  if (K < 1 || N < 1 || D < 4 || DV < 4 || D > kFusedMaxD || DV > kFusedMaxD || D % 4 ||
      DV % 4)
    return false;
  if (robust && (iters < 1 || iters > kMaxIters)) return false;
  const int it = robust ? iters : 0;
  return fused_fwd_smem_bytes(N, D, DV) <= limit && fused_bwd_smem_bytes(N, D, DV, it) <= limit;
}

// The bytes a block may use beyond the kernel's static shared memory.
template <class Kernel>
inline cudaError_t fused_smem_limit(Kernel kernel, size_t& limit) {
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) limit = (size_t)optin - attr.sharedSizeBytes;
  return err;
}

// An item's rows from device memory into its shared-memory region, as
// float32: `count` consecutive elements, dealt out to the item's P threads.
template <typename T>
__device__ __forceinline__ void fused_load(float* dst, const T* src, int count, int t, int P) {
  for (int idx = t; idx < count; idx += P) dst[idx] = to_f(src[idx]);
}

// x ← a row of d floats (d a multiple of 4, at most DM; the rest zero).
template <int DM>
__device__ __forceinline__ void row_load(float (&x)[DM], const float* p, int d) {
#pragma unroll
  for (int c = 0; c < DM; c += 4) {
    const float4 y =
        c < d ? *reinterpret_cast<const float4*>(p + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    x[c] = y.x;
    x[c + 1] = y.y;
    x[c + 2] = y.z;
    x[c + 3] = y.w;
  }
}

// Σ_c x[c]·p[c] over a row of d floats, in order of c.
template <int DM>
__device__ __forceinline__ float row_dot(const float (&x)[DM], const float* p, int d) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DM; c += 4) {
    if (c < d) {
      const float4 y = *reinterpret_cast<const float4*>(p + c);
      s = fmaf(x[c], y.x, s);
      s = fmaf(x[c + 1], y.y, s);
      s = fmaf(x[c + 2], y.z, s);
      s = fmaf(x[c + 3], y.w, s);
    }
  }
  return s;
}

// acc[c] += w·p[c] over a row of d floats.
template <int DM>
__device__ __forceinline__ void row_axpy(float (&acc)[DM], float w, const float* p, int d) {
#pragma unroll
  for (int c = 0; c < DM; c += 4) {
    if (c < d) {
      const float4 y = *reinterpret_cast<const float4*>(p + c);
      acc[c] = fmaf(w, y.x, acc[c]);
      acc[c + 1] = fmaf(w, y.y, acc[c + 1]);
      acc[c + 2] = fmaf(w, y.z, acc[c + 2]);
      acc[c + 3] = fmaf(w, y.w, acc[c + 3]);
    }
  }
}

// The attention weight A_ij = exp(scale·(x·y) − lse_i) from a row held in
// registers and one in shared memory (q_i and k_j, either way round).
template <int DM>
__device__ __forceinline__ float fused_weight(const float (&x)[DM], const float* y, int d,
                                              float scale, float lse) {
  return expf(row_dot(x, y, d) * scale - lse);
}

}  // namespace nrv
