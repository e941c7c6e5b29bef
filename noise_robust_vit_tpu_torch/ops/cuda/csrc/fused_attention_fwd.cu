// Fused q/k/v attention, forward: out = diag(a)·A·diag(b)·v with A the row
// softmax of scale·q·kᵀ and (a, b) the Sinkhorn scaling vectors (robust),
// or out = A·v (vanilla), and the residual rows the backward starts from.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// sinkhorn_attention.py::_fused_attention_impl (pl.pallas_call at :147),
// whose body is _fwd_math_batched. The design, and what bounds it, are in
// fused_attention.cuh: no N×N matrix is stored; each pass forms the entries
// it needs from q, k and lse in shared memory.
//
// Layout: q, k [K, N, D], v and out [K, N, DV], contiguous; vecs [K, R, N]
// float32: the a-rows (iters − 1, plus the final one), the iters b-rows and
// lse when robust; lse alone when vanilla (the JAX kernel's residual stack
// without its padding).
//
// Passes, each over the item's N×N entries:
//   1. rows: lse_i = m_i + log Σ_j exp(s_ij − m_i), online over j. A =
//      exp(s − lse) is then the softmax itself, so a_0 ≡ 1 (the first row
//      normalization of a row softmax is the identity) and the row
//      normalizer folds away.
//   2. robust, for t = 0 … iters − 1: (t > 0) rows: a = recip(A·b); columns:
//      b = recip(Aᵀ·a). recip is the clamped reciprocal of ops/sinkhorn.py.
//   3. rows: out_i = a_i · Σ_j A_ij b_j v_j, with the final row scale a_i =
//      recip(Σ_j A_ij b_j) taken from the same walk when final_row.
// At (3, final) that is six passes; vanilla takes two.
#include "fused_attention.cuh"

namespace nrv {

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_kernel(const T* __restrict__ q_all, const T* __restrict__ k_all,
                           const T* __restrict__ v_all, T* __restrict__ out_all,
                           float* __restrict__ vecs_all, int K, int N, int D, int DV,
                           float scale, int robust, int iters, int final_row) {
  extern __shared__ float smem[];
  const int P = fused_threads_per_item(N);
  const int slot = threadIdx.x / P, t = threadIdx.x % P;
  const size_t item = (size_t)blockIdx.x * (kThreads / P) + slot;
  const bool live = item < (size_t)K;
  const int ldv = padded_ld(N);
  float* qs = smem + slot * fused_fwd_item_floats(N, D, DV);
  float* ks = qs + (size_t)N * D;
  float* vs = ks + (size_t)N * D;
  float* lse = vs + (size_t)N * DV;
  float* arow = lse + ldv;
  float* brow = arow + ldv;
  const int R = num_vecs(iters, final_row, robust);
  const int ka = robust ? num_arows(iters, final_row) : 0;
  float* vec = vecs_all + (live ? item : 0) * R * N;

  if (live) {
    fused_load(qs, q_all + item * N * D, N * D, t, P);
    fused_load(ks, k_all + item * N * D, N * D, t, P);
    fused_load(vs, v_all + item * N * DV, N * DV, t, P);
    for (int j = t; j < N; j += P) brow[j] = 1.f;
  }
  __syncthreads();

  // 1. lse, and a_0 = 1
  if (live) {
    for (int i = t; i < N; i += P) {
      float qi[DM];
      row_load(qi, qs + (size_t)i * D, D);
      float m = -INFINITY, r = 0.f;
      for (int j = 0; j < N; ++j) {
        const float s = row_dot(qi, ks + (size_t)j * D, D) * scale;
        if (s > m) {
          r = r * expf(m - s) + 1.f;
          m = s;
        } else {
          r += expf(s - m);
        }
      }
      const float l = m + logf(r);
      lse[i] = l;
      vec[(size_t)(R - 1) * N + i] = l;
      arow[i] = 1.f;
    }
  }
  __syncthreads();

  // 2. the Sinkhorn chain
  if (robust) {
    for (int it = 0; it < iters; ++it) {
      if (it > 0) {
        if (live) {
          for (int i = t; i < N; i += P) {
            float qi[DM];
            row_load(qi, qs + (size_t)i * D, D);
            const float li = lse[i];
            float s = 0.f;
            for (int j = 0; j < N; ++j)
              s = fmaf(fused_weight(qi, ks + (size_t)j * D, D, scale, li), brow[j], s);
            const float a = recip_clamped(s);
            arow[i] = a;
            vec[(size_t)(it - 1) * N + i] = a;
          }
        }
        __syncthreads();
      }
      if (live) {
        for (int j = t; j < N; j += P) {
          float kj[DM];
          row_load(kj, ks + (size_t)j * D, D);
          float s = 0.f;
          for (int i = 0; i < N; ++i)
            s = fmaf(fused_weight(kj, qs + (size_t)i * D, D, scale, lse[i]), arow[i], s);
          const float b = recip_clamped(s);
          brow[j] = b;
          vec[(size_t)(ka + it) * N + j] = b;
        }
      }
      __syncthreads();
    }
  }

  // 3. the output, with the final row norm
  if (live) {
    T* out = out_all + item * N * DV;
    const bool fin = robust && final_row;
    for (int i = t; i < N; i += P) {
      float qi[DM], acc[DM];
      row_load(qi, qs + (size_t)i * D, D);
#pragma unroll
      for (int c = 0; c < DM; ++c) acc[c] = 0.f;
      const float li = lse[i];
      float rs = 0.f;
      for (int j = 0; j < N; ++j) {
        const float w = fused_weight(qi, ks + (size_t)j * D, D, scale, li) * brow[j];
        rs += w;
        row_axpy(acc, w, vs + (size_t)j * DV, DV);
      }
      float a = arow[i];
      if (fin) {
        a = recip_clamped(rs);
        vec[(size_t)(ka - 1) * N + i] = a;
      }
#pragma unroll
      for (int c = 0; c < DM; ++c)
        if (c < DV) store_f(out + (size_t)i * DV + c, a * acc[c]);
    }
  }
}

template <typename T, int DM>
int launch_fused_fwd(const void* q, const void* k, const void* v, void* out, void* vecs, int K,
                     int N, int D, int DV, float scale, int robust, int iters, int final_row,
                     cudaStream_t stream) {
  auto kernel = fused_attention_fwd_kernel<T, DM>;
  size_t limit = 0;
  cudaError_t err = fused_smem_limit(kernel, limit);
  if (err != cudaSuccess) return (int)err;
  if (!fused_check(K, N, D, DV, robust, iters, limit)) return (int)cudaErrorInvalidValue;
  const size_t smem = fused_fwd_smem_bytes(N, D, DV);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kThreads / fused_threads_per_item(N);
  kernel<<<(K + per_block - 1) / per_block, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(vecs), K, N, D, DV, scale, robust, iters,
      final_row);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused_fwd_width(const void* q, const void* k, const void* v, void* out, void* vecs,
                           int K, int N, int D, int DV, float scale, int robust, int iters,
                           int final_row, cudaStream_t stream) {
  const int w = D > DV ? D : DV;
  if (w <= 8)
    return launch_fused_fwd<T, 8>(q, k, v, out, vecs, K, N, D, DV, scale, robust, iters,
                                  final_row, stream);
  if (w <= 16)
    return launch_fused_fwd<T, 16>(q, k, v, out, vecs, K, N, D, DV, scale, robust, iters,
                                   final_row, stream);
  return launch_fused_fwd<T, 32>(q, k, v, out, vecs, K, N, D, DV, scale, robust, iters,
                                 final_row, stream);
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. Returns cudaErrorInvalidValue for a shape
// outside the gate, else cudaGetLastError() after the launch.
extern "C" int nrv_fused_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* vecs, int dtype, int K, int N, int D, int DV,
                                       float scale, int robust, int iters, int final_row,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_fused_fwd_width<float>(q, k, v, out, vecs, K, N, D, DV, scale, robust,
                                              iters, final_row, s);
  if (dtype == 1)
    return nrv::launch_fused_fwd_width<__nv_bfloat16>(q, k, v, out, vecs, K, N, D, DV, scale,
                                                      robust, iters, final_row, s);
  return (int)cudaErrorInvalidValue;
}
