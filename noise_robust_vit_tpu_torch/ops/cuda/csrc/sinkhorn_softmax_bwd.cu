// Softmax + Sinkhorn over precomputed logits, backward: (logits, g,
// residual rows) → d logits, the hand-derived gradient of the forward in
// sinkhorn_softmax_fwd.cu. Square and rectangular matrices share the body.
//
// Replaces the TPU kernels noise_robust_vit_tpu/ops/pallas/
// sinkhorn_softmax.py::_sinkhorn_softmax_bwd_impl (pl.pallas_call at :266,
// body _norm_bwd_math) and ::_rect_bwd_impl (:537, body _rect_bwd_math).
//
// Forward is out = diag(a)·A·diag(b) with A = softmax(s). Per item:
//   A = exp(s − lse)                    (the stored log-normalizer: one exp)
//   da = (A ⊙ g)·b, db = (A ⊙ g)ᵀ·a     (the direct grads of the final a, b)
//   the reverse chain (sinkhorn_chain.cuh) on vectors, giving svec and the
//   rank-1 terms u_k v_kᵀ;
//   ds = A ⊙ ((a ⊙ g ⊙ bᵀ − (a ⊙ da + svec)) + Σ u_k v_kᵀ),
// since rowsum(dA ⊙ A) = a ⊙ da by identity for the direct dA = a ⊙ g ⊙ bᵀ.
//
// Design. One item per block at a time, A rebuilt in shared memory (one
// matrix: 150 KB at 196×196, where A and g do not both fit the 227 KB a
// block may use), or in a global scratch slot when even A alone does not
// fit. g is not kept: it is read three times from device memory, once for
// da (a warp per row), once for db (the rows dealt out to all warps, as
// cols_partials does), and once in the pass that forms ds, which also
// applies the rank-1 terms. The item's g is at most 154 KB and the blocks
// in flight hold ~20 MB of it, so the second and third reads come from L2.
// The chain itself runs on vectors. No atomics: a run repeats bit for bit.
//
// What bounds it on the card (H100): the bytes. At LeViT-128S's subsample
// [256, 8, 49, 196] float32 the logits, g and ds are 78.7 MB each, so
// ≥ 0.070 ms at 3.35 TB/s; the float32 work (one exp, the direct sums, the
// chain's 2·iters + 1 products, the ds pass with ≤ 2·iters + 1 rank-1
// terms) is ~3 GFLOP, well below the CUDA cores' 67 TFLOP/s.
#include "sinkhorn_softmax.cuh"

namespace nrv {

inline size_t sinkhorn_softmax_bwd_smem_bytes(int nr, int nc, int iters, int ka,
                                              bool matrix_in_smem) {
  return sizeof(float) * ((matrix_in_smem ? (size_t)nr * padded_ld(nc) : 0) +
                          bwd_vector_floats(nr, nc, iters, ka));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
sinkhorn_softmax_bwd_kernel(const T* __restrict__ s_all, const T* __restrict__ g_all,
                            const float* __restrict__ va, const float* __restrict__ vb,
                            T* __restrict__ ds_all, float* __restrict__ scratch, int K,
                            int nr, int nc, int iters, int final_row, int rect) {
  extern __shared__ float smem[];
  __shared__ int s_tu[kMaxTerms], s_tv[kMaxTerms];
  __shared__ float part[kThreads];
  const int ld = padded_ld(nc);
  const int ka = num_arows(iters, final_row);
  float* P = scratch ? scratch + (size_t)blockIdx.x * nr * ld : smem;  // A
  const BwdVectors v = bwd_vectors(scratch ? smem : smem + (size_t)nr * ld, nr, nc, iters, ka);

  for (int i = threadIdx.x; i < (nr > nc ? nr : nc); i += kThreads) v.ones[i] = 1.f;
  for (int item = blockIdx.x; item < K; item += gridDim.x) {
    const size_t off = (size_t)item * nr * nc;
    const T* s = s_all + off;
    const T* g = g_all + off;
    T* ds = ds_all + off;
    load_residual_rows(residual_rows(va, vb, item, nr, nc, iters, ka, rect), v, nr, nc, iters,
                       ka);
    const float* lse = v.lse;
    load_matrix(s, nr, nc, ld, P, [=](int i, float x) { return expf(x - lse[i]); });
    const int nt = sinkhorn_bwd_vectors(P, g, nr, nc, ld, iters, final_row, v, part, s_tu, s_tv);

    // ds = A ⊙ ((a ⊙ g ⊙ bᵀ − row term) + Σ_k u_k v_kᵀ)
    if (nc % 4 == 0) {
      for (int r = threadIdx.x; r < nr * nc / 4; r += kThreads) {
        const int f = 4 * r, i = f / nc, j = f - i * nc;
        const float4 p = *reinterpret_cast<const float4*>(P + (size_t)i * ld + j);
        const float4 gv = value(run4(g + f));
        store4(ds + f, make_float4(ds_entry(v, s_tu, s_tv, nt, i, j, p.x, gv.x),
                                   ds_entry(v, s_tu, s_tv, nt, i, j + 1, p.y, gv.y),
                                   ds_entry(v, s_tu, s_tv, nt, i, j + 2, p.z, gv.z),
                                   ds_entry(v, s_tu, s_tv, nt, i, j + 3, p.w, gv.w)));
      }
    } else {
      for (int f = threadIdx.x; f < nr * nc; f += kThreads) {
        const int i = f / nc, j = f - i * nc;
        store_f(ds + f, ds_entry(v, s_tu, s_tv, nt, i, j, P[(size_t)i * ld + j], to_f(g[f])));
      }
    }
    __syncthreads();  // the next item overwrites A and the vectors
  }
}

template <typename T>
int launch_sinkhorn_softmax_bwd(const void* s, const void* g, const void* va,
                                const void* vb, void* ds, void* scratch, int K, int nr,
                                int nc, int iters, int final_row, int rect, int blocks,
                                cudaStream_t stream) {
  const size_t smem = sinkhorn_softmax_bwd_smem_bytes(nr, nc, iters,
                                                      num_arows(iters, final_row),
                                                      scratch == nullptr);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_softmax_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_softmax_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(g), static_cast<const float*>(va),
      static_cast<const float*>(vb), static_cast<T*>(ds), static_cast<float*>(scratch), K,
      nr, nc, iters, final_row, rect);
  return (int)cudaGetLastError();
}

inline int sinkhorn_softmax_bwd_dispatch(const void* s, const void* g, const void* va,
                                         const void* vb, void* ds, void* scratch, int dtype,
                                         int K, int nr, int nc, int iters, int final_row,
                                         int rect, int blocks, void* stream) {
  if (K < 1 || nr < 1 || nc < 1 || iters < 1 || iters > kMaxIters || blocks < 1 ||
      (final_row != 0 && final_row != 1) || (!rect && nr != nc) || (rect && !vb))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sinkhorn_softmax_bwd<float>(s, g, va, vb, ds, scratch, K, nr, nc, iters,
                                              final_row, rect, blocks, st);
  if (dtype == 1)
    return launch_sinkhorn_softmax_bwd<__nv_bfloat16>(s, g, va, vb, ds, scratch, K, nr, nc,
                                                      iters, final_row, rect, blocks, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. logits, g and ds [K, N, N]; vecs float32
// [K, R, N] from the forward; scratch as in nrv_sinkhorn_softmax_fwd.
// Returns cudaGetLastError().
extern "C" int nrv_sinkhorn_softmax_bwd(const void* logits, const void* g, const void* vecs,
                                        void* ds, void* scratch, int dtype, int K, int N,
                                        int iters, int final_row, int blocks, void* stream) {
  return nrv::sinkhorn_softmax_bwd_dispatch(logits, g, vecs, nullptr, ds, scratch, dtype, K,
                                            N, N, iters, final_row, 0, blocks, stream);
}

// The rectangular form: logits, g and ds [K, NR, NC]; va and vb from the
// forward.
extern "C" int nrv_sinkhorn_softmax_rect_bwd(const void* logits, const void* g,
                                             const void* va, const void* vb, void* ds,
                                             void* scratch, int dtype, int K, int NR, int NC,
                                             int iters, int final_row, int blocks,
                                             void* stream) {
  return nrv::sinkhorn_softmax_bwd_dispatch(logits, g, va, vb, ds, scratch, dtype, K, NR, NC,
                                            iters, final_row, 1, blocks, stream);
}
