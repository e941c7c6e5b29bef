// Softmax + Sinkhorn over precomputed logits, forward: logits [K, nr, nc]
// in, the doubly-stochastic weights out (same dtype, float32 or bfloat16,
// math in float32), with the residual rows the backward rebuilds from.
// Square matrices (nr = nc) and rectangular ones share the body.
//
// Replaces the TPU kernels noise_robust_vit_tpu/ops/pallas/
// sinkhorn_softmax.py::_sinkhorn_softmax_fwd_impl (pl.pallas_call at :229,
// square, body _norm_fwd_math) and ::_rect_fwd_impl (:497, rectangular,
// body _rect_fwd_math).
//
// Residual layout, as there (without the TPU's padding to 8): square, one
// float32 stack [K, R, N] of the a-rows, the b-rows and lse; rectangular,
// va [K, ka + 1, nr] (the a-rows, then lse) and vb [K, iters, nc] (the
// b-rows), ka = iters − 1 + final_row.
//
// Design. One (image, head) item per thread block at a time. The item's
// matrix is read from device memory once (runs of four elements), and
// e = exp(s − m) stays in shared memory for the whole chain: 38 KB at
// 49×196, 150 KB at 196×196. Row maxima and sums take one warp per row;
// the column sums of the chain deal the rows out to all eight warps
// (cols_partials), so a 49- or 16-wide matrix does not leave warps idle.
// The chain runs on vectors only, and out = e·a·b is written once, beside
// the residual rows. A matrix too large for one block's shared memory
// (square N above ~220, up to the gate's 640) lives in a global scratch
// slot instead, one per block of a grid that walks the items in turn.
// No cross-block reduction: every item is independent.
//
// What bounds it on the card (H100): the bytes. LeViT-128S's subsample
// logits [256, 8, 49, 196] float32 are 78.7 MB in and 78.7 MB out, so
// ≥ 0.047 ms at 3.35 TB/s; the float32 passes (exp, the chain's
// 2·iters + 1 matrix-vector products) are ~1.5 GFLOP, far below the
// CUDA cores' 67 TFLOP/s. The design reads and writes the N² matrix once
// each; the plain version reads it about 4·iters times.
#include "sinkhorn_softmax.cuh"

namespace nrv {

// Shared memory: the item's matrix (rows padded to a multiple of 4 floats)
// unless it lives in a scratch slot, then inv_r and a_scale (nr) and b (nc).
inline size_t sinkhorn_softmax_fwd_smem_bytes(int nr, int nc, bool matrix_in_smem) {
  return sizeof(float) * ((matrix_in_smem ? (size_t)nr * padded_ld(nc) : 0) +
                          2 * (size_t)nr + nc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
sinkhorn_softmax_fwd_kernel(const T* __restrict__ s_all, T* __restrict__ out_all,
                            float* __restrict__ va, float* __restrict__ vb,
                            float* __restrict__ scratch, int K, int nr, int nc,
                            int iters, int final_row, int rect) {
  extern __shared__ float smem[];
  const int ld = padded_ld(nc);
  float* E = scratch ? scratch + (size_t)blockIdx.x * nr * ld : smem;
  float* inv_r = scratch ? smem : smem + (size_t)nr * ld;
  float* a_scale = inv_r + nr;
  float* bvec = a_scale + nr;
  const int ka = num_arows(iters, final_row);
  for (int item = blockIdx.x; item < K; item += gridDim.x) {
    const size_t off = (size_t)item * nr * nc;
    const ResidualRows<float> res = residual_rows(va, vb, item, nr, nc, iters, ka, rect);
    load_matrix(s_all + off, nr, nc, ld, E, [](int, float x) { return x; });
    softmax_rows(E, nr, nc, ld, inv_r, res.lse);
    sinkhorn_forward_chain(E, nr, nc, ld, inv_r, iters, final_row != 0, a_scale, bvec,
                           res.a, res.b);
    // out = (e · a_scale) · b, in the dtype of the logits
    T* out = out_all + off;
    if (nc % 4 == 0) {
      for (int r = threadIdx.x; r < nr * nc / 4; r += kThreads) {
        const int f = 4 * r, i = f / nc, j = f - i * nc;
        const float4 e = *reinterpret_cast<const float4*>(E + (size_t)i * ld + j);
        const float as = a_scale[i];
        store4(out + f, make_float4(e.x * as * bvec[j], e.y * as * bvec[j + 1],
                                    e.z * as * bvec[j + 2], e.w * as * bvec[j + 3]));
      }
    } else {
      for (int f = threadIdx.x; f < nr * nc; f += kThreads) {
        const int i = f / nc, j = f - i * nc;
        store_f(out + f, E[(size_t)i * ld + j] * a_scale[i] * bvec[j]);
      }
    }
    __syncthreads();  // the next item overwrites E and the vectors
  }
}

template <typename T>
int launch_sinkhorn_softmax_fwd(const void* s, void* out, void* va, void* vb,
                                void* scratch, int K, int nr, int nc, int iters,
                                int final_row, int rect, int blocks,
                                cudaStream_t stream) {
  const size_t smem = sinkhorn_softmax_fwd_smem_bytes(nr, nc, scratch == nullptr);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_softmax_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_softmax_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(out), static_cast<float*>(va),
      static_cast<float*>(vb), static_cast<float*>(scratch), K, nr, nc, iters, final_row,
      rect);
  return (int)cudaGetLastError();
}

inline int sinkhorn_softmax_fwd_dispatch(const void* s, void* out, void* va, void* vb,
                                         void* scratch, int dtype, int K, int nr, int nc,
                                         int iters, int final_row, int rect, int blocks,
                                         void* stream) {
  if (K < 1 || nr < 1 || nc < 1 || iters < 1 || iters > kMaxIters || blocks < 1 ||
      (final_row != 0 && final_row != 1) || (!rect && nr != nc) || (rect && !vb))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sinkhorn_softmax_fwd<float>(s, out, va, vb, scratch, K, nr, nc, iters,
                                              final_row, rect, blocks, st);
  if (dtype == 1)
    return launch_sinkhorn_softmax_fwd<__nv_bfloat16>(s, out, va, vb, scratch, K, nr, nc,
                                                      iters, final_row, rect, blocks, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. logits and out [K, N, N]; vecs float32
// [K, R, N]. scratch is null when the matrix fits in shared memory, else
// `blocks` slots of N·padded_ld(N) floats. Returns cudaGetLastError().
extern "C" int nrv_sinkhorn_softmax_fwd(const void* logits, void* out, void* vecs,
                                        void* scratch, int dtype, int K, int N, int iters,
                                        int final_row, int blocks, void* stream) {
  return nrv::sinkhorn_softmax_fwd_dispatch(logits, out, vecs, nullptr, scratch, dtype, K,
                                            N, N, iters, final_row, 0, blocks, stream);
}

// The rectangular form: logits and out [K, NR, NC]; va float32
// [K, ka + 1, NR], vb float32 [K, iters, NC]; scratch as above with
// NR·padded_ld(NC) floats a slot.
extern "C" int nrv_sinkhorn_softmax_rect_fwd(const void* logits, void* out, void* va,
                                             void* vb, void* scratch, int dtype, int K,
                                             int NR, int NC, int iters, int final_row,
                                             int blocks, void* stream) {
  return nrv::sinkhorn_softmax_fwd_dispatch(logits, out, va, vb, scratch, dtype, K, NR, NC,
                                            iters, final_row, 1, blocks, stream);
}
