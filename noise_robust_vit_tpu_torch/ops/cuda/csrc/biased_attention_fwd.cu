// Biased (windowed) attention, forward: softmax, or softmax + Sinkhorn in
// scaling-vector form, of s = scale·q·kᵀ + bias, for the windowed models
// (Swin's relative-position bias plus shift mask, LeViT's and MaxViT's bias
// tables; Twins' local attention with no bias).
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/biased_attention.py
// ::_biased_fwd_impl (pl.pallas_call at :230), whose body is
// sinkhorn_attention.py::_fwd_math_batched with _add_bias.
//
// Layout: q, k [BW, H, N, D], v and out [BW, H, N, DV], contiguous; bias
// [nW, H, N, N] float32, window bw reading row bw % nW (null when there is
// no bias); residual stack vecs [BW, H, R, N] float32: a-rows, b-rows, lse
// (robust); lse alone (vanilla).
//
// Design. One thread block per (window, head) item; the grid holds all
// BW·H of them. A window is small (N = 49 or 64 in Swin, 196 in LeViT), so
// the item's N×N float32 matrix lives in shared memory (9.8 KB at N = 49,
// 16 KB at 64, 150 KB at 196), and every pass of the softmax and of the
// Sinkhorn chain reads it there, never device memory:
//   1. e ← scale·q·kᵀ + bias (block GEMM on the tensor cores, the bias added
//      in its epilogue, after the scale), then in place e = exp(s − m) per
//      row, with 1/r and lse = m + log r kept.
//   2. robust: the Sinkhorn chain on e (sinkhorn_chain.cuh). Column passes
//      deal the rows out to all eight warps (cols_dot), so a 49-wide window
//      does not leave six of them idle.
//   3. out = a_scale ⊙ (e·(b ⊙ v)) in the model dtype.
//
// What bounds it on the card (H100): the bytes. Swin-T stage 0 in bf16,
// [8192, 3, 49, 32] with nW = 64, robust (3, final), counting each byte
// once: q, k, v 231 MB, bias 1.8 MB, out 77 MB, residual rows 34 MB, so
// ~0.10 ms at 3.35 TB/s; the products are 7.6 GFLOP, ~8 µs at 989 TFLOP/s.
// With the matrix in shared memory the kernel reads q, k, v and the bias
// once and writes out and vecs once, but it runs ~17× above that bound
// (PERF.md): each item is a string of short phases with a barrier between
// them, and the latency of its loads from device memory is exposed. Four
// blocks per SM hide part of it. Next: several items per block, the next
// item's loads in flight while the current one's chain runs, and
// wgmma/TMA tiles in place of block_gemm's mma.sync (bf16 for q·kᵀ in a
// bf16 model, 3xTF32 otherwise).
#include "sinkhorn_chain.cuh"

namespace nrv {

// the item's matrix (rows padded to a multiple of 4 floats), the GEMM
// tiles, then inv_r, a_scale and b
inline size_t biased_fwd_smem_bytes(int n) {
  return sizeof(float) *
         ((size_t)n * padded_ld(n) + (size_t)kGemmSmemFloats + 3 * (size_t)n);
}

// Four blocks per SM (at most 64 registers a thread): per-item latency,
// not bytes, bounds this kernel, and four blocks hide more of it than two
// or three (PERF.md, tools/torch_biased_variants.py).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
biased_attention_fwd_kernel(const T* __restrict__ q_all, const T* __restrict__ k_all,
                            const T* __restrict__ v_all, const float* __restrict__ bias,
                            T* __restrict__ out, float* __restrict__ vecs, int H,
                            int N, int D, int DV, int nW, float scale, int robust,
                            int iters, int final_row) {
  extern __shared__ float smem[];
  const int ldn = padded_ld(N);
  float* E = smem;
  float* gemm_smem = E + (size_t)N * ldn;  // 16-byte aligned: ldn % 4 == 0
  float* inv_r = gemm_smem + kGemmSmemFloats;
  float* a_scale = inv_r + N;
  float* bvec = a_scale + N;
  const int R = num_vecs(iters, final_row, robust);

  const size_t item = blockIdx.x;  // bw·H + h
  const int bw = (int)(item / H), h = (int)(item % H);
  const T* q = q_all + item * N * D;
  const T* k = k_all + item * N * D;
  const T* v = v_all + item * N * DV;
  T* o = out + item * N * DV;
  float* vec = vecs + item * R * N;
  const float* bi = bias ? bias + ((size_t)(bw % nW) * H + h) * N * N : nullptr;

  block_gemm<true, false>(
      N, N, D, [=](int i, int c) { return run4(q + i * D + c); },
      [=](int c, int j) { return run4(k + j * D + c); },
      [=](int i, int j, float acc) {
        E[(size_t)i * ldn + j] = bi ? acc * scale + bi[i * N + j] : acc * scale;
      },
      gemm_smem);
  softmax_rows(E, N, N, ldn, inv_r, vec + (size_t)(R - 1) * N);
  if (robust) {
    sinkhorn_forward_chain(E, N, N, ldn, inv_r, iters, final_row != 0, a_scale, bvec, vec,
                           vec + (size_t)num_arows(iters, final_row) * N);
  } else {
    for (int i = threadIdx.x; i < N; i += kThreads) {
      a_scale[i] = inv_r[i];
      bvec[i] = 1.f;
    }
    __syncthreads();
  }
  block_gemm<true, true>(
      N, DV, N, [=](int i, int j) { return run4(E + (size_t)i * ldn + j); },
      [=](int j, int c) { return run4(v + j * DV + c, bvec[j]); },
      [=](int i, int c, float acc) { store_f(o + i * DV + c, acc * a_scale[i]); },
      gemm_smem);
}

template <typename T>
int launch_biased_fwd(const void* q, const void* k, const void* v, const void* bias,
                      void* out, void* vecs, int BW, int H, int N, int D, int DV,
                      int nW, float scale, int robust, int iters, int final_row,
                      cudaStream_t stream) {
  const size_t smem = biased_fwd_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(biased_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  biased_attention_fwd_kernel<T><<<BW * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), static_cast<float*>(vecs),
      H, N, D, DV, nW, scale, robust, iters, final_row);
  return (int)cudaGetLastError();
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16; bias null when there is none. Returns
// cudaGetLastError() after the launch.
extern "C" int nrv_biased_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, void* out, void* vecs,
                                        int dtype, int BW, int H, int N, int D, int DV,
                                        int nW, float scale, int robust, int iters,
                                        int final_row, void* stream) {
  if (BW < 1 || H < 1 || N < 1 || D < 1 || DV < 1 || nW < 1 || BW % nW ||
      iters < 1 || iters > nrv::kMaxIters)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_biased_fwd<float>(q, k, v, bias, out, vecs, BW, H, N, D, DV, nW,
                                         scale, robust, iters, final_row, s);
  if (dtype == 1)
    return nrv::launch_biased_fwd<__nv_bfloat16>(q, k, v, bias, out, vecs, BW, H, N, D,
                                                 DV, nW, scale, robust, iters,
                                                 final_row, s);
  return (int)cudaErrorInvalidValue;
}
