// Packed-qkv attention, forward, scratch branch: softmax, or softmax +
// Sinkhorn in scaling-vector form, read in place from the [B, N, 3·H·D]
// output of to_qkv and written as the [B, N, H·D] input of to_out. It
// takes the shapes the resident kernels (packed_resident_fwd.cu: bf16,
// D = 64, N ≤ 198, the N×N matrix in shared memory) do not: float32, N
// above their range, D = 32 or 128 (ops/cuda/packed_attention.py::
// packed_branch).
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/block_attention.py
// ::_packed_fwd_impl (pl.pallas_call at :234), whose body is
// sinkhorn_attention.py::_fwd_math_batched.
//
// Design. One thread block per (image, head) at a time; a grid of n_slots
// blocks walks all B·H of them, and each block owns one N×N float32 slot of
// a global scratch (rows padded to a multiple of 4 floats). q, k and v are
// read straight from the packed tensor by stride (q at column h·D, k at
// H·D + h·D, v at 2·H·D + h·D): no host-side split, transpose or pad. N is
// not padded, so no row or column needs a mask.
//   1. e ← scale·q·kᵀ (block GEMM on the tensor cores), then in place
//      e = exp(s − m) per row, with 1/r and lse = m + log r kept.
//   2. robust: the Sinkhorn chain on e (sinkhorn_chain.cuh).
//   3. out = a_scale ⊙ (e·(b ⊙ v)) in the model dtype.
// Residual stack vecs [B, H, R, N] float32: a-rows, b-rows, lse (robust);
// lse alone (vanilla).
//
// What bounds it on the card (H100, PERF.md): the two products (4·N²·D
// flops per head) run on the tensor cores with float32-level accuracy:
// q·kᵀ as bf16 mma.sync in a bf16 model (its products are exact), e·(b⊙v)
// and every float32 product as 3xTF32. Cutting q·kᵀ from six MMAs per
// 16-deep slice to one saved only 7-10% of the kernel, which suggests the
// products are bound less by the MMAs than by moving their tiles through
// shared memory.
// Softmax and the chain are passes over the N×N slot, bound by device-memory
// bandwidth because the slots of the blocks in flight (2 per SM) do not stay
// in L2. That holds on this branch only: the resident kernels keep the
// matrix in shared memory and take their tiles by TMA into wgmma.
#include "sinkhorn_chain.cuh"

namespace nrv {

// GEMM tiles, then inv_r, a_scale and b
inline size_t fwd_smem_bytes(int n) {
  return sizeof(float) * ((size_t)kGemmSmemFloats + 3 * (size_t)n);
}

// Two blocks per SM: at most 128 registers a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
packed_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                            float* __restrict__ vecs, float* __restrict__ scratch,
                            int B, int N, int H, int D, float scale, int robust,
                            int iters, int final_row) {
  extern __shared__ float smem[];
  float* gemm_smem = smem;
  float* inv_r = smem + kGemmSmemFloats;
  float* a_scale = inv_r + N;
  float* bvec = a_scale + N;
  const int ldn = padded_ld(N);
  float* E = scratch + (size_t)blockIdx.x * N * ldn;
  const size_t ld = 3 * (size_t)H * D;  // row stride of the packed qkv
  const size_t ld_out = (size_t)H * D;
  const int R = num_vecs(iters, final_row, robust);
  for (int bh = blockIdx.x; bh < B * H; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    const T* q = qkv + (size_t)b * N * ld + (size_t)h * D;
    const T* k = q + (size_t)H * D;
    const T* v = q + 2 * (size_t)H * D;
    float* vec = vecs + (size_t)bh * R * N;
    T* o = out + (size_t)b * N * ld_out + (size_t)h * D;

    block_gemm<true, false>(
        N, N, D, [=](int i, int c) { return run4(q + i * ld + c); },
        [=](int c, int j) { return run4(k + j * ld + c); },
        [=](int i, int j, float acc) { E[(size_t)i * ldn + j] = acc * scale; },
        gemm_smem);
    softmax_rows(E, N, N, ldn, inv_r, vec + (size_t)(R - 1) * N);
    if (robust) {
      sinkhorn_forward_chain(E, N, N, ldn, inv_r, iters, final_row != 0, a_scale, bvec,
                             vec, vec + (size_t)num_arows(iters, final_row) * N);
    } else {
      for (int i = threadIdx.x; i < N; i += kThreads) {
        a_scale[i] = inv_r[i];
        bvec[i] = 1.f;
      }
      __syncthreads();
    }
    block_gemm<true, true>(
        N, D, N, [=](int i, int j) { return run4(E + (size_t)i * ldn + j); },
        [=](int j, int c) { return run4(v + j * ld + c, bvec[j]); },
        [=](int i, int c, float acc) { store_f(o + i * ld_out + c, acc * a_scale[i]); },
        gemm_smem);
  }
}

template <typename T>
int launch_fwd(const void* qkv, void* out, void* vecs, void* scratch, int B,
               int N, int H, int D, float scale, int robust, int iters,
               int final_row, int n_slots, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(packed_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  packed_attention_fwd_kernel<T><<<n_slots, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), static_cast<float*>(vecs),
      static_cast<float*>(scratch), B, N, H, D, scale, robust, iters, final_row);
  return (int)cudaGetLastError();
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int nrv_packed_attention_fwd(const void* qkv, void* out, void* vecs,
                                        void* scratch, int dtype, int B, int N,
                                        int H, int D, float scale, int robust,
                                        int iters, int final_row, int n_slots,
                                        void* stream) {
  if (B < 1 || N < 1 || H < 1 || D < 1 || n_slots < 1 || iters < 1 ||
      iters > nrv::kMaxIters)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_fwd<float>(qkv, out, vecs, scratch, B, N, H, D, scale,
                                  robust, iters, final_row, n_slots, s);
  if (dtype == 1)
    return nrv::launch_fwd<__nv_bfloat16>(qkv, out, vecs, scratch, B, N, H, D,
                                          scale, robust, iters, final_row, n_slots, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nrv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
