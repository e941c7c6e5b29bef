// Talking-heads Sinkhorn, forward: dots [B, H, N, N] (float32 or bfloat16,
// math in float32) and the head mixes pre, post [H, H] (float32) in,
//   y_q = Σ_g post[g, q] · sinkhorn(softmax(Σ_h pre[h, g] · s_h))_g
// out (the dots' dtype), with the residual rows of each (image, mixed head)
// item that the backward rebuilds from.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// talking_heads.py::_th_fwd_impl (pl.pallas_call at :175; body
// _th_fwd_kernel around sinkhorn_softmax.py::_norm_fwd_math).
//
// Residuals, as there without the TPU's padding: one float32 stack
// [B·H, R, N] per (image, mixed head) item, the a-rows, the b-rows and lse
// (the square logits-interface kernel's layout).
//
// Design. The TPU kernel keeps an image's H planes resident at once and
// mixes them as scalar-scaled plane sums. One float32 196×196 plane is
// ~150 KB here, so an image's 8 planes do not fit the 227 KB a block may
// use. Two kernels instead:
//  1. talking_heads_fwd_kernel: one block per (image b, mixed head g)
//     item. Its load prologue forms m_g = Σ_h pre[h, g]·s_h from the
//     image's H planes straight into shared memory; the grid runs item
//     b·H + g, so an image's H items run together and its planes come
//     from L2 after the first read. Then the softmax and the Sinkhorn chain
//     of sinkhorn_chain.cuh, as the square logits-interface kernel runs
//     them, and w_g = e·a·b to a float32 scratch [B, H, N, N].
//  2. mix_planes_kernel: y_q = Σ_g post[g, q]·w_g, elementwise over the
//     planes, in runs of four.
// No cross-block reduction and no atomics: a run repeats bit for bit.
//
// What bounds it on the card (H100): the bytes. CaiT's dots
// [128, 8, 196, 196] float32 are 157.35 MB in and 157.35 MB out, so
// ≥ 0.094 ms at 3.35 TB/s; the float32 work, B·H·N²·(4 + 4·iters + 4·H)
// (the TPU kernel's own estimate), is ~1.9 GFLOP, 0.03 ms at 67 TFLOP/s.
// This design also writes and reads the scratch w (twice the bytes); a
// cluster holding an image's planes in distributed shared memory would
// keep w on the chip.
#include "talking_heads.cuh"

namespace nrv {

// Shared memory: the item's matrix (rows padded to a multiple of 4
// floats), then inv_r, a_scale and b (N each).
inline size_t talking_heads_fwd_smem_bytes(int n) {
  return sizeof(float) * ((size_t)n * padded_ld(n) + 3 * (size_t)n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
talking_heads_fwd_kernel(const T* __restrict__ s_all, const float* __restrict__ pre,
                         float* __restrict__ w_all, float* __restrict__ vecs, int H, int n,
                         int iters, int final_row) {
  extern __shared__ float smem[];
  __shared__ float coef[kMaxHeads];
  const int ld = padded_ld(n);
  float* E = smem;
  float* inv_r = E + (size_t)n * ld;
  float* a_scale = inv_r + n;
  float* bvec = a_scale + n;
  const int item = blockIdx.x, b = item / H, g = item % H;
  const size_t nn = (size_t)n * n;
  const int ka = num_arows(iters, final_row);
  if (threadIdx.x < H) coef[threadIdx.x] = pre[threadIdx.x * H + g];  // pre[:, g]
  __syncthreads();
  const ResidualRows<float> res = residual_rows(vecs, (float*)nullptr, item, n, n, iters, ka, 0);
  mix_load(s_all + (size_t)b * H * nn, nn, H, coef, n, ld, E, [](int, float x) { return x; });
  softmax_rows(E, n, n, ld, inv_r, res.lse);
  sinkhorn_forward_chain(E, n, n, ld, inv_r, iters, final_row != 0, a_scale, bvec, res.a, res.b);
  // w = (e · a_scale) · b, float32
  float* w = w_all + (size_t)item * nn;
  if (n % 4 == 0) {
    for (int r = threadIdx.x; r < n * n / 4; r += kThreads) {
      const int f = 4 * r, i = f / n, j = f - i * n;
      const float4 e = *reinterpret_cast<const float4*>(E + (size_t)i * ld + j);
      const float as = a_scale[i];
      store4(w + f, make_float4(e.x * as * bvec[j], e.y * as * bvec[j + 1],
                                e.z * as * bvec[j + 2], e.w * as * bvec[j + 3]));
    }
  } else {
    for (int f = threadIdx.x; f < n * n; f += kThreads) {
      const int i = f / n, j = f - i * n;
      w[f] = E[(size_t)i * ld + j] * a_scale[i] * bvec[j];
    }
  }
}

template <typename T>
int launch_talking_heads_fwd(const void* s, const void* pre, const void* post, void* out,
                             void* vecs, void* w, int B, int H, int n, int iters, int final_row,
                             cudaStream_t stream) {
  const size_t smem = talking_heads_fwd_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(talking_heads_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  talking_heads_fwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const float*>(pre), static_cast<float*>(w),
      static_cast<float*>(vecs), H, n, iters, final_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_mix_planes<T>(static_cast<const float*>(w), static_cast<const float*>(post),
                              static_cast<T*>(out), B, H, (size_t)n * n, 0, stream);
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. dots and out [B, H, N, N] in that dtype;
// pre and post float32 [H, H]; vecs float32 [B·H, R, N]; w a float32
// scratch [B, H, N, N]. Returns cudaGetLastError().
extern "C" int nrv_talking_heads_fwd(const void* dots, const void* pre, const void* post,
                                     void* out, void* vecs, void* w, int dtype, int B, int H,
                                     int N, int iters, int final_row, void* stream) {
  if (B < 1 || H < 1 || H > nrv::kMaxHeads || N < 2 || iters < 1 || iters > nrv::kMaxIters ||
      (final_row != 0 && final_row != 1))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_talking_heads_fwd<float>(dots, pre, post, out, vecs, w, B, H, N, iters,
                                                final_row, st);
  if (dtype == 1)
    return nrv::launch_talking_heads_fwd<__nv_bfloat16>(dots, pre, post, out, vecs, w, B, H, N,
                                                        iters, final_row, st);
  return (int)cudaErrorInvalidValue;
}
