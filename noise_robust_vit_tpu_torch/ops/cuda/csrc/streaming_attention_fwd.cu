// Streaming q/k/v-interface Sinkhorn attention, forward: q [K, N, D],
// k, v [K, M, D] (float32 or bfloat16) → out [K, N, D] = a ⊙ (en · (b ⊙ v))
// with en = softmax(scale·q·kᵀ) scaled to the Sinkhorn schedule's
// a and b, and the residual vectors the backward rebuilds from. The N×M
// matrix never reaches device memory.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// streaming_sinkhorn.py::_stream_fwd_impl (pl.pallas_call at :397; body
// _stream_fwd_kernel).
//
// Residuals, float32, as there without the TPU's padding: av [K, 1 + n_av,
// N] (lse, then the n_av = iters − 1 + final_row a-vectors) and bv [K,
// iters, M] (the b-vectors).
//
// Sweeps over the item's query tiles (streaming_attention.cuh), each tile
// recomputing S = scale·q_t·kᵀ on the tensor cores:
//   0. e = exp(s − max), lse = max + log Σe, and the first column sum of
//      e/Σe (the first row norm is the identity after a softmax);
//   i. (one per further iteration) en = exp(s − lse), a = recip(en·b),
//      then the column sum of en ⊙ a;
//   out. en, the final a = recip(en·b) if any, out = a ⊙ (en·(b ⊙ v)).
// A row lies whole in its tile, so each row update rides the sweep of the
// next column sum: iters + 1 sweeps.
//
// Design against the card. The TPU kernel keeps an item's q, k, v in VMEM
// (2.4 MB at stage 1); a block here has 227 KB, so only the tile's rows of
// en (tq × M float32: 100 KB at CvT stage 1, tq = 32) stay on the chip, and
// k and v come from L2 at each tile. Column sums are carried in shared
// memory from tile to tile in order, inside the block: no cross-block
// reduction and no atomics, so a run repeats bit for bit. One block per
// item: 128 blocks at CvT stage 1 (one 8-warp block per SM, ~160 KB of
// shared memory), 384 at stage 2 (tq = 64, ~95 KB, two per SM).
//
// What bounds it on the card (H100): the operations. At CvT stage 1,
// batch 128, q·kᵀ and en·v are 2 × 40 GFLOP of products (bf16 tensor
// cores) and the exp and sums ~2.5 G float32 operations per sweep; the
// bytes (q, k, v, out in bf16, ~40 MB) take a tenth of that. The
// recomputes multiply the products by the number of sweeps.
#include "streaming_attention.cuh"

namespace nrv {

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
streaming_attention_fwd_kernel(const T* __restrict__ q_all, const T* __restrict__ k_all,
                               const T* __restrict__ v_all, T* __restrict__ out_all,
                               float* __restrict__ av_all, float* __restrict__ bv_all, int N,
                               int M, int D, float scale, int iters, int final_row, int tq) {
  extern __shared__ float smem[];
  const int ld = padded_ld(M);
  float* S = smem;
  float* G = S + (size_t)tq * ld;
  float* bsum = G + kGemmSmemFloats;
  float* bvec = bsum + M;
  float* lse_t = bvec + M;
  float* inv_r = lse_t + tq;
  float* a_t = inv_r + tq;
  const int item = blockIdx.x;
  const int n_av = num_arows(iters, final_row);
  const T* q = q_all + (size_t)item * N * D;
  const T* k = k_all + (size_t)item * M * D;
  const T* v = v_all + (size_t)item * M * D;
  T* out = out_all + (size_t)item * N * D;
  float* lse = av_all + (size_t)item * (1 + n_av) * N;
  float* arows = lse + N;  // a-vector j at arows + j·N
  float* brows = bv_all + (size_t)item * iters * M;

  auto zero_bsum = [&] {
    for (int j = threadIdx.x; j < M; j += kThreads) bsum[j] = 0.f;
    __syncthreads();
  };
  auto add_bsum = [&](int j, float s) { bsum[j] += s; };
  // b = recip(column sum) into bvec and the residual row
  auto close_b = [&](int it) {
    for (int j = threadIdx.x; j < M; j += kThreads) {
      const float b = recip_clamped(bsum[j]);
      bvec[j] = b;
      brows[(size_t)it * M + j] = b;
    }
    __syncthreads();
  };
  auto load_lse = [&](int t0, int rows) {
    for (int i = threadIdx.x; i < rows; i += kThreads) lse_t[i] = lse[t0 + i];
    __syncthreads();
  };
  // en = exp(scale·q·kᵀ − lse) over the tile, the scale applied after the
  // product as the plain version does
  auto en_tile = [&](int t0, int rows) {
    stream_nt(q + (size_t)t0 * D, k, rows, M, D, G, [=](int i, int j, float c) {
      S[(size_t)i * ld + j] = expf(c * scale - lse_t[i]);
    });
  };

  // sweep 0: per-row lse, and the column sum of e/Σe
  zero_bsum();
  for (int t0 = 0; t0 < N; t0 += tq) {
    const int rows = min(tq, N - t0);
    stream_nt(q + (size_t)t0 * D, k, rows, M, D, G,
              [=](int i, int j, float c) { S[(size_t)i * ld + j] = c * scale; });
    softmax_rows(S, rows, M, ld, inv_r, lse + t0);
    cols_dot(S, rows, M, ld, inv_r, add_bsum);
  }
  close_b(0);

  // one sweep per further iteration
  for (int it = 1; it < iters; ++it) {
    float* a_out = arows + (size_t)(it - 1) * N;
    zero_bsum();
    for (int t0 = 0; t0 < N; t0 += tq) {
      const int rows = min(tq, N - t0);
      load_lse(t0, rows);
      en_tile(t0, rows);
      rows_dot(S, rows, M, ld, bvec, [&](int i, float s) {
        const float a = recip_clamped(s);
        a_out[t0 + i] = a;
        a_t[i] = a;
      });
      cols_dot(S, rows, M, ld, a_t, add_bsum);
    }
    close_b(it);
  }

  // output sweep: out = a ⊙ (en · (b ⊙ v)); without a final row norm the
  // scaling is the last stored a (none at one iteration)
  float* a_fin = n_av ? arows + (size_t)(n_av - 1) * N : nullptr;
  for (int t0 = 0; t0 < N; t0 += tq) {
    const int rows = min(tq, N - t0);
    if (!final_row)
      for (int i = threadIdx.x; i < rows; i += kThreads) a_t[i] = a_fin ? a_fin[t0 + i] : 1.f;
    load_lse(t0, rows);
    en_tile(t0, rows);
    if (final_row)
      rows_dot(S, rows, M, ld, bvec, [&](int i, float s) {
        const float a = recip_clamped(s);
        a_fin[t0 + i] = a;
        a_t[i] = a;
      });
    T* o = out + (size_t)t0 * D;
    block_gemm<true, true>(
        rows, D, M, [=](int i, int kk) { return run4(S + (size_t)i * ld + kk); },
        [=](int kk, int j) { return run4(v + (size_t)kk * D + j, bvec[kk]); },
        [=](int i, int j, float c) { store_f(o + (size_t)i * D + j, a_t[i] * c); }, G);
  }
}

template <typename T>
int launch_streaming_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* av, void* bv, int K, int N, int M, int D, float scale,
                                   int iters, int final_row, int tq, cudaStream_t stream) {
  const size_t smem = sizeof(float) * stream_fwd_smem_floats(tq, M);
  cudaError_t err = cudaFuncSetAttribute(streaming_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  streaming_attention_fwd_kernel<T><<<K, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(av), static_cast<float*>(bv), N, M, D, scale,
      iters, final_row, tq);
  return (int)cudaGetLastError();
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. q and out [K, N, D], k and v [K, M, D] in
// that dtype (D a multiple of 4); av float32 [K, 1 + n_av, N], bv float32
// [K, iters, M]; tq the query tile's rows (stream_tile_fits). Returns
// cudaGetLastError().
extern "C" int nrv_streaming_attention_fwd(const void* q, const void* k, const void* v,
                                           void* out, void* av, void* bv, int dtype, int K,
                                           int N, int M, int D, float scale, int iters,
                                           int final_row, int tq, void* stream) {
  if (int err = nrv::stream_check(K, N, M, D, iters, final_row, tq)) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_streaming_attention_fwd<float>(q, k, v, out, av, bv, K, N, M, D, scale,
                                                      iters, final_row, tq, st);
  if (dtype == 1)
    return nrv::launch_streaming_attention_fwd<__nv_bfloat16>(q, k, v, out, av, bv, K, N, M,
                                                              D, scale, iters, final_row, tq,
                                                              st);
  return (int)cudaErrorInvalidValue;
}
