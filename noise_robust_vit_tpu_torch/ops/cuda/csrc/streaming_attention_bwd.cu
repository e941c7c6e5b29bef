// Streaming q/k/v-interface Sinkhorn attention, backward: (q, k, v, the
// upstream gradient g, the residual vectors) → (dq, dk, dv), the
// hand-derived gradient of streaming_attention_fwd.cu, again without the N×M
// matrix in device memory.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// streaming_sinkhorn.py::_stream_bwd_impl (pl.pallas_call at :449; body
// _stream_bwd_kernel).
//
// Sweeps over the item's query tiles, each recomputing en = exp(s − lse):
//   B1. ev = en·(b_F ⊙ v) (o / a_F, so that no output is kept), go =
//       rowsum(a_F·g ⊙ ev), T += enᵀ·(a_F ⊙ g); with a final row norm
//       du_F = −go·a_F and its column sum dcol. Then dv = b_F ⊙ T and
//       db = rowsum(v ⊙ T) + dcol, the gradient of the last b.
//   chain. For b_i, i = iters − 1 … 1: dw = −db·b_i², da = en·dw (plus
//       go / a_F at the head of a schedule without a final row norm),
//       du = −da·a², and the next db = enᵀ·du. Each link adds the rank-1
//       terms (a_{i−1}, dw) and (du, b_{i−1}); b_0 closes with (1, dw_0).
//   final. ρ = Σ_k u_k ⊙ (en·w_k) + go, ds = en ⊙ (Σ_k u_k w_kᵀ +
//       (a_F ⊙ g)·(b_F ⊙ v)ᵀ − ρ), dq = scale·ds·k, dK += scale·dsᵀ·q_t.
// iters + 2 sweeps; the (3, final) schedule has 6 rank-1 terms.
//
// Design against the card. The TPU kernel keeps dv's and dk's [M, D]
// float32 accumulators in VMEM (200 KB each at CvT stage 1). They do not
// fit beside a tile here, so each item has one float32 slot [M, D] in
// device memory (the wrapper's scratch), used for T in B1 and for dK in the
// final sweep: every tile adds its product to it in the GEMM's epilogue,
// each entry by the one thread that owns it, so the sum runs in tile order
// and a run repeats bit for bit. The 128 items' slots at stage 1 (25.7 MB)
// stay in L2 with k and v. The row vectors that outlive a sweep (go and the
// du-vectors, N each) go to a second scratch; the rank-1 column factors
// (2·iters vectors of M) stay in shared memory, where the final sweep's
// epilogue reads them for every entry. One block per item, as the forward.
//
// What bounds it on the card (H100): the operations, as the forward: at
// CvT stage 1, batch 128, q·kᵀ (recomputed each sweep), o/a, dA, T, dq and
// dk are 6 products of 40 GFLOP, and the float32 passes over the N×M
// entries ~2.5 G operations each.
#include "streaming_attention.cuh"

namespace nrv {

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
streaming_attention_bwd_kernel(const T* __restrict__ q_all, const T* __restrict__ k_all,
                               const T* __restrict__ v_all, const T* __restrict__ g_all,
                               const float* __restrict__ av_all, const float* __restrict__ bv_all,
                               T* __restrict__ dq_all, T* __restrict__ dk_all,
                               T* __restrict__ dv_all, float* __restrict__ acc_all,
                               float* __restrict__ rows_all, int N, int M, int D, float scale,
                               int iters, int final_row, int tq) {
  extern __shared__ float smem[];
  __shared__ const float* trow[kMaxTerms];  // rank-1 row factors (null: ones)
  const int ld = padded_ld(M);
  const int nt_max = 2 * iters;
  float* S = smem;
  float* G = S + (size_t)tq * ld;
  float* ev = G + kGemmSmemFloats;  // [tq, D]
  float* dcur = ev + (size_t)tq * D;  // db, then the next link's column sum
  float* dcol = dcur + M;
  float* bF = dcol + M;
  float* qs = bF + M;  // rank-1 column factors [nt_max, M]
  float* lse_t = qs + (size_t)nt_max * M;
  float* aF_t = lse_t + tq;
  float* go_t = aF_t + tq;
  float* rho_t = go_t + tq;
  float* a_t = rho_t + tq;
  float* du_t = a_t + tq;
  float* pt = du_t + tq;  // rank-1 row factors of the tile [nt_max, tq]

  const int item = blockIdx.x;
  const int n_av = num_arows(iters, final_row);
  const size_t nd = (size_t)N * D, md = (size_t)M * D;
  const T* q = q_all + item * nd;
  const T* k = k_all + item * md;
  const T* v = v_all + item * md;
  const T* g = g_all + item * nd;
  T* dq = dq_all + item * nd;
  const float* lse = av_all + (size_t)item * (1 + n_av) * N;
  const float* arows = lse + N;
  const float* aF = n_av ? arows + (size_t)(n_av - 1) * N : nullptr;
  const float* brows = bv_all + (size_t)item * iters * M;
  float* acc = acc_all + item * md;
  float* go = rows_all + (size_t)item * (1 + iters) * N;
  float* dus = go + N;  // the du-vectors, N each

  for (size_t idx = threadIdx.x; idx < md; idx += kThreads) acc[idx] = 0.f;
  for (int j = threadIdx.x; j < M; j += kThreads) {
    bF[j] = brows[(size_t)(iters - 1) * M + j];
    dcol[j] = 0.f;
  }
  __syncthreads();

  auto load_rows = [&](int t0, int rows) {
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      lse_t[i] = lse[t0 + i];
      aF_t[i] = aF ? aF[t0 + i] : 1.f;
    }
  };
  auto en_tile = [&](int t0, int rows) {
    __syncthreads();
    stream_nt(q + (size_t)t0 * D, k, rows, M, D, G, [=](int i, int j, float c) {
      S[(size_t)i * ld + j] = expf(c * scale - lse_t[i]);
    });
  };

  // ---- B1
  for (int t0 = 0; t0 < N; t0 += tq) {
    const int rows = min(tq, N - t0);
    const T* gt = g + (size_t)t0 * D;
    load_rows(t0, rows);
    en_tile(t0, rows);
    block_gemm<true, true>(
        rows, D, M, [=](int i, int kk) { return run4(S + (size_t)i * ld + kk); },
        [=](int kk, int j) { return run4(v + (size_t)kk * D + j, bF[kk]); },
        [=](int i, int j, float c) { ev[(size_t)i * D + j] = c; }, G);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = warp; i < rows; i += kWarps) {
      float s = 0.f;
      for (int j = lane; j < D; j += 32) s += aF_t[i] * to_f(gt[(size_t)i * D + j]) * ev[(size_t)i * D + j];
      s = warp_sum(s);
      if (lane == 0) {
        go_t[i] = s;
        go[t0 + i] = s;
        const float du = -s * aF_t[i];  // du_F = −da_F·a_F² with da_F = go / a_F
        du_t[i] = du;
        if (final_row) dus[t0 + i] = du;
      }
    }
    __syncthreads();
    block_gemm<false, true>(
        M, D, rows, [=](int i, int kk) { return run4(S + (size_t)kk * ld + i); },
        [=](int kk, int j) { return run4(gt + (size_t)kk * D + j, aF_t[kk]); },
        [=](int i, int j, float c) { acc[(size_t)i * D + j] += c; }, G);
    if (final_row) cols_dot(S, rows, M, ld, du_t, [&](int j, float s) { dcol[j] += s; });
  }
  {
    T* dv = dv_all + item * md;
    for (size_t idx = threadIdx.x; idx < md; idx += kThreads)
      store_f(dv + idx, bF[idx / D] * acc[idx]);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int m = warp; m < M; m += kWarps) {
      float s = 0.f;
      for (int j = lane; j < D; j += 32) s += to_f(v[(size_t)m * D + j]) * acc[(size_t)m * D + j];
      s = warp_sum(s);
      if (lane == 0) dcur[m] = s + dcol[m];
    }
    __syncthreads();
    for (size_t idx = threadIdx.x; idx < md; idx += kThreads) acc[idx] = 0.f;
  }
  int nt = 0, ndu = 0;
  if (final_row) {
    for (int j = threadIdx.x; j < M; j += kThreads) qs[j] = bF[j];
    if (threadIdx.x == 0) trow[0] = dus;
    nt = ndu = 1;
  }
  __syncthreads();

  // ---- the reverse chain: one fused sweep per b_i, i = iters − 1 … 1
  for (int i = iters - 1; i >= 1; --i) {
    const float* bi = brows + (size_t)i * M;
    const float* a_prev = arows + (size_t)(i - 1) * N;
    float* dw = qs + (size_t)nt * M;
    float* du_out = dus + (size_t)ndu * N;
    const bool head = !final_row && i == iters - 1;
    for (int j = threadIdx.x; j < M; j += kThreads) dw[j] = -dcur[j] * bi[j] * bi[j];
    if (threadIdx.x == 0) trow[nt] = a_prev;
    __syncthreads();
    for (int j = threadIdx.x; j < M; j += kThreads) dcur[j] = 0.f;
    for (int t0 = 0; t0 < N; t0 += tq) {
      const int rows = min(tq, N - t0);
      load_rows(t0, rows);
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        a_t[r] = a_prev[t0 + r];
        go_t[r] = go[t0 + r];
      }
      en_tile(t0, rows);
      rows_dot(S, rows, M, ld, dw, [&](int r, float s) {
        const float da = head ? s + go_t[r] / aF_t[r] : s;
        const float du = -da * a_t[r] * a_t[r];
        du_t[r] = du;
        du_out[t0 + r] = du;
      });
      cols_dot(S, rows, M, ld, du_t, [&](int j, float s) { dcur[j] += s; });
    }
    float* qb = qs + (size_t)(nt + 1) * M;
    for (int j = threadIdx.x; j < M; j += kThreads) qb[j] = brows[(size_t)(i - 1) * M + j];
    if (threadIdx.x == 0) trow[nt + 1] = du_out;
    nt += 2;
    ++ndu;
    __syncthreads();
  }
  // b_0 = recip(colsum(en)): its row side is the constant ones
  {
    float* dw0 = qs + (size_t)nt * M;
    for (int j = threadIdx.x; j < M; j += kThreads) dw0[j] = -dcur[j] * brows[j] * brows[j];
    if (threadIdx.x == 0) trow[nt] = nullptr;
    ++nt;
    __syncthreads();
  }

  // ---- final sweep: ds = en ⊙ (Σ_k u_k w_kᵀ + (a_F ⊙ g)·(b_F ⊙ v)ᵀ − ρ) in
  // place of en, then dq and dK
  for (int t0 = 0; t0 < N; t0 += tq) {
    const int rows = min(tq, N - t0);
    const T* qt = q + (size_t)t0 * D;
    const T* gt = g + (size_t)t0 * D;
    load_rows(t0, rows);
    for (int idx = threadIdx.x; idx < nt * tq; idx += kThreads) {
      const int kt = idx / tq, r = idx % tq;
      if (r < rows) pt[idx] = trow[kt] ? trow[kt][t0 + r] : 1.f;
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) go_t[r] = go[t0 + r];
    en_tile(t0, rows);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < rows; r += kWarps) {
      float eq[kMaxTerms];
#pragma unroll
      for (int kt = 0; kt < kMaxTerms; ++kt) eq[kt] = 0.f;
      for (int j = lane; j < M; j += 32) {
        const float e = S[(size_t)r * ld + j];
#pragma unroll
        for (int kt = 0; kt < kMaxTerms; ++kt)
          if (kt < nt) eq[kt] = fmaf(e, qs[(size_t)kt * M + j], eq[kt]);
      }
      float rho = 0.f;
#pragma unroll
      for (int kt = 0; kt < kMaxTerms; ++kt)
        if (kt < nt) rho += pt[kt * tq + r] * warp_sum(eq[kt]);
      if (lane == 0) rho_t[r] = rho + go_t[r];
    }
    __syncthreads();
    // the direct term (a_F ⊙ g)·(b_F ⊙ v)ᵀ as a_F[i]·b_F[j]·(g·vᵀ)[i, j]: g and
    // v as they come, so bf16 ones take the exact bf16 product
    stream_nt(gt, v, rows, M, D, G, [=](int i, int j, float c) {
      float r1 = 0.f;
      for (int kt = 0; kt < nt; ++kt) r1 = fmaf(pt[kt * tq + i], qs[(size_t)kt * M + j], r1);
      float* e = S + (size_t)i * ld + j;
      *e = *e * ((r1 + aF_t[i] * bF[j] * c) - rho_t[i]);
    });
    block_gemm<true, true>(
        rows, D, M, [=](int i, int kk) { return run4(S + (size_t)i * ld + kk); },
        [=](int kk, int j) { return run4(k + (size_t)kk * D + j); },
        [=](int i, int j, float c) { store_f(dq + (size_t)(t0 + i) * D + j, scale * c); }, G);
    block_gemm<false, true>(
        M, D, rows, [=](int i, int kk) { return run4(S + (size_t)kk * ld + i); },
        [=](int kk, int j) { return run4(qt + (size_t)kk * D + j); },
        [=](int i, int j, float c) { acc[(size_t)i * D + j] += scale * c; }, G);
  }
  T* dk = dk_all + item * md;
  for (size_t idx = threadIdx.x; idx < md; idx += kThreads) store_f(dk + idx, acc[idx]);
}

template <typename T>
int launch_streaming_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   const void* av, const void* bv, void* dq, void* dk, void* dv,
                                   void* acc, void* rows, int K, int N, int M, int D,
                                   float scale, int iters, int final_row, int tq,
                                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * stream_bwd_smem_floats(tq, M, D, iters);
  cudaError_t err = cudaFuncSetAttribute(streaming_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  streaming_attention_bwd_kernel<T><<<K, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(av), static_cast<const float*>(bv),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(acc),
      static_cast<float*>(rows), N, M, D, scale, iters, final_row, tq);
  return (int)cudaGetLastError();
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. q, g, dq [K, N, D]; k, v, dk, dv [K, M, D]
// in that dtype; av and bv float32 from the forward. Scratch: acc float32
// [K, M, D] and rows float32 [K, 1 + iters, N]. tq as the forward's.
// Returns cudaGetLastError().
extern "C" int nrv_streaming_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* g, const void* av, const void* bv,
                                           void* dq, void* dk, void* dv, void* acc, void* rows,
                                           int dtype, int K, int N, int M, int D, float scale,
                                           int iters, int final_row, int tq, void* stream) {
  if (int err = nrv::stream_check(K, N, M, D, iters, final_row, tq)) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_streaming_attention_bwd<float>(q, k, v, g, av, bv, dq, dk, dv, acc, rows,
                                                      K, N, M, D, scale, iters, final_row, tq,
                                                      st);
  if (dtype == 1)
    return nrv::launch_streaming_attention_bwd<__nv_bfloat16>(q, k, v, g, av, bv, dq, dk, dv,
                                                              acc, rows, K, N, M, D, scale,
                                                              iters, final_row, tq, st);
  return (int)cudaErrorInvalidValue;
}
