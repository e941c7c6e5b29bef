// Packed-qkv attention, backward, scratch branch: the hand-derived gradient
// of the forward in packed_attention_fwd.cu, from the stored residual rows,
// written straight into a packed [B, N, 3·H·D] gradient (dq | dk | dv
// chunks, the layout the to_qkv backward consumes). It takes the shapes
// the resident kernels (packed_resident_bwd.cu) do not, as the forward.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/block_attention.py
// ::_packed_bwd_impl (pl.pallas_call at :284), whose body is
// sinkhorn_attention.py::_bwd_math_batched.
//
// Forward is O = diag(a)·A·diag(b)·V with A the row softmax. Per (image,
// head), in one thread block that owns a slot of the global scratch
// (attn N×N and dA/dS N×N with rows padded to a multiple of 4 floats, two
// N×D float32 buffers):
//   attn = exp(scale·q·kᵀ − lse)            (one exp, in the GEMM epilogue)
//   vanilla: dV = Aᵀ·G, dA = G·Vᵀ, dS = A ⊙ (dA − rowsum(dA ⊙ A)).
//   robust:  o/a = A·(b⊙V), t1 = Aᵀ·(a⊙G), dV = b ⊙ t1,
//            dA = (a⊙G)·(b⊙V)ᵀ, da = rowsum(G ⊙ o/a), db = rowsum(t1 ⊙ V),
//            the reverse chain (sinkhorn_chain.cuh) with its rank-1 dA terms
//            applied once, dS = A ⊙ ((dA − row term) + Σ u_k v_kᵀ).
//   dQ = scale·dS·K, dK = scale·dSᵀ·Q.
//
// What bounds it on the card: as the forward (packed_attention_fwd.cu), the
// products (six per head, five when vanilla; q·kᵀ and G·Vᵀ as bf16 MMAs in
// a bf16 model, the rest 3xTF32) by moving their tiles, and the chain's
// 2·iters passes over attn by device-memory bandwidth. The latter holds on
// this branch only: the resident kernels keep attn in shared memory.
#include "sinkhorn_chain.cuh"

namespace nrv {

// GEMM tiles, then ones, the ka a-rows, the iters b-rows, da, db_row, svec,
// m_dc, row_term, and the iters dc and iters dr vectors of the chain
inline size_t bwd_smem_bytes(int n, int iters) {
  const int ka = iters;  // upper bound of iters − 1 + final_row
  const size_t vectors = 1 + (size_t)ka + iters + 5 + 2 * (size_t)iters;
  return sizeof(float) * ((size_t)kGemmSmemFloats + vectors * n);
}

// Two blocks per SM: at most 128 registers a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
packed_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                            const float* __restrict__ vecs, T* __restrict__ dqkv,
                            float* __restrict__ scratch, int B, int N, int H,
                            int D, float scale, int robust, int iters,
                            int final_row) {
  extern __shared__ float smem[];
  __shared__ int s_tu[kMaxTerms], s_tv[kMaxTerms];
  float* gemm_smem = smem;
  const int ka = robust ? (iters > 1 ? iters - 1 : 0) + final_row : 0;
  float* vbase = smem + kGemmSmemFloats;
  float* ones = vbase;
  float* arows = ones + N;
  float* brows = arows + (size_t)ka * N;
  float* da = brows + (size_t)iters * N;
  float* db_row = da + N;
  float* svec = db_row + N;
  float* m_dc = svec + N;
  float* row_term = m_dc + N;
  float* dcs = row_term + N;
  float* drs = dcs + (size_t)iters * N;

  const int ldn = padded_ld(N);
  float* P = scratch + (size_t)blockIdx.x * (2 * (size_t)N * ldn + 2 * (size_t)N * D);
  float* dS = P + (size_t)N * ldn;
  float* OA = dS + (size_t)N * ldn;
  float* T1 = OA + (size_t)N * D;
  const size_t ld = 3 * (size_t)H * D;  // row stride of the packed qkv / dqkv
  const size_t ld_g = (size_t)H * D;    // row stride of dout
  const int R = num_vecs(iters, final_row, robust);

  for (int bh = blockIdx.x; bh < B * H; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    const T* q = qkv + (size_t)b * N * ld + (size_t)h * D;
    const T* k = q + (size_t)H * D;
    const T* v = q + 2 * (size_t)H * D;
    const T* g = dout + (size_t)b * N * ld_g + (size_t)h * D;
    T* dq = dqkv + (size_t)b * N * ld + (size_t)h * D;
    T* dk = dq + (size_t)H * D;
    T* dv = dq + 2 * (size_t)H * D;
    const float* vec = vecs + (size_t)bh * R * N;
    const float* lse = vec + (size_t)(R - 1) * N;

    // attn = exp(scale·q·kᵀ − lse): the stored log-normalizer replaces the
    // max/sum replay
    block_gemm<true, false>(
        N, N, D, [=](int i, int c) { return run4(q + i * ld + c); },
        [=](int c, int j) { return run4(k + j * ld + c); },
        [=](int i, int j, float acc) { P[(size_t)i * ldn + j] = expf(acc * scale - lse[i]); },
        gemm_smem);

    if (!robust) {
      block_gemm<false, true>(  // dV = Aᵀ·G
          N, D, N, [=](int j, int i) { return run4(P + (size_t)i * ldn + j); },
          [=](int i, int c) { return run4(g + i * ld_g + c); },
          [=](int j, int c, float acc) { store_f(dv + j * ld + c, acc); }, gemm_smem);
      block_gemm<true, false>(  // dA = G·Vᵀ
          N, N, D, [=](int i, int c) { return run4(g + i * ld_g + c); },
          [=](int c, int j) { return run4(v + j * ld + c); },
          [=](int i, int j, float acc) { dS[(size_t)i * ldn + j] = acc; }, gemm_smem);
      // dS = A ⊙ (dA − rowsum(dA ⊙ A)): one warp owns each row
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int i = warp; i < N; i += kWarps) {
        const float* pa = P + (size_t)i * ldn;
        float* pd = dS + (size_t)i * ldn;
        const float s = warp_dot(pd, pa, N);
        for (int j0 = lane; j0 < N; j0 += kColBlock) {
          float a[kCols], d[kCols];
#pragma unroll
          for (int u = 0; u < kCols; ++u) {
            const int j = j0 + 32 * u;
            a[u] = j < N ? pa[j] : 0.f;
            d[u] = j < N ? pd[j] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kCols; ++u) {
            const int j = j0 + 32 * u;
            if (j < N) pd[j] = a[u] * (d[u] - s);
          }
        }
      }
      __syncthreads();
    } else {
      // scaling vectors from the residual stack (_restore_vec_rows)
      for (int i = threadIdx.x; i < N; i += kThreads) ones[i] = 1.f;
      for (int idx = threadIdx.x; idx < (ka + iters) * N; idx += kThreads)
        arows[idx] = vec[idx];  // arows and brows are adjacent, as in vecs
      __syncthreads();
      const float* a_fin = ka > 0 ? arows + (size_t)(ka - 1) * N : ones;
      const float* b_fin = brows + (size_t)(iters - 1) * N;

      block_gemm<true, true>(  // o/a = A·(b⊙V)
          N, D, N, [=](int i, int j) { return run4(P + (size_t)i * ldn + j); },
          [=](int j, int c) { return run4(v + j * ld + c, b_fin[j]); },
          [=](int i, int c, float acc) { OA[(size_t)i * D + c] = acc; }, gemm_smem);
      block_gemm<false, true>(  // t1 = Aᵀ·(a⊙G)
          N, D, N, [=](int j, int i) { return run4(P + (size_t)i * ldn + j); },
          [=](int i, int c) { return run4(g + i * ld_g + c, a_fin[i]); },
          [=](int j, int c, float acc) { T1[(size_t)j * D + c] = acc; }, gemm_smem);
      block_gemm<true, false>(  // direct dA = (a⊙G)·(b⊙V)ᵀ = a ⊙ (G·Vᵀ) ⊙ b
          N, N, D, [=](int i, int c) { return run4(g + i * ld_g + c); },
          [=](int c, int j) { return run4(v + j * ld + c); },
          [=](int i, int j, float acc) { dS[(size_t)i * ldn + j] = a_fin[i] * acc * b_fin[j]; },
          gemm_smem);

      // da = rowsum(G ⊙ o/a), db = rowsum(t1 ⊙ V), dV = b ⊙ t1
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int i = warp; i < N; i += kWarps) {
        float sa = 0.f, sb = 0.f;
        for (int c = lane; c < D; c += 32) {
          const float t1 = T1[(size_t)i * D + c];
          sa = fmaf(to_f(g[i * ld_g + c]), OA[(size_t)i * D + c], sa);
          sb = fmaf(t1, to_f(v[i * ld + c]), sb);
          store_f(dv + i * ld + c, b_fin[i] * t1);
        }
        sa = warp_sum(sa);
        sb = warp_sum(sb);
        if (lane == 0) {
          da[i] = sa;
          db_row[i] = sb;
        }
      }
      __syncthreads();

      const int nt = sinkhorn_reverse_chain(P, N, N, ldn, iters, final_row != 0, vbase,
                                            ones, arows, brows, da, db_row,
                                            svec, m_dc, dcs, drs, s_tu, s_tv);
      // row term = rowsum(direct dA ⊙ A) + svec, with rowsum(dA ⊙ A) =
      // a_fin ⊙ da by identity (no N² reduce)
      for (int i = threadIdx.x; i < N; i += kThreads)
        row_term[i] = a_fin[i] * da[i] + svec[i];
      __syncthreads();
      // dS = A ⊙ ((dA − row term) + Σ_k u_k v_kᵀ)
      for (int i = warp; i < N; i += kWarps) {
        const float* pa = P + (size_t)i * ldn;
        float* pd = dS + (size_t)i * ldn;
        const float rt = row_term[i];
        for (int j0 = lane; j0 < N; j0 += kColBlock) {
          float a[kCols], d[kCols];
#pragma unroll
          for (int u = 0; u < kCols; ++u) {
            const int j = j0 + 32 * u;
            a[u] = j < N ? pa[j] : 0.f;
            d[u] = j < N ? pd[j] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kCols; ++u) {
            const int j = j0 + 32 * u;
            if (j < N) {
              float r1 = 0.f;
              for (int t = 0; t < nt; ++t)
                r1 = fmaf(vbase[s_tu[t] + i], vbase[s_tv[t] + j], r1);
              pd[j] = a[u] * ((d[u] - rt) + r1);
            }
          }
        }
      }
      __syncthreads();
    }

    block_gemm<true, true>(  // dQ = scale·dS·K
        N, D, N, [=](int i, int j) { return run4(dS + (size_t)i * ldn + j); },
        [=](int j, int c) { return run4(k + j * ld + c); },
        [=](int i, int c, float acc) { store_f(dq + i * ld + c, scale * acc); }, gemm_smem);
    block_gemm<false, true>(  // dK = scale·dSᵀ·Q
        N, D, N, [=](int j, int i) { return run4(dS + (size_t)i * ldn + j); },
        [=](int i, int c) { return run4(q + i * ld + c); },
        [=](int j, int c, float acc) { store_f(dk + j * ld + c, scale * acc); }, gemm_smem);
  }
}

template <typename T>
int launch_bwd(const void* qkv, const void* dout, const void* vecs, void* dqkv,
               void* scratch, int B, int N, int H, int D, float scale, int robust,
               int iters, int final_row, int n_slots, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(N, iters);
  cudaError_t err = cudaFuncSetAttribute(packed_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  packed_attention_bwd_kernel<T><<<n_slots, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(vecs), static_cast<T*>(dqkv),
      static_cast<float*>(scratch), B, N, H, D, scale, robust, iters, final_row);
  return (int)cudaGetLastError();
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int nrv_packed_attention_bwd(const void* qkv, const void* dout,
                                        const void* vecs, void* dqkv, void* scratch,
                                        int dtype, int B, int N, int H, int D,
                                        float scale, int robust, int iters,
                                        int final_row, int n_slots, void* stream) {
  if (B < 1 || N < 1 || H < 1 || D < 1 || n_slots < 1 || iters < 1 ||
      iters > nrv::kMaxIters)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_bwd<float>(qkv, dout, vecs, dqkv, scratch, B, N, H, D,
                                  scale, robust, iters, final_row, n_slots, s);
  if (dtype == 1)
    return nrv::launch_bwd<__nv_bfloat16>(qkv, dout, vecs, dqkv, scratch, B, N, H,
                                          D, scale, robust, iters, final_row,
                                          n_slots, s);
  return (int)cudaErrorInvalidValue;
}
