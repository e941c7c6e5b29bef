// Biased (windowed) attention, backward: the hand-derived gradient of the
// forward in biased_attention_fwd.cu from the stored residual rows, with
// dq, dk, dv in the model dtype and dbias = Σ over the BW/nW images of dS,
// float32 [nW, H, N, N].
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/biased_attention.py
// ::_biased_bwd_impl (pl.pallas_call at :296), whose body is
// sinkhorn_attention.py::_bwd_math_batched with want_ds.
//
// Forward is O = diag(a)·A·diag(b)·V, A the row softmax of scale·q·kᵀ +
// bias (a = b = 1 when vanilla). Per (window, head) item, with A in shared
// memory:
//   A = exp(scale·q·kᵀ + bias − lse)          (one exp, in the GEMM epilogue)
//   o/a = A·(b⊙V), t1 = Aᵀ·(a⊙G), dV = b ⊙ t1,
//   da = rowsum(G ⊙ o/a), db = rowsum(t1 ⊙ V),
//   robust: the reverse chain (sinkhorn_chain.cuh), giving svec and the
//   rank-1 dA terms u_k v_kᵀ;
//   dS = A ⊙ ((a ⊙ (G·Vᵀ) ⊙ b − (a ⊙ da + svec)) + Σ u_k v_kᵀ), formed in
//   the epilogue of the G·Vᵀ GEMM and written over A in place, since
//   rowsum(dA ⊙ A) = a ⊙ da by identity (vanilla: dS = A ⊙ (G·Vᵀ − da),
//   the softmax vjp, with no chain);
//   dQ = scale·dS·K, dK = scale·dSᵀ·Q.
// Only one N×N matrix is held, so LeViT's N = 196 fits in one block's
// shared memory with o/a and t1 beside it (they share space with the
// chain's vectors, which come after them). Where o/a and t1 at their full
// width DV do not fit beside the matrix (N = 196 with DV = 64: stage 0 of
// LeViT-192/256/384), they are formed DVC = 32 columns at a time, and da
// and db add up the chunks' row sums in chunk order.
//
// dbias across blocks. The TPU kernel sums dbias by revisiting one output
// block over a sequential grid axis. CUDA blocks run in no order, so here
// each block owns one (window, head) pair and one chunk of the images that
// share its bias row: it walks its images in turn and adds each dS into its
// own float32 partial [chunk, nW, H, N, N] (the first image writes it). A
// second kernel sums the chunks' partials in chunk order. No atomics: a run
// repeats bit for bit.
//
// What bounds it on the card (H100): the bytes, as the forward. Stage 0 of
// Swin-T in bf16, robust: q, k, v, dout 308 MB, dq, dk, dv 231 MB, the
// residual rows 34 MB, bias and dbias 3.7 MB: ~0.17 ms at 3.35 TB/s, beside
// 23 GFLOP of products (~23 µs at 989 TFLOP/s). The partials add
// chunks·nW·H·N²·4 bytes, written and read once (~11 MB at stage 0). As in
// the forward, per-item latency keeps it ~20× above that bound (PERF.md):
// one item at a time per block with a barrier between phases, and
// block_gemm's mma.sync tiles (bf16 for q·kᵀ and G·Vᵀ in a bf16 model,
// 3xTF32 otherwise).
#include "sinkhorn_chain.cuh"

namespace nrv {

// Floats of shared memory after the matrix and the GEMM tiles: ones, the
// ka a-rows, the iters b-rows, da, db_row, then a region that holds o/a and
// t1 (2·N·DVC, DVC the columns formed at a time) first and the chain's
// svec, m_dc, row_term, iters dc and iters dr vectors after them.
__host__ __device__ inline size_t biased_bwd_vector_floats(int n, int dvc, int iters,
                                                           int ka) {
  const size_t head = (1 + (size_t)ka + iters + 2) * n;
  const size_t chain = (3 + 2 * (size_t)iters) * n;
  const size_t prod = 2 * (size_t)n * dvc;
  return head + (chain > prod ? chain : prod);
}

inline size_t biased_bwd_smem_bytes(int n, int dvc, int iters, int ka) {
  return sizeof(float) * ((size_t)n * padded_ld(n) + (size_t)kGemmSmemFloats +
                          biased_bwd_vector_floats(n, dvc, iters, ka));
}

// The o/a and t1 columns formed at a time: all DV of them where they fit
// beside the kernel's static shared memory in what a block may use, else
// 32 (DV a multiple of 32); 0 when neither fits.
// ops/cuda/biased_attention.py::_dv_chunk mirrors this for the gate.
inline int biased_bwd_dv_chunk(int n, int dv, int iters, int ka, size_t limit) {
  if (biased_bwd_smem_bytes(n, dv, iters, ka) <= limit) return dv;
  if (dv % 32 == 0 && biased_bwd_smem_bytes(n, 32, iters, ka) <= limit) return 32;
  return 0;
}

// Three blocks per SM (at most 85 registers a thread): faster than two,
// and than four, where the spills grow (PERF.md,
// tools/torch_biased_variants.py).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
biased_attention_bwd_kernel(const T* __restrict__ q_all, const T* __restrict__ k_all,
                            const T* __restrict__ v_all, const float* __restrict__ bias,
                            const T* __restrict__ g_all, const float* __restrict__ vecs,
                            T* __restrict__ dq_all, T* __restrict__ dk_all,
                            T* __restrict__ dv_all, float* __restrict__ partial,
                            int BW, int H, int N, int D, int DV, int DVC, int nW,
                            float scale, int robust, int iters, int final_row,
                            int per_chunk) {
  extern __shared__ float smem[];
  __shared__ int s_tu[kMaxTerms], s_tv[kMaxTerms];
  const int ka = robust ? (iters > 1 ? iters - 1 : 0) + final_row : 0;
  const int ldn = padded_ld(N);
  float* P = smem;  // A, then dS
  float* gemm_smem = P + (size_t)N * ldn;
  float* vbase = gemm_smem + kGemmSmemFloats;
  float* ones = vbase;
  float* arows = ones + N;
  float* brows = arows + (size_t)ka * N;
  float* da = brows + (size_t)iters * N;
  float* db_row = da + N;
  float* OA = db_row + N;  // o/a [N, DVC], then the chain's vectors
  float* T1 = OA + (size_t)N * DVC;
  float* svec = db_row + N;
  float* m_dc = svec + N;
  float* row_term = m_dc + N;
  float* dcs = row_term + N;
  float* drs = dcs + (size_t)iters * N;
  const int* tu = s_tu;
  const int* tv = s_tv;

  const int w = blockIdx.x / H, h = blockIdx.x % H;  // the bias row this block owns
  const int imgs = BW / nW;
  const int first_img = blockIdx.y * per_chunk;
  const int last_img = min(imgs, first_img + per_chunk);
  const int R = num_vecs(iters, final_row, robust);
  const float* bi = bias ? bias + ((size_t)w * H + h) * N * N : nullptr;
  float* my_part = partial ? partial + (((size_t)blockIdx.y * nW + w) * H + h) * N * N : nullptr;

  for (int i = threadIdx.x; i < N; i += kThreads) ones[i] = 1.f;
  __syncthreads();
  const float* a_fin = ka > 0 ? arows + (size_t)(ka - 1) * N : ones;
  const float* b_fin = robust ? brows + (size_t)(iters - 1) * N : ones;

  for (int img = first_img; img < last_img; ++img) {
    const size_t item = ((size_t)img * nW + w) * H + h;
    const T* q = q_all + item * N * D;
    const T* k = k_all + item * N * D;
    const T* v = v_all + item * N * DV;
    const T* g = g_all + item * N * DV;
    T* dq = dq_all + item * N * D;
    T* dk = dk_all + item * N * D;
    T* dv = dv_all + item * N * DV;
    const float* vec = vecs + item * R * N;
    const float* lse = vec + (size_t)(R - 1) * N;
    const bool first = img == first_img;

    // A = exp(scale·q·kᵀ + bias − lse): the stored log-normalizer replaces
    // the max/sum replay
    block_gemm<true, false>(
        N, N, D, [=](int i, int c) { return run4(q + i * D + c); },
        [=](int c, int j) { return run4(k + j * D + c); },
        [=](int i, int j, float acc) {
          const float s = bi ? acc * scale + bi[i * N + j] : acc * scale;
          P[(size_t)i * ldn + j] = expf(s - lse[i]);
        },
        gemm_smem);
    if (robust) {  // scaling vectors from the residual stack (_restore_vec_rows)
      for (int idx = threadIdx.x; idx < (ka + iters) * N; idx += kThreads)
        arows[idx] = vec[idx];  // arows and brows are adjacent, as in vecs
      __syncthreads();
    }

    // DVC columns c0.. at a time: o/a = A·(b⊙V), t1 = Aᵀ·(a⊙G), then
    // da = rowsum(G ⊙ o/a), db = rowsum(t1 ⊙ V), dV = b ⊙ t1
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c0 = 0; c0 < DV; c0 += DVC) {
      block_gemm<true, true>(
          N, DVC, N, [=](int i, int j) { return run4(P + (size_t)i * ldn + j); },
          [=](int j, int c) { return run4(v + j * DV + c0 + c, b_fin[j]); },
          [=](int i, int c, float acc) { OA[(size_t)i * DVC + c] = acc; }, gemm_smem);
      block_gemm<false, true>(
          N, DVC, N, [=](int j, int i) { return run4(P + (size_t)i * ldn + j); },
          [=](int i, int c) { return run4(g + i * DV + c0 + c, a_fin[i]); },
          [=](int j, int c, float acc) { T1[(size_t)j * DVC + c] = acc; }, gemm_smem);
      for (int i = warp; i < N; i += kWarps) {
        float sa = 0.f, sb = 0.f;
        for (int c = lane; c < DVC; c += 32) {
          const float t1 = T1[(size_t)i * DVC + c];
          sa = fmaf(to_f(g[i * DV + c0 + c]), OA[(size_t)i * DVC + c], sa);
          sb = fmaf(t1, to_f(v[i * DV + c0 + c]), sb);
          store_f(dv + i * DV + c0 + c, b_fin[i] * t1);
        }
        sa = warp_sum(sa);
        sb = warp_sum(sb);
        if (lane == 0) {
          da[i] = c0 ? da[i] + sa : sa;
          db_row[i] = c0 ? db_row[i] + sb : sb;
        }
      }
      __syncthreads();  // o/a and t1 are dead from here: the next chunk or
                        // the chain reuses them
    }

    int nt = 0;
    if (robust) {
      nt = sinkhorn_reverse_chain(P, N, N, ldn, iters, final_row != 0, vbase, ones, arows,
                                  brows, da, db_row, svec, m_dc, dcs, drs, s_tu, s_tv);
    } else {
      for (int i = threadIdx.x; i < N; i += kThreads) svec[i] = 0.f;
      __syncthreads();
    }
    for (int i = threadIdx.x; i < N; i += kThreads) row_term[i] = a_fin[i] * da[i] + svec[i];
    __syncthreads();

    // dS over A in place, in the epilogue of G·Vᵀ; each entry is read and
    // written by the one thread that computes it, and added into this
    // block's dbias partial
    block_gemm<true, false>(
        N, N, DV, [=](int i, int c) { return run4(g + i * DV + c); },
        [=](int c, int j) { return run4(v + j * DV + c); },
        [=](int i, int j, float acc) {
          float r1 = 0.f;
          for (int t = 0; t < nt; ++t) r1 = fmaf(vbase[tu[t] + i], vbase[tv[t] + j], r1);
          float* p = P + (size_t)i * ldn + j;
          const float ds = *p * ((a_fin[i] * acc * b_fin[j] - row_term[i]) + r1);
          *p = ds;
          if (my_part) my_part[i * N + j] = first ? ds : my_part[i * N + j] + ds;
        },
        gemm_smem);

    block_gemm<true, true>(  // dQ = scale·dS·K
        N, D, N, [=](int i, int j) { return run4(P + (size_t)i * ldn + j); },
        [=](int j, int c) { return run4(k + j * D + c); },
        [=](int i, int c, float acc) { store_f(dq + i * D + c, scale * acc); }, gemm_smem);
    block_gemm<false, true>(  // dK = scale·dSᵀ·Q
        N, D, N, [=](int j, int i) { return run4(P + (size_t)i * ldn + j); },
        [=](int i, int c) { return run4(q + i * D + c); },
        [=](int j, int c, float acc) { store_f(dk + j * D + c, scale * acc); }, gemm_smem);
  }
}

// dbias[e] = Σ_c partial[c, e] over the chunks, in chunk order.
__global__ void biased_dbias_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ dbias, size_t elems,
                                           int chunks) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < elems;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * elems + e];
    dbias[e] = s;
  }
}

// The chunks' dbias partials [chunks, elems] summed in chunk order into
// dbias [elems]; the resident backward (biased_resident_bwd.cu) uses it too.
cudaError_t biased_dbias_reduce(const float* partial, float* dbias, size_t elems, int chunks,
                                cudaStream_t stream) {
  const int blocks = (int)((elems + 255) / 256 < 4096 ? (elems + 255) / 256 : 4096);
  biased_dbias_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, dbias, elems, chunks);
  return cudaGetLastError();
}

template <typename T>
int launch_biased_bwd(const void* q, const void* k, const void* v, const void* bias,
                      const void* dout, const void* vecs, void* dq, void* dk, void* dv,
                      void* partial, void* dbias, int BW, int H, int N, int D, int DV,
                      int nW, float scale, int robust, int iters, int final_row,
                      int chunks, int per_chunk, cudaStream_t stream) {
  const int ka = robust ? (iters > 1 ? iters - 1 : 0) + final_row : 0;
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, biased_attention_bwd_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  const int DVC = biased_bwd_dv_chunk(N, DV, iters, ka, (size_t)optin - attr.sharedSizeBytes);
  if (DVC == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = biased_bwd_smem_bytes(N, DVC, iters, ka);
  err = cudaFuncSetAttribute(biased_attention_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one chunk: the single partial is dbias itself
  float* part = static_cast<float*>(chunks == 1 ? dbias : partial);
  biased_attention_bwd_kernel<T><<<dim3(nW * H, chunks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(dout),
      static_cast<const float*>(vecs), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), bias ? part : nullptr, BW, H, N, D, DV, DVC, nW, scale,
      robust, iters, final_row, per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || !bias || chunks == 1) return (int)err;
  return (int)biased_dbias_reduce(static_cast<const float*>(partial), static_cast<float*>(dbias),
                                  (size_t)nW * H * N * N, chunks, stream);
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. bias and dbias are null when there is no
// bias; partial holds chunks·nW·H·N·N floats (unused when chunks == 1).
// The grid is nW·H pairs × chunks, each chunk per_chunk images. Returns
// cudaGetLastError() after the launches.
extern "C" int nrv_biased_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* dout,
                                        const void* vecs, void* dq, void* dk, void* dv,
                                        void* partial, void* dbias, int dtype, int BW,
                                        int H, int N, int D, int DV, int nW, float scale,
                                        int robust, int iters, int final_row, int chunks,
                                        int per_chunk, void* stream) {
  if (BW < 1 || H < 1 || N < 1 || D < 1 || DV < 1 || nW < 1 || BW % nW ||
      iters < 1 || iters > nrv::kMaxIters || chunks < 1 || per_chunk < 1 ||
      (long long)chunks * per_chunk < BW / nW || (bias && !dbias) ||
      (bias && chunks > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_biased_bwd<float>(q, k, v, bias, dout, vecs, dq, dk, dv, partial,
                                         dbias, BW, H, N, D, DV, nW, scale, robust, iters,
                                         final_row, chunks, per_chunk, s);
  if (dtype == 1)
    return nrv::launch_biased_bwd<__nv_bfloat16>(q, k, v, bias, dout, vecs, dq, dk, dv,
                                                 partial, dbias, BW, H, N, D, DV, nW,
                                                 scale, robust, iters, final_row, chunks,
                                                 per_chunk, s);
  return (int)cudaErrorInvalidValue;
}
