// Talking-heads Sinkhorn, backward: (dots, g, residual rows, pre, post) →
// (d dots, d pre, d post), the hand-derived gradient of the forward in
// talking_heads_fwd.cu.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// talking_heads.py::_th_bwd_impl (pl.pallas_call at :208; body
// _th_bwd_kernel around sinkhorn_softmax.py::_norm_bwd_math).
//
// The math, per image (m = premix(s), w = sinkhorn(softmax(m)),
// y = postmix(w)):
//   gw_g = Σ_q post[g, q]·gy_q          (the post-mix's vjp)
//   dm_g = the logits-interface backward of item g from m_g, gw_g and its
//          residual rows (sinkhorn_bwd_vectors, ds_entry)
//   ds_h = Σ_g pre[h, g]·dm_g           (the pre-mix's vjp)
//   dpre[h, g] = Σ s_h ⊙ dm_g,  dpost[g, q] = Σ w_g ⊙ gy_q
// summed over the images and the n×n entries.
//
// Design. Three kernels:
//  1. talking_heads_bwd_kernel: one block per (image b, mixed head g) item,
//     the grid ordered so that an image's H items run together (its planes
//     of s and gy come from L2 after the first read). The prologue rebuilds
//     A = exp(m_g − lse) in shared memory from the H planes of s (150 KB
//     at 196×196). One pass over the H planes of gy then forms gw_g into a
//     float32 scratch [B, H, N, N] and the item's row of dpost partials
//     (w_g = A·a·b is at hand). The vectors and the reverse chain run as in
//     the square logits-interface backward, reading gw_g from the scratch
//     (L2). The last pass forms dm_g in place of gw_g and, reading the H
//     planes of s once more, the item's row of dpre partials.
//  2. mix_planes_kernel (talking_heads.cuh): ds_h = Σ_g pre[h, g]·dm_g.
//  3. th_reduce_kernel: dpre and dpost as sums of the items' partial rows
//     over the images, in a fixed order.
// No atomics: the TPU kernel summed dpre and dpost by revisiting one output
// block across its sequential grid; blocks here run concurrently, so each
// writes its partials and a second kernel adds them. A run repeats bit for
// bit.
//
// What bounds it on the card (H100): the bytes. At CaiT's
// [128, 8, 196, 196] float32 the dots, g and ds are 157.35 MB each, so
// ≥ 0.141 ms at 3.35 TB/s; the float32 work, B·H·N²·(8 + 4·iters + 8·H)
// (the TPU kernel's estimate), is ~3.3 GFLOP, 0.05 ms at 67 TFLOP/s. The
// scratch dm is written and read once more.
#include "talking_heads.cuh"

namespace nrv {

inline size_t talking_heads_bwd_smem_bytes(int n, int iters, int ka) {
  return sizeof(float) * ((size_t)n * padded_ld(n) + bwd_vector_floats(n, n, iters, ka));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
talking_heads_bwd_kernel(const T* __restrict__ s_all, const T* __restrict__ g_all,
                         const float* __restrict__ vecs, const float* __restrict__ pre,
                         const float* __restrict__ post, float* dm_all,
                         float* __restrict__ part_pre, float* __restrict__ part_post, int H,
                         int n, int iters, int final_row) {
  extern __shared__ float smem[];
  __shared__ int s_tu[kMaxTerms], s_tv[kMaxTerms];
  __shared__ float part[kThreads];
  __shared__ float cpre[kMaxHeads], cpost[kMaxHeads];
  __shared__ float red[kWarps * kMaxHeads];
  const int ld = padded_ld(n);
  const int ka = num_arows(iters, final_row);
  const int item = blockIdx.x, b = item / H, g = item % H;
  const size_t nn = (size_t)n * n;
  float* P = smem;  // A
  const BwdVectors v = bwd_vectors(smem + (size_t)n * ld, n, n, iters, ka);
  const float* a_fin = v.a_fin;
  const float* b_fin = v.b_fin;
  const float* lse = v.lse;
  const T* s = s_all + (size_t)b * H * nn;  // the image's H planes
  const T* gy = g_all + (size_t)b * H * nn;
  float* G = dm_all + (size_t)item * nn;  // gw_g, then dm_g

  for (int i = threadIdx.x; i < n; i += kThreads) v.ones[i] = 1.f;
  if (threadIdx.x < H) {
    cpre[threadIdx.x] = pre[threadIdx.x * H + g];    // pre[:, g]
    cpost[threadIdx.x] = post[g * H + threadIdx.x];  // post[g, :]
  }
  load_residual_rows(residual_rows(vecs, (const float*)nullptr, item, n, n, iters, ka, 0), v, n,
                     n, iters, ka);
  mix_load(s, nn, H, cpre, n, ld, P, [=](int i, float x) { return expf(x - lse[i]); });

  // gw_g = Σ_q post[g, q]·gy_q into G; dpost[g, q] partials Σ w_g ⊙ gy_q
  float acc[kMaxHeads];
#pragma unroll
  for (int q = 0; q < kMaxHeads; ++q) acc[q] = 0.f;
  if (n % 4 == 0) {
    for (int r = threadIdx.x; r < n * n / 4; r += kThreads) {
      const int f = 4 * r, i = f / n, j = f - i * n;
      float4 x[kMaxHeads];
#pragma unroll
      for (int q = 0; q < kMaxHeads; ++q)
        if (q < H) x[q] = value(run4(gy + q * nn + f));
      const float4 p = *reinterpret_cast<const float4*>(P + (size_t)i * ld + j);
      const float a = a_fin[i];
      const float4 w = make_float4(p.x * a * b_fin[j], p.y * a * b_fin[j + 1],
                                   p.z * a * b_fin[j + 2], p.w * a * b_fin[j + 3]);
      float4 gw = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kMaxHeads; ++q)
        if (q < H) {
          const float c = cpost[q];
          gw = make_float4(fmaf(c, x[q].x, gw.x), fmaf(c, x[q].y, gw.y), fmaf(c, x[q].z, gw.z),
                           fmaf(c, x[q].w, gw.w));
          acc[q] = fmaf(w.x, x[q].x, fmaf(w.y, x[q].y, fmaf(w.z, x[q].z, fmaf(w.w, x[q].w, acc[q]))));
        }
      store4(G + f, gw);
    }
  } else {
    for (int f = threadIdx.x; f < n * n; f += kThreads) {
      const int i = f / n, j = f - i * n;
      float x[kMaxHeads];
#pragma unroll
      for (int q = 0; q < kMaxHeads; ++q)
        if (q < H) x[q] = to_f(gy[q * nn + f]);
      const float w = P[(size_t)i * ld + j] * a_fin[i] * b_fin[j];
      float gw = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxHeads; ++q)
        if (q < H) {
          gw = fmaf(cpost[q], x[q], gw);
          acc[q] = fmaf(w, x[q], acc[q]);
        }
      G[f] = gw;
    }
  }
  block_sum_heads(acc, H, red, part_post + (size_t)item * H);  // also publishes G

  const int nt = sinkhorn_bwd_vectors(P, static_cast<const float*>(G), n, n, ld, iters, final_row,
                                      v, part, s_tu, s_tv);

  // dm_g in place of gw_g; dpre[h, g] partials Σ s_h ⊙ dm_g
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) acc[h] = 0.f;
  if (n % 4 == 0) {
    for (int r = threadIdx.x; r < n * n / 4; r += kThreads) {
      const int f = 4 * r, i = f / n, j = f - i * n;
      float4 x[kMaxHeads];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) x[h] = value(run4(s + h * nn + f));
      const float4 p = *reinterpret_cast<const float4*>(P + (size_t)i * ld + j);
      const float4 gw = *reinterpret_cast<const float4*>(G + f);
      const float4 dm = make_float4(ds_entry(v, s_tu, s_tv, nt, i, j, p.x, gw.x),
                                    ds_entry(v, s_tu, s_tv, nt, i, j + 1, p.y, gw.y),
                                    ds_entry(v, s_tu, s_tv, nt, i, j + 2, p.z, gw.z),
                                    ds_entry(v, s_tu, s_tv, nt, i, j + 3, p.w, gw.w));
      store4(G + f, dm);
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H)
          acc[h] = fmaf(dm.x, x[h].x, fmaf(dm.y, x[h].y, fmaf(dm.z, x[h].z, fmaf(dm.w, x[h].w, acc[h]))));
    }
  } else {
    for (int f = threadIdx.x; f < n * n; f += kThreads) {
      const int i = f / n, j = f - i * n;
      float x[kMaxHeads];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) x[h] = to_f(s[h * nn + f]);
      const float dm = ds_entry(v, s_tu, s_tv, nt, i, j, P[(size_t)i * ld + j], G[f]);
      G[f] = dm;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) acc[h] = fmaf(dm, x[h], acc[h]);
    }
  }
  block_sum_heads(acc, H, red, part_pre + (size_t)item * H);
}

// dpre[h, g] = Σ_b part_pre[b·H + g, h] (block 0) and
// dpost[g, q] = Σ_b part_post[b·H + g, q] (block 1), b in order.
__global__ void __launch_bounds__(kThreads)
th_reduce_kernel(const float* __restrict__ part_pre, const float* __restrict__ part_post,
                 float* __restrict__ dpre, float* __restrict__ dpost, int B, int H) {
  const bool is_pre = blockIdx.x == 0;
  const float* part = is_pre ? part_pre : part_post;
  for (int t = threadIdx.x; t < H * H; t += kThreads) {
    const int g = t / H, x = t % H;
    float sum = 0.f;
    for (int b = 0; b < B; ++b) sum += part[((size_t)b * H + g) * H + x];
    if (is_pre)
      dpre[x * H + g] = sum;
    else
      dpost[g * H + x] = sum;
  }
}

template <typename T>
int launch_talking_heads_bwd(const void* s, const void* g, const void* vecs, const void* pre,
                             const void* post, void* ds, void* dpre, void* dpost, void* dm,
                             void* part, int B, int H, int n, int iters, int final_row,
                             cudaStream_t stream) {
  const size_t smem = talking_heads_bwd_smem_bytes(n, iters, num_arows(iters, final_row));
  cudaError_t err = cudaFuncSetAttribute(talking_heads_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* part_pre = static_cast<float*>(part);
  float* part_post = part_pre + (size_t)B * H * H;
  talking_heads_bwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(g), static_cast<const float*>(vecs),
      static_cast<const float*>(pre), static_cast<const float*>(post), static_cast<float*>(dm),
      part_pre, part_post, H, n, iters, final_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = (cudaError_t)launch_mix_planes<T>(static_cast<const float*>(dm),
                                          static_cast<const float*>(pre), static_cast<T*>(ds), B,
                                          H, (size_t)n * n, 1, stream);
  if (err != cudaSuccess) return (int)err;
  th_reduce_kernel<<<2, kThreads, 0, stream>>>(part_pre, part_post, static_cast<float*>(dpre),
                                               static_cast<float*>(dpost), B, H);
  return (int)cudaGetLastError();
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. dots, g and ds [B, H, N, N] in that dtype;
// vecs float32 [B·H, R, N] from the forward; pre and post float32 [H, H];
// dpre and dpost float32 [H, H] out. Scratch: dm float32 [B, H, N, N] and
// part float32 [2, B·H, H]. Returns cudaGetLastError().
extern "C" int nrv_talking_heads_bwd(const void* dots, const void* g, const void* vecs,
                                     const void* pre, const void* post, void* ds, void* dpre,
                                     void* dpost, void* dm, void* part, int dtype, int B, int H,
                                     int N, int iters, int final_row, void* stream) {
  if (B < 1 || H < 1 || H > nrv::kMaxHeads || N < 2 || iters < 1 || iters > nrv::kMaxIters ||
      (final_row != 0 && final_row != 1))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_talking_heads_bwd<float>(dots, g, vecs, pre, post, ds, dpre, dpost, dm,
                                                part, B, H, N, iters, final_row, st);
  if (dtype == 1)
    return nrv::launch_talking_heads_bwd<__nv_bfloat16>(dots, g, vecs, pre, post, ds, dpre,
                                                        dpost, dm, part, B, H, N, iters,
                                                        final_row, st);
  return (int)cudaErrorInvalidValue;
}
