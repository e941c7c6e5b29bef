// Talking-heads Sinkhorn, forward, the cluster branch: dots [B, H, N, N]
// (float32 or bfloat16, math in float32) and the head mixes pre, post
// [H, H] (float32) in,
//   y_q = Σ_g post[g, q] · sinkhorn(softmax(Σ_h pre[h, g] · s_h))_g
// out (the dots' dtype), with the residual rows of each (image, mixed head)
// item, the same stack [B·H, R, N] (a-rows, b-rows, lse) as the plane
// kernels' (talking_heads_fwd.cu): either backward takes either forward's.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// talking_heads.py::_th_fwd_impl (pl.pallas_call at :175; body
// _th_fwd_kernel around sinkhorn_softmax.py::_norm_fwd_math) for H ≤ 8,
// N ≤ 200 (talking_heads_cluster.cuh).
//
// One cluster an image, block k of H (talking_heads_cluster.cuh):
//  1. strip k of the image's H planes from device memory, in runs of four
//     when N is a multiple of 4; m_g = Σ_h pre[h, g]·s_h for every g, each
//     run stored by st.async into block g's plane (its own rows by a plain
//     store), the bytes counted by block g's mbarrier;
//  2. on its plane m_k: the softmax (ex2 with log2 e folded into one FMA,
//     lse to the residuals) together with the first column sums; each
//     further iteration one read of the plane (the row scale a, then the
//     column partials with it); the final row norm writes w = e·a·b in
//     place (without it, one more pass writes w);
//  3. a cluster barrier, then strip k of every block's w through
//     distributed shared memory: y_q = Σ_g post[g, q]·w_g, written once.
// Barriers: 3 cluster barriers, one mbarrier wait, 2·iters + 1 block barriers.
//
// What bounds it on the card (H100): the bytes. CaiT's dots
// [128, 8, 196, 196] float32 are 157.35 MB in and 157.35 MB out, ≥ 0.094 ms
// at 3.35 TB/s; no N×N float32 scratch is written. What is left: one
// 16-warp block an SM (the plane takes ~150 KB), 15 clusters of 8 at once,
// so 9 waves of images whose load, chain and store phases overlap only
// across clusters, and passes over the plane bound by the latency of their
// warp sums.
#include "talking_heads_cluster.cuh"

namespace nrv {
namespace thc {

template <typename T, int VEC>
__global__ void __launch_bounds__(kFwdThreads, 1)
th_cluster_fwd_kernel(const T* __restrict__ dots, const float* __restrict__ pre,
                      const float* __restrict__ post, T* __restrict__ out,
                      float* __restrict__ vecs, int H, int n, int iters, int final_row) {
  constexpr int kThreads = kFwdThreads, kWarps = kThreads / 32;
  constexpr int U = Lanes<VEC>::kUnits;
  constexpr int R = kRowsAtOnce;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank();  // this block's strip and mixed head
  const int b = blockIdx.x / H;
  const int ld = padded_ld(n);
  const size_t nn = (size_t)n * n;
  float* E = smem;
  float* inv_r = E + (size_t)n * ld;
  float* a_scale = inv_r + ld;
  float* bvec = a_scale + ld;
  float* part = bvec + ld;
  float* pre_t = part + kWarps * ld;  // pre_t[g][h] = pre[h, g]
  float* post_t = pre_t + kTable;     // post_t[q][g] = post[g, q]
  const int warp = threadIdx.x / 32;
  const int ka = num_arows(iters, final_row);
  const ResidualRows<float> res =
      residual_rows(vecs, (float*)nullptr, b * H + k, n, n, iters, ka, 0);
  THC_PHASE_INIT
  load_table<kThreads>(pre_t, pre, H, true);
  load_table<kThreads>(post_t, post, H, true);
  exchange_init(&bar, 1);  // also publishes the tables
  const int r0 = strip_row(k, n, H), r1 = strip_row(k + 1, n, H);
  if (threadIdx.x == 0)
    hopper::mbar_expect_tx(&bar, (uint32_t)((size_t)(n - (r1 - r0)) * n * sizeof(float)));
  THC_PHASE(0);

  // 1. premix of strip k into every block's plane
  {
    uint32_t dst[kMaxH], dbar[kMaxH];
#pragma unroll
    for (int g = 0; g < kMaxH; ++g)
      if (g < H) {
        dst[g] = cluster_addr(E, g);
        dbar[g] = cluster_addr(&bar, g);
      }
    const T* img = dots + (size_t)b * H * nn;
    if constexpr (VEC == 4) {
      const int runs = (r1 - r0) * n / 4;
      for (int u = threadIdx.x; u < runs; u += kThreads) {
        const int f = r0 * n + 4 * u, i = f / n, j = f - i * n;
        float4 x[kMaxH];
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          if (h < H) x[h] = value(run4(img + h * nn + f));
        const int off = i * ld + j;
#pragma unroll
        for (int g = 0; g < kMaxH; ++g)
          if (g < H) {
            float c[kMaxH];
            table_row(pre_t, g, c);
            const float4 m = mix4(c, x, H);
            if (g == k)
              *reinterpret_cast<float4*>(E + off) = m;
            else
              st_async(dst[g] + 4 * off, m, dbar[g]);
          }
      }
    } else {
      const int count = (r1 - r0) * n;
      for (int u = threadIdx.x; u < count; u += kThreads) {
        const int f = r0 * n + u, i = f / n, j = f - i * n;
        float x[kMaxH];
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          if (h < H) x[h] = to_f(img[h * nn + f]);
        const int off = i * ld + j;
#pragma unroll
        for (int g = 0; g < kMaxH; ++g)
          if (g < H) {
            float c[kMaxH];
            table_row(pre_t, g, c);
            const float m = mix1(c, x, H);
            if (g == k)
              E[off] = m;
            else
              st_async(dst[g] + 4 * off, m, dbar[g]);
          }
      }
    }
  }
  THC_PHASE(1);
  mbar_wait_cluster(&bar, 0);
  __syncthreads();
  THC_PHASE(2);

  // 2. softmax with the first column sums (a_0 ≡ 1: the column scale is
  //    1 / rowsum)
  const int sub = threadIdx.x % kRowLanes;
  {
    float acc[U][VEC] = {};
    for (int i0 = warp * R; i0 < n; i0 += kWarps * R) {
      const int i = i0 + Lanes<VEC>::row();
      float x[U][VEC];
      load_row<VEC>(E, ld, n, i, x, -INFINITY);
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < U; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) mx = fmaxf(mx, x[c][e]);
      mx = row_max(mx);
      const float off = i < n ? -mx * kLog2e : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < U; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          x[c][e] = ex2(fmaf(x[c][e], kLog2e, off));
          rs += x[c][e];
        }
      rs = row_sum(rs);
      const float inv = i < n ? __frcp_rn(rs) : 0.f;
      col_acc<VEC>(acc, x, inv);
      if (sub == 0 && i < n) {
        inv_r[i] = inv;
        a_scale[i] = inv;
        res.lse[i] = mx + logf(rs);
      }
      store_row<VEC>(E, ld, n, i, x);
    }
    col_finish<kThreads, VEC>(acc, part, ld, n, [&](int j, float t) {
      const float bj = recip_rn(t);
      bvec[j] = bj;
      res.b[j] = bj;
    });
  }
  THC_PHASE(3);
  // further iterations: row scale a_t, then the column sums with it
  for (int t = 1; t < iters; ++t) {
    float bl[U][VEC], acc[U][VEC] = {};
    load_vec<VEC>(bvec, n, bl);
    for (int i0 = warp * R; i0 < n; i0 += kWarps * R) {
      const int i = i0 + Lanes<VEC>::row();
      float x[U][VEC];
      load_row<VEC>(E, ld, n, i, x, 0.f);
      const float s = row_sum(lane_dot<VEC>(x, bl));
      const float ir = i < n ? inv_r[i] : 0.f;
      const float a = recip_rn(s * ir);
      const float as = a * ir;
      col_acc<VEC>(acc, x, as);
      if (sub == 0 && i < n) {
        res.a[(size_t)(t - 1) * n + i] = a;
        a_scale[i] = as;
      }
    }
    col_finish<kThreads, VEC>(acc, part, ld, n, [&](int j, float s) {
      const float bj = recip_rn(s);
      bvec[j] = bj;
      res.b[(size_t)t * n + j] = bj;
    });
  }
  THC_PHASE(4);
  // the final row norm (if any) and w = (e·a_scale)·b in place
  {
    float bl[U][VEC];
    load_vec<VEC>(bvec, n, bl);
    for (int i0 = warp * R; i0 < n; i0 += kWarps * R) {
      const int i = i0 + Lanes<VEC>::row();
      float x[U][VEC];
      load_row<VEC>(E, ld, n, i, x, 0.f);
      float as;
      if (final_row) {
        const float s = row_sum(lane_dot<VEC>(x, bl));
        const float ir = i < n ? inv_r[i] : 0.f;
        const float a = recip_rn(s * ir);
        as = a * ir;
        if (sub == 0 && i < n) res.a[(size_t)(ka - 1) * n + i] = a;
      } else {
        as = i < n ? a_scale[i] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < U; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[c][e] = x[c][e] * as * bl[c][e];
      store_row<VEC>(E, ld, n, i, x);
    }
  }
  THC_PHASE(5);
  cluster.sync();
  THC_PHASE(6);

  // 3. post-mix of strip k from every block's w
  {
    const float* src[kMaxH];
#pragma unroll
    for (int g = 0; g < kMaxH; ++g)
      if (g < H) src[g] = cluster.map_shared_rank(E, g);
    T* img = out + (size_t)b * H * nn;
    if constexpr (VEC == 4) {
      const int runs = (r1 - r0) * n / 4;
      for (int u = threadIdx.x; u < runs; u += kThreads) {
        const int f = r0 * n + 4 * u, i = f / n, j = f - i * n;
        const int off = i * ld + j;
        float4 w[kMaxH];
#pragma unroll
        for (int g = 0; g < kMaxH; ++g)
          if (g < H) w[g] = *reinterpret_cast<const float4*>(src[g] + off);
#pragma unroll
        for (int q = 0; q < kMaxH; ++q)
          if (q < H) {
            float c[kMaxH];
            table_row(post_t, q, c);
            store4(img + q * nn + f, mix4(c, w, H));
          }
      }
    } else {
      const int count = (r1 - r0) * n;
      for (int u = threadIdx.x; u < count; u += kThreads) {
        const int f = r0 * n + u, i = f / n, j = f - i * n;
        const int off = i * ld + j;
        float w[kMaxH];
#pragma unroll
        for (int g = 0; g < kMaxH; ++g)
          if (g < H) w[g] = src[g][off];
#pragma unroll
        for (int q = 0; q < kMaxH; ++q)
          if (q < H) {
            float c[kMaxH];
            table_row(post_t, q, c);
            store_f(img + q * nn + f, mix1(c, w, H));
          }
      }
    }
  }
  THC_PHASE(7);
  cluster.sync();  // no block leaves while another still reads its plane
  THC_PHASE(8);
}

template <typename T>
int launch_fwd(const void* dots, const void* pre, const void* post, void* out, void* vecs,
               int B, int H, int n, int iters, int final_row, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats(n);
  auto args = [&](auto kernel) {
    return launch(kernel, kFwdThreads, B, H, smem, stream, static_cast<const T*>(dots),
                  static_cast<const float*>(pre), static_cast<const float*>(post),
                  static_cast<T*>(out), static_cast<float*>(vecs), H, n, iters, final_row);
  };
  return (int)(n % 4 == 0 ? args(th_cluster_fwd_kernel<T, 4>) : args(th_cluster_fwd_kernel<T, 1>));
}

}  // namespace thc
}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. dots and out [B, H, N, N] in that dtype;
// pre and post float32 [H, H]; vecs float32 [B·H, R, N]. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape the cluster kernels
// do not take).
extern "C" int nrv_talking_heads_cluster_fwd(const void* dots, const void* pre, const void* post,
                                             void* out, void* vecs, int dtype, int B, int H,
                                             int N, int iters, int final_row, void* stream) {
  if (B < 1 || !nrv::thc::takes(H, N, iters, final_row)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::thc::launch_fwd<float>(dots, pre, post, out, vecs, B, H, N, iters, final_row, st);
  if (dtype == 1)
    return nrv::thc::launch_fwd<__nv_bfloat16>(dots, pre, post, out, vecs, B, H, N, iters,
                                               final_row, st);
  return (int)cudaErrorInvalidValue;
}

// Clusters of the forward kernel at this shape that fit on the card at once
// (cudaOccupancyMaxActiveClusters; -1 on an error).
extern "C" int nrv_talking_heads_cluster_fwd_clusters(int dtype, int H, int N) {
  using nrv::thc::active_clusters;
  using nrv::thc::kFwdThreads;
  using nrv::thc::th_cluster_fwd_kernel;
  if (!nrv::thc::takes(H, N, 1, 0) || (dtype != 0 && dtype != 1)) return -1;
  const size_t smem = sizeof(float) * nrv::thc::fwd_smem_floats(N);
  if (N % 4 == 0)
    return dtype == 0
               ? active_clusters(th_cluster_fwd_kernel<float, 4>, kFwdThreads, H, smem)
               : active_clusters(th_cluster_fwd_kernel<__nv_bfloat16, 4>, kFwdThreads, H, smem);
  return dtype == 0
             ? active_clusters(th_cluster_fwd_kernel<float, 1>, kFwdThreads, H, smem)
             : active_clusters(th_cluster_fwd_kernel<__nv_bfloat16, 1>, kFwdThreads, H, smem);
}
