// Talking-heads Sinkhorn, backward, the cluster branch: (dots, g, residual
// rows, pre, post) → (d dots, d pre, d post), the hand-derived gradient of
// the forward (talking_heads_cluster_fwd.cu, or the plane kernels' forward:
// the residual rows are the same).
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// talking_heads.py::_th_bwd_impl (pl.pallas_call at :208; body
// _th_bwd_kernel around sinkhorn_softmax.py::_norm_bwd_math) for H ≤ 8,
// N ≤ 200 (talking_heads_cluster.cuh).
//
// The math, per image (m = premix(s), A = exp(m − lse), w = A·a·b,
// y = postmix(w)):
//   gw_g = Σ_q post[g, q]·gy_q
//   da = (A ⊙ gw)·b, db = (A ⊙ gw)ᵀ·a, the reverse chain on A to the
//   rank-1 terms u_t v_tᵀ and row_term
//   dm_g = A·a·gw·b + C_g,  C_g = A ⊙ (Σ_t u_t v_tᵀ − row_term)
//   ds_h = Σ_g pre[h, g]·dm_g
//   dpre[h, g] = Σ s_h ⊙ dm_g,  dpost[g, q] = Σ w_g ⊙ gy_q
//
// Design: one cluster an image, block k of H (talking_heads_cluster.cuh).
// Two planes (A and gw) do not fit a block at N = 196, and A alone does;
// so gw never lives in a plane. The strip owner, one lane a column and one
// row at a time, holds s and gy of every head at the entry in registers
// and works every head without a test (past H the tables, s, gy and the
// vectors are zeros, so those terms are zeros):
//  1. strip k of s and gy from device memory; for every g: A_g (sent by
//     st.async into block g's plane), gw_g, and the strip's sums of
//     A⊙gw: da (the rows, a reduce-scatter across the warp, then the warps
//     in order) and db (a column partial in registers), both sent to block
//     g; the dpost partial of (image, strip k);
//  2. block k on its plane A_k: db as the strips' partials in strip order,
//     the reverse chain with each row pass and the column pass after it in
//     one read of the plane, and the last pass writing C_k in place (the
//     rank-1 terms and row_term applied while the warp holds the row);
//  3. a cluster barrier; strip k of s and gy once more (from L2), A_g and
//     gw_g recomputed, C_g read from block g's plane through distributed
//     shared memory: dm_g, then ds_h for every h written once, and the
//     dpre partial of (image, strip k);
//  4. th_cluster_reduce_kernel: dpre and dpost as the partials summed over
//     the images in order, then over the strips in order.
// Barriers: 3 cluster barriers, one mbarrier wait, 3·iters + 7 block
// barriers (with the final row norm). No atomics, no N×N device scratch.
//
// What bounds it on the card (H100): the bytes. At CaiT's [128, 8, 196,
// 196] float32 the dots, g and ds are 157.35 MB each, ≥ 0.141 ms at
// 3.35 TB/s. This design reads the dots and g twice (the second time mostly
// from L2) and moves two planes an image through distributed shared memory.
#include "talking_heads_cluster.cuh"

namespace nrv {
namespace thc {

template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads, 1)
th_cluster_bwd_kernel(const T* __restrict__ dots, const T* __restrict__ gall,
                      const float* __restrict__ vecs, const float* __restrict__ pre,
                      const float* __restrict__ post, T* __restrict__ ds_all,
                      float* __restrict__ part_pre, float* __restrict__ part_post, int H, int n,
                      int iters, int final_row) {
  constexpr int kThreads = kBwdThreads, kWarps = kThreads / 32;
  constexpr int U = Lanes<VEC>::kUnits;
  constexpr int R = kRowsAtOnce;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank();
  const int b = blockIdx.x / H;
  const int ld = padded_ld(n);
  const size_t nn = (size_t)n * n;
  const int ka = num_arows(iters, final_row);
  const int nrows = ka + iters + 1;  // rows of an item's residual stack
  const int rsmax = strip_rows_max(n, H);
  // shared memory (bwd_smem_floats)
  float* E = smem;  // A, then C
  float* ones = E + (size_t)n * ld;
  float* arows = ones + ld;
  float* brows = arows + (size_t)ka * ld;
  float* da = brows + (size_t)iters * ld;
  float* dbrow = da + ld;
  float* svec = dbrow + ld;
  float* dcs = svec + ld;                  // dc_t, t < iters
  float* drs = dcs + (size_t)iters * ld;   // dr of the final row norm, then dr_t, t ≥ 1
  float* part = drs + (size_t)iters * ld;  // column partials [kWarps][ld]
  float* dbr = part + (size_t)kWarps * ld;  // the strips' db partials [H][ld]
  float* pre_t = dbr + (size_t)H * ld;      // pre_t[g][h] = pre[h, g]
  float* post_n = pre_t + kTable;           // post_n[g][q] = post[g, q]
  float* red = post_n + kTable;             // [kWarps][kTable]
  float* lse_s = red + kWarps * kTable;          // [rsmax][kMaxH], lse·log2 e
  float* af_s = lse_s + (size_t)rsmax * kMaxH;   // [rsmax][kMaxH], final a
  float* dap = af_s + (size_t)rsmax * kMaxH;     // [rsmax][kWarps][H], da partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = strip_row(k, n, H), r1 = strip_row(k + 1, n, H), rs = r1 - r0;

  THC_PHASE_INIT
  load_table<kThreads>(pre_t, pre, H, true);
  load_table<kThreads>(post_n, post, H, false);
  for (int j = threadIdx.x; j < ld; j += kThreads) ones[j] = 1.f;
  {
    // this block's a- and b-rows by cp.async: phase 2 waits for them
    const float* mine = vecs + (size_t)(b * H + k) * nrows * n;
    for (int x = threadIdx.x; x < ka * n; x += kThreads)
      cp_async4(&arows[(x / n) * ld + x % n], mine + x, true);
    for (int x = threadIdx.x; x < iters * n; x += kThreads)
      cp_async4(&brows[(x / n) * ld + x % n], mine + (size_t)ka * n + x, true);
    cp_async_commit();
    // zeros past H: those heads' terms below come out zero
    for (int x = threadIdx.x; x < rs * kMaxH; x += kThreads) {
      const int ri = x / kMaxH, g = x % kMaxH;
      const float* v = vecs + (size_t)(b * H + g) * nrows * n;
      lse_s[x] = g < H ? v[(size_t)(ka + iters) * n + r0 + ri] * kLog2e : 0.f;
      af_s[x] = g < H ? (ka > 0 ? v[(size_t)(ka - 1) * n + r0 + ri] : 1.f) : 0.f;
    }
  }
  exchange_init(&bar, 1);  // also publishes the tables and the strip's rows
  if (threadIdx.x == 0)
    hopper::mbar_expect_tx(
        &bar, (uint32_t)(sizeof(float) * ((size_t)(n - rs) * (n + 1) + (size_t)(H - 1) * n)));
  THC_PHASE(0);

  const T* s_img = dots + (size_t)b * H * nn;
  const T* g_img = gall + (size_t)b * H * nn;
  const int j = threadIdx.x;  // the strip owner's column
  const bool live = j < n;
  float bf[kMaxH];  // final b of every head at column j
#pragma unroll
  for (int g = 0; g < kMaxH; ++g)
    bf[g] = (g < H && live)
                ? vecs[(size_t)(b * H + g) * nrows * n + (size_t)(ka + iters - 1) * n + j]
                : 0.f;
  auto load_entry = [&](int i, float (&sv)[kMaxH], float (&gv)[kMaxH]) {
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const bool ok = h < H && live && i < r1;
      sv[h] = ok ? to_f(s_img[h * nn + (size_t)i * n + j]) : 0.f;
      gv[h] = ok ? to_f(g_img[h * nn + (size_t)i * n + j]) : 0.f;
    }
  };

  // 1. strip k: A_g to block g, the da and db sums, the dpost partial
  {
    uint32_t dst[kMaxH], dbar[kMaxH];
#pragma unroll
    for (int g = 0; g < kMaxH; ++g) {
      dst[g] = cluster_addr(E, g < H ? g : 0);
      dbar[g] = cluster_addr(&bar, g < H ? g : 0);
    }
    float db[kMaxH], dpost[kTable];
#pragma unroll
    for (int g = 0; g < kMaxH; ++g) db[g] = 0.f;
#pragma unroll
    for (int x = 0; x < kTable; ++x) dpost[x] = 0.f;
    float sv[kMaxH], gv[kMaxH], sn[kMaxH], gn[kMaxH];
    load_entry(r0, sn, gn);
    for (int ri = 0; ri < rs; ++ri) {
      const int i = r0 + ri;
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        sv[h] = sn[h];
        gv[h] = gn[h];
      }
      load_entry(i + 1, sn, gn);  // the next row's loads in flight
      // every head, branch-free: past H the tables, s, gy, lse, a and b
      // are zeros, so those heads' terms are zeros
      const int off = i * ld + j;
      const float* lse_r = lse_s + ri * kMaxH;
      const float* af_r = af_s + ri * kMaxH;
      float dav[kMaxH];
#pragma unroll
      for (int g = 0; g < kMaxH; ++g) {
        float c[kMaxH];
        table_row(pre_t, g, c);
        const float A = ex2(fmaf(mix8(c, sv), kLog2e, -lse_r[g]));
        const bool send = live && g < H;
        if (send && g == k) E[off] = A;
        st_async_if(send && g != k, dst[g] + 4 * off, A, dbar[g]);
        table_row(post_n, g, c);
        const float q = A * mix8(c, gv);  // A ⊙ gw
        const float af = af_r[g];
        const float w = A * af * bf[g];
        dav[g] = q * bf[g];
        db[g] = fmaf(q, af, db[g]);
#pragma unroll
        for (int x = 0; x < kMaxH; ++x)
          dpost[g * kMaxH + x] = fmaf(w, gv[x], dpost[g * kMaxH + x]);
      }
      // the row's da partials of this warp: lane 4·g' holds head g' after
      // the reduce-scatter
      int base = 0;
      rs_step<4>(dav, 16, base);
      rs_step<2>(dav, 8, base);
      rs_step<1>(dav, 4, base);
      dav[0] += __shfl_xor_sync(0xffffffffu, dav[0], 2);
      dav[0] += __shfl_xor_sync(0xffffffffu, dav[0], 1);
      if ((lane & 3) == 0 && base < H) dap[((size_t)ri * kWarps + warp) * H + base] = dav[0];
    }
    __syncthreads();
    THC_PHASE(1);
    // da of the strip's rows (the warps that hold columns, in order) and
    // the strip's db partial, to every block
    const int wcols = (n + 31) / 32;
    for (int x = threadIdx.x; x < rs * H; x += kThreads) {
      const int ri = x / H, g = x % H, i = r0 + ri;
      float t = 0.f;
      for (int w = 0; w < wcols; ++w) t += dap[((size_t)ri * kWarps + w) * H + g];
      if (g == k)
        da[i] = t;
      else
        st_async(cluster_addr(da + i, g), t, cluster_addr(&bar, g));
    }
    if (live) {
#pragma unroll
      for (int g = 0; g < kMaxH; ++g)
        if (g < H) {
          if (g == k)
            dbr[k * ld + j] = db[g];
          else
            st_async(cluster_addr(dbr + k * ld + j, g), db[g], dbar[g]);
        }
    }
    block_sum_table<kThreads>(dpost, H, red, part_post + (size_t)(b * H + k) * H * H);
  }
  THC_PHASE(2);
  mbar_wait_cluster(&bar, 0);
  cp_async_wait<0>();
  __syncthreads();
  THC_PHASE(3);

  // 2. the reverse chain on A_k
  const float* a_fin = ka > 0 ? arows + (size_t)(ka - 1) * ld : ones;
  auto as_r = [&](int t) { return t == 0 ? (const float*)ones : arows + (size_t)(t - 1) * ld; };
  auto bs_r = [&](int t) { return t == 0 ? (const float*)ones : brows + (size_t)(t - 1) * ld; };
  for (int x = threadIdx.x; x < n; x += kThreads) {
    float t = 0.f;
    for (int q = 0; q < H; ++q) t += dbr[q * ld + x];  // strip order
    dbrow[x] = t;
    if (final_row) {
      const float tmp = da[x] * a_fin[x];
      drs[x] = -(tmp * a_fin[x]);
      svec[x] = -tmp;
    } else {
      svec[x] = 0.f;
    }
  }
  __syncthreads();
  const int sub = threadIdx.x % kRowLanes;
  if (final_row) {  // db_row += Aᵀ·dr of the final row norm
    float acc[U][VEC] = {};
    for (int i0 = warp * R; i0 < n; i0 += kWarps * R) {
      const int i = i0 + Lanes<VEC>::row();
      float x[U][VEC];
      load_row<VEC>(E, ld, n, i, x, 0.f);
      col_acc<VEC>(acc, x, i < n ? drs[i] : 0.f);
    }
    col_finish<kThreads, VEC>(acc, part, ld, n, [&](int jj, float t) { dbrow[jj] += t; });
  }
  THC_PHASE(4);
  for (int t = iters - 1; t >= 0; --t) {
    // dc_t from the grad of b_t = bs_r(t + 1)
    const float* b_t = bs_r(t + 1);
    float* dc = dcs + (size_t)t * ld;
    for (int x = threadIdx.x; x < n; x += kThreads) dc[x] = dbrow[x] * -(b_t[x] * b_t[x]);
    __syncthreads();
    float dcl[U][VEC];
    load_vec<VEC>(dc, n, dcl);
    if (t > 0) {
      // m_dc = A·dc, then dr_t and db_row = Aᵀ·dr_t in the same read
      const float* a_t = as_r(t);
      float* dr = drs + (size_t)t * ld;
      const bool da_live = !final_row && t == iters - 1;
      float acc[U][VEC] = {};
      for (int i0 = warp * R; i0 < n; i0 += kWarps * R) {
        const int i = i0 + Lanes<VEC>::row();
        float x[U][VEC];
        load_row<VEC>(E, ld, n, i, x, 0.f);
        const float md = row_sum(lane_dot<VEC>(x, dcl));
        float dri = 0.f, sv = 0.f;
        if (i < n) {
          const float at = a_t[i];
          const float tmp = (da_live ? da[i] + md : md) * at;
          sv = svec[i] + at * md - tmp;
          dri = -(tmp * at);
        }
        __syncwarp();  // every lane of the row has read svec[i]
        if (sub == 0 && i < n) {
          svec[i] = sv;
          dr[i] = dri;
        }
        col_acc<VEC>(acc, x, dri);
      }
      col_finish<kThreads, VEC>(acc, part, ld, n, [&](int jj, float s) { dbrow[jj] = s; });
    } else {
      THC_PHASE(5);
      // the last pass: row_term, the rank-1 terms, C = A ⊙ (Σ u vᵀ − row_term)
      for (int i0 = warp * R; i0 < n; i0 += kWarps * R) {
        const int i = i0 + Lanes<VEC>::row();
        float x[U][VEC], r1v[U][VEC] = {};
        load_row<VEC>(E, ld, n, i, x, 0.f);
        auto term = [&](const float* u, const float* v) {
          float vl[U][VEC];
          load_vec<VEC>(v, n, vl);
          const float ui = i < n ? u[i] : 0.f;
#pragma unroll
          for (int c = 0; c < U; ++c)
#pragma unroll
            for (int e = 0; e < VEC; ++e) r1v[c][e] = fmaf(ui, vl[c][e], r1v[c][e]);
        };
        // the terms in the order the reverse chain makes them
        if (final_row) term(drs, bs_r(iters));
        for (int tt = iters - 1; tt >= 1; --tt) {
          term(as_r(tt), dcs + (size_t)tt * ld);
          term(drs + (size_t)tt * ld, bs_r(tt));
        }
        term(ones, dc);
        const float md = row_sum(lane_dot<VEC>(x, dcl));
        const float row_term = i < n ? a_fin[i] * da[i] + (svec[i] + md) : 0.f;
#pragma unroll
        for (int c = 0; c < U; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) x[c][e] = x[c][e] * (r1v[c][e] - row_term);
        store_row<VEC>(E, ld, n, i, x);
      }
    }
  }
  THC_PHASE(6);
  cluster.sync();
  THC_PHASE(7);

  // 3. strip k: dm_g from A_g, gw_g and C_g; ds_h written once; the dpre
  //    partial
  {
    const float* src[kMaxH];
#pragma unroll
    for (int g = 0; g < kMaxH; ++g) src[g] = cluster.map_shared_rank(E, g < H ? g : 0);
    float dpre[kTable];
#pragma unroll
    for (int x = 0; x < kTable; ++x) dpre[x] = 0.f;
    T* ds_img = ds_all + (size_t)b * H * nn;
    float sv[kMaxH], gv[kMaxH], sn[kMaxH], gn[kMaxH], cv[kMaxH], cn[kMaxH];
    auto load_c = [&](int i, float (&c)[kMaxH]) {
#pragma unroll
      for (int g = 0; g < kMaxH; ++g)
        c[g] = (g < H && live && i < r1) ? src[g][(size_t)i * ld + j] : 0.f;
    };
    load_entry(r0, sn, gn);
    load_c(r0, cn);
    for (int ri = 0; ri < rs; ++ri) {
      const int i = r0 + ri;
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        sv[h] = sn[h];
        gv[h] = gn[h];
        cv[h] = cn[h];
      }
      load_entry(i + 1, sn, gn);
      load_c(i + 1, cn);
      // every head, branch-free, as in phase 1
      const float* lse_r = lse_s + ri * kMaxH;
      const float* af_r = af_s + ri * kMaxH;
      float dsv[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) dsv[h] = 0.f;
#pragma unroll
      for (int g = 0; g < kMaxH; ++g) {
        float c[kMaxH];
        table_row(pre_t, g, c);  // pre[:, g]
        const float A = ex2(fmaf(mix8(c, sv), kLog2e, -lse_r[g]));
        float cp[kMaxH];
        table_row(post_n, g, cp);
        const float dm = fmaf(A * af_r[g], mix8(cp, gv) * bf[g], cv[g]);
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) {
          dsv[h] = fmaf(c[h], dm, dsv[h]);
          dpre[h * kMaxH + g] = fmaf(sv[h], dm, dpre[h * kMaxH + g]);
        }
      }
      if (live) {
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          if (h < H) store_f(ds_img + h * nn + (size_t)i * n + j, dsv[h]);
      }
    }
    THC_PHASE(8);
    block_sum_table<kThreads>(dpre, H, red, part_pre + (size_t)(b * H + k) * H * H);
  }
  THC_PHASE(9);
  cluster.sync();  // no block leaves while another still reads its plane
  THC_PHASE(10);
}

// dpre[h, g] = Σ_k Σ_b part_pre[b, k, h·H + g] (block 0) and
// dpost[g, q] = Σ_k Σ_b part_post[b, k, g·H + q] (block 1): each strip's
// partials summed over the images in order, then the strips in order.
__global__ void __launch_bounds__(kMaxH * kTable)
th_cluster_reduce_kernel(const float* __restrict__ part_pre, const float* __restrict__ part_post,
                         float* __restrict__ dpre, float* __restrict__ dpost, int B, int H) {
  __shared__ float strip_sum[kMaxH * kTable];
  const float* part = blockIdx.x == 0 ? part_pre : part_post;
  float* out = blockIdx.x == 0 ? dpre : dpost;
  const int hh = H * H, t = threadIdx.x;
  if (t < H * hh) {
    const int k = t / hh, e = t % hh;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += part[((size_t)b * H + k) * hh + e];
    strip_sum[t] = s;
  }
  __syncthreads();
  if (t < hh) {
    float s = 0.f;
    for (int k = 0; k < H; ++k) s += strip_sum[k * hh + t];
    out[t] = s;
  }
}

template <typename T>
int launch_bwd(const void* dots, const void* g, const void* vecs, const void* pre,
               const void* post, void* ds, void* dpre, void* dpost, void* part, int B, int H,
               int n, int iters, int final_row, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * bwd_smem_floats(n, H, iters, num_arows(iters, final_row));
  float* part_pre = static_cast<float*>(part);
  float* part_post = part_pre + (size_t)B * H * H * H;
  auto args = [&](auto kernel) {
    return launch(kernel, kBwdThreads, B, H, smem, stream, static_cast<const T*>(dots),
                  static_cast<const T*>(g), static_cast<const float*>(vecs),
                  static_cast<const float*>(pre), static_cast<const float*>(post),
                  static_cast<T*>(ds), part_pre, part_post, H, n, iters, final_row);
  };
  cudaError_t err =
      n % 4 == 0 ? args(th_cluster_bwd_kernel<T, 4>) : args(th_cluster_bwd_kernel<T, 1>);
  if (err != cudaSuccess) return (int)err;
  th_cluster_reduce_kernel<<<2, kMaxH * kTable, 0, stream>>>(
      part_pre, part_post, static_cast<float*>(dpre), static_cast<float*>(dpost), B, H);
  return (int)cudaGetLastError();
}

}  // namespace thc
}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. dots, g and ds [B, H, N, N] in that dtype;
// vecs float32 [B·H, R, N] from either forward; pre and post float32
// [H, H]; dpre and dpost float32 [H, H] out. Scratch: part float32
// [2, B, H, H·H] (the per-(image, strip) partials). Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape the cluster kernels
// do not take).
extern "C" int nrv_talking_heads_cluster_bwd(const void* dots, const void* g, const void* vecs,
                                             const void* pre, const void* post, void* ds,
                                             void* dpre, void* dpost, void* part, int dtype,
                                             int B, int H, int N, int iters, int final_row,
                                             void* stream) {
  if (B < 1 || !nrv::thc::takes(H, N, iters, final_row)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::thc::launch_bwd<float>(dots, g, vecs, pre, post, ds, dpre, dpost, part, B, H, N,
                                       iters, final_row, st);
  if (dtype == 1)
    return nrv::thc::launch_bwd<__nv_bfloat16>(dots, g, vecs, pre, post, ds, dpre, dpost, part,
                                               B, H, N, iters, final_row, st);
  return (int)cudaErrorInvalidValue;
}

// Clusters of the backward kernel at this shape that fit on the card at
// once (cudaOccupancyMaxActiveClusters; -1 on an error).
extern "C" int nrv_talking_heads_cluster_bwd_clusters(int dtype, int H, int N, int iters,
                                                      int final_row) {
  if (!nrv::thc::takes(H, N, iters, final_row) || (dtype != 0 && dtype != 1)) return -1;
  const size_t smem = sizeof(float) * nrv::thc::bwd_smem_floats(
                                          N, H, iters, nrv::num_arows(iters, final_row));
  using nrv::thc::active_clusters;
  using nrv::thc::kBwdThreads;
  using nrv::thc::th_cluster_bwd_kernel;
  if (N % 4 == 0)
    return dtype == 0
               ? active_clusters(th_cluster_bwd_kernel<float, 4>, kBwdThreads, H, smem)
               : active_clusters(th_cluster_bwd_kernel<__nv_bfloat16, 4>, kBwdThreads, H, smem);
  return dtype == 0
             ? active_clusters(th_cluster_bwd_kernel<float, 1>, kBwdThreads, H, smem)
             : active_clusters(th_cluster_bwd_kernel<__nv_bfloat16, 1>, kBwdThreads, H, smem);
}
