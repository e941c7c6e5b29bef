// Talking-heads Sinkhorn, the cluster branch: what the forward and backward
// kernels (talking_heads_cluster_{fwd,bwd}.cu) share. float32 or bfloat16
// dots [B, H, N, N] with 1 ≤ H ≤ kMaxH heads and 2 ≤ N ≤ kMaxN, 1-8
// iterations, with or without the final row norm; every other shape the
// gate takes stays on the plane kernels (talking_heads_{fwd,bwd}.cu).
//
// Counterpart of noise_robust_vit_tpu/ops/pallas/talking_heads.py::
// _th_fwd_impl / _th_bwd_impl. Its caller is robust CaiT @224: 8 heads of
// 196 × 196 float32 logits, 128 images a call.
//
// Design. One thread-block cluster an image, one block a head (rank k). Two
// jobs a block:
//  * strip owner: rows [k·N/H, (k + 1)·N/H) of every plane of the image.
//    It reads that strip of the dots (and, backward, of g) from device
//    memory once, mixes the heads there in registers, and trades strips
//    with the other blocks through distributed shared memory: each mixed
//    strip g goes by st.async into block g's shared memory, completing
//    block g's mbarrier; the other way, it reads strip k of every block's
//    plane (generic loads through map_shared_rank) and writes strip k of
//    every output plane.
//  * plane holder: the whole N×N float32 plane of mixed head g = k in
//    shared memory (~150 KB at N = 196), on which it runs the softmax and
//    the Sinkhorn chain.
// So each byte of the dots is read once, and no N×N plane goes to device
// memory but the outputs. The chain's passes read each row whole: a row
// takes 8 lanes (each its runs of VEC columns, 28 floats at N = 196), a
// warp 4 rows at a time, so a row sum is 3 shuffles, and a column sum is a
// partial in each lane's registers over the lane's rows, added across the
// warp's row groups and then over the warps in warp order (col_finish). A
// row pass and the column pass after it share one read of the plane: the
// row's scale is known before the warp lets go of the row. No atomics anywhere; the H×H gradients are per-(image, strip)
// partials that a second kernel adds in a fixed order. Two runs give the
// same bits.
#pragma once

#include "cluster.cuh"
#include "resident_warp.cuh"
#include "sinkhorn_softmax.cuh"

namespace nrv {
namespace thc {

// Threads a block: the forward 16 warps (the only block on its SM, under
// 128 registers); the backward 8, whose strip phases hold every head's s
// and gy and an 8×8 table of sums in registers (~245).
constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;
constexpr int kMaxH = 8;       // one block a head: a portable cluster
constexpr int kMaxN = 200;     // a plane in a block's shared memory at 8 iterations
constexpr int kTable = kMaxH * kMaxH;
// A pass over the plane: a row takes kRowLanes lanes, a warp kRowsAtOnce
// rows at a time.
constexpr int kRowLanes = 8;
constexpr int kRowsAtOnce = 32 / kRowLanes;

// A lane's place in a pass: row Lanes::row() of the warp's rows at a time,
// and the runs of VEC columns VEC·(lane % kRowLanes + kRowLanes·c) for
// c < kUnits (N ≤ kMaxN).
template <int VEC>
struct Lanes {
  static constexpr int kUnits = (kMaxN / VEC + kRowLanes - 1) / kRowLanes;
  static __device__ __forceinline__ int col(int c) {
    return VEC * ((int)(threadIdx.x % kRowLanes) + kRowLanes * c);
  }
  static __device__ __forceinline__ int row() { return (int)(threadIdx.x % 32) / kRowLanes; }
};

// Strip k of H: rows [k·n/H, (k + 1)·n/H).
__host__ __device__ inline int strip_row(int k, int n, int H) { return k * n / H; }
__host__ __device__ inline int strip_rows_max(int n, int H) { return (n + H - 1) / H; }

// Shared memory, in floats, each vector ld wide (16-byte aligned).
//   forward: the plane, inv_r, a_scale, b, the warps' column partials, two
//   mix tables;
//   backward: the plane, ones, the a-rows, the b-rows, da, db_row, svec,
//   the dc and dr vectors of the reverse chain, the column partials, the
//   strips' db partials, two mix tables, the table reduction, the strip's
//   lse and final a of every head a row ([rows][kMaxH], zeros past H), then
//   (not 16-byte aligned) the strip's da partials.
__host__ __device__ inline size_t fwd_smem_floats(int n) {
  const size_t ld = padded_ld(n);
  return (size_t)n * ld + (3 + kFwdThreads / 32) * ld + 2 * kTable;
}
__host__ __device__ inline size_t bwd_smem_floats(int n, int H, int iters, int ka) {
  const size_t ld = padded_ld(n);
  const size_t rs = strip_rows_max(n, H);
  constexpr int warps = kBwdThreads / 32;
  return (size_t)n * ld + (size_t)(1 + ka + iters + 3 + 2 * iters + warps + H) * ld +
         rs * (2 * kMaxH + H * warps) + warps * kTable + 2 * kTable;
}

// A mix table t[o·kMaxH + c] = mix[c, o] (transpose) or mix[o, c], for
// o, c < H from the float32 [H, H] `mix`; zeros elsewhere. NT threads.
template <int NT>
__device__ inline void load_table(float* t, const float* mix, int H, bool transpose) {
  for (int x = threadIdx.x; x < kTable; x += NT) {
    const int o = x / kMaxH, c = x % kMaxH;
    t[x] = (o < H && c < H) ? (transpose ? mix[c * H + o] : mix[o * H + c]) : 0.f;
  }
}

// Row o of a table (16-byte aligned) into registers.
__device__ __forceinline__ void table_row(const float* t, int o, float (&c)[kMaxH]) {
  const float4 lo = *reinterpret_cast<const float4*>(t + o * kMaxH);
  const float4 hi = *reinterpret_cast<const float4*>(t + o * kMaxH + 4);
  c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
  c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
}

// Σ_h c[h]·x[h] for h < H in head order (the TPU kernel's _mix order).
// mix8 sums all kMaxH terms: where the coefficients and x past H are zeros,
// the same bits without a test a head.
__device__ __forceinline__ float mix1(const float (&c)[kMaxH], const float (&x)[kMaxH], int H) {
  float m = 0.f;
#pragma unroll
  for (int h = 0; h < kMaxH; ++h)
    if (h < H) m = fmaf(c[h], x[h], m);
  return m;
}
__device__ __forceinline__ float mix8(const float (&c)[kMaxH], const float (&x)[kMaxH]) {
  float m = 0.f;
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) m = fmaf(c[h], x[h], m);
  return m;
}
__device__ __forceinline__ float4 mix4(const float (&c)[kMaxH], const float4 (&x)[kMaxH], int H) {
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int h = 0; h < kMaxH; ++h)
    if (h < H)
      m = make_float4(fmaf(c[h], x[h].x, m.x), fmaf(c[h], x[h].y, m.y), fmaf(c[h], x[h].z, m.z),
                      fmaf(c[h], x[h].w, m.w));
  return m;
}

// Row i of the plane E (row stride ld): this lane's runs into registers,
// `fill` past row or column n.
template <int VEC>
__device__ __forceinline__ void load_row(const float* E, int ld, int n, int i,
                                         float (&x)[Lanes<VEC>::kUnits][VEC], float fill) {
#pragma unroll
  for (int c = 0; c < Lanes<VEC>::kUnits; ++c) {
    const int j = Lanes<VEC>::col(c);
    if (i < n && j < n) {
      if constexpr (VEC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(E + (size_t)i * ld + j);
        x[c][0] = v.x; x[c][1] = v.y; x[c][2] = v.z; x[c][3] = v.w;
      } else {
        x[c][0] = E[(size_t)i * ld + j];
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[c][e] = fill;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* E, int ld, int n, int i,
                                          const float (&x)[Lanes<VEC>::kUnits][VEC]) {
#pragma unroll
  for (int c = 0; c < Lanes<VEC>::kUnits; ++c) {
    const int j = Lanes<VEC>::col(c);
    if (i < n && j < n) {
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(E + (size_t)i * ld + j) =
            make_float4(x[c][0], x[c][1], x[c][2], x[c][3]);
      else
        E[(size_t)i * ld + j] = x[c][0];
    }
  }
}

// This lane's entries of the vector v (zeros past n).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* v, int n,
                                         float (&x)[Lanes<VEC>::kUnits][VEC]) {
#pragma unroll
  for (int c = 0; c < Lanes<VEC>::kUnits; ++c) {
    const int j = Lanes<VEC>::col(c);
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[c][e] = j < n ? v[j + e] : 0.f;
  }
}

// The sum (max) of v over the kRowLanes lanes of this lane's row: every
// lane of the row gets the same bits.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < kRowLanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < kRowLanes; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Σ over this lane's entries of x times w.
template <int VEC>
__device__ __forceinline__ float lane_dot(const float (&x)[Lanes<VEC>::kUnits][VEC],
                                          const float (&w)[Lanes<VEC>::kUnits][VEC]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < Lanes<VEC>::kUnits; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s = fmaf(x[c][e], w[c][e], s);
  return s;
}

// acc += x times the row's scalar s.
template <int VEC>
__device__ __forceinline__ void col_acc(float (&acc)[Lanes<VEC>::kUnits][VEC],
                                        const float (&x)[Lanes<VEC>::kUnits][VEC], float s) {
#pragma unroll
  for (int c = 0; c < Lanes<VEC>::kUnits; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[c][e] = fmaf(x[c][e], s, acc[c][e]);
}

// The column sums of a pass: each warp's partials, its rows' lanes added
// across the warp (lanes l, l ^ 8, l ^ 16, l ^ 24 hold the same columns),
// to part[warp][j]; a barrier, then post(j, Σ_w part[w][j]) in warp order
// by thread j < n, and a barrier. NT threads; `part` holds NT / 32 rows of
// ld floats.
template <int NT, int VEC, class Post>
__device__ __forceinline__ void col_finish(float (&acc)[Lanes<VEC>::kUnits][VEC], float* part,
                                           int ld, int n, Post post) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < Lanes<VEC>::kUnits; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int o = kRowLanes; o < 32; o <<= 1)
        acc[c][e] += __shfl_xor_sync(0xffffffffu, acc[c][e], o);
  if ((int)(threadIdx.x % 32) < kRowLanes) {
#pragma unroll
    for (int c = 0; c < Lanes<VEC>::kUnits; ++c) {
      const int j = Lanes<VEC>::col(c);
      if (j < n) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[warp * ld + j + e] = acc[c][e];
      }
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) t += part[w * ld + threadIdx.x];
    post((int)threadIdx.x, t);
  }
  __syncthreads();
}

// Σ over the block's threads of the 8×8 table v, in a fixed order: a
// reduce-scatter across each warp's lanes (each lane ends with two entries),
// then the warps in turn; out[t] for t < H·H is entry (t / H, t % H).
// NT threads; `red` holds NT / 32 · kTable floats. Ends with a barrier.
template <int NT>
__device__ inline void block_sum_table(float (&v)[kTable], int H, float* red, float* out) {
  int base = 0;
  rs_step<32>(v, 16, base);
  rs_step<16>(v, 8, base);
  rs_step<8>(v, 4, base);
  rs_step<4>(v, 2, base);
  rs_step<2>(v, 1, base);
  const int warp = threadIdx.x / 32;
  red[warp * kTable + base] = v[0];
  red[warp * kTable + base + 1] = v[1];
  __syncthreads();
  if ((int)threadIdx.x < H * H) {
    const int o = threadIdx.x / H, c = threadIdx.x % H;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w * kTable + o * kMaxH + c];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// The launch: B clusters of H blocks of NT threads, one cluster an image,
// `smem` bytes a block.
template <class Kernel, class... Args>
inline cudaError_t launch(Kernel kernel, int NT, int B, int H, size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the kernel that fit on the card at once (0: none fits).
template <class Kernel>
inline int active_clusters(Kernel kernel, int NT, int H, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}

// The shapes the cluster kernels take (mirrored in ops/cuda/talking_heads.py::
// talking_heads_branch).
__host__ __device__ inline bool takes(int H, int n, int iters, int final_row) {
  return H >= 1 && H <= kMaxH && n >= 2 && n <= kMaxN && iters >= 1 && iters <= kMaxIters &&
         (final_row == 0 || final_row == 1);
}

}  // namespace thc
}  // namespace nrv

// Phase timers of tools/torch_th_phases.py: nothing in the package's build.
#ifndef THC_PHASE
#define THC_PHASE(k)
#define THC_PHASE_INIT
#endif
