// Fused LayerNorm, forward: y = (x − mean)·rstd·g + b over the last axis of
// x [R, D] (float32 or bfloat16; y the same), rstd = 1/√(var + eps), the
// moments in float32 and in two passes (the mean, then the mean of
// (x − mean)²). g and b are float32 [D].
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/fused_ln.py
// ::_fwd_impl (pl.pallas_call at :90, body _fwd_kernel :43-52). There a grid
// step holds 512 rows in VMEM; here a row is one warp's, 8 lanes' or one
// block's (fused_ln.cuh row_lanes), with bounds checks for any row count
// instead of padding.
//
// What bounds it on the card (H100): the bytes. At SimpleViT-B/16's
// [50176, 768] bf16 it must read x and write y, 2 × 77.07 MB, ≥ 0.046 ms at
// 3.35 TB/s; its ~8 float32 operations an element are ~0.3 GFLOP, far below
// the CUDA cores' 67 TFLOP/s. The design reads x once and writes y once:
// the row stays on the chip between the two moment passes and the
// normalization (the eager float32 LayerNorm casts x to float32, normalizes
// and casts back: three kernels and five times the bytes in bfloat16).
//
// Design. G lanes a row (256 / G rows a block): a warp (G = 32) where D is
// a multiple of 128 up to 1024, 8 lanes (four rows a warp) at the other
// widths up to 256. A lane holds D/G elements in registers as D/(4G) runs
// of four (16-byte loads in float32, 8-byte in bfloat16; lane l of the
// row's group takes columns 4·(G·c + l) .. +3, so a group's loads are one
// contiguous segment a run: 256 bytes a row at G = 32, 64 at G = 8 in
// bfloat16), and the moments come from butterfly shuffles over the group.
// At Swin-T's and CvT-13's 64, 96 and 192 a warp a row would hold a
// part-run or leave lanes idle; 8 lanes a row keep every lane on whole runs
// and put four rows' loads in flight a warp (on an H100 at [401408, 96]
// bf16 84% of the byte bound, the warp path at [50176, 768] 83%).
// The rest (D > 1024, and 288 to 992 where no multiple of 128): one block a
// row, the row held in shared memory as float32, each thread on its own
// runs of four, the moments from block sums in a fixed order. No cross-row
// work: nothing to reduce over blocks.
#include "fused_ln.cuh"

namespace nrv {
namespace fln {

// G lanes a row, NC = D / (4G) runs of four a lane.
template <typename T, int G, int NC>
__global__ void __launch_bounds__(kThreads)
fused_ln_fwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ g,
                         const float* __restrict__ b, T* __restrict__ y, int R, float eps) {
  constexpr int D = 4 * G * NC;
  const int lane = threadIdx.x % G;
  const int row = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (row >= R) return;  // the row's lanes together
  const T* xr = x + (size_t)row * D;
  float4 v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) v[c] = load4(xr + 4 * (G * c + lane));
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) s += sum4(v[c]);
  const float mu = lanes_sum<G>(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    v[c] = make_float4(v[c].x - mu, v[c].y - mu, v[c].z - mu, v[c].w - mu);
    q += ((v[c].x * v[c].x + v[c].y * v[c].y) + v[c].z * v[c].z) + v[c].w * v[c].w;
  }
  const float rstd = rsqrtf(lanes_sum<G>(q) / (float)D + eps);
  T* yr = y + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = 4 * (G * c + lane);
    const float4 gg = load4(g + j), bb = load4(b + j);
    store4(yr + j, make_float4(v[c].x * rstd * gg.x + bb.x, v[c].y * rstd * gg.y + bb.y,
                               v[c].z * rstd * gg.z + bb.z, v[c].w * rstd * gg.w + bb.w));
  }
}

// One block a row; dynamic shared memory: the row, D floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ln_fwd_block_kernel(const T* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ b, T* __restrict__ y, int D, float eps) {
  extern __shared__ float4 row4[];
  __shared__ float red[kWarps];
  const int nq = D / 4;
  const T* xr = x + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const float4 v = load4(xr + 4 * q);
    row4[q] = v;
    s += sum4(v);
  }
  const float mu = block_sum(s, red) / (float)D;
  // each thread reads back only the runs it wrote: no barrier needed
  float ss = 0.f;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const float4 v = row4[q];
    const float4 c = make_float4(v.x - mu, v.y - mu, v.z - mu, v.w - mu);
    ss += ((c.x * c.x + c.y * c.y) + c.z * c.z) + c.w * c.w;
  }
  const float rstd = rsqrtf(block_sum(ss, red) / (float)D + eps);
  T* yr = y + (size_t)blockIdx.x * D;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const float4 v = row4[q];
    const float4 gg = load4(g + 4 * q), bb = load4(b + 4 * q);
    store4(yr + 4 * q, make_float4((v.x - mu) * rstd * gg.x + bb.x,
                                   (v.y - mu) * rstd * gg.y + bb.y,
                                   (v.z - mu) * rstd * gg.z + bb.z,
                                   (v.w - mu) * rstd * gg.w + bb.w));
  }
}

// The row kernel's arguments, for the dispatch by path.
struct FwdArgs {
  const void *x, *g, *b;
  void* y;
  int R;
  float eps;
  cudaStream_t stream;
};

template <typename T, int G, int NC>
int launch_group(const FwdArgs& a) {
  constexpr int rows = kThreads / G;  // a block's
  fused_ln_fwd_rows_kernel<T, G, NC><<<(a.R + rows - 1) / rows, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.g), static_cast<const float*>(a.b),
      static_cast<T*>(a.y), a.R, a.eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* g, const void* b, void* y, int R, int D, float eps,
               cudaStream_t stream) {
  const FwdArgs a{x, g, b, y, R, eps, stream};
  switch (row_lanes(D)) {  // the lane-group paths, by the runs a lane
    case 32:
      switch (D / 128) {
        case 1: return launch_group<T, 32, 1>(a);
        case 2: return launch_group<T, 32, 2>(a);
        case 3: return launch_group<T, 32, 3>(a);
        case 4: return launch_group<T, 32, 4>(a);
        case 5: return launch_group<T, 32, 5>(a);
        case 6: return launch_group<T, 32, 6>(a);
        case 7: return launch_group<T, 32, 7>(a);
        case 8: return launch_group<T, 32, 8>(a);
      }
      break;
    case 8:
      switch (D / 32) {  // 4 and 8 are the warp path's
        case 1: return launch_group<T, 8, 1>(a);
        case 2: return launch_group<T, 8, 2>(a);
        case 3: return launch_group<T, 8, 3>(a);
        case 5: return launch_group<T, 8, 5>(a);
        case 6: return launch_group<T, 8, 6>(a);
        case 7: return launch_group<T, 8, 7>(a);
      }
      break;
  }
  const size_t smem = sizeof(float) * (size_t)D;  // at most 32 KB: no opt-in needed
  fused_ln_fwd_block_kernel<T><<<R, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(y), D, eps);
  return (int)cudaGetLastError();
}

}  // namespace fln
}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. x and y [R, D] contiguous, 16-byte aligned;
// g, b float32 [D]. Returns cudaGetLastError() after the launch.
extern "C" int nrv_fused_ln_fwd(const void* x, const void* g, const void* b, void* y,
                                int dtype, int R, int D, float eps, void* stream) {
  if (R < 1 || !nrv::fln::supported(D)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return nrv::fln::launch_fwd<float>(x, g, b, y, R, D, eps, s);
  if (dtype == 1) return nrv::fln::launch_fwd<__nv_bfloat16>(x, g, b, y, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
