// Pieces shared by the fused LayerNorm kernels (fused_ln_{fwd,bwd}.cu):
// the gate, the paths by width, the backward's row blocking, four-element
// loads and stores, and the lane-group and block sums. Everything sits in
// nrv::fln, apart from the other kernels' helpers of the same names.
//
// The gate: D a multiple of 32, from 32 to 8192. Python mirrors it in
// ops/cuda/fused_ln.py (fused_ln_supported); change one, change the other.
// It contains the TPU kernel's (noise_robust_vit_tpu/ops/pallas/fused_ln.py
// ::fused_ln_supported: D a multiple of 128, the TPU's lane width); on this
// card a row splits into runs of four over 8 lanes, so 32 is the step.
// Python reads the row blocking from nrv_fused_ln_bwd_blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nrv {
namespace fln {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 32;      // D % kStep == 0: runs of four over 8 lanes
constexpr int kMaxD = 8192;
constexpr int kBlockRowsPerBlock = 32;  // backward, block path: one row at a time

inline bool supported(int d) { return d >= kStep && d % kStep == 0 && d <= kMaxD; }

// Lanes that hold a row inside the gate: 32, a warp a row (D a multiple of
// 128 up to 1024); 8, four rows a warp (the other widths up to 256, D / 32
// runs of four a lane: 1, 2, 3, 5, 6 or 7); 0, a block a row (the rest).
inline int row_lanes(int d) {
  if (d % 128 == 0 && d <= 1024) return 32;
  return d <= 256 ? 8 : 0;
}

// Rows a lane group of the backward walks: 16 on the warp path, 8 on the
// 8-lane path (fused_ln_bwd.cu says why).
__host__ __device__ constexpr int group_rows(int lanes) { return lanes == 32 ? 16 : 8; }

// Rows a backward block walks, and so the rows of the dg/db partials: 128
// on the warp path, 256 on the 8-lane path, 32 on the block path.
inline int bwd_rows_per_block(int d) {
  const int lanes = row_lanes(d);
  return lanes ? group_rows(lanes) * (kThreads / lanes) : kBlockRowsPerBlock;
}
inline int bwd_blocks(int rows, int d) {
  const int rpb = bwd_rows_per_block(d);
  return (rows + rpb - 1) / rpb;
}

// Four consecutive elements as float32, from 16-byte aligned float32 or
// 8-byte aligned bfloat16 storage, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float sum4(float4 v) { return ((v.x + v.y) + v.z) + v.w; }

// Butterfly sum over G aligned lanes (G = 32: the warp): every lane of the
// group ends with the same bits (each step adds the same two values on both
// lanes, and addition commutes). The mask names the group alone, so groups
// of a warp whose rows ran out need not be present.
template <int G>
__device__ __forceinline__ float lanes_sum(float v) {
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// Sum over the block's kThreads threads: warp sums, then the kWarps of
// them in warp order. `red` holds kWarps floats; ends with a barrier, so
// the next call may reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = lanes_sum<32>(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

}  // namespace fln
}  // namespace nrv
