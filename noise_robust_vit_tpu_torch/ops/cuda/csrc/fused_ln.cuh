// Pieces shared by the fused LayerNorm kernels (fused_ln_{fwd,bwd}.cu):
// the gate, the backward's row blocking, four-element loads and stores, and
// the warp and block sums. Everything sits in nrv::fln, apart from the
// other kernels' helpers of the same names.
//
// The gate is the TPU kernel's (noise_robust_vit_tpu/ops/pallas/fused_ln.py
// ::fused_ln_supported): D a multiple of 128, at most 8192. Python mirrors
// it in ops/cuda/fused_ln.py (fused_ln_supported); change one, change the
// other. Python reads the row blocking from nrv_fused_ln_bwd_blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nrv {
namespace fln {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kLane = 128;     // D % kLane == 0: four elements a lane, in chunks
constexpr int kMaxD = 8192;
constexpr int kWarpMaxD = 1024;          // one warp a row up to here
constexpr int kWarpRowsPerBlock = 128;   // backward, D <= 1024: 16 rows a warp
constexpr int kBlockRowsPerBlock = 32;   // backward, D > 1024: one row at a time

inline bool supported(int d) { return d >= kLane && d % kLane == 0 && d <= kMaxD; }

// Rows a backward block walks, and so the rows of the dg/db partials.
inline int bwd_rows_per_block(int d) {
  return d <= kWarpMaxD ? kWarpRowsPerBlock : kBlockRowsPerBlock;
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

// Butterfly sum over the warp: every lane ends with the same bits (each
// step adds the same two values on both lanes, and addition commutes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block's kThreads threads: warp sums, then the kWarps of
// them in warp order. `red` holds kWarps floats; ends with a barrier, so
// the next call may reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
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
