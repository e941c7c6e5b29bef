// Packed-qkv attention, forward, resident branch (bf16, D = 64, N ≤ 198 as
// packed_resident.cuh::resident_fits allows; SimpleViT-B/16's N = 196 and
// vit_b_16's 197): softmax, or softmax + Sinkhorn in scaling-vector form,
// read from the [B, N, 3·H·64] output of to_qkv and written as the
// [B, N, H·64] input of to_out. Same function, outputs and residual stack
// as packed_attention_fwd.cu, which keeps the other shapes.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/block_attention.py
// ::_packed_fwd_impl (pl.pallas_call at :234), whose body is
// sinkhorn_attention.py::_fwd_math_batched.
//
// What bounds it on the card (H100): per (image, head) item, q·kᵀ and the
// split e·V are ~15 MFLOP of bf16 MMA (~2 µs at one SM's share of 989
// TFLOP/s), the N² exps ~1.3 µs, and each pass over the 157 KB matrix
// ~0.7 µs of shared-memory bandwidth; the bytes (q, k, v in, out and vecs
// out, ~0.1 ms a [256, 196, 2304] call) are far below. The scratch branch
// keeps the matrix in device memory and runs every product through a
// generic mma.sync GEMM with float32 tiles. Here:
//   * one persistent block per SM walks the items; the item's matrix stays
//     in shared memory (row stride resident_ld: conflict-free row and
//     transposed fragment reads), no N×N device scratch;
//   * k, v and two q row tiles arrive by TMA (3-D map, rows ≥ N zero-filled,
//     128-byte swizzle) under mbarriers; robust, the next item's k is in
//     flight while this item's chain and output product run (its v and
//     first q tiles are asked for when the item ends);
//   * S = q·kᵀ on wgmma m64n200k16, one 64-row tile a warpgroup; the
//     softmax (max, exp, row sum, 1/r, lse) in the accumulator's registers;
//   * vanilla: P·V straight from those registers (wgmma with A from
//     registers, split into bf16 hi + lo), the output scaled by 1/r: no
//     N×N store at all;
//   * robust: e stored once; the Sinkhorn chain as passes of a warp a row,
//     each iteration's row pass fused with the next column sum (one read of
//     the matrix an iteration; per-warp column partials summed in a fixed
//     order, no atomics); then out = a_scale ⊙ ((e ⊙ b)·V), the b scaling
//     on the float32 side so that V stays exact bf16 (2 MMAs, hi and lo).
// Measured (PERF.md, ops/cuda/packed_phases.py): ~6× the byte bound
// robust, ~3× vanilla; the softmax, the chain and the output product take
// about equal parts. The matrix fills shared memory, so an SM holds one
// block of 8 warps, two a scheduler, and latency is hidden by the
// instruction-level parallelism of each warp alone.
#include "packed_resident.cuh"

namespace nrv {
namespace res {

// Rows a pass takes at once (load_rows).
constexpr int kRows = 8;

// v[r], lane partials of the kRows rows, summed across the warp by halving:
// each exchange keeps half of the rows a lane still carries (7 shuffles
// where 8 butterflies take 40), then two butterflies finish one row. Lane
// l ends with the sum of row l / 4.
__device__ __forceinline__ float row_sums(const float (&v)[kRows]) {
  const int lane = threadIdx.x % 32;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    a[k] = (h16 ? v[4 + k] : v[k]) + __shfl_xor_sync(0xffffffffu, h16 ? v[k] : v[4 + k], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    b[k] = (h8 ? a[2 + k] : a[k]) + __shfl_xor_sync(0xffffffffu, h8 ? a[k] : a[2 + k], 8);
  float c = (h4 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, h4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  return c + __shfl_xor_sync(0xffffffffu, c, 1);
}

// One pass over the matrix, a warp a row (kRows rows at once). row:
// a_i = recip(Σ_j e_ij·b_j / r_i), a_scale_i = a_i / r_i, a_i stored to
// a_out. col: b_j = recip(Σ_i e_ij·a_scale_i), to bvec and b_out; each lane
// keeps its columns' partial sums over its warp's rows, and the warps'
// partials are summed in warp order.
__device__ void fwd_pass(const float* P, int n, int ld, bool row, bool col, const float* inv_r,
                         float* a_scale, float* bvec, float* a_out, float* b_out, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float bw[kPassCols], cacc[kPassCols];
  load_cols(bvec, row ? n : 0, bw);
#pragma unroll
  for (int c = 0; c < kPassCols; ++c) cacc[c] = 0.f;
  const float my_ir = warp_rows_of(inv_r, n);
  const float my_as = warp_rows_of(a_scale, n);
  for (int q0 = 0; warp + kWarps * q0 < n; q0 += kRows) {
    float p[kRows][kPassCols];
    load_rows(P, n, ld, q0, p);
    float as[kRows];
    if (row) {
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = 0.f;
#pragma unroll
        for (int c = 0; c < kPassCols; ++c) s[r] = fmaf(p[r][c], bw[c], s[r]);
      }
      // each lane finishes one row's scalars, then every lane takes all
      const int q = q0 + lane / 4, i = warp + kWarps * q;
      const float ir = __shfl_sync(0xffffffffu, my_ir, q);
      const float a = recip_clamped_rn(row_sums(s) * ir);
      const float my = a * ir;
      if (lane % 4 == 0 && i < n) {
        a_out[i] = a;
        a_scale[i] = my;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) as[r] = __shfl_sync(0xffffffffu, my, 4 * r);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) as[r] = __shfl_sync(0xffffffffu, my_as, q0 + r);
    }
    if (col) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kPassCols; ++c) cacc[c] = fmaf(p[r][c], as[r], cacc[c]);
    }
  }
  if (col) {
    col_sums(cacc, n, part, [&](int j, float s) {
      const float b = recip_clamped_rn(s);
      bvec[j] = b;
      b_out[j] = b;
    });
  }
  __syncthreads();
}

// o = E·V for the warpgroup's 64 rows of a wgmma tile, E in the
// accumulator layout of wg_tile (e[4s + q], this warp's 16 rows) split
// into bf16 hi + lo, V the operand buffer (rows ≥ n zero), on wgmma.
__device__ __forceinline__ void pv_from_regs(const float (&e)[kAcc], const uint8_t* vbuf,
                                             float (&o)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int kb = 0; kb < kOpRows / 16; ++kb) {
    constexpr int kTiles8 = kNCols / 8;
    const int s0 = 2 * kb, s1 = 2 * kb + 1;
    uint32_t hi[4], lo[4];
    hopper::split_bf16x2(e[4 * s0], e[4 * s0 + 1], hi[0], lo[0]);
    hopper::split_bf16x2(e[4 * s0 + 2], e[4 * s0 + 3], hi[1], lo[1]);
    if (s1 < kTiles8) {
      hopper::split_bf16x2(e[4 * s1], e[4 * s1 + 1], hi[2], lo[2]);
      hopper::split_bf16x2(e[4 * s1 + 2], e[4 * s1 + 3], hi[3], lo[3]);
    } else {
      hi[2] = hi[3] = lo[2] = lo[3] = 0u;
    }
    wg_split_mma(o, hi, lo, vbuf, kb);
  }
}

// Two blocks cannot share an SM (the matrix takes ~157 KB): one block of
// two warpgroups, at most 255 registers a thread.
__global__ void __launch_bounds__(kThreads, 1)
packed_resident_fwd_kernel(const __grid_constant__ CUtensorMap tm_ops,
                           const __grid_constant__ CUtensorMap tm_tiles,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ vecs, int B, int N,
                           int H, float scale, int robust, int iters, int final_row) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[4];  // k, v, q slot 0, q slot 1
  uint8_t* base = align_smem(smem_raw);
  uint8_t* kbuf = base;
  uint8_t* vbuf = base + kOpBytes;
  uint8_t* qslots = base + 2 * kOpBytes;
  float* P = reinterpret_cast<float*>(qslots + 2 * kTileBytes);
  const int ld = resident_ld(N);
  float* inv_r = P + (size_t)N * ld;
  float* a_scale = inv_r + N;
  float* bvec = a_scale + N;
  float* part = reinterpret_cast<float*>(qslots);  // kWarps × N floats, in slot 0

  const int tid = threadIdx.x, wg = tid / 128, wl = tid % 128;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int items = B * H, HD = H * kD;
  const int R = num_vecs(iters, final_row, robust);
  const int ka = num_arows(iters, final_row);
  const int row_tiles = (N + kTileRows - 1) / kTileRows;
  const float scale_log2 = scale * kLog2e;
  uint8_t* qslot = qslots + wg * kTileBytes;  // this warpgroup's q tiles: wg, wg + 2

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  auto issue_k = [&](int bh) {
    hopper::mbar_expect_tx(&bars[0], kOpBytes);
    hopper::tma_load_3d(kbuf, &tm_ops, HD + (bh % H) * kD, 0, bh / H, &bars[0]);
  };
  auto issue_vq = [&](int bh) {
    const int b = bh / H, h = bh % H;
    hopper::mbar_expect_tx(&bars[1], kOpBytes);
    hopper::tma_load_3d(vbuf, &tm_ops, 2 * HD + h * kD, 0, b, &bars[1]);
    for (int s = 0; s < 2 && s < row_tiles; ++s) {
      hopper::mbar_expect_tx(&bars[2 + s], kTileBytes);
      hopper::tma_load_3d(qslots + s * kTileBytes, &tm_tiles, h * kD, kTileRows * s, b,
                          &bars[2 + s]);
    }
  };
  if (tid == 0 && (int)blockIdx.x < items) {
    issue_k(blockIdx.x);
    issue_vq(blockIdx.x);
  }
  uint32_t ph_k = 0, ph_v = 0, ph_q = 0;

  for (int bh = blockIdx.x; bh < items; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    const int next = bh + gridDim.x;
    float* vec = vecs + (size_t)bh * R * N;
    __nv_bfloat16* o = out + (size_t)b * N * HD + h * kD;

    hopper::mbar_wait(&bars[0], ph_k);
    ph_k ^= 1;
    if (!robust) {
      hopper::mbar_wait(&bars[1], ph_v);
      ph_v ^= 1;
    }
    for (int rt = wg; rt < row_tiles; rt += 2) {
      hopper::mbar_wait(&bars[2 + wg], ph_q);
      ph_q ^= 1;
      float acc[kAcc];
      wg_tile(acc, qslot, kbuf);  // s = q·kᵀ for rows 64·rt..
      named_sync(1 + wg, 128);    // the slot is free: bring the tile after next
      if (wl == 0 && rt + 2 < row_tiles) {
        hopper::mbar_expect_tx(&bars[2 + wg], kTileBytes);
        hopper::tma_load_3d(qslot, &tm_tiles, h * kD, kTileRows * (rt + 2), b, &bars[2 + wg]);
      }
      // softmax in registers: rows r0 (acc[4s], acc[4s + 1]) and r1
      // (acc[4s + 2], acc[4s + 3]), a row's columns across the quad
      const int r0 = kTileRows * rt + 16 * (wl / 32) + g, r1 = r0 + 8;
      // in base 2: x = s·log2(e), e = 2^(x − max x)
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int s = 0; s < kNCols / 8; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = 8 * s + 2 * t + e < N;
          acc[4 * s + e] = in ? acc[4 * s + e] * scale_log2 : -INFINITY;
          acc[4 * s + 2 + e] = in ? acc[4 * s + 2 + e] * scale_log2 : -INFINITY;
          m0 = fmaxf(m0, acc[4 * s + e]);
          m1 = fmaxf(m1, acc[4 * s + 2 + e]);
        }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int s = 0; s < kNCols / 8; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[4 * s + e] = exp2f(acc[4 * s + e] - m0);
          acc[4 * s + 2 + e] = exp2f(acc[4 * s + 2 + e] - m1);
          s0 += acc[4 * s + e];
          s1 += acc[4 * s + 2 + e];
        }
      s0 = quad_sum(s0);
      s1 = quad_sum(s1);
      const float i0 = 1.f / s0, i1 = 1.f / s1;
      if (t == 0) {  // lse = max s + log Σ e
        if (r0 < N) vec[(size_t)(R - 1) * N + r0] = m0 / kLog2e + logf(s0);
        if (r1 < N) vec[(size_t)(R - 1) * N + r1] = m1 / kLog2e + logf(s1);
      }
      if (robust) {
        if (t == 0) {
          if (r0 < N) inv_r[r0] = a_scale[r0] = i0;
          if (r1 < N) inv_r[r1] = a_scale[r1] = i1;
        }
        // the whole row stride: e is 0 at columns ≥ N
#pragma unroll
        for (int s = 0; s < kNCols / 8; ++s) {
          const int c = 8 * s + 2 * t;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = hr ? r1 : r0;
            if (r < N && c < ld)
              *reinterpret_cast<float2*>(P + (size_t)r * ld + c) =
                  make_float2(acc[4 * s + 2 * hr], acc[4 * s + 2 * hr + 1]);
          }
        }
      } else {
        float ov[32];
        pv_from_regs(acc, vbuf, ov);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = 8 * nt + 2 * t;
          if (r0 < N) store_bf16x2(o + (size_t)r0 * HD + c, ov[4 * nt] * i0, ov[4 * nt + 1] * i0);
          if (r1 < N)
            store_bf16x2(o + (size_t)r1 * HD + c, ov[4 * nt + 2] * i1, ov[4 * nt + 3] * i1);
        }
      }
    }
    if (robust) {
      hopper::fence_proxy_async();
      __syncthreads();  // e complete; the k buffer and the q slots are free
      if (tid == 0 && next < items) issue_k(next);
      // the chain (_fwd_math_batched): b_0 from a_scale = 1/r, then each
      // iteration's row pass fused with its column pass, then the final
      // row pass
      float* brows = vec + (size_t)ka * N;
      fwd_pass(P, N, ld, false, true, inv_r, a_scale, bvec, nullptr, brows, part);
      for (int it = 1; it < iters; ++it)
        fwd_pass(P, N, ld, true, true, inv_r, a_scale, bvec, vec + (size_t)(it - 1) * N,
                 brows + (size_t)it * N, part);
      if (final_row)
        fwd_pass(P, N, ld, true, false, inv_r, a_scale, bvec, vec + (size_t)(ka - 1) * N,
                 nullptr, part);
      hopper::mbar_wait(&bars[1], ph_v);
      ph_v ^= 1;
      resident_product<false, true>(P, N, ld, bvec, vbuf, [=](int i, bool valid, float(&v)[16]) {
        if (!valid) return;
        const float as = a_scale[i];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          store_bf16x2(o + (size_t)i * HD + 8 * nt + 2 * t, v[2 * nt] * as, v[2 * nt + 1] * as);
      });
    }
    hopper::fence_proxy_async();
    __syncthreads();  // every buffer is free: the next item's loads
    if (tid == 0 && next < items) {
      if (!robust) issue_k(next);
      issue_vq(next);
    }
  }
}

int launch_resident_fwd(const void* qkv, void* out, void* vecs, int B, int N, int H, float scale,
                        int robust, int iters, int final_row, int grid, cudaStream_t stream) {
  CUtensorMap ops, tiles;
  cudaError_t err = hopper::make_operand_map(&ops, qkv, B, N, 3 * H * kD, kOpRows);
  if (err != cudaSuccess) return (int)err;
  err = hopper::make_operand_map(&tiles, qkv, B, N, 3 * H * kD, kTileRows);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fwd_smem_bytes(N);
  err = cudaFuncSetAttribute(packed_resident_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  packed_resident_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      ops, tiles, static_cast<__nv_bfloat16*>(out), static_cast<float*>(vecs), B, N, H, scale,
      robust, iters, final_row);
  return (int)cudaGetLastError();
}

}  // namespace res
}  // namespace nrv

// bf16 only; refuses (cudaErrorInvalidValue) what resident_fits does not
// take. grid: persistent blocks, at most one an SM. Returns
// cudaGetLastError() after the launch.
extern "C" int nrv_packed_resident_fwd(const void* qkv, void* out, void* vecs, int B, int N,
                                       int H, int D, float scale, int robust, int iters,
                                       int final_row, int grid, void* stream) {
  if (B < 1 || H < 1 || grid < 1 || iters < 1 || iters > nrv::kMaxIters ||
      !nrv::res::resident_fits(N, D))
    return (int)cudaErrorInvalidValue;
  return nrv::res::launch_resident_fwd(qkv, out, vecs, B, N, H, scale, robust, iters, final_row,
                                       grid, static_cast<cudaStream_t>(stream));
}
