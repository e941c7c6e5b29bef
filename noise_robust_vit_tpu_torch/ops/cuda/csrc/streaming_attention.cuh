// Pieces shared by the streaming q/k/v-interface Sinkhorn kernels
// (streaming_attention_{fwd,bwd}.cu): the shared-memory budgets that fix a
// block's query tile, and the tile recompute of the logits from q and k.
//
// One (image, head) item per thread block. A sweep walks the item's query
// tiles of tq rows in order; each tile's full rows of en = exp(s − lse)
// (s = scale·q·kᵀ, float32, rows padded to 4 floats) live in shared memory
// while the sweep's row and column work runs on them. q, k, v and g are read
// from device memory in runs of four elements: an item's k and v (200 KB at
// CvT stage 1 in bf16) are read once per tile and stay in L2. No padded rows
// or columns exist: every loop stops at N rows and M columns.
#pragma once

#include "sinkhorn_chain.cuh"

namespace nrv {

constexpr size_t kStreamSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr size_t kStreamStaticSmem = 4096;   // kept for the static shared arrays
constexpr int kStreamMaxTile = 64;

// Forward: the tile S [tq, padded_ld(M)], the GEMM tiles, the running column
// sum and b (M each), and the tile's lse, 1/rowsum and a (tq each).
inline size_t stream_fwd_smem_floats(int tq, int m) {
  return (size_t)tq * padded_ld(m) + kGemmSmemFloats + 2 * (size_t)m + 3 * (size_t)tq;
}

// Backward: the tile S, the GEMM tiles, o/a of the tile [tq, D], the column
// vectors (running db, dcol, b_F and 2·iters rank-1 column factors, M each)
// and the tile's row vectors (lse, a_F, go, ρ, a, du and 2·iters rank-1 row
// factors, tq each). 2·iters terms is the worst schedule of `iters` (a
// final row norm).
inline size_t stream_bwd_smem_floats(int tq, int m, int d, int iters) {
  const size_t nt = 2 * (size_t)iters;
  return (size_t)tq * padded_ld(m) + kGemmSmemFloats + (size_t)tq * d + (3 + nt) * m +
         (6 + nt) * tq;
}

// Whether a query tile of tq rows fits both kernels' shared memory
// (ops/cuda/streaming_attention.py::_tile picks the largest of 64, 32, 16).
inline bool stream_tile_fits(int tq, int m, int d, int iters) {
  const size_t f = stream_fwd_smem_floats(tq, m);
  const size_t b = stream_bwd_smem_floats(tq, m, d, iters);
  return 4 * (f > b ? f : b) + kStreamStaticSmem <= kStreamSmemLimit;
}

constexpr int kStreamMaxMt = kStreamMaxTile / 16;  // m16 row tiles of a tile
constexpr int kStreamWarpMaxD = 64;                // q·kᵀ from registers up to D = 64

// epi(i, j, Σ_d a[i, d]·b[j, d]) for the tile's rows i < rows and every key
// j < M: a points at the tile's first row ([rows, D]: q, or g for the
// backward's direct term), b at the item's keys ([M, D]: k, or v). Both
// bf16: one bf16 MMA per 16-deep slice, exact products; float32: 3xTF32.
// bf16 with D ≤ 64: each warp keeps the tile's a fragments in registers and
// takes every eighth chunk of 8 keys, loading the next chunk's b fragments
// while the tensor cores work on the current one.
template <typename T, class Epi>
__device__ inline void stream_nt(const T* q, const T* k, int rows, int M, int D, float* G,
                                 Epi epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (D <= kStreamWarpMaxD) {
      constexpr int KS = kStreamWarpMaxD / 16;
      const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
      const int g = lane / 4, t = lane % 4;
      const int mt = (rows + 15) / 16, dp = D / 2;  // bf16 pairs a row
      const uint32_t* q2 = reinterpret_cast<const uint32_t*>(q);
      const uint32_t* k2 = reinterpret_cast<const uint32_t*>(k);
      uint32_t a[kStreamMaxMt][KS][4];
#pragma unroll
      for (int m = 0; m < kStreamMaxMt; ++m)
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int r0 = 16 * m + g, r1 = r0 + 8, c0 = 8 * s + t, c1 = c0 + 4;
          a[m][s][0] = r0 < rows && c0 < dp ? q2[r0 * dp + c0] : 0u;
          a[m][s][1] = r1 < rows && c0 < dp ? q2[r1 * dp + c0] : 0u;
          a[m][s][2] = r0 < rows && c1 < dp ? q2[r0 * dp + c1] : 0u;
          a[m][s][3] = r1 < rows && c1 < dp ? q2[r1 * dp + c1] : 0u;
        }
      auto load_b = [&](int j0, uint32_t (&b)[KS][2]) {
        const int j = j0 + g;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int c0 = 8 * s + t, c1 = c0 + 4;
          b[s][0] = j < M && c0 < dp ? k2[(size_t)j * dp + c0] : 0u;
          b[s][1] = j < M && c1 < dp ? k2[(size_t)j * dp + c1] : 0u;
        }
      };
      uint32_t b[KS][2], bn[KS][2];
      load_b(8 * warp, b);
      for (int j0 = 8 * warp; j0 < M; j0 += 8 * kWarps) {
        load_b(j0 + 8 * kWarps, bn);
#pragma unroll
        for (int m = 0; m < kStreamMaxMt; ++m) {
          if (m < mt) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int s = 0; s < KS; ++s) mma_bf16(acc, a[m][s], b[s]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int i = 16 * m + g + (c >= 2 ? 8 : 0), j = j0 + 2 * t + (c & 1);
              if (i < rows && j < M) epi(i, j, acc[c]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          b[s][0] = bn[s][0];
          b[s][1] = bn[s][1];
        }
      }
      __syncthreads();
      return;
    }
  }
  block_gemm<true, false>(
      rows, M, D, [=](int i, int kk) { return run4(q + (size_t)i * D + kk); },
      [=](int kk, int j) { return run4(k + (size_t)j * D + kk); }, epi, G);
}

// Validates a launch of either kernel; 0 or cudaErrorInvalidValue.
inline int stream_check(int K, int N, int M, int D, int iters, int final_row, int tq) {
  if (K < 1 || N < 1 || M < 1 || D < 4 || D % 4 || iters < 1 || iters > kMaxIters ||
      (final_row != 0 && final_row != 1) || tq < 1 || tq > kStreamMaxTile ||
      !stream_tile_fits(tq, M, D, iters))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace nrv
