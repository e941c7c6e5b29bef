// Device building blocks shared by the Sinkhorn kernels: a block GEMM on
// the tensor cores (float32-level accuracy: bf16 MMAs where both operands
// are exact bf16, 3xTF32 otherwise), softmax and row and column reductions
// over an nr×nc float32 matrix (square, nr = nc = N, for self-attention;
// rectangular for the logits-interface kernel's cross-shaped matrices), and
// the forward and reverse Sinkhorn scaling chains.
//
// Counterpart of the math in noise_robust_vit_tpu/ops/pallas/
// sinkhorn_attention.py: _fwd_math_batched (:202), _restore_vec_rows (:349),
// _reverse_chain_inner (:403) and _bwd_math_batched (:496), default path
// (NRV_FOLD_FINAL_A / NRV_CHAIN_V2 off). The TPU kernel batches many
// (image, head) chains into one [K, N, N] string to keep its vector unit
// busy; here each thread block runs one chain at a time, and the card's
// parallelism comes from many blocks in flight.
//
// Every function below is called by all threads of a block (kThreads), in
// uniform control flow: they synchronise internally.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace nrv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxIters = 8;
constexpr int kMaxTerms = 2 * kMaxIters + 1;

// Block GEMM tile: 64×64 outputs, 32-deep k slices. Each of the 8 warps
// owns 16 rows × 32 columns of the tile (four m16n8k8 MMA tiles). An
// operand's shared-memory tile is stored with its contiguous index
// innermost, padded so that both the stores and the fragment loads are free
// of bank conflicts.
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kLdK = kBK + 4;  // row length of a [64][kBK] tile
constexpr int kLdMN = kBM + 8;  // row length of a [kBK][64] tile
constexpr int kTileFloats = kBM * kLdK > kBK * kLdMN ? kBM * kLdK : kBK * kLdMN;
constexpr int kGemmSmemFloats = 2 * kTileFloats;

// Residual rows per (image, head) (block_attention.py::_num_vecs): the
// a-rows, the b-rows and lse when robust; lse alone otherwise.
__host__ __device__ inline int num_vecs(int iters, int final_row, int robust) {
  return robust ? (iters > 1 ? iters - 1 : 0) + final_row + iters + 1 : 1;
}

// Stored Sinkhorn a-rows: iters − 1 iteration rows, plus the final one.
__host__ __device__ inline int num_arows(int iters, int final_row) {
  return (iters > 1 ? iters - 1 : 0) + final_row;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Clamped reciprocal of a Sinkhorn sum (ops/sinkhorn.py::sinkhorn_scalings):
// an exact-zero sum maps to 1, a live sum is clamped at 1e-8 so the scaling
// vector cannot overflow when training starves a key of mass.
__device__ __forceinline__ float recip_clamped(float x) {
  return x == 0.f ? 1.f : 1.f / fmaxf(x, 1e-8f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x as a TF32 pair hi + lo (hi rounded to nearest, lo the rounded rest):
// hi·hi + hi·lo + lo·hi keeps a product to about 2^-21 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// d += a·b on the tensor cores: a 16×8 (row-major fragment), b 8×8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b on the tensor cores: a 16×16 bf16 (row-major fragment), b 16×8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two values that are exact bf16 as one fragment register, `lo` in the low
// half (the smaller k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A run of four consecutive operand elements as loaded (16-byte aligned
// float32 or 8-byte aligned bfloat16 storage), with the factor it is scaled
// by, if any. The raw bits stay in registers until the run is stored to
// shared memory, so that a prefetch never waits for its load; `value`
// converts. A value-initialized run is four zeros. An unscaled bfloat16 run
// (RunBF16) is exact in bf16, which lets block_gemm use bf16 MMAs.
struct RunF32 {
  float4 v;
  float s;
};
struct RunBF16 {
  uint2 v;
};
struct RunBF16Scaled {
  uint2 v;
  float s;
};
__device__ __forceinline__ RunF32 run4(const float* p, float s = 1.f) {
  return {*reinterpret_cast<const float4*>(p), s};
}
__device__ __forceinline__ RunBF16 run4(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint2*>(p)};
}
__device__ __forceinline__ RunBF16Scaled run4(const __nv_bfloat16* p, float s) {
  return {*reinterpret_cast<const uint2*>(p), s};
}
__device__ __forceinline__ float4 value(const RunF32& r) {
  return make_float4(r.v.x * r.s, r.v.y * r.s, r.v.z * r.s, r.v.w * r.s);
}
__device__ __forceinline__ float4 bf16x4(uint2 v, float s) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x * s, lo.y * s, hi.x * s, hi.y * s);
}
__device__ __forceinline__ float4 value(const RunBF16& r) { return bf16x4(r.v, 1.f); }
__device__ __forceinline__ float4 value(const RunBF16Scaled& r) { return bf16x4(r.v, r.s); }

// Row stride of the float32 N×N scratch matrices: a multiple of 4, so that
// every row starts 16-byte aligned for run4.
__host__ __device__ inline int padded_ld(int n) { return (n + 3) / 4 * 4; }

// C = A·B for i < M, j < N, k < K; epi(i, j, c) receives each entry.
// Float32 accumulation on the tensor cores. When both operands are unscaled
// bf16 runs and contiguous along k (q·kᵀ, G·Vᵀ), one bf16 MMA per 16-deep
// slice computes the exact products. Otherwise each float32 operand is split
// into a TF32 pair for three MMAs per product (3xTF32).
// Operands come as runs of four (run4) along their contiguous index:
// load_a(i, k) returns A(i, k..k+3) when A_K_CONTIG, else A(i..i+3, k);
// load_b(k, j) returns B(k, j..j+3) when B_J_CONTIG, else B(k..k+3, j). A
// run is asked for only when its first element is in range; it must be
// readable to its end (the caller pads rows to a multiple of 4), and entries
// past the edge are zeroed here. Each thread keeps the next k-slice's raw
// runs in registers while the tensor cores work on the current slice.
// `smem` holds kGemmSmemFloats floats.
template <bool A_K_CONTIG, bool B_J_CONTIG, class LoadA, class LoadB, class Epi>
__device__ void block_gemm(int M, int N, int K, LoadA load_a, LoadB load_b,
                           Epi epi, float* smem) {
  constexpr int kRuns = kBM * kBK / 4 / kThreads;  // runs per thread per operand
  float* As = smem;
  float* Bs = smem + kTileFloats;
  // element (row, k) of the A tile and (k, col) of the B tile
  auto a_at = [&](int r, int k) -> float& {
    return A_K_CONTIG ? As[r * kLdK + k] : As[k * kLdMN + r];
  };
  auto b_at = [&](int k, int c) -> float& {
    return B_J_CONTIG ? Bs[k * kLdMN + c] : Bs[c * kLdK + k];
  };
  // run e of a tile: (outer, inner) offsets, inner along the contiguous index
  auto a_run = [](int e, int& ii, int& kk) {
    if (A_K_CONTIG) { ii = e / (kBK / 4); kk = e % (kBK / 4) * 4; }
    else { kk = e / (kBM / 4); ii = e % (kBM / 4) * 4; }
  };
  auto b_run = [](int e, int& kk, int& jj) {
    if (B_J_CONTIG) { kk = e / (kBN / 4); jj = e % (kBN / 4) * 4; }
    else { jj = e / (kBK / 4); kk = e % (kBK / 4) * 4; }
  };
  // zero the entries of v at and past `edge`, counted from `first`
  auto clip = [](float4 v, int first, int edge) {
    if (first + 1 >= edge) v.y = 0.f;
    if (first + 2 >= edge) v.z = 0.f;
    if (first + 3 >= edge) v.w = 0.f;
    return v;
  };
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;  // MMA group and thread-in-group
  const int wm = (warp % 4) * 16, wn = (warp / 4) * 32;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  using RunA = decltype(load_a(0, 0));
  using RunB = decltype(load_b(0, 0));
  constexpr bool kBF16 = std::is_same<RunA, RunBF16>::value &&
                         std::is_same<RunB, RunBF16>::value && A_K_CONTIG && !B_J_CONTIG;
  RunA ra[kRuns];
  RunB rb[kRuns];
  auto fetch = [&](int i0, int j0, int k0) {
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      int ii, kk, jj;
      a_run(tid + r * kThreads, ii, kk);
      ra[r] = (i0 + ii < M && k0 + kk < K) ? load_a(i0 + ii, k0 + kk) : RunA{};
      b_run(tid + r * kThreads, kk, jj);
      rb[r] = (j0 + jj < N && k0 + kk < K) ? load_b(k0 + kk, j0 + jj) : RunB{};
    }
  };
  auto stash = [&](int i0, int j0, int k0) {
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      int ii, kk, jj;
      a_run(tid + r * kThreads, ii, kk);
      *reinterpret_cast<float4*>(&a_at(ii, kk)) =
          A_K_CONTIG ? clip(value(ra[r]), k0 + kk, K) : clip(value(ra[r]), i0 + ii, M);
      b_run(tid + r * kThreads, kk, jj);
      *reinterpret_cast<float4*>(&b_at(kk, jj)) =
          B_J_CONTIG ? clip(value(rb[r]), j0 + jj, N) : clip(value(rb[r]), k0 + kk, K);
    }
  };
  for (int tile = 0; tile < tiles; ++tile) {
    const int i0 = (tile / tiles_n) * kBM, j0 = (tile % tiles_n) * kBN;
    float acc[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[s][c] = 0.f;
    fetch(i0, j0, 0);
    for (int k0 = 0; k0 < K; k0 += kBK) {
      stash(i0, j0, k0);
      __syncthreads();
      if (k0 + kBK < K) fetch(i0, j0, k0 + kBK);
      if constexpr (kBF16) {
#pragma unroll
        for (int k16 = 0; k16 < kBK; k16 += 16) {
          const int k = k16 + 2 * t;
          uint32_t a[4];
          a[0] = pack_bf16(a_at(wm + g, k), a_at(wm + g, k + 1));
          a[1] = pack_bf16(a_at(wm + g + 8, k), a_at(wm + g + 8, k + 1));
          a[2] = pack_bf16(a_at(wm + g, k + 8), a_at(wm + g, k + 9));
          a[3] = pack_bf16(a_at(wm + g + 8, k + 8), a_at(wm + g + 8, k + 9));
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int c = wn + 8 * s + g;
            const uint32_t b[2] = {pack_bf16(b_at(k, c), b_at(k + 1, c)),
                                   pack_bf16(b_at(k + 8, c), b_at(k + 9, c))};
            mma_bf16(acc[s], a, b);
          }
        }
      } else {
#pragma unroll
        for (int k8 = 0; k8 < kBK; k8 += 8) {
          uint32_t ah[4], al[4];
          split_tf32(a_at(wm + g, k8 + t), ah[0], al[0]);
          split_tf32(a_at(wm + g + 8, k8 + t), ah[1], al[1]);
          split_tf32(a_at(wm + g, k8 + t + 4), ah[2], al[2]);
          split_tf32(a_at(wm + g + 8, k8 + t + 4), ah[3], al[3]);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            uint32_t bh[2], bl[2];
            split_tf32(b_at(k8 + t, wn + 8 * s + g), bh[0], bl[0]);
            split_tf32(b_at(k8 + t + 4, wn + 8 * s + g), bh[1], bl[1]);
            mma_tf32(acc[s], al, bh);
            mma_tf32(acc[s], ah, bl);
            mma_tf32(acc[s], ah, bh);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + wm + g + (c >= 2 ? 8 : 0);
        const int j = j0 + wn + 8 * s + 2 * t + (c & 1);
        if (i < M && j < N) epi(i, j, acc[s][c]);
      }
    }
  }
  __syncthreads();
}

// The nr×nc matrices below are float32 with row stride ld, in shared or
// global memory. On the packed kernels' scratch branch (the shapes the
// resident kernels, packed_resident_{fwd,bwd}.cu, do not take: float32,
// N above their range, D ≠ 64) the passes over a global scratch are bound
// by device-memory bandwidth, as the scratch slots of the blocks in
// flight do not stay in L2. Streaming a row (one warp) or all columns of
// a row (the whole block) at a time reads the matrix in order, and
// measured fastest among the orders tried (PERF.md).
constexpr int kCols = 8;
constexpr int kColBlock = 32 * kCols;  // columns one pass of a warp covers

// Σ_j x[j]·w[j] over a row, summed across the warp: every lane gets it.
// Each lane issues its kCols loads before it uses any of them.
__device__ __forceinline__ float warp_dot(const float* x, const float* w, int n) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int j0 = lane; j0 < n; j0 += kColBlock) {
    float p[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + 32 * c;
      p[c] = j < n ? x[j] * w[j] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) s += p[c];
  }
  return warp_sum(s);
}

// post(i, Σ_j E[i, j]·w[j]) for every row i < nr: one warp per row.
template <class Post>
__device__ void rows_dot(const float* E, int nr, int nc, int ld, const float* w,
                         Post post) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < nr; i += kWarps) {
    const float s = warp_dot(E + (size_t)i * ld, w, nc);
    if (lane == 0) post(i, s);
  }
  __syncthreads();
}

// Partial column sums of a narrow matrix: the rows are dealt out to
// `groups` groups of cw threads, and thread grp·cw + j leaves group grp's
// Σ E[i, j]·w[i] in the returned shared array. Not a template, so that
// every caller shares one array (a template's static shared array would be
// one per instantiation).
__device__ inline float* cols_partials(const float* E, int nr, int nc, int ld,
                                       const float* w, int cw, int groups) {
  __shared__ float part[kThreads];
  const int j = threadIdx.x % cw, grp = threadIdx.x / cw;
  float s = 0.f;
  if (grp < groups && j < nc)
    for (int i = grp; i < nr; i += groups) s = fmaf(E[(size_t)i * ld + j], w[i], s);
  part[threadIdx.x] = s;
  __syncthreads();
  return part;
}

// post(j, Σ_i E[i, j]·w[i]) for every column j < nc: one thread per column,
// so the block reads each row whole before the next. A narrow matrix (at
// most kThreads / 2 columns, a window of 49 or 64 tokens) would leave most
// threads idle that way, so there the rows are dealt out to groups of
// threads, and the groups' partial sums are added in a fixed order.
template <class Post>
__device__ void cols_dot(const float* E, int nr, int nc, int ld, const float* w,
                         Post post) {
  const int cw = (nc + 31) / 32 * 32;  // columns of one group, whole warps
  const int groups = kThreads / cw;
  if (groups > 1) {
    const float* part = cols_partials(E, nr, nc, ld, w, cw, groups);
    if (threadIdx.x < nc) {
      float t = 0.f;
      for (int g = 0; g < groups; ++g) t += part[g * cw + threadIdx.x];
      post(threadIdx.x, t);
    }
    __syncthreads();
    return;
  }
  for (int j = threadIdx.x; j < nc; j += kThreads) {
    float s = 0.f;
    for (int i = 0; i < nr; ++i) s = fmaf(E[(size_t)i * ld + j], w[i], s);
    post(j, s);
  }
  __syncthreads();
}

// In place over the logits s [nr, nc]: E ← e = exp(s − m) with m the row
// max; inv_r[i] = 1 / Σ_j e_ij; lse[i] = m_i + log Σ_j e_ij (the residual
// row the backward rebuilds attn from in one exp). A warp takes kRows rows
// at once and issues all their loads before it uses any.
constexpr int kRows = 4;
__device__ inline void softmax_rows(float* E, int nr, int nc, int ld, float* inv_r,
                                    float* lse) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i0 = warp; i0 < nr; i0 += kWarps * kRows) {
    float m[kRows], r[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      m[q] = -INFINITY;
      r[q] = 0.f;
    }
    for (int j0 = lane; j0 < nc; j0 += kColBlock) {
      float x[kRows][kCols];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int i = i0 + kWarps * q, j = j0 + 32 * c;
          x[q][c] = (i < nr && j < nc) ? E[(size_t)i * ld + j] : -INFINITY;
        }
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int c = 0; c < kCols; ++c) m[q] = fmaxf(m[q], x[q][c]);
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) m[q] = warp_max(m[q]);
    for (int j0 = lane; j0 < nc; j0 += kColBlock) {
      float x[kRows][kCols];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int i = i0 + kWarps * q, j = j0 + 32 * c;
          x[q][c] = (i < nr && j < nc) ? E[(size_t)i * ld + j] : 0.f;
        }
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int i = i0 + kWarps * q, j = j0 + 32 * c;
          if (i < nr && j < nc) {
            const float e = expf(x[q][c] - m[q]);
            E[(size_t)i * ld + j] = e;
            r[q] += e;
          }
        }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const float rs = warp_sum(r[q]);
      const int i = i0 + kWarps * q;
      if (lane == 0 && i < nr) {
        inv_r[i] = 1.f / rs;
        lse[i] = m[q] + logf(rs);
      }
    }
  }
  __syncthreads();
}

// Forward Sinkhorn chain on e (row normalizer folded into the vectors, as in
// _fwd_math_batched): a_0 ≡ 1, so the first row normalization is skipped.
// Writes the a-rows (iters − 1, plus the final one; width nr) to a_out and
// the iters b-rows (width nc) to b_out. Leaves the output row scale
// a·(1/r) in a_scale and the final column scale in b.
__device__ inline void sinkhorn_forward_chain(const float* E, int nr, int nc, int ld,
                                              const float* inv_r, int iters,
                                              bool final_row, float* a_scale,
                                              float* b, float* a_out, float* b_out) {
  for (int i = threadIdx.x; i < nr; i += kThreads) a_scale[i] = inv_r[i];
  for (int j = threadIdx.x; j < nc; j += kThreads) b[j] = 1.f;
  __syncthreads();
  int arow = 0;
  auto row_step = [&](int i, float s) {
    const float a = recip_clamped(s * inv_r[i]);  // rowsum(attn⊙b)
    a_out[(size_t)arow * nr + i] = a;
    a_scale[i] = a * inv_r[i];
  };
  for (int t = 0; t < iters; ++t) {
    if (t > 0) {
      rows_dot(E, nr, nc, ld, b, row_step);
      ++arow;
    }
    float* brow = b_out + (size_t)t * nc;
    cols_dot(E, nr, nc, ld, a_scale, [&](int j, float s) {
      const float bj = recip_clamped(s);
      brow[j] = bj;
      b[j] = bj;
    });
  }
  if (final_row) rows_dot(E, nr, nc, ld, b, row_step);
}

// Reverse of the Sinkhorn iteration (_reverse_chain_inner, default path).
// In: attn [nr, nc]; the scaling vectors as_r(t) (a_0 ≡ ones, then the
// stored a-rows, width nr) and bs_r(t) (b_0 ≡ ones, then the stored b-rows,
// width nc); `ones` holds max(nr, nc) ones; da (nr), the grad of the final
// a; db_row (nc), the grad of the final b (overwritten). Out: svec (nr),
// the chain's part of the softmax-vjp row term, and the rank-1 dA terms as
// offsets into `vbase` (tu[k] the row factor, tv[k] the column factor),
// collected to be applied once by the caller. Returns the term count.
// Scratch vectors: m_dc (nr), dcs (iters·nc), drs (iters·nr).
__device__ inline int sinkhorn_reverse_chain(const float* attn, int nr, int nc, int ld,
                                             int iters, bool final_row,
                                             const float* vbase, const float* ones,
                                             const float* arows, const float* brows,
                                             const float* da, float* db_row,
                                             float* svec, float* m_dc, float* dcs,
                                             float* drs, int* tu, int* tv) {
  auto as_r = [&](int t) { return t == 0 ? ones : arows + (size_t)(t - 1) * nr; };
  auto bs_r = [&](int t) { return t == 0 ? ones : brows + (size_t)(t - 1) * nc; };
  auto push = [&](int k, const float* u, const float* v) {
    if (threadIdx.x == 0) {
      tu[k] = (int)(u - vbase);
      tv[k] = (int)(v - vbase);
    }
  };
  const float* a_fin = as_r(num_arows(iters, final_row ? 1 : 0));
  int nt = 0, ndr = 0;
  if (final_row) {
    // a* = recip(A b_T); A·b_T = 1/a_fin by construction
    float* dr = drs + (size_t)(ndr++) * nr;
    for (int i = threadIdx.x; i < nr; i += kThreads) {
      const float tmp = da[i] * a_fin[i];
      dr[i] = -(tmp * a_fin[i]);
      svec[i] = -tmp;
    }
    push(nt++, dr, bs_r(iters));
    __syncthreads();
    cols_dot(attn, nr, nc, ld, dr, [&](int j, float s) { db_row[j] += s; });
  } else {
    for (int i = threadIdx.x; i < nr; i += kThreads) svec[i] = 0.f;
    __syncthreads();
  }
  for (int t = iters - 1; t >= 0; --t) {
    // b_t = recip(Aᵀ a_t): db_row holds the grad of b_t = bs_r(t + 1)
    float* dc = dcs + (size_t)t * nc;
    const float* b_t = bs_r(t + 1);
    for (int j = threadIdx.x; j < nc; j += kThreads) dc[j] = db_row[j] * -(b_t[j] * b_t[j]);
    __syncthreads();
    rows_dot(attn, nr, nc, ld, dc, [&](int i, float s) { m_dc[i] = s; });  // A·dc
    push(nt++, as_r(t), dc);
    if (t == 0) {
      // a_0 is the constant 1: its own gradient is discarded
      for (int i = threadIdx.x; i < nr; i += kThreads) svec[i] += m_dc[i];
      __syncthreads();
      break;
    }
    const float* a_t = as_r(t);
    float* dr = drs + (size_t)(ndr++) * nr;
    const bool da_live = !final_row && t == iters - 1;
    for (int i = threadIdx.x; i < nr; i += kThreads) {
      const float md = m_dc[i];
      const float s = svec[i] + a_t[i] * md;
      const float tmp = (da_live ? da[i] + md : md) * a_t[i];  // = da·a_t
      svec[i] = s - tmp;  // dr / a_t = −da·a_t
      dr[i] = -(tmp * a_t[i]);
    }
    push(nt++, dr, bs_r(t));
    __syncthreads();
    cols_dot(attn, nr, nc, ld, dr, [&](int j, float s) { db_row[j] = s; });  // Aᵀ·dr
  }
  return nt;
}

}  // namespace nrv
