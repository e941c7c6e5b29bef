// Shared parts of the packed-qkv attention kernels of the resident branch
// (packed_resident_{fwd,bwd}.cu): bf16, D = 64, N ≤ kMaxN. q, k, v, dout
// arrive by TMA into 128-byte-swizzled operand buffers (hopper.cuh); q·kᵀ
// and G·Vᵀ run on wgmma with both operands exact bf16; the products with
// the float32 matrix run on wgmma m64n64k16 with the matrix side split into
// bf16 hi + lo (two MMAs, about 2^-17 relative) and the bf16 side read
// MN-major from the swizzled buffer. The forward's persistent block (one a
// SM) holds the item's N×N float32 matrix in shared memory and takes one
// (image, head) item at a time; the backward holds it in registers, over a
// cluster of two blocks above 128 rows, and keeps its shared memory for an
// operand ring and the transposed products (packed_resident_bwd.cu).
//
// The branch rule (resident_fits) is mirrored in Python
// (ops/cuda/packed_attention.py::_resident_fits and its smem formulas):
// change one, change the other.
#pragma once

#include "hopper.cuh"
#include "sinkhorn_chain.cuh"

namespace nrv {
namespace res {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kD = 64;            // the head width the branch takes: one swizzle atom
constexpr int kNCols = 200;       // wgmma n: the columns of an S or G·Vᵀ tile
constexpr int kMaxN = kNCols;     // and so the largest N, before the smem budget
constexpr int kTileRows = 64;     // rows of a wgmma A tile (a q or dout row tile)
constexpr int kOpRows = 208;      // rows of a full operand buffer: 13 blocks of 16
constexpr int kOpBytes = kOpRows * hopper::kSwizzleRowBytes;
constexpr int kTileBytes = kTileRows * hopper::kSwizzleRowBytes;
constexpr int kAlign = 1024;      // the 128-byte swizzle's alignment
constexpr int kStaticSmem = 256;  // the kernels' static shared memory (mbarriers), kept
constexpr int kSmemLimit = 232448;
// Columns a lane holds in a pass over a row: two runs of four, at 4·lane
// and 128 + 4·lane (8·32 ≥ kNCols), read as float4.
constexpr int kPassCols = 8;
constexpr int kAcc = kNCols / 2;  // accumulator floats a thread holds for a wgmma tile
constexpr float kLog2e = 1.4426950408889634f;

// Row stride (floats) of the resident matrix: N rounded up to 8, then to
// ≡ 8 (mod 32). Columns N..ld − 1 are kept zero, so that passes and
// products read whole rows without a column mask. A warp's float2
// fragment reads of 4 rows × 8 columns (the wgmma accumulator stores,
// A fragment rows) then hit 32 distinct banks a half-warp.
__host__ __device__ inline int resident_ld(int n) {
  int ld = (n + 7) / 8 * 8;
  while (ld % 32 != 8) ld += 8;
  return ld;
}

// Dynamic shared memory of the forward: K and V buffers, two q row-tile
// slots (the chain's per-warp column partials use slot 0 while no q tile
// is in flight), the matrix, then inv_r, a_scale and b.
__host__ __device__ inline size_t fwd_smem_bytes(int n) {
  return kAlign + 2 * (size_t)kOpBytes + 2 * (size_t)kTileBytes +
         4 * ((size_t)n * resident_ld(n) + 3 * (size_t)n);
}

// The backward's block: two consumer warpgroups, which hold 128 rows of
// the matrix (kBlockRows), and a producer warpgroup, whose first warp
// issues the loads (a warpgroup, so that setmaxnreg can hand its registers
// to the consumers).
constexpr int kBwdThreads = kThreads + 128;
constexpr int kBlockRows = 2 * kTileRows;
constexpr int kHalfBytes = kBlockRows * hopper::kSwizzleRowBytes;  // q or dout: the block's rows
constexpr int kSlotBytes = kOpBytes + kHalfBytes;  // a ring slot: k | q or v | dout
constexpr int kRingSlots = 2;
// A staging region: one plane (hi or lo) of one warpgroup's rows,
// transposed: kNCols rows (the matrix's columns) of 64 bf16.
constexpr int kStageBytes = kNCols * hopper::kSwizzleRowBytes;
constexpr int kPartBytes = kTileRows * kD * 4;  // a 64 × 64 float32 tile of partial sums

// Dynamic shared memory of the backward, whatever N and the schedule: the
// ring, four staging regions ([plane][warpgroup]; a tile of the last one
// reads up to 56 rows past it, into the vectors), then the column vectors
// (kMaxIters b rows, kMaxIters dc vectors, db_row), the per-warp column
// partials, the column sums' exchange buffers ([2][2] × kNCols) and the row
// vectors at the block's rows (kMaxIters a rows, kMaxIters dr vectors).
__host__ __device__ inline size_t bwd_smem_bytes() {
  return kAlign + kRingSlots * (size_t)kSlotBytes + 4 * (size_t)kStageBytes +
         4 * ((size_t)(2 * kMaxIters + 1 + kWarps + 4) * kNCols +
              (size_t)2 * kMaxIters * kBlockRows);
}

// The branch rule: the resident kernels take bf16 at D = 64 and N up to
// the wgmma width, where both kernels' shared memory fits a block.
__host__ __device__ inline bool resident_fits(int n, int d) {
  return d == kD && n >= 1 && n <= kMaxN && fwd_smem_bytes(n) + kStaticSmem <= kSmemLimit &&
         bwd_smem_bytes() + kStaticSmem <= kSmemLimit;
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  const uint32_t a = hopper::smem_u32(raw);
  return raw + (((a + kAlign - 1) & ~(uint32_t)(kAlign - 1)) - a);
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// bf16 elements (row, col), (row, col + 1) of an operand buffer as floats.
__device__ __forceinline__ float2 op_pair(const uint8_t* buf, int row, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(buf + hopper::swz_offset(row, col)));
}

// acc = A·Bᵀ for a 64-row A tile and a kNCols-row B buffer, both K-major
// bf16 operand buffers of width kD, on wgmma. Called by a whole warpgroup;
// returns with the products complete. A tile that starts at row 192 of a
// full buffer reads rows 208..255 from whatever follows it in shared
// memory: those output rows are ≥ N and discarded. Thread l of the warpgroup holds
// acc[4s + q] = C(16·(l / 32) + (l % 32) / 4 + 8·(q / 2), 8·s + 2·(l % 4)
// + q % 2).
__device__ __forceinline__ void wg_tile(float (&acc)[kAcc], const void* a_tile,
                                        const void* b_buf) {
  const uint64_t da = hopper::desc_sw128(a_tile), db = hopper::desc_sw128(b_buf);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kD / 16; ++k) hopper::wgmma_m64n200k16(acc, da + 2 * k, db + 2 * k, k > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
  hopper::fence_regs(acc);
}

// A pass over the forward's matrix takes a warp a row, lanes across the
// columns, and R rows at once (load_rows), their loads in flight together
// (R = 8).

// Column of entry c of a lane's run in a pass (kPassCols entries).
__device__ __forceinline__ int pass_col(int c) {
  return 4 * (threadIdx.x % 32) + 128 * (c / 4) + c % 4;
}

// Rows i = warp + kWarps·(q0 + r) of the matrix at the lane's pass
// columns (zero past row n or past the row's ld columns).
template <int R>
__device__ __forceinline__ void load_rows(const float* P, int n, int ld, int q0,
                                          float (&p)[R][kPassCols]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = warp + kWarps * (q0 + r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 4 * lane + 128 * h;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && j < ld) v = *reinterpret_cast<const float4*>(P + (size_t)i * ld + j);
      p[r][4 * h] = v.x;
      p[r][4 * h + 1] = v.y;
      p[r][4 * h + 2] = v.z;
      p[r][4 * h + 3] = v.w;
    }
  }
}

// A vector's entries at the lane's pass columns (zero past n).
__device__ __forceinline__ void load_cols(const float* v, int n, float (&w)[kPassCols]) {
#pragma unroll
  for (int c = 0; c < kPassCols; ++c) {
    const int j = pass_col(c);
    w[c] = j < n ? v[j] : 0.f;
  }
}

// Each lane's column partials (cacc) to the per-warp rows of part
// [kWarps, n], a barrier, then post(j, Σ_w part[w][j]) in warp order for
// every column (the caller ends with a barrier).
template <class Post>
__device__ __forceinline__ void col_sums(const float (&cacc)[kPassCols], int n, float* part,
                                         Post post) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < kPassCols; ++c) {
    const int j = pass_col(c);
    if (j < n) part[warp * n + j] = cacc[c];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * n + j];
    post(j, s);
  }
}

// recip_clamped (sinkhorn_chain.cuh) with the correctly rounded reciprocal
// instruction sequence in place of a division: the same bits.
__device__ __forceinline__ float recip_clamped_rn(float x) {
  return x == 0.f ? 1.f : __frcp_rn(fmaxf(x, 1e-8f));
}

// The scalar of row warp + kWarps·lane of a row vector (0 past n): a
// pass over the matrix takes each of its warp's rows' scalars from lane
// (row − warp) / kWarps by a shuffle instead of a load (n ≤ 32·kWarps).
__device__ __forceinline__ float warp_rows_of(const float* v, int n) {
  const int i = threadIdx.x / 32 + kWarps * (threadIdx.x % 32);
  return i < n ? v[i] : 0.f;
}

// A(m, k) = P(m, k)·ks(k) (TRANS false) or P(k, m)·ks(k) (TRANS true) of
// one A fragment in mma.sync m16n8k16's layout (rows mt·16.., k block
// kb·16..), entries with m or k ≥ n zero. Loaded raw (x) with the k scales
// (s), then split into bf16 hi + lo (split_a) once the loads have landed.
// The transposed fragment reads 8 rows × 4 columns a warp, rows 2t and
// 2t + 1 apart by two strides: with ld ≡ 8 (mod 32), a 2-way bank
// conflict on half the reads.
struct AFrag {
  float x[8];
};
struct KScale {
  float s[4];  // at k0, k0 + 1, k0 + 8, k0 + 9 (k0 = 16·kb + 2·(lane % 4))
};

__device__ __forceinline__ KScale load_ks(const float* ks, int n, int kb) {
  const int k0 = 16 * kb + 2 * (threadIdx.x % 4);
  KScale r;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int k = k0 + (f & 1) + 8 * (f >> 1);
    r.s[f] = k < n ? ks[k] : 0.f;
  }
  return r;
}

// Rows past n and columns past ld read as zero (columns n..ld − 1 are).
template <bool TRANS>
__device__ __forceinline__ AFrag load_a(const float* P, int n, int ld, int mt, int kb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = 16 * mt + g, k0 = 16 * kb + 2 * t;
  AFrag a;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int m = m0 + 8 * (f & 1), k = k0 + 8 * (f >> 1);
    if (!TRANS) {
      float2 v = make_float2(0.f, 0.f);
      if (m < n && k < ld) v = *reinterpret_cast<const float2*>(P + (size_t)m * ld + k);
      a.x[2 * f] = v.x;
      a.x[2 * f + 1] = v.y;
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        a.x[2 * f + e] = (k + e < n && m < ld) ? P[(size_t)(k + e) * ld + m] : 0.f;
    }
  }
  return a;
}

// x[2f + e] sits at k0 + e + 8·(f >> 1): scale s[2·(f >> 1) + e].
template <bool SCALED>
__device__ __forceinline__ void split_a(const AFrag& a, const KScale& ks, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    float x0 = a.x[2 * f], x1 = a.x[2 * f + 1];
    if (SCALED) {
      x0 *= ks.s[2 * (f >> 1)];
      x1 *= ks.s[2 * (f >> 1) + 1];
    }
    hopper::split_bf16x2(x0, x1, hi[f], lo[f]);
  }
}

// acc += (hi + lo)·B[16·kb .. 16·kb + 15, 0..63] on wgmma, A from registers
// (the warpgroup's 64 rows), B read MN-major from an operand buffer. Waits
// for the products, so that the caller may reuse hi and lo. (Keeping the
// next block's group in flight with two register sets measured no faster.)
__device__ __forceinline__ void wg_split_mma(float (&acc)[32], uint32_t (&hi)[4],
                                             uint32_t (&lo)[4], const uint8_t* bbuf, int kb) {
  const uint64_t db = hopper::desc_sw128(bbuf + kb * 16 * hopper::kSwizzleRowBytes);
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
  hopper::wgmma_m64n64k16_rs(acc, hi, db, 1);
  hopper::wgmma_m64n64k16_rs(acc, lo, db, 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
  hopper::fence_regs(acc);
  hopper::fence_regs(hi);
  hopper::fence_regs(lo);
}

// C = A·B over the resident matrix, with A as in load_a (times ks(k) when
// SCALED) and B an operand buffer [kOpRows, kD] bf16 whose rows are the
// contraction index (rows ≥ n hold zeros: TMA fills them). C is [n, kD], a
// 64-row tile a warpgroup at a time, on wgmma with A from registers; each
// thread loads the next k block's A values and scales while the tensor
// cores work on the current one. epi(row, valid, v) receives a row's 16
// values, v[2·nt + e] at column 8·nt + 2·(lane % 4) + e; all lanes of a
// warp call it alike (valid is false for rows ≥ n), so it may sum across
// the four lanes of a row.
template <bool TRANS, bool SCALED, class Epi>
__device__ __forceinline__ void resident_product(const float* P, int n, int ld, const float* ks,
                                                 const uint8_t* bbuf, Epi epi) {
  const int wg = threadIdx.x / 128, g = (threadIdx.x % 32) / 4;
  const int ktiles = (n + 15) / 16;
  for (int rt = wg; rt < (n + kTileRows - 1) / kTileRows; rt += 2) {
    const int mt = 4 * rt + (threadIdx.x % 128) / 32;  // this warp's 16 rows
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    AFrag a = load_a<TRANS>(P, n, ld, mt, 0);
    KScale sc{};
    if (SCALED) sc = load_ks(ks, n, 0);
    for (int kb = 0; kb < ktiles; ++kb) {
      uint32_t hi[4], lo[4];
      split_a<SCALED>(a, sc, hi, lo);
      if (kb + 1 < ktiles) {  // the next block's loads, in flight during the MMAs
        a = load_a<TRANS>(P, n, ld, mt, kb + 1);
        if (SCALED) sc = load_ks(ks, n, kb + 1);
      }
      wg_split_mma(acc, hi, lo, bbuf, kb);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * mt + g + 8 * half;
      float v[16];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        v[2 * nt] = acc[4 * nt + 2 * half];
        v[2 * nt + 1] = acc[4 * nt + 2 * half + 1];
      }
      epi(row, row < n, v);
    }
  }
}

}  // namespace res
}  // namespace nrv

// Phase timers of tools/torch_packed_phases.py (the backward's consumer
// warps): nothing in the package's build.
#ifndef PRES_PHASE
#define PRES_PHASE(k)
#define PRES_PHASE_INIT
#endif
