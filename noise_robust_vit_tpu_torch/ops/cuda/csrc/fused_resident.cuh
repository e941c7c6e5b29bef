// Fused q/k/v attention for narrow heads, the resident branch: what the
// forward and backward kernels (fused_resident_{fwd,bwd}.cu) share. bf16
// q, k, v [K, N, 8], N ≤ kMaxN = 256; every other shape the gate takes goes
// to the recompute kernels (fused_attention_{fwd,bwd}.cu), which form each
// entry anew in every pass.
//
// Counterpart of noise_robust_vit_tpu/ops/pallas/sinkhorn_attention.py::
// fused_attention. Its first caller is MobileViT-XS: 4 heads of width 8 at
// N = 256, 64 and 16, 2048 items a call at batch 128.
//
// Design: each item's N×N matrix is formed once a direction, on the tensor
// cores, and stays on chip in float32 for every pass, in registers. A warp
// owns a strip of 16 rows of one item and holds its 16 × NC entries (NC = N
// rounded up to a power of two from 16 to 256) in the accumulator layout of
// mma.sync m16n8: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8
// at columns 8·nt + 2t, 8·nt + 2t + 1 of each 8-column tile nt, NC / 2
// floats (128 at N = 256). So:
//   * q·kᵀ (depth 8) is one m16n8k8 bf16 MMA a tile, its result already in
//     place;
//   * a product with the matrix on the left, (A⊙b)·V or dS·K, takes the
//     entries as m16n8k16 A fragments straight from those registers (two
//     tiles make one fragment), split into bf16 hi + lo (two MMAs, about
//     2^-17 relative), the bf16 operand by ldmatrix.trans from shared
//     memory;
//   * a product with the matrix transposed, (A⊙a)ᵀ·G or dSᵀ·Q, moves each
//     8×8 block of the hi and lo halves across the warp with movmatrix.trans
//     into the A fragment of Aᵀ, again with no trip through memory;
//   * a row pass (A·x) sums a thread's entries and then across the four
//     lanes of a row; a column pass (Aᵀ·x) sums across the 8 row groups of
//     the warp by shuffles, then across the item's warps through shared
//     memory in warp order, then, at N > 128, across the cluster.
// A block is 8 warps, 128 rows: up to 8 / strips items side by side at N ≤
// 128 (8 at N = 16, 2 at N = 64), and at 128 < N ≤ 256 a cluster of two
// blocks holds one item, rows 0..127 in rank 0 and the rest in rank 1. Each
// block sums its own warps' column partials; the two blocks' sums are
// exchanged through distributed shared memory and added in rank order, the
// same in both, so both hold the same column vectors. No atomics: two runs
// give the same bits.
//
// Operands (q, k, v, g) arrive by cp.async into [rows, 8] bf16 tiles in
// shared memory (16 bytes a row), zero-filled past N.
//
// What bounds it on the card (H100): at MobileViT-XS's stage 1 the bytes
// each direction must move are ~15-20 µs at 3.35 TB/s; the products are a
// few GFLOP. What is left is issue and latency: one 8-warp block a SM at N
// = 256 (the matrix takes 128 registers a thread), barriers between the
// column passes, and the shuffles of the column sums.
//
// The branch rule (resident_fits) and the shared-memory formulas are
// mirrored in Python (ops/cuda/fused_attention.py::_resident_fits and its
// smem formulas): change one, change the other.
#pragma once

#include "cluster.cuh"
#include "resident_warp.cuh"

namespace nrv {
namespace fres {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;  // rows a block holds
constexpr int kD = 8;               // the head width (D = DV) the branch takes
constexpr int kMaxN = 256;
constexpr int kStaticSmem = 1024;   // kept for the kernels' static shared memory
constexpr int kSmemLimit = 232448;

// Columns a warp holds: N rounded up to a power of two, at least 16.
__host__ __device__ inline int res_cols(int n) {
  int c = 16;
  while (c < n) c *= 2;
  return c;
}
__host__ __device__ inline int res_strips(int n) { return (n + 15) / 16; }
// Items a block holds (at N > kRows one item spans a cluster of two
// blocks: the kernels' CL, from NC).
__host__ __device__ inline int res_items(int n) {
  return n > kRows ? 1 : kWarps / res_strips(n);
}

// Dynamic shared memory of the forward: q, k, v tiles [items, NC, 8] bf16,
// twice (the next unit's arrive while this one's are in use), the warps'
// column partials [kWarps, NC], the blocks' column sums ([2 buffers][2
// ranks][items, NC], Xchg) and the column vector b [items, NC], float32.
__host__ __device__ inline size_t fwd_smem_bytes(int n) {
  const size_t ic = (size_t)res_items(n) * res_cols(n);
  return 2 * 3 * ic * kD * 2 + 4 * ((size_t)kWarps * res_cols(n) + 5 * ic);
}

// Column vectors of an item in the backward: ones, the it b-rows, the it
// dc-vectors; row vectors: lse, ones, the a-rows (room for it), the dr-
// vectors (it) (it = iters when robust, else 0).
__host__ __device__ inline int bwd_col_vecs(int it) { return 1 + 2 * it; }
__host__ __device__ inline int bwd_row_vecs(int it) { return 2 + 2 * it; }

// The rank-1 terms' column factors as B fragments of m16n8k16: [NC, kRankLd]
// floats an item, terms along a row (two blocks of 16, padded so that a
// warp's float2 reads of 8 columns × 4 term pairs hit distinct banks).
constexpr int kRankLd = 40;

// Floats of the backward's partials region: the warps' [NC, 8] partials of
// a transposed product (the column passes' partials share them), or,
// robust, while dS is formed, the rank-1 column factors [items, NC,
// kRankLd].
__host__ __device__ inline size_t bwd_part_floats(int n, int it) {
  const size_t prod = (size_t)kWarps * res_cols(n) * kD;
  const size_t rank1 = it > 0 ? (size_t)res_items(n) * res_cols(n) * kRankLd : 0;
  return prod > rank1 ? prod : rank1;
}

// Dynamic shared memory of the backward: q, k, v, g tiles, twice; the
// partials region; the blocks' sums of the transposed products' partials
// ([2 buffers][2 ranks][items, NC, 8], Xchg) and the item's totals; the
// column passes' block sums ([2][2][items, NC]); the column and row
// vectors, twice.
__host__ __device__ inline size_t bwd_smem_bytes(int n, int it) {
  const size_t ic = (size_t)res_items(n) * res_cols(n);
  return 2 * 4 * ic * kD * 2 +
         4 * (bwd_part_floats(n, it) + 5 * ic * kD + 4 * ic +
              2 * ic * (bwd_col_vecs(it) + bwd_row_vecs(it)));
}

// The branch rule: bf16 (checked by the caller), D = DV = 8, 1 ≤ N ≤ 256,
// 1 to kMaxIters iterations when robust, both directions' shared memory
// within a block's.
__host__ __device__ inline bool resident_fits(int n, int d, int dv, int robust, int iters) {
  if (d != kD || dv != kD || n < 1 || n > kMaxN) return false;
  if (robust && (iters < 1 || iters > kMaxIters)) return false;
  const int it = robust ? iters : 0;
  return fwd_smem_bytes(n) + kStaticSmem <= kSmemLimit &&
         bwd_smem_bytes(n, it) + kStaticSmem <= kSmemLimit;
}

// ---- device helpers ---------------------------------------------------------


// The B fragment of m16n8k16 for rows r0..r0 + 15 of a [rows, 8] bf16 tile
// (the rows are the contraction index, the 8 columns n).
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&b)[2], const __nv_bfloat16* tile,
                                             int r0) {
  const int lane = threadIdx.x % 32;
  const uint32_t addr = hopper::smem_u32(tile + (size_t)(r0 + (lane % 16)) * kD);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr)
               : "memory");
}







// An item's [N, 8] bf16 rows of x into a [NC, 8] tile, zero past N (and for
// an item past K); `slots` items from `item0`, all threads of the block.
template <int NC>
__device__ __forceinline__ void load_tiles(__nv_bfloat16* tile, const __nv_bfloat16* x,
                                           size_t item0, int slots, int K, int N) {
  for (int idx = threadIdx.x; idx < slots * NC; idx += kThreads) {
    const int slot = idx / NC, row = idx % NC;
    const size_t item = item0 + slot;
    const bool valid = item < (size_t)K && row < N;
    cp_async16(tile + (size_t)idx * kD, x + (valid ? (item * N + row) * kD : 0), valid);
  }
}

// Where a warp sits: its item slot in the block, its strip of rows, and
// whether it holds live rows at all.
struct WarpPos {
  int g, t, slot, r0;
  size_t item;
  bool live;
};

template <int CL>
__device__ __forceinline__ WarpPos warp_pos(int K, int N, int rank, int unit) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int items = res_items(N);
  const int per = CL == 2 ? kWarps : res_strips(N);  // warps of an item in this block
  WarpPos p;
  p.g = lane / 4;
  p.t = lane % 4;
  const int slot = warp / per;
  const int strip = CL == 2 ? rank * kWarps + warp : warp % per;
  p.item = (size_t)unit * items + slot;
  p.live = slot < items && p.item < (size_t)K && strip * 16 < N;
  p.slot = slot < items ? slot : 0;
  p.r0 = strip * 16;
  return p;
}

// The exchange of block sums between the two blocks of a cluster. Each
// block writes its sums into its own rank's slot of the current buffer and,
// by st.async, into the same slot of the other block, whose mbarrier counts
// the bytes; once its own mbarrier's phase completes, a block holds both
// slots and adds them in rank order, so both blocks get the same bits. The
// two buffers take turns: a block writes into a buffer again only after
// the other block has sent the next exchange, which it does only after it
// has read this buffer. The mbarriers are set up by exchange_init
// (cluster.cuh).
struct Xchg {
  float* buf;     // [2 buffers][2 ranks][n] floats
  uint64_t* bar;  // [2] mbarriers, one a buffer
  int cur = 0;
  uint32_t parity = 0;  // bit b: the phase the next wait on buffer b expects
};

// The cluster part of a reduction: this block's `n` sums (T = float or
// float4), sum(idx) for idx < n, exchanged as above; post(idx, total) for
// every idx, then the caller's barrier.
template <class T, class Sum, class Post>
__device__ __forceinline__ void exchange(Xchg& x, int n, Sum sum, Post post) {
  const int rank = (int)cg::this_cluster().block_rank();
  T* mine = reinterpret_cast<T*>(x.buf) + (size_t)x.cur * 2 * n;
  uint64_t* bar = &x.bar[x.cur];
  if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, (uint32_t)(n * sizeof(T)));
  const uint32_t remote_bar = cluster_addr(bar, rank ^ 1);
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const T s = sum(idx);
    mine[rank * n + idx] = s;
    st_async(cluster_addr(&mine[rank * n + idx], rank ^ 1), s, remote_bar);
  }
  __syncthreads();
  mbar_wait_cluster(bar, (x.parity >> x.cur) & 1);
  x.parity ^= 1u << x.cur;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    if constexpr (sizeof(T) == sizeof(float))
      post(idx, mine[idx] + mine[n + idx]);
    else
      post(idx, add4(mine[idx], mine[n + idx]));
  }
  x.cur ^= 1;
}



// Column sums of this warp's entries weighted by the row scalars (w0 at row
// g, w1 at row g + 8) (col_partials), summed over the item's warps in warp
// order and, in a cluster, over the two blocks in rank order (Xchg);
// post(slot, j, sum) is called once per item column j < NC by one thread
// of each block, then a block barrier. `part` holds kWarps·NC floats, `x`
// items·NC floats a slot.
template <int NC, int CL, class Post>
__device__ __forceinline__ void col_reduce(const float (&e)[NC / 8][4], float w0, float w1,
                                           float* part, Xchg& x, int N, Post post) {
  const int warp = threadIdx.x / 32;
  col_partials<NC>(e, w0, w1, part + warp * NC);
  __syncthreads();
  const int items = res_items(N);
  const int per = CL == 2 ? kWarps : res_strips(N);
  auto sum = [&](int idx) {
    const int slot = idx / NC, j = idx % NC;
    float s = 0.f;
#pragma unroll 8
    for (int w = 0; w < per; ++w) s += part[(slot * per + w) * NC + j];
    return s;
  };
  if (CL == 1) {
    for (int idx = threadIdx.x; idx < items * NC; idx += kThreads)
      post(idx / NC, idx % NC, sum(idx));
  } else {
    exchange<float>(x, items * NC, sum,
                    [&](int idx, float s) { post(idx / NC, idx % NC, s); });
  }
  __syncthreads();
}

// X = (A⊙w)ᵀ·B for this warp's 16 rows: A its entries (w0 at row g, w1 at
// row g + 8), B the item's [NC, 8] bf16 tile at rows r0..r0 + 15. The
// entries are split into bf16 hi + lo and each 8×8 block moved across the
// warp by movmatrix.trans into the A fragment of Aᵀ (two MMAs a 16-column
// block). Then the [NC, 8] partials are summed as in col_reduce;
// post(slot, j, h, v) receives the float4 of columns 4h..4h + 3 of row j.
// `part` holds kWarps·NC·8 floats, `x` items·NC·8 floats a slot.
template <int NC, int CL, class Post>
__device__ __forceinline__ void colprod_reduce(const float (&e)[NC / 8][4], float w0, float w1,
                                               const __nv_bfloat16* btile, int r0, float* part,
                                               Xchg& x, int N, Post post) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t b[2];
  ldsm_b_trans(b, btile, r0);
#pragma unroll
  for (int cb = 0; cb < NC / 16; ++cb) {
    uint32_t hi[4], lo[4];
    // A fragment of Aᵀ: reg 0 cols 0..7 × rows 0..7, reg 1 cols 8..15 ×
    // rows 0..7, reg 2 cols 0..7 × rows 8..15, reg 3 cols 8..15 × rows 8..15
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int nt = 2 * cb + (f & 1), h = f >> 1;
      const float w = h ? w1 : w0;
      uint32_t xh, xl;
      hopper::split_bf16x2(e[nt][2 * h] * w, e[nt][2 * h + 1] * w, xh, xl);
      hi[f] = mov_trans(xh);
      lo[f] = mov_trans(xl);
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(acc, hi, b);
    mma_bf16(acc, lo, b);
    float* p = part + ((size_t)warp * NC + 16 * cb + g) * kD + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(p + 8 * kD) = make_float2(acc[2], acc[3]);
  }
  __syncthreads();
  const int items = res_items(N);
  const int per = CL == 2 ? kWarps : res_strips(N);
  const float4* part4 = reinterpret_cast<const float4*>(part);
  auto sum = [&](int idx) {
    const int slot = idx / (2 * NC), rest = idx % (2 * NC);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int w = 0; w < per; ++w) s = add4(s, part4[(size_t)(slot * per + w) * NC * 2 + rest]);
    return s;
  };
  auto to_post = [&](int idx, float4 s) {
    const int rest = idx % (2 * NC);
    post(idx / (2 * NC), rest / 2, rest % 2, s);
  };
  if (CL == 1) {
    for (int idx = threadIdx.x; idx < items * NC * 2; idx += kThreads) to_post(idx, sum(idx));
  } else {
    exchange<float4>(x, items * NC * 2, sum, to_post);
  }
  __syncthreads();
}

// acc = (A⊙s)·B for this warp's 16 rows: the entries scaled by a column
// vector s (when given) as m16n8k16 A fragments, split into bf16 hi + lo,
// B the item's [NC, 8] bf16 tile. acc holds (row g, cols 2t, 2t + 1) and
// (row g + 8, the same columns).
template <int NC>
__device__ __forceinline__ void rowprod(float (&acc)[4], const float (&e)[NC / 8][4],
                                        const float* s, const __nv_bfloat16* btile) {
  const int t = threadIdx.x % 4;
  float acc_lo[4];  // the lo products in a chain of their own
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = acc_lo[i] = 0.f;
#pragma unroll
  for (int cb = 0; cb < NC / 16; ++cb) {
    uint32_t b[2];
    ldsm_b_trans(b, btile, 16 * cb);
    uint32_t hi[4], lo[4];
    // reg 0 (row g, k 0..7), reg 1 (row g + 8, k 0..7), reg 2 (row g, k
    // 8..15), reg 3 (row g + 8, k 8..15)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int nt = 2 * cb + (f >> 1), h = f & 1;
      float x0 = e[nt][2 * h], x1 = e[nt][2 * h + 1];
      if (s != nullptr) {
        const float2 sv = lds_f2(s + 8 * nt + 2 * t);
        x0 *= sv.x;
        x1 *= sv.y;
      }
      hopper::split_bf16x2(x0, x1, hi[f], lo[f]);
    }
    mma_bf16(acc, hi, b);
    mma_bf16(acc_lo, lo, b);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += acc_lo[i];
}


// The tile nt of q·kᵀ, (q rows of this warp)·(k rows 8·nt..)ᵀ, with the
// columns past N at −∞ (the callers fold scale·log2(e) into the exponent).
__device__ __forceinline__ void s_tile(float (&c)[4], uint32_t qa0, uint32_t qa1,
                                       const __nv_bfloat16* ktile, int nt, int N) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  c[0] = c[1] = c[2] = c[3] = 0.f;
  mma_k8(c, qa0, qa1, lds_u32(ktile + (size_t)(8 * nt + g) * kD + 2 * t));
  const int col = 8 * nt + 2 * t;
  if (col >= N) c[0] = c[2] = -INFINITY;
  if (col + 1 >= N) c[1] = c[3] = -INFINITY;
}

// The launch: a persistent grid, as many blocks (in clusters of cl) as
// are resident at once, at most one a unit; each walks the units
// (res_units) with a stride of the grid's clusters.
template <class Kernel, class... Args>
inline cudaError_t launch(Kernel kernel, int units, int cl, size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  if (cl == 1) {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem);
    resident *= sms;
  } else {
    cfg.gridDim = dim3(cl);
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((units < resident ? units : resident) * cl);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Units of work of a launch over K items: res_items(N) items each, one
// block's or one cluster's at a time.
__host__ __device__ inline int res_units(int K, int N) {
  const int items = res_items(N);
  return (K + items - 1) / items;
}

}  // namespace fres
}  // namespace nrv

// Phase timers of tools/torch_fused_phases.py: nothing in the package's
// build.
#ifndef FRES_PHASE
#define FRES_PHASE(k)
#define FRES_PHASE_INIT
#endif
