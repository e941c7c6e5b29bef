// Biased (windowed) attention, the resident branch: what the forward and
// backward kernels (biased_resident_{fwd,bwd}.cu) share. bf16 q, k [BW, H,
// N, D], v [BW, H, N, DV], N ≤ kMaxN = 64, D and DV each 16, 32 or 64, a
// float32 bias [nW, H, N, N] or none; every other shape the gate takes goes
// to the shared-memory kernels (biased_attention_{fwd,bwd}.cu), which hold
// each matrix in shared memory.
//
// Counterpart of noise_robust_vit_tpu/ops/pallas/biased_attention.py::
// biased_attention. Its callers are the windowed models: Swin-T's 12 sites
// at N = 49 (D 32), swin_v2_t's at N = 64, LeViT's N = 49 and 16 stages (D
// 16 / DV 32, D 32 / DV 64), Twins' local attention (D 64, no bias).
//
// Design (the matrix as in fused_resident.cuh): a warp owns a strip of 16
// rows of one (image, head) item and holds its 16 × NC float32 entries (NC =
// N rounded up to 16, 32 or 64) in registers in the mma.sync m16n8
// accumulator layout (resident_warp.cuh), NC / 2 floats a thread. An item
// takes strips = NC / 16 warps (at N = 49 four; at N = 33..48 the fourth
// holds no row), so that a slot's threads number 2·NC, and a 4-warp block
// holds items = 4 / strips of them (1 at N = 49, 4 at N ≤ 16), each in a
// slot of its own. Every product is an MMA on the tensor cores: q·kᵀ and
// G·Vᵀ (m16n8k16 over D or DV, bf16 operands by ldmatrix), the products
// with the matrix on the left ((A⊙b)·V, dS·K) from the accumulators split
// into bf16 hi + lo, those with it transposed ((A⊙a)ᵀ·G, dSᵀ·Q) from Aᵀ's
// movmatrix fragments, stored once to the slot's shared memory, each warp
// then multiplying its own 16 output rows. A column pass sums the slot's
// warps' partials through shared memory in strip order; at N ≤ 16 the
// warp holds the whole item and syncs only itself. The slots of a block
// never wait for each other: each syncs its own warps on a named barrier.
//
// Units that share a bias row. The BW / nW images whose windows read bias
// row w are cut into `chunks` chunks of `per` images; a unit is (chunk,
// window w, head h), numbered u = (chunk·nW + w)·H + h, and holds the items
// img·nW·H + w·H + h of its chunk's images. A slot loads bias[w, h] once a
// unit, into shared memory in its warps' fragment order (each lane reads
// its entries as float4), and walks the unit's images in turn; while it
// computes one image, the next image's q, k, v (and g) tiles are in flight
// by cp.async (two buffers). The grid is persistent, as many blocks as are
// resident at once (4-warp blocks: the forward caps its registers at 128
// for 4 blocks an SM, the backward at 168 for 3; 8-warp blocks, one
// backward block an SM, ran slower on an H100); slot s of block b takes
// units b·items + s, then every gridDim.x·items-th. The backward adds each
// image's dS into a register accumulator in image order and writes its
// float32 partial once a unit: [chunks, nW, H, N, N], summed over the
// chunks in chunk order by biased_dbias_reduce (biased_attention_bwd.cu).
// No atomics: two runs give the same bits.
//
// Operand tiles are [NC, W] bf16 (W = D or DV), rows past N zero, each
// row's 16-byte chunks XOR-swizzled (tile_at) so that ldmatrix on 8
// consecutive rows hits 8 distinct bank groups without padding.
//
// What bounds it on the card (H100): at Swin-T stage 0 ([8192, 3, 49, 32]
// bf16, nW = 64, robust (3, final)) the bytes each direction must move take
// ~0.10 ms (fwd) and ~0.17 ms (bwd) at 3.35 TB/s; the products are 8 and 23
// GFLOP on the bf16 tensor cores (~10-25 µs). What is left is issue and
// latency: 12 to 16 warps an SM (the matrix takes 32 registers a thread,
// the backward's dbias accumulator 32 more), the barriers of the column
// passes and of the transposed products, and the shuffles of the sums.
//
// The branch rule (resident_fits) and the shared-memory formulas are
// mirrored in Python (ops/cuda/biased_attention.py::_resident_fits and its
// smem formulas): change one, change the other.
#pragma once

#include "resident_warp.cuh"

namespace nrv {

// The dbias partials' sum over the chunks, in chunk order (biased_attention_bwd.cu).
cudaError_t biased_dbias_reduce(const float* partial, float* dbias, size_t elems, int chunks,
                                cudaStream_t stream);

namespace bres {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 64;
constexpr int kStaticSmem = 1024;  // kept for the kernels' static shared memory
constexpr int kSmemLimit = 232448;
// The rank-1 terms' column factors as B fragments of m16n8k16: a slot's
// [NC, kRankLd / 2] bf16 pairs of consecutive terms, hi and lo (row
// stride 20 words: a warp's reads hit distinct banks).
constexpr int kRankLd = 40;
// A stored-vector code at or above kComp names a row of the slot's
// computed vectors, below it a row of its residual rows.
constexpr int kComp = 64;

// Columns a warp holds: N rounded up to 16, 32 or 64.
__host__ __device__ inline int res_cols(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : 64; }
// Warps an item takes.
__host__ __device__ inline int res_strips(int n) { return res_cols(n) / 16; }
// Items (slots) a block holds.
__host__ __device__ inline int res_items(int n) { return kWarps / res_strips(n); }
__host__ __device__ inline bool res_width(int w) { return w == 16 || w == 32 || w == 64; }
// Residual rows the layout keeps room for: the most num_vecs gives at `it`
// iterations (it = 0 when vanilla).
__host__ __device__ inline int res_vec_rows(int it) { return it > 0 ? 2 * it + 1 : 1; }

// Dynamic shared memory of the forward: q, k, v tiles [items][NC, D | NC,
// D | NC, DV] bf16, twice; the bias in fragment order [kWarps, 16·NC], the
// column partials [kWarps, NC] and the column vector b [items, NC], float32.
__host__ __device__ inline size_t fwd_smem_bytes(int n, int d, int dv) {
  const size_t nc = res_cols(n), ic = (size_t)res_items(n) * nc;
  return 2 * ic * (2 * d + dv) * 2 + 4 * (kWarps * 16 * nc + kWarps * nc + ic);
}

// Floats of a slot's partials region in the backward: the transposed
// products' hi and lo tiles of Aᵀ ([NC, NC] bf16 each; the column passes'
// [strips, NC] share them), or, robust, while dS is formed, the rank-1
// column factors (2 × [NC, kRankLd / 2] bf16 pairs).
__host__ __device__ inline int bwd_part_floats(int n, int it) {
  const int nc = res_cols(n);
  const int prod = nc * nc;  // 2 · NC · NC bf16
  const int rank1 = it > 0 ? nc * kRankLd : 0;
  return prod > rank1 ? prod : rank1;
}

// Computed vectors of a slot in the backward, rows of NC floats: ones, the
// it dc-vectors, dr_F and the chain's it − 1 dr-vectors.
__host__ __device__ inline int bwd_comp_rows(int it) { return 1 + 2 * it; }

// Dynamic shared memory of the backward: q, k, v, g tiles, twice; the bias
// in fragment order; the partials regions; the residual rows [items,
// res_vec_rows, NC], twice; the computed vectors.
__host__ __device__ inline size_t bwd_smem_bytes(int n, int d, int dv, int it) {
  const size_t nc = res_cols(n), items = res_items(n), ic = items * nc;
  return 2 * ic * (2 * d + 2 * dv) * 2 +
         4 * (kWarps * 16 * nc + items * bwd_part_floats(n, it) +
              2 * ic * res_vec_rows(it) + ic * bwd_comp_rows(it));
}

// The branch rule: bf16 (checked by the caller), 1 ≤ N ≤ 64, D and DV each
// 16, 32 or 64, 1 to kMaxIters iterations when robust, both directions'
// shared memory within a block's.
__host__ __device__ inline bool resident_fits(int n, int d, int dv, int robust, int iters) {
  if (n < 1 || n > kMaxN || !res_width(d) || !res_width(dv)) return false;
  if (robust && (iters < 1 || iters > kMaxIters)) return false;
  const int it = robust ? iters : 0;
  return fwd_smem_bytes(n, d, dv) + kStaticSmem <= kSmemLimit &&
         bwd_smem_bytes(n, d, dv, it) + kStaticSmem <= kSmemLimit;
}

// ---- the walk --------------------------------------------------------------

struct Shape {
  int BW, H, N, D, DV, nW, chunks, per;
};

// Units of a launch and where a unit's images lie.
struct Walk {
  int pairs, units, imgs, per;
  __host__ __device__ explicit Walk(const Shape& s)
      : pairs(s.nW * s.H), units(s.chunks * s.nW * s.H), imgs(s.BW / s.nW), per(s.per) {}
  // unit u's first item (its chunk's first image) and its number of images
  __device__ void span(int u, size_t& first, int& count) const {
    const int chunk = u / pairs;
    first = (size_t)chunk * per * pairs + (u - chunk * pairs);
    count = min(per, imgs - chunk * per);
  }
  __device__ int pair(int u) const { return u % pairs; }
};

// Where a warp sits: its slot (item) in the block, its strip of rows, lane
// (g, t), and its rows r0 + g, r0 + g + 8.
struct Warp {
  int lane, g, t, warp, slot, strip, r0;
};

__device__ __forceinline__ Warp warp_of(int strips) {
  Warp p;
  p.lane = threadIdx.x % 32;
  p.g = p.lane / 4;
  p.t = p.lane % 4;
  p.warp = threadIdx.x / 32;
  p.slot = p.warp / strips;
  p.strip = p.warp % strips;
  p.r0 = 16 * p.strip;
  return p;
}

// The barrier of one slot's warps (named barrier slot + 1; the warp alone
// at NC = 16).
template <int NC>
__device__ __forceinline__ void slot_sync(const Warp& p, int strips) {
  if constexpr (NC == 16) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(p.slot + 1), "r"(strips * 32) : "memory");
  }
}

// Element offset of chunk c (8 bf16) of row r of a [rows, W] tile: the
// chunk index XOR-ed with (r · W / 64) mod (W / 8), so that 8 consecutive
// rows at one chunk fill the 8 bank groups (W = 16, 32, 64).
__device__ __forceinline__ int tile_at(int r, int c, int W) {
  const int C = W >> 3;
  return r * W + ((c ^ ((r * C >> 3) & (C - 1))) << 3);
}

// Rows 0..NC − 1 of an item's [N, W] rows of x into a tile, zero past N; by
// the slot's threads (tid of nthreads).
template <int NC>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, const __nv_bfloat16* x,
                                          size_t item, int N, int W, int tid, int nthreads) {
  const int lg = W == 16 ? 1 : W == 32 ? 2 : 3;  // log2 of the 16-byte chunks a row
  const __nv_bfloat16* src = x + item * N * W;
  for (int idx = tid; idx < NC << lg; idx += nthreads) {
    const int r = idx >> lg, c = idx & ((1 << lg) - 1);
    const bool valid = r < N;
    cp_async16(tile + tile_at(r, c, W), src + (valid ? r * W + c * 8 : 0), valid);
  }
}

// Rows 0..R − 1 of an item's residual rows [R, N] float32 into [R, NC], zero
// past N; by the slot's threads.
template <int NC>
__device__ __forceinline__ void load_vecs(float* dst, const float* vecs, size_t item, int R,
                                          int N, int tid, int nthreads) {
  const float* src = vecs + item * R * N;
  for (int idx = tid; idx < R * NC; idx += nthreads) {
    const int r = idx / NC, j = idx % NC;
    const bool valid = j < N;
    cp_async4(dst + idx, src + (valid ? r * N + j : 0), valid);
  }
}

// This lane's entries of bias row `pair` ([N, N] float32) in fragment
// order, [NT][lane][4], zero past N: the warp's own, by the lane itself.
template <int NC>
__device__ __forceinline__ void load_bias(float* frag, const float* bias, int pair, int N,
                                          const Warp& p) {
  const float* src = bias + (size_t)pair * N * N;
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = p.r0 + p.g + 8 * (k >> 1), c = 8 * nt + 2 * p.t + (k & 1);
      const bool valid = r < N && c < N;
      cp_async4(frag + (nt * 32 + p.lane) * 4 + k, src + (valid ? r * N + c : 0), valid);
    }
  }
}

// ---- products --------------------------------------------------------------

// acc[nt] = X·Yᵀ for this warp's 16 rows of X and every 8-row tile nt of Y,
// over W (m16n8k16; X, Y [NC, W] tiles): q·kᵀ and G·Vᵀ, already in the
// accumulator layout.
template <int NC>
__device__ __forceinline__ void nt_product(float (&acc)[NC / 8][4], const __nv_bfloat16* xt,
                                           const __nv_bfloat16* yt, int W, const Warp& p) {
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int ks = 0; ks < W / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, xt + tile_at(p.r0 + (p.lane & 15), 2 * ks + (p.lane >> 4), W));
#pragma unroll
    for (int np = 0; np < NC / 16; ++np) {
      uint32_t b[4];  // tile 2np at k 0..7, 8..15, then tile 2np + 1
      ldsm_x4(b, yt + tile_at(16 * np + (p.lane & 7) + ((p.lane >> 4) << 3),
                              2 * ks + ((p.lane >> 3) & 1), W));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[2 * np], a, b0);
      mma_bf16(acc[2 * np + 1], a, b1);
    }
  }
}

// The entries (scaled by a column vector s when given) as m16n8k16 A
// fragments, split into bf16 hi + lo: for products with the matrix on the
// left.
template <int NC>
__device__ __forceinline__ void row_frags(uint32_t (&hi)[NC / 16][4], uint32_t (&lo)[NC / 16][4],
                                          const float (&e)[NC / 8][4], const float* s, int t) {
#pragma unroll
  for (int cb = 0; cb < NC / 16; ++cb) {
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
      hopper::split_bf16x2(x0, x1, hi[cb][f], lo[cb][f]);
    }
  }
}

// The entries weighted by row scalars (w0 at row g, w1 at row g + 8) as A
// fragments of the transpose, split into hi + lo, each 8×8 block moved
// across the warp by movmatrix.trans: for products with the matrix
// transposed.
template <int NC>
__device__ __forceinline__ void col_frags(uint32_t (&hi)[NC / 16][4], uint32_t (&lo)[NC / 16][4],
                                          const float (&e)[NC / 8][4], float w0, float w1) {
#pragma unroll
  for (int cb = 0; cb < NC / 16; ++cb) {
    // A fragment of Aᵀ: reg 0 cols 0..7 × rows 0..7, reg 1 cols 8..15 ×
    // rows 0..7, reg 2 cols 0..7 × rows 8..15, reg 3 cols 8..15 × rows 8..15
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int nt = 2 * cb + (f & 1), h = f >> 1;
      const float w = h ? w1 : w0;
      uint32_t xh, xl;
      hopper::split_bf16x2(e[nt][2 * h] * w, e[nt][2 * h + 1] * w, xh, xl);
      hi[cb][f] = mov_trans(xh);
      lo[cb][f] = mov_trans(xl);
    }
  }
}

// out = (A…)·B over the item's columns, from the fragments of row_frags and
// B an [NC, W] tile (rows the contraction index): two 8-column tiles of
// the result at a time, put(c, acc) for the tile at columns c..c + 7 (acc:
// row g at c + 2t, c + 2t + 1, then row g + 8).
template <int NC, class Put>
__device__ __forceinline__ void row_product(const uint32_t (&hi)[NC / 16][4],
                                            const uint32_t (&lo)[NC / 16][4],
                                            const __nv_bfloat16* bt, int W, const Warp& p,
                                            Put put) {
  for (int np = 0; np < W / 16; ++np) {
    float acc[2][4] = {}, acc_lo[2][4] = {};  // the lo products in chains of their own
#pragma unroll
    for (int cb = 0; cb < NC / 16; ++cb) {
      uint32_t b[4];  // tile 2np at k 0..7, 8..15, then tile 2np + 1
      ldsm_x4_trans(b, bt + tile_at(16 * cb + (p.lane & 15), 2 * np + (p.lane >> 4), W));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[0], hi[cb], b0);
      mma_bf16(acc_lo[0], lo[cb], b0);
      mma_bf16(acc[1], hi[cb], b1);
      mma_bf16(acc_lo[1], lo[cb], b1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h][i] += acc_lo[h][i];
      put(16 * np + 8 * h, acc[h]);
    }
  }
}

// X = (A⊙w)ᵀ·B over the slot's rows, from the fragments of col_frags and B
// an [NC, W] tile whose rows are the item's (the contraction index). The
// fragments go to the slot's hi and lo tiles of Aᵀ ([NC, NC] bf16 each,
// swizzled as tile_at, in `tt`), each warp writing its 16 columns; after a
// slot barrier each warp takes the 16 rows of X at its own rows' indices,
// Aᵀ's fragments by ldmatrix, and gets put(c, acc) as in row_product. At NC
// = 16 the warp's registers hold all of Aᵀ and nothing goes through
// shared memory. Ends with a slot barrier (tt may be reused).
template <int NC, class Put>
__device__ __forceinline__ void col_product(const uint32_t (&hi)[NC / 16][4],
                                            const uint32_t (&lo)[NC / 16][4],
                                            const __nv_bfloat16* bt, int W, __nv_bfloat16* tt,
                                            const Warp& p, int strips, Put put) {
  if constexpr (NC == 16) {
    row_product<NC>(hi, lo, bt, W, p, put);
  } else {
    __nv_bfloat16* th = tt;
    __nv_bfloat16* tl = tt + NC * NC;
#pragma unroll
    for (int cb = 0; cb < NC / 16; ++cb) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        // reg f holds Aᵀ at row 16cb + g (+ 8 for f = 1, 3), columns r0 +
        // 2t, + 1 (+ 8 for f = 2, 3)
        const int at = tile_at(16 * cb + p.g + 8 * (f & 1), 2 * p.strip + (f >> 1), NC) + 2 * p.t;
        *reinterpret_cast<uint32_t*>(th + at) = hi[cb][f];
        *reinterpret_cast<uint32_t*>(tl + at) = lo[cb][f];
      }
    }
    slot_sync<NC>(p, strips);
    for (int np = 0; np < W / 16; ++np) {
      float acc[2][4] = {}, acc_lo[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < NC / 16; ++ks) {
        uint32_t ah[4], al[4], b[4];
        const int at = tile_at(p.r0 + (p.lane & 15), 2 * ks + (p.lane >> 4), NC);
        ldsm_x4(ah, th + at);
        ldsm_x4(al, tl + at);
        ldsm_x4_trans(b, bt + tile_at(16 * ks + (p.lane & 15), 2 * np + (p.lane >> 4), W));
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(acc[0], ah, b0);
        mma_bf16(acc_lo[0], al, b0);
        mma_bf16(acc[1], ah, b1);
        mma_bf16(acc_lo[1], al, b1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[h][i] += acc_lo[h][i];
        put(16 * np + 8 * h, acc[h]);
      }
    }
    slot_sync<NC>(p, strips);
  }
}

// Column sums of this warp's entries weighted by row scalars (w0 at row g,
// w1 at row g + 8), summed over the slot's strips in strip order;
// post(j, sum) for every column j < NC by one of the slot's threads, then
// a slot barrier. `part` holds strips·NC floats.
template <int NC, class Post>
__device__ __forceinline__ void col_reduce(const float (&e)[NC / 8][4], float w0, float w1,
                                           float* part, const Warp& p, int strips, Post post) {
  col_partials<NC>(e, w0, w1, part + p.strip * NC);
  slot_sync<NC>(p, strips);
  const int j = p.strip * 32 + p.lane;
  if (j < NC) {
    float s = 0.f;
    for (int w = 0; w < strips; ++w) s += part[w * NC + j];
    post(j, s);
  }
  slot_sync<NC>(p, strips);
}

// The launch: a persistent grid of as many blocks as are resident at once
// (resident_blocks), at most one for every `items` units.
template <class Kernel>
inline cudaError_t resident_blocks(Kernel kernel, size_t smem, int& blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  blocks = sms * per_sm;
  if (err == cudaSuccess && blocks < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// Whether a walk of `chunks` chunks of `per` images covers the BW / nW
// images of each bias row with no chunk empty.
inline bool walk_ok(const Shape& s) {
  if (s.BW < 1 || s.H < 1 || s.nW < 1 || s.BW % s.nW || s.chunks < 1 || s.per < 1) return false;
  const long long imgs = s.BW / s.nW;
  return (long long)s.chunks * s.per >= imgs && (long long)(s.chunks - 1) * s.per < imgs &&
         (long long)s.chunks * s.nW * s.H < (1ll << 31);
}

// Blocks of each direction's kernel resident on the card at once at this
// shape (biased_resident_{fwd,bwd}.cu; it = iterations when robust, else
// 0).
cudaError_t fwd_resident_blocks(int n, int d, int dv, int& blocks);
cudaError_t bwd_resident_blocks(int n, int d, int dv, int it, int& blocks);

}  // namespace bres
}  // namespace nrv

// Phase timers of tools/torch_biased_phases.py: nothing in the package's
// build.
#ifndef BRES_PHASE
#define BRES_PHASE(k)
#define BRES_PHASE_INIT
#endif
