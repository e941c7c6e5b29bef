// Streaming q/k/v-interface Sinkhorn attention, the split branch: what the
// forward and backward (streaming_split_{fwd,bwd}.cu) share. bf16 q, g [K,
// N, 64], k, v [K, M, 64], any N ≥ 1 and M ≥ 1, 1 to 8 iterations with or
// without the final row norm; every other shape the gate takes goes to the
// tile branch (streaming_attention_{fwd,bwd}.cu).
//
// Counterpart of noise_robust_vit_tpu/ops/pallas/streaming_sinkhorn.py::
// streaming_attention (_stream_fwd_impl, pl.pallas_call at :397;
// _stream_bwd_impl, :449). Its callers: CvT-13's robust stages 1 and 2
// ([128, 1, 3136 | 784, 64], [128, 3, 784 | 196, 64] at 224 px); Twins-SVT
// and ScalableViT's global attention will be next.
//
// Design. No block holds an item's N×M matrix, or a whole row and a whole
// column of it at once: every pass recomputes its entries e_ij = 2^(c·q_i·k_j
// − lse2_i) (c = scale·log2 e, lse2 = lse·log2 e; q·kᵀ by mma.sync m16n8k16
// from ldmatrix fragments, the exponential on the SFU by ex2.approx) and
// reduces them one way, each reduction by one warp in a fixed order:
//   - a row pass: a warp owns 16 query rows (the A operand, in registers)
//     and walks the item's keys in chunks of 64 (k, and v where a product
//     needs it, by cp.async into two swizzled shared-memory buffers), so a
//     row's sum over its keys stays in the warp's registers;
//   - a column pass: the same product turned round, keys as the A operand
//     and queries streamed, so a key's sum over its queries stays in
//     registers.
// An item's query rows are split over many blocks: kSplitRows = 256 rows
// (8 warps × 2 strips of 16) a block in the sweeps. A sweep's row update
// a = recip(en·b) needs whole rows before the column sum of en ⊙ a can
// start, so a sweep block makes its rows' a (row pass) and then the column
// sums of its own rows (column pass over the split's q, kept in shared
// memory): e is recomputed rather than kept (a tile of 256 × 784 float32
// would not fit). Each block writes its column partial [K, S, M]; a small
// kernel (reduce_kernel) sums the S partials in split order and closes the
// vector (b = recip, or the chain's dw = −db·b²). No atomics, so a run
// repeats bit for bit. The products with a float32 side (en·(b ⊙ v),
// enᵀ·(a_F ⊙ g), dS·K, dSᵀ·Q) take it from the accumulators, scaled, as bf16
// hi + lo A fragments against the exact bf16 v, g, k or q (ldmatrix.trans).
// The [M, 64] gradients (dv's T and dK) come from key-major launches
// (keys_kernel): a block owns 64 keys and walks all N queries, its
// accumulators in registers, written once.
//
// What bounds it on the card (H100): per entry and pass, 64 MACs of q·kᵀ
// (and 128 more per hi + lo product) and one exponential, at 16 a clock an
// SM on the SFU. At CvT stage 1 (315 M entries a pass) a light pass needs
// ~0.08 ms of SFU time; the forward at (3, final) makes 7 passes, the
// backward 9 (5 of them with products besides q·kᵀ). The light passes run
// at about twice their SFU time, the product passes at about a third of
// mma.sync's rate (8-16 warps an SM). Two strips a warp in the sweeps and
// 4-warp key-major blocks measured fastest (tools/torch_stream_variants.py,
// PERF.md). The table's bound counts every product once and no
// exponential; PERF.md gives both and the sweep floor.
#pragma once

#include "resident_warp.cuh"

namespace nrv {
namespace ssplit {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;              // the head width the branch takes
constexpr int kWords = kD / 2;      // 32-bit words of a bf16 row
constexpr int kChunk = 64;          // rows of a streamed operand chunk
constexpr int kTile = kChunk * kD;  // bf16 elements of a chunk tile (8 KB)
constexpr int kRowThreads = 256;    // the query-major kernels
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kLightStrips = 2;  // 16-row strips of a warp in a sweep's row pass
constexpr int kSplitRows = kRowWarps * 16 * kLightStrips;  // rows of a split
constexpr int kProductRows = kRowWarps * 16;  // rows of a block in the product passes
constexpr int kKeyThreads = 128;              // the key-major kernels
constexpr int kKeyRows = kKeyThreads / 32 * 16;  // keys of a key-major block
constexpr int kTerms = 2 * kMaxIters;     // rank-1 terms of the backward, at most
constexpr int kSplitLd = 2 * kTerms;      // a row of split rank-1 factors: 16 hi, 16 lo
constexpr float kBig = 1e30f;

// Launch kinds. Sweeps (rows_kernel): kLse (lse and the first column sum),
// kSweep (a = recip(en·b), then the column sum of en ⊙ a), kChain (the
// backward's du = −(en·dw)·a², then the column sum of en ⊙ du). Products
// (out_kernel): kOut (the forward's output), kGo (go = rowsum(a_F·g ⊙
// en·(b_F ⊙ v))). Key-major (keys_kernel): kT (dv and the last b's
// gradient), kDk (dK).
enum Kind { kLse, kSweep, kChain, kOut, kGo, kT, kDk, kReduceB, kReduceDw };

// Everything a launch reads and writes, and which rows of the residuals
// and scratch vectors it takes. av [K, 1 + n_av, N] (lse, then the
// a-vectors) and bv [K, iters, M] as the tile branch's; part [K, S, M] the
// column partials; U [K, nt, N] and W [K, nt, M] the backward's computed
// rank-1 factors (term t: U row t ⊗ W row t, the plain version's order;
// the rows that are residual vectors or ones stay unwritten), us [K, N,
// 32] and ws [K, M, 32] every factor as bf16 hi + lo rows over 16 terms
// (zero past nt), the A and B operands of the rank-1 stack's product; go
// and rho [K, N].
struct Args {
  const bf16 *q, *k, *v, *g;
  bf16* out;  // out (kOut), dq (ds_kernel), dv (kT), dk (kDk)
  float *av, *bv, *part, *U, *W, *go, *rho;
  bf16 *us, *ws;
  int K, N, M, S, iters, n_av, nt, final_row;
  float scale, c;  // c = scale·log2 e
  int vrow;        // kSweep: bv row of b; reduce kinds: bv row of b
  int arow;        // kSweep: av row written (a); kChain: av row of a_{i−1}
  int urow;        // kChain: U row written (du)
  int wrow;        // kChain: W row read (dw); kT, kReduceDw: W row written
  int head;        // kChain: add go / a_F (the head of a schedule without final row norm)
  int usrc[kTerms], wsrc[kTerms];  // rank-1 factors' sources (split_kernel)
};

// Element offset of 16-byte chunk c of row r of a [rows, 64] bf16 tile, the
// chunk index XOR-ed with r mod 8: ldmatrix on 8 consecutive rows at one
// chunk hits 8 distinct bank groups.
__device__ __forceinline__ int at(int r, int c) { return r * kD + ((c ^ (r & 7)) << 3); }

// Rows row0 … row0 + 63 of an item's [rows, 64] matrix into a tile, zero
// past `rows`.
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* x, int row0, int rows,
                                          int tid, int nthr) {
  for (int idx = tid; idx < kChunk * 8; idx += nthr) {
    const int r = idx >> 3, c = idx & 7, gr = row0 + r;
    const bool valid = gr < rows;
    cp_async16(tile + at(r, c), x + (size_t)(valid ? gr : 0) * kD + c * 8, valid);
  }
}

// Entries i0 … i0 + 63 of a float vector into dst, zero past n.
__device__ __forceinline__ void load_vec(float* dst, const float* x, int i0, int n, int idx) {
  const bool valid = i0 + idx < n;
  cp_async4(dst + idx, x + (valid ? i0 + idx : 0), valid);
}

// This lane's A fragments of rows r0 … r0 + 15 of an item's [rows, 64]
// matrix, straight from device memory (zero past `rows`): a[ks] covers
// columns 16·ks … 16·ks + 15.
__device__ __forceinline__ void frags_global(uint32_t (&a)[4][4], const bf16* x, int r0,
                                             int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* x2 = reinterpret_cast<const uint32_t*>(x);
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = ra < rows ? x2[(size_t)ra * kWords + 8 * ks + t] : 0u;
    a[ks][1] = rb < rows ? x2[(size_t)rb * kWords + 8 * ks + t] : 0u;
    a[ks][2] = ra < rows ? x2[(size_t)ra * kWords + 8 * ks + t + 4] : 0u;
    a[ks][3] = rb < rows ? x2[(size_t)rb * kWords + 8 * ks + t + 4] : 0u;
  }
}

// The same from rows r0 … r0 + 15 of a swizzled tile, by ldmatrix.
__device__ __forceinline__ void frags_smem(uint32_t (&a)[4][4], const bf16* tile, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldsm_x4(a[ks], tile + at(r0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// B fragments of tile rows rb0 … rb0 + 15 as two 8-row n-tiles (rows of
// the tile are the columns of the product): b[ks][0..1] the first n-tile,
// b[ks][2..3] the second.
__device__ __forceinline__ void bfrags_pair(uint32_t (&b)[4][4], const bf16* tile, int rb0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(b[ks], tile + at(rb0 + (lane & 7) + ((lane >> 4) << 3), 2 * ks + ((lane >> 3) & 1)));
}

// acc = A·Bᵀ over the 64 columns for 16 rows of A and the 16 rows of B in
// b: acc[n][·] the accumulator of n-tile n (row g: [0], [1] at columns 2t,
// 2t + 1; row g + 8: [2], [3]).
__device__ __forceinline__ void nt_pair(float (&acc)[2][4], const uint32_t (&a)[4][4],
                                        const uint32_t (&b)[4][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t b0[2] = {b[ks][0], b[ks][1]}, b1[2] = {b[ks][2], b[ks][3]};
    mma_bf16(acc[0], a[ks], b0);
    mma_bf16(acc[1], a[ks], b1);
  }
}

// o += X·B: X the 16 × 16 float32 entries of an n-tile pair (the
// accumulator layout of nt_pair), split into bf16 hi + lo A fragments; B
// tile rows rb0 … rb0 + 15 (the contraction index) × 64 columns, by
// ldmatrix.trans. o[dt] is the accumulator of output columns 8·dt ….
__device__ __forceinline__ void tn_pair(float (&o)[8][4], const float (&x)[2][4],
                                        const bf16* tile, int rb0) {
  uint32_t hi[4], lo[4];
  hopper::split_bf16x2(x[0][0], x[0][1], hi[0], lo[0]);
  hopper::split_bf16x2(x[0][2], x[0][3], hi[1], lo[1]);
  hopper::split_bf16x2(x[1][0], x[1][1], hi[2], lo[2]);
  hopper::split_bf16x2(x[1][2], x[1][3], hi[3], lo[3]);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, tile + at(rb0 + (lane & 15), 2 * dp + (lane >> 4)));
    const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    mma_bf16(o[2 * dp], hi, b0);
    mma_bf16(o[2 * dp + 1], hi, b1);
    mma_bf16(o[2 * dp], lo, b0);
    mma_bf16(o[2 * dp + 1], lo, b1);
  }
}

// Element offset of 16-byte chunk c (0, 1: hi of terms 0-7, 8-15; 2, 3:
// lo) of row r of a [rows, 32] tile of split rank-1 factors, the chunk index
// XOR-ed with (r / 2) mod 4: ldmatrix on 8 consecutive rows hits 8 distinct
// bank groups.
__device__ __forceinline__ int at_split(int r, int c) {
  return r * kSplitLd + ((c ^ ((r >> 1) & 3)) << 3);
}

// Rows row0 … row0 + 63 of an item's [rows, 32] split factors into a
// tile, zero past `rows`.
__device__ __forceinline__ void load_split_tile(bf16* tile, const bf16* x, int row0, int rows,
                                                int tid, int nthr) {
  for (int idx = tid; idx < kChunk * 4; idx += nthr) {
    const int r = idx >> 2, c = idx & 3, gr = row0 + r;
    const bool valid = gr < rows;
    cp_async16(tile + at_split(r, c), x + (size_t)(valid ? gr : 0) * kSplitLd + c * 8, valid);
  }
}

// This lane's A fragments (hi, lo) of rows r0 … r0 + 15 of an item's [rows,
// 32] split factors, from device memory (zero past `rows`).
__device__ __forceinline__ void split_afrags(uint32_t (&ah)[4], uint32_t (&al)[4], const bf16* x,
                                             int r0, int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* x2 = reinterpret_cast<const uint32_t*>(x);
  const int ra = r0 + g, rb = ra + 8;
  constexpr int kW = kSplitLd / 2;  // words a row: 8 hi pairs, 8 lo pairs
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    uint32_t(&a)[4] = part ? al : ah;
    const int o = 8 * part + t;
    a[0] = ra < rows ? x2[(size_t)ra * kW + o] : 0u;
    a[1] = rb < rows ? x2[(size_t)rb * kW + o] : 0u;
    a[2] = ra < rows ? x2[(size_t)ra * kW + o + 4] : 0u;
    a[3] = rb < rows ? x2[(size_t)rb * kW + o + 4] : 0u;
  }
}

// B fragments (hi, lo) of split-tile rows rb0 … rb0 + 15 as two n-tiles
// over the 16 terms: [0..1] the first n-tile, [2..3] the second.
__device__ __forceinline__ void split_bfrags_pair(uint32_t (&bh)[4], uint32_t (&bl)[4],
                                                  const bf16* tile, int rb0) {
  const int lane = threadIdx.x & 31;
  const int r = rb0 + (lane & 7) + ((lane >> 4) << 3), c = (lane >> 3) & 1;
  ldsm_x4(bh, tile + at_split(r, c));
  ldsm_x4(bl, tile + at_split(r, c + 2));
}

// The rank-1 stack Σ_t a_t ⊗ b_t at 16 rows × the 16 columns of an n-tile
// pair, on the tensor cores: (Ah + Al)·(Bh + Bl)ᵀ without the lo·lo
// product, about 2^-16 relative.
__device__ __forceinline__ void rank1_pair(float (&r1)[2][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[4],
                                           const uint32_t (&bl)[4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const uint32_t h[2] = {bh[2 * n], bh[2 * n + 1]}, l[2] = {bl[2 * n], bl[2 * n + 1]};
    r1[n][0] = r1[n][1] = r1[n][2] = r1[n][3] = 0.f;
    mma_bf16(r1[n], ah, h);
    mma_bf16(r1[n], ah, l);
    mma_bf16(r1[n], al, h);
  }
}

// 2^(c·s − l): an entry of the matrix from its raw product s.
__device__ __forceinline__ float entry(float s, float c, float l) { return ex2(fmaf(s, c, -l)); }

// ---- the sweeps ------------------------------------------------------------

// Dynamic shared memory of rows_kernel: the split's q rows, two key tiles,
// two column-vector chunks, the rows' lse2 and weights.
constexpr size_t kRowsSmem = 2 * (size_t)kSplitRows * kD + 2 * 2 * kTile + 4 * (2 * kChunk) +
                             4 * (2 * kSplitRows);

// One block a (item, split): the row pass over the split's rows, then the
// column pass over the same rows; writes the split's column partial.
template <int kKind>
__global__ void __launch_bounds__(kRowThreads) rows_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kSplitRows, 64]
  bf16* kt = qs + kSplitRows * kD;                // [2][kChunk, 64]
  float* cvec = reinterpret_cast<float*>(kt + 2 * kTile);  // [2][kChunk]
  float* lse2s = cvec + 2 * kChunk;                        // [kSplitRows]
  float* us = lse2s + kSplitRows;                          // [kSplitRows]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / p.S, split = blockIdx.x % p.S;
  const int i0 = split * kSplitRows, rows = min(kSplitRows, p.N - i0);
  const bf16* q = p.q + ((size_t)item * p.N + i0) * kD;
  const bf16* k = p.k + (size_t)item * p.M * kD;
  const size_t avi = (size_t)item * (1 + p.n_av) * p.N;
  const float* colv = kKind == kSweep ? p.bv + ((size_t)item * p.iters + p.vrow) * p.M
                      : kKind == kChain ? p.W + ((size_t)item * p.nt + p.wrow) * p.M
                                        : nullptr;
  for (int idx = tid; idx < kSplitRows * 8; idx += kRowThreads) {
    const int r = idx >> 3, c = idx & 7;
    const bool valid = r < rows;
    cp_async16(qs + at(r, c), q + (size_t)(valid ? r : 0) * kD + c * 8, valid);
  }
  if constexpr (kKind != kLse)
    for (int r = tid; r < kSplitRows; r += kRowThreads)
      lse2s[r] = r < rows ? p.av[avi + i0 + r] * kLog2e : kBig;
  const int nchunks = (p.M + kChunk - 1) / kChunk;
  auto stage = [&](int ch) {
    if (ch < nchunks) {
      load_tile(kt + (ch & 1) * kTile, k, ch * kChunk, p.M, tid, kRowThreads);
      if constexpr (kKind != kLse)
        if (tid < kChunk) load_vec(cvec + (ch & 1) * kChunk, colv, ch * kChunk, p.M, tid);
    }
    cp_async_commit();
  };
  stage(0);

  // ---- row pass: this warp's strips 2·warp, 2·warp + 1
  const int r0 = 16 * kLightStrips * warp;
  const bool active = r0 < rows;
  uint32_t a[kLightStrips][4][4];
  float l2[kLightStrips][2];                // the rows' lse2 (sweeps and chain)
  float racc[kLightStrips][2] = {};         // row sums (sweeps and chain), Σe (kLse)
  float mx[kLightStrips][2];                // running row max (kLse)
#pragma unroll
  for (int s = 0; s < kLightStrips; ++s) mx[s][0] = mx[s][1] = -INFINITY;
  for (int ch = 0; ch < nchunks; ++ch) {
    stage(ch + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (ch == 0) {
#pragma unroll
      for (int s = 0; s < kLightStrips; ++s) {
        frags_smem(a[s], qs, r0 + 16 * s);
        if constexpr (kKind != kLse) {
          l2[s][0] = lse2s[r0 + 16 * s + g];
          l2[s][1] = lse2s[r0 + 16 * s + g + 8];
        }
      }
    }
    const bf16* kc = kt + (ch & 1) * kTile;
    const float* cv = cvec + (ch & 1) * kChunk;
    if (active) {
      if constexpr (kKind == kLse) {
        float sv[kLightStrips][8][4];
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4][4];
          bfrags_pair(b, kc, 16 * np);
#pragma unroll
          for (int s = 0; s < kLightStrips; ++s) {
            float acc[2][4];
            nt_pair(acc, a[s], b);
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = ch * kChunk + 16 * np + 8 * n + 2 * t + (e & 1);
                sv[s][2 * np + n][e] = j < p.M ? acc[n][e] * p.c : -INFINITY;
              }
          }
        }
#pragma unroll
        for (int s = 0; s < kLightStrips; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float cm = -INFINITY;
#pragma unroll
            for (int n8 = 0; n8 < 8; ++n8)
              cm = fmaxf(cm, fmaxf(sv[s][n8][2 * h], sv[s][n8][2 * h + 1]));
            const float mn = fmaxf(mx[s][h], quad_max(cm));
            float add = 0.f;
#pragma unroll
            for (int n8 = 0; n8 < 8; ++n8)
              add += ex2(sv[s][n8][2 * h] - mn) + ex2(sv[s][n8][2 * h + 1] - mn);
            racc[s][h] = fmaf(racc[s][h], ex2(mx[s][h] - mn), add);
            mx[s][h] = mn;
          }
      } else {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4][4];
          bfrags_pair(b, kc, 16 * np);
          const float2 w0 = lds_f2(cv + 16 * np + 2 * t), w1 = lds_f2(cv + 16 * np + 8 + 2 * t);
#pragma unroll
          for (int s = 0; s < kLightStrips; ++s) {
            float acc[2][4];
            nt_pair(acc, a[s], b);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float r = racc[s][h];
              r = fmaf(entry(acc[0][2 * h], p.c, l2[s][h]), w0.x, r);
              r = fmaf(entry(acc[0][2 * h + 1], p.c, l2[s][h]), w0.y, r);
              r = fmaf(entry(acc[1][2 * h], p.c, l2[s][h]), w1.x, r);
              r = fmaf(entry(acc[1][2 * h + 1], p.c, l2[s][h]), w1.y, r);
              racc[s][h] = r;
            }
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // the rows' results and the column pass's row weights
#pragma unroll
  for (int s = 0; s < kLightStrips; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * s + g + 8 * h;
      const bool valid = r < rows;
      const float sum = quad_sum(racc[s][h]);
      const size_t at_row = i0 + r;
      if constexpr (kKind == kLse) {
        const float lse = (mx[s][h] + log2f(sum)) * kLn2;
        if (t == 0) {
          if (valid) p.av[avi + at_row] = lse;
          lse2s[r] = valid ? lse * kLog2e : kBig;
          us[r] = valid ? 1.f : 0.f;
        }
      } else if constexpr (kKind == kSweep) {
        const float av_ = recip_rn(sum);
        if (t == 0) {
          if (valid) p.av[avi + (size_t)p.arow * p.N + at_row] = av_;
          us[r] = valid ? av_ : 0.f;
        }
      } else {
        float da = sum;
        float du = 0.f;
        if (valid) {
          if (p.head)
            da += p.go[(size_t)item * p.N + at_row] / p.av[avi + (size_t)p.n_av * p.N + at_row];
          const float ap = p.av[avi + (size_t)p.arow * p.N + at_row];
          du = -da * ap * ap;
        }
        if (t == 0) {
          if (valid) p.U[((size_t)item * p.nt + p.urow) * p.N + at_row] = du;
          us[r] = du;
        }
      }
    }
  __syncthreads();

  // ---- column pass: 32 keys a warp at a time, over the split's rows
  const int qpairs = (rows + 15) / 16;
  float* part = p.part + ((size_t)item * p.S + split) * p.M;
  for (int j0 = 32 * warp; j0 < p.M; j0 += 32 * kRowWarps) {
    uint32_t ka[2][4][4];
    frags_global(ka[0], k, j0, p.M);
    frags_global(ka[1], k, j0 + 16, p.M);
    float cacc[2][2] = {};
    for (int qp = 0; qp < qpairs; ++qp) {
      uint32_t b[4][4];
      bfrags_pair(b, qs, 16 * qp);
      const float2 la = lds_f2(lse2s + 16 * qp + 2 * t), lb = lds_f2(lse2s + 16 * qp + 8 + 2 * t);
      const float2 ua = lds_f2(us + 16 * qp + 2 * t), ub = lds_f2(us + 16 * qp + 8 + 2 * t);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float acc[2][4];
        nt_pair(acc, ka[s], b);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = cacc[s][h];
          x = fmaf(entry(acc[0][2 * h], p.c, la.x), ua.x, x);
          x = fmaf(entry(acc[0][2 * h + 1], p.c, la.y), ua.y, x);
          x = fmaf(entry(acc[1][2 * h], p.c, lb.x), ub.x, x);
          x = fmaf(entry(acc[1][2 * h + 1], p.c, lb.y), ub.y, x);
          cacc[s][h] = x;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = quad_sum(cacc[s][h]);
        const int j = j0 + 16 * s + g + 8 * h;
        if (t == 0 && j < p.M) part[j] = v;
      }
  }
}

// The column partials' sum over the splits, in split order, one thread a
// (item, key): kReduceB closes b = recip(Σ) into bv row vrow; kReduceDw
// the chain's dw = −Σ·b² (b = bv row vrow) into W row wrow.
template <int kKind>
__global__ void __launch_bounds__(256) reduce_kernel(const Args p) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (size_t)p.K * p.M) return;
  const int item = idx / p.M, j = idx % p.M;
  const float* src = p.part + (size_t)item * p.S * p.M + j;
  float s = 0.f;
  for (int sp = 0; sp < p.S; ++sp) s += src[(size_t)sp * p.M];
  float* brow = p.bv + ((size_t)item * p.iters + p.vrow) * p.M;
  if constexpr (kKind == kReduceB) {
    brow[j] = recip_rn(s);
  } else {
    const float b = brow[j];
    p.W[((size_t)item * p.nt + p.wrow) * p.M + j] = -s * b * b;
  }
}

// ---- the output product ----------------------------------------------------

constexpr size_t kOutSmem = 2 * (2 * 2 * (size_t)kTile) + 4 * (2 * kChunk);

// One block a (item, 128 rows), a warp a 16-row strip, two blocks an SM
// (at most 128 registers a thread): o = en·(b ⊙ v) and
// r = en·b with b the last b-vector; kOut writes out = a ⊙ o (a = recip(r)
// with the final row norm, else the last stored a, else 1), kGo writes go =
// a_F·rowsum(g ⊙ o) and, with the final row norm, du_F = −go·a_F (U row 0).
template <int kKind>
__global__ void __launch_bounds__(kRowThreads, 2) out_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* kt = reinterpret_cast<bf16*>(smem_raw);  // [2][kChunk, 64]
  bf16* vt = kt + 2 * kTile;                      // [2][kChunk, 64]
  float* cvec = reinterpret_cast<float*>(vt + 2 * kTile);  // [2][kChunk]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int blocks = (p.N + kProductRows - 1) / kProductRows;
  const int item = blockIdx.x / blocks, i0 = (blockIdx.x % blocks) * kProductRows;
  const int rows = min(kProductRows, p.N - i0), r0 = 16 * warp;
  const bf16* k = p.k + (size_t)item * p.M * kD;
  const bf16* v = p.v + (size_t)item * p.M * kD;
  const float* bcol = p.bv + ((size_t)item * p.iters + p.iters - 1) * p.M;
  const size_t avi = (size_t)item * (1 + p.n_av) * p.N;
  const int nchunks = (p.M + kChunk - 1) / kChunk;
  auto stage = [&](int ch) {
    if (ch < nchunks) {
      load_tile(kt + (ch & 1) * kTile, k, ch * kChunk, p.M, tid, kRowThreads);
      load_tile(vt + (ch & 1) * kTile, v, ch * kChunk, p.M, tid, kRowThreads);
      if (tid < kChunk) load_vec(cvec + (ch & 1) * kChunk, bcol, ch * kChunk, p.M, tid);
    }
    cp_async_commit();
  };
  stage(0);
  const bool active = r0 < rows;
  uint32_t a[4][4];
  frags_global(a, p.q + ((size_t)item * p.N + i0) * kD, r0, rows);
  float l2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    l2[h] = r < rows ? p.av[avi + i0 + r] * kLog2e : kBig;
  }
  float o[8][4] = {}, racc[2] = {};
  for (int ch = 0; ch < nchunks; ++ch) {
    stage(ch + 1);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kc = kt + (ch & 1) * kTile;
    const bf16* vc = vt + (ch & 1) * kTile;
    const float* cv = cvec + (ch & 1) * kChunk;
    if (active) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4][4];
        bfrags_pair(b, kc, 16 * np);
        float acc[2][4];
        nt_pair(acc, a, b);
        const float2 w0 = lds_f2(cv + 16 * np + 2 * t), w1 = lds_f2(cv + 16 * np + 8 + 2 * t);
        float x[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[0][2 * h] = entry(acc[0][2 * h], p.c, l2[h]) * w0.x;
          x[0][2 * h + 1] = entry(acc[0][2 * h + 1], p.c, l2[h]) * w0.y;
          x[1][2 * h] = entry(acc[1][2 * h], p.c, l2[h]) * w1.x;
          x[1][2 * h + 1] = entry(acc[1][2 * h + 1], p.c, l2[h]) * w1.y;
          racc[h] += (x[0][2 * h] + x[0][2 * h + 1]) + (x[1][2 * h] + x[1][2 * h + 1]);
        }
        tn_pair(o, x, vc, 16 * np);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    const bool valid = r < rows;
    const size_t row = (size_t)item * p.N + i0 + r;
    const float sum = quad_sum(racc[h]);
    if constexpr (kKind == kOut) {
      float a_r = 1.f;
      if (p.final_row) {
        a_r = recip_rn(sum);
        if (valid && t == 0) p.av[avi + (size_t)p.n_av * p.N + i0 + r] = a_r;
      } else if (p.n_av && valid) {
        a_r = p.av[avi + (size_t)p.n_av * p.N + i0 + r];
      }
      if (valid) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(p.out + row * kD);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
          dst[4 * dt + t] = pack_bf16(a_r * o[dt][2 * h], a_r * o[dt][2 * h + 1]);
      }
    } else {
      float dot = 0.f;
      if (valid) {
        const uint32_t* gr = reinterpret_cast<const uint32_t*>(p.g + row * kD);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          const uint32_t w = gr[4 * dt + t];
          const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
          dot = fmaf(gv.x, o[dt][2 * h], fmaf(gv.y, o[dt][2 * h + 1], dot));
        }
      }
      dot = quad_sum(dot);
      if (valid && t == 0) {
        const float aF = p.n_av ? p.av[avi + (size_t)p.n_av * p.N + i0 + r] : 1.f;
        const float go = aF * dot;
        p.go[row] = go;
        if (p.final_row) p.U[((size_t)item * p.nt) * p.N + i0 + r] = -go * aF;
      }
    }
  }
}

// ---- host ------------------------------------------------------------------

// Validates a launch of either direction; 0 or cudaErrorInvalidValue.
inline int check(int K, int N, int M, int D, int iters, int final_row) {
  if (K < 1 || N < 1 || M < 1 || D != kD || iters < 1 || iters > kMaxIters ||
      (final_row != 0 && final_row != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The parts of Args every launch of a call shares.
inline Args base_args(int K, int N, int M, float scale, int iters, int final_row) {
  Args a{};
  a.K = K;
  a.N = N;
  a.M = M;
  a.S = (N + kSplitRows - 1) / kSplitRows;
  a.iters = iters;
  a.n_av = num_arows(iters, final_row);
  a.nt = 2 * iters - 1 + final_row;
  a.final_row = final_row;
  a.scale = scale;
  a.c = scale * kLog2e;
  return a;
}

template <class Kernel>
inline cudaError_t launch(Kernel kernel, int blocks, int threads, size_t smem, cudaStream_t st,
                          const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace ssplit
}  // namespace nrv
