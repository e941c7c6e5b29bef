// Packed-qkv attention, backward, resident branch (bf16, D = 64, N as
// packed_resident.cuh::resident_fits allows): the hand-derived gradient of
// packed_resident_fwd.cu from the stored residual rows, written into a
// packed [B, N, 3·H·64] gradient (dq | dk | dv). Same function as
// packed_attention_bwd.cu, which keeps the other shapes.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/block_attention.py
// ::_packed_bwd_impl (pl.pallas_call at :284), whose body is
// sinkhorn_attention.py::_bwd_math_batched.
//
// Per (image, head) item, with A = exp(scale·q·kᵀ − lse) (robust: O =
// diag(a)·A·diag(b)·V):
//   vanilla: dV = Aᵀ·G, dA = G·Vᵀ, dS = A ⊙ (dA − rowsum(dA ⊙ A));
//   robust:  t1 = (A ⊙ a)ᵀ·G, dV = b ⊙ t1, db = rowsum(t1 ⊙ V),
//            o/a = (A ⊙ b)·V, da = rowsum(G ⊙ o/a), the reverse chain,
//            dS = A ⊙ ((a ⊙ (G·Vᵀ) ⊙ b − row term) + Σ u_k v_kᵀ);
//   dQ = scale·dS·K, dK = scale·dSᵀ·Q.
//
// What bounds it on the card (H100): not the bytes (q, k, v, dout and
// vecs in, dqkv out: ~0.17 ms a [256, 196, 2304] call) but, per item, ten
// product-equivalents of 2·N²·D on the tensor cores (~64 MFLOP with the
// float32 side split into bf16 hi + lo and the rows padded to 64-row
// tiles), the N² exps and the chain's passes over the matrix, and the
// latency between them. Here:
//   * the item's N×N float32 matrix lives in registers, in the wgmma
//     accumulator layout, a 64-row tile a consumer warpgroup: one block of
//     two warpgroups holds 128 rows, so at N ≤ 128 one block holds the
//     item and at 128 < N ≤ 200 a cluster of two blocks does (rows
//     128·rank..); S = q·kᵀ lands in the registers that then hold A, and
//     dS is formed over A in place;
//   * products with the matrix on the left, o/a = (A ⊙ b)·V and dQ = dS·K,
//     take those registers as wgmma A fragments (split into bf16 hi + lo);
//     G·Vᵀ for dS runs in 40-column chunks beside A;
//   * the transposed products, t1 (vanilla: dV) and dK, go through shared
//     memory: each warpgroup stores the hi and lo planes of its rows
//     transposed (stmatrix), and a 64-row tile of columns at a time is
//     multiplied on wgmma; each block sends the partial sums of the tiles
//     the other block owns through distributed shared memory (st.async)
//     and adds the other's to its own, while o/a or dS (dK: the next
//     item's q·kᵀ) runs;
//   * dQ, dK and dV leave a warp's 16 rows at a time through shared memory
//     (stmatrix), 16 bytes a lane;
//   * the reverse chain's row passes run in registers; its column sums are
//     per-warp partials (shuffles across the warp's row groups), summed
//     across warps in warp order through shared memory, then across the
//     cluster in rank order; no atomics, so two runs give the same bits;
//   * the matrix out of shared memory frees it for a ring of two operand
//     slots: a producer warp (in a warpgroup of its own, which hands its
//     registers to the consumers) keeps the next round's k | q, dout | v or
//     k | q (k and v whole, q and dout the block's rows) in flight by TMA
//     while the consumers compute, and the warpgroup's second warp copies
//     each item's stored b and a rows (cp.async); no device scratch at all.
// Measured (PERF.md §6, tools/torch_packed_phases.py): 1.01 ms robust (3,
// final), 0.61 vanilla at [256, 196, 2304], 6.1× and 3.8× the byte bound;
// the chain's cluster exchanges, dS's rank-1 terms and the transposed
// products' shared-memory traffic take most of what the tensor cores do
// not, and the consumers' 240 registers are spent: one more live tile
// spills.
#include "cluster.cuh"
#include "packed_resident.cuh"
#include "resident_warp.cuh"

namespace nrv {
namespace res {

// Barrier of the two consumer warpgroups (the producer warp never joins).
__device__ __forceinline__ void cbar() { named_sync(1, kThreads); }

// The thread's warpgroup, as a value the compiler knows to be the same
// across the warp (so that a branch on it around wgmma is not divergent).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// The block's shared memory, carved from the aligned base.
struct BwdSmem {
  uint8_t* ring;   // kRingSlots × [full buffer (k or v), half buffer (q or dout)]
  uint8_t* stage;  // [plane hi, lo][warpgroup] regions; then the exchange's receive area
  float* colb;     // [kMaxIters][kNCols] the b rows, zero past N
  float* coldc;    // [kMaxIters][kNCols] the chain's dc vectors
  float* db;       // [kNCols] db_row
  float* part;     // [kWarps][kNCols] per-warp column partials
  float* xbuf;     // [2 buffers][2 ranks][kNCols] the column sums' cluster exchange
  float* rowa;     // [kMaxIters][kBlockRows] the a rows at the block's rows
  float* rowdr;    // [kMaxIters][kBlockRows] the chain's dr vectors

  __device__ explicit BwdSmem(uint8_t* base) {
    ring = base;
    stage = base + kRingSlots * kSlotBytes;
    float* f = reinterpret_cast<float*>(stage + 4 * kStageBytes);
    colb = f;
    coldc = colb + kMaxIters * kNCols;
    db = coldc + kMaxIters * kNCols;
    part = db + kNCols;
    xbuf = part + kWarps * kNCols;
    rowa = xbuf + 4 * kNCols;
    rowdr = rowa + kMaxIters * kBlockRows;
  }
};

// mbarriers: the ring's full and empty ones, the item's b and a rows
// (landed; read), the column sums' two exchange buffers, and the
// transposed products' exchange (the peer's staging area is free; this
// block's receive area is filled).
enum Bar { kFull = 0, kEmpty = kRingSlots, kVecFull = 2 * kRingSlots, kVecEmpty, kXchg,
           kFree = kXchg + 2, kData, kBars };

// What a consumer thread carries from one cluster exchange to the next.
struct Sync {
  uint64_t* bars;
  int rank;
  int xcur = 0;
  uint32_t xpar = 0;  // bit b: the phase the next wait on exchange buffer b expects
  uint32_t fpar = 0, dpar = 0;
};

// ---- the matrix in registers ----------------------------------------------
// Thread l of warpgroup wg holds A[4s + q] = row 64·wg + 16·(l / 32) +
// (l % 32) / 4 + 8·(q / 2) of the block's rows, column 8·s + 2·(l % 4) +
// q % 2 (wg_tile's layout): 25 column tiles s of 8, two rows per thread.

// The hi and lo planes of the warpgroup's 64 rows, stored transposed into
// its staging regions ([plane][wg], rows = the matrix's columns, 64 columns
// = the warpgroup's rows, the 128-byte swizzle): frag(s, hr, hi, lo) gives
// fragment (s, hr), the bf16 pairs hi and lo of the thread's columns 8s +
// 2t, 8s + 2t + 1 of row g + 8·hr. Each stmatrix.x4 stores the 8×8 blocks
// (s, 0), (s, 1), (s + 1, 0), (s + 1, 1).
template <class Frag>
__device__ __forceinline__ void stage_planes(uint8_t* stage, Frag frag) {
  const int wg = warpgroup(), wq = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int m = lane / 8, r = lane % 8;
  uint8_t* hi_base = stage + wg * kStageBytes;
  uint8_t* lo_base = stage + (2 + wg) * kStageBytes;
#pragma unroll
  for (int s = 0; s + 1 < kNCols / 8; s += 2) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) frag(s + f / 2, f % 2, h[f], l[f]);
    const uint32_t off = hopper::swz_offset(8 * (s + m / 2) + r, 16 * wq + 8 * (m % 2));
    hopper::stmatrix_x4_trans(hi_base + off, h[0], h[1], h[2], h[3]);
    hopper::stmatrix_x4_trans(lo_base + off, l[0], l[1], l[2], l[3]);
  }
  constexpr int kLast = kNCols / 8 - 1;  // 25 tiles: the last one alone
  uint32_t h[2], l[2];
  frag(kLast, 0, h[0], l[0]);
  frag(kLast, 1, h[1], l[1]);
  const uint32_t off = hopper::swz_offset(8 * kLast + r, 16 * wq + 8 * (m % 2));
  hopper::stmatrix_x2_trans(hi_base + off, h[0], h[1]);
  hopper::stmatrix_x2_trans(lo_base + off, l[0], l[1]);
}

// The transposed products, C = Mᵀ·Bop for the staged planes M (the
// block's rows × N columns) and an operand buffer Bop (the block's rows ×
// 64, read MN-major): rows of C are the matrix's columns j, in tiles of 64
// (rows past N are computed and dropped, so no wgmma waits on a branch).
// A lone block (N ≤ 128) gives warpgroup wg tile wg. In a cluster both
// blocks compute all four tiles over their own rows, warpgroup wg tiles 2·wg
// and 2·wg + 1; block rank owns tile 2·wg + rank of each warpgroup (acc[0])
// and sends the other (acc[1]) to the block that owns it (tp_park), which
// adds it to its own partial (tp_take): a sum of two, the same bits in
// either order. Each epilogue then takes tile own_tile(): acc[0] in the n64
// accumulator layout, v[4nt + q] at row 64·jt + 16·(wl / 32) + g +
// 8·(q / 2), column 8·nt + 2t + q % 2.
template <int CL>
constexpr int kTilesPerWg = CL == 2 ? 2 : 1;

template <int CL>
__device__ __forceinline__ int own_tile(int rank) {
  return CL == 2 ? 2 * warpgroup() + rank : warpgroup();
}

// The warpgroup's tiles (own first) from the planes that frag gives (as
// stage_planes), every wgmma in one group. The caller passes a consumer
// barrier first (the staging area is free).
template <int CL, class Frag>
__device__ __forceinline__ void tp_product(float (&acc)[kTilesPerWg<CL>][32], uint8_t* stage,
                                           const uint8_t* bop, int rank, Frag frag) {
  constexpr int T = kTilesPerWg<CL>;
  stage_planes(stage, frag);
  hopper::fence_proxy_async();
  cbar();
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
#pragma unroll
  for (int u = 0; u < T; ++u) hopper::fence_regs(acc[u]);
  hopper::wgmma_fence();
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int jt = own_tile<CL>(rank) ^ u;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint64_t da = hopper::desc_sw128(stage + (2 * p + hh) * kStageBytes + jt * kTileBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n64k16_ss(
              acc[u], da + 2 * kk,
              hopper::desc_sw128(bop + (kTileRows * hh + 16 * kk) * hopper::kSwizzleRowBytes), 1);
      }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < T; ++u) hopper::fence_regs(acc[u]);
}

// Whether warp wq of the warpgroup that holds tile jt has a row below N.
__device__ __forceinline__ bool warp_rows_live(int jt, int wq, int N) {
  return kTileRows * jt + 16 * wq < N;
}

// Partial sums a block receives: 4 KB from each warp of the peer whose
// rows of the tile this block owns are live.
__device__ __forceinline__ uint32_t tp_recv_bytes(int rank, int N) {
  uint32_t bytes = 0;
  for (int wg = 0; wg < 2; ++wg)
    for (int wq = 0; wq < 4; ++wq)
      if (warp_rows_live(2 * wg + rank, wq, N)) bytes += 32 * 32 * sizeof(float);
  return bytes;
}

// Once the products have read the staging area, it holds two areas of
// partial sums, each [warpgroup][8][128 threads] float4s: the peer's
// partials of the own tiles (written by the peer) and this block's own
// ones (kept); beyond them, a warpgroup's 8 KB of bf16 rows on their way
// to device memory (store_tile).
constexpr uint32_t kRecvArea = 0, kKeepArea = 2 * kPartBytes, kOutArea = 4 * kPartBytes;
__device__ __forceinline__ uint32_t tp_slot(uint32_t area, int wg, int k, int wl) {
  return area + ((wg * 8 + k) * 128 + wl) * (uint32_t)sizeof(float4);
}
__device__ __forceinline__ float4& tp_at(uint8_t* stage, uint32_t area, int wg, int k, int wl) {
  return *reinterpret_cast<float4*>(stage + tp_slot(area, wg, k, wl));
}

// After the products: tell the peer that its partials may come, park the
// own tile in the staging area, so that no registers carry it, and, once
// the peer is ready for them (its tp_park), send it the other tile's
// partials from the registers.
template <int CL>
__device__ __forceinline__ void tp_park(const float (&acc)[kTilesPerWg<CL>][32], uint8_t* stage,
                                        int N, Sync& sy) {
  const int wg = warpgroup(), wl = threadIdx.x % 128, wq = wl / 32;
  cbar();  // both warpgroups' products have read the staging area
  if (CL == 2 && threadIdx.x == 0) {
    hopper::mbar_expect_tx(&sy.bars[kData], tp_recv_bytes(sy.rank, N));
    mbar_arrive_cluster(cluster_addr(&sy.bars[kFree], sy.rank ^ 1));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    tp_at(stage, kKeepArea, wg, k, wl) =
        make_float4(acc[0][4 * k], acc[0][4 * k + 1], acc[0][4 * k + 2], acc[0][4 * k + 3]);
  if constexpr (CL == 2) {
    const int peer = sy.rank ^ 1;
    mbar_wait_cluster(&sy.bars[kFree], sy.fpar);
    sy.fpar ^= 1;
    if (warp_rows_live(2 * wg + peer, wq, N)) {
      const uint32_t remote = cluster_addr(stage, peer);
      const uint32_t rbar = cluster_addr(&sy.bars[kData], peer);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        st_async(remote + tp_slot(kRecvArea, wg, k, wl),
                 make_float4(acc[1][4 * k], acc[1][4 * k + 1], acc[1][4 * k + 2], acc[1][4 * k + 3]),
                 rbar);
    }
  }
}

// The own tile's totals: the kept partials plus, in a cluster, the peer's.
template <int CL>
__device__ __forceinline__ void tp_take(float (&v)[32], uint8_t* stage, int N, Sync& sy) {
  const int wg = warpgroup(), wl = threadIdx.x % 128, wq = wl / 32;
  bool add = false;
  if constexpr (CL == 2) {
    mbar_wait_cluster(&sy.bars[kData], sy.dpar);
    sy.dpar ^= 1;
    add = warp_rows_live(2 * wg + sy.rank, wq, N);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float4 o = tp_at(stage, kKeepArea, wg, k, wl);
    if (add) o = add4(o, tp_at(stage, kRecvArea, wg, k, wl));
    v[4 * k] = o.x;
    v[4 * k + 1] = o.y;
    v[4 * k + 2] = o.z;
    v[4 * k + 3] = o.w;
  }
}

// o = (A ⊙ cs)·Bop for the warpgroup's rows, A from the registers (times
// the column vector cs) split into bf16 hi + lo, Bop an operand buffer
// read MN-major (rows = the contraction index, zero past N). Two fragment
// sets take turns, so that one k block's split overlaps the previous
// one's products.
__device__ __forceinline__ void scaled_product(float (&o)[32], const float (&A)[kAcc],
                                               const float* cs, const uint8_t* bop) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int kb = 0; kb < kOpRows / 16; ++kb) {
    const int p = kb & 1;
    if (kb >= 2) {
      hopper::wgmma_wait<1>();
      hopper::fence_regs(hi[p]);
      hopper::fence_regs(lo[p]);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int s = 2 * kb + f / 2, hr = f % 2;
      if (s < kNCols / 8) {
        const float2 c = lds_f2(cs + 8 * s + 2 * t);
        hopper::split_bf16x2(A[4 * s + 2 * hr] * c.x, A[4 * s + 2 * hr + 1] * c.y, hi[p][f], lo[p][f]);
      } else {
        hi[p][f] = lo[p][f] = 0u;
      }
    }
    hopper::fence_regs(o);
    hopper::wgmma_fence();
    const uint64_t db = hopper::desc_sw128(bop + kb * 16 * hopper::kSwizzleRowBytes);
    hopper::wgmma_m64n64k16_rs(o, hi[p], db, 1);
    hopper::wgmma_m64n64k16_rs(o, lo[p], db, 1);
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
}

// x = (G·Vᵀ)[:, 40c .. 40c + 39] for the warpgroup's rows, issued: the G
// tile (K-major, 64 rows) against v rows 40c.. (K-major), on wgmma. x[4s' +
// q] is column 40c + 8s' + 2t + q % 2 of row g + 8·(q / 2): matrix tile 5c
// + s'.
constexpr int kChunkTiles = 5;
constexpr int kChunks = kNCols / (8 * kChunkTiles);
__device__ __forceinline__ void gv_issue(float (&x)[4 * kChunkTiles], const uint8_t* gtile,
                                         const uint8_t* vbuf, int c) {
  const uint64_t da = hopper::desc_sw128(gtile);
  const uint64_t db =
      hopper::desc_sw128(vbuf + 8 * kChunkTiles * c * hopper::kSwizzleRowBytes);
  hopper::fence_regs(x);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kD / 16; ++k) hopper::wgmma_m64n40k16(x, da + 2 * k, db + 2 * k, k > 0);
  hopper::wgmma_commit();
}

// fn(c, x) for the chunks of G·Vᵀ in turn, chunk c + 1 on the tensor cores
// while fn takes chunk c.
template <class Fn>
__device__ __forceinline__ void gv_chunks(const uint8_t* gtile, const uint8_t* vbuf, Fn fn) {
  float x[2][4 * kChunkTiles];
  gv_issue(x[0], gtile, vbuf, 0);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) {
      gv_issue(x[(c + 1) & 1], gtile, vbuf, c + 1);
      hopper::wgmma_wait<1>();
    } else {
      hopper::wgmma_wait<0>();
    }
    hopper::fence_regs(x[c & 1]);
    fn(c, x[c & 1]);
  }
}

// Row sums of the thread's two rows weighted by the column vector cv.
__device__ __forceinline__ float2 row_pass(const float (&A)[kAcc], const float* cv) {
  const int t = threadIdx.x % 4;
  float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f;  // even and odd columns apart
#pragma unroll
  for (int s = 0; s < kNCols / 8; ++s) {
    const float2 w = lds_f2(cv + 8 * s + 2 * t);
    a0 = fmaf(A[4 * s], w.x, a0);
    b0 = fmaf(A[4 * s + 1], w.y, b0);
    a1 = fmaf(A[4 * s + 2], w.x, a1);
    b1 = fmaf(A[4 * s + 3], w.y, b1);
  }
  return make_float2(quad_sum(a0 + b0), quad_sum(a1 + b1));
}

// The item's column vector db from each block's contribution contrib(j),
// j < N: in a cluster the two blocks' contributions are exchanged
// (st.async into both slots of the current buffer) and added in rank order;
// then, when dc is given, dc[j] = db[j]·−bn[j]² too. Both are written for
// every j < kNCols (zero past N). Ends with a consumer barrier.
template <int CL, class Contrib>
__device__ __forceinline__ void post_cols(const BwdSmem& sm, int N, Sync& sy, Contrib contrib,
                                          float* dc, const float* bn) {
  auto post = [&](int j, float total) {
    sm.db[j] = total;
    if (dc != nullptr) dc[j] = total * -(bn[j] * bn[j]);
  };
  if constexpr (CL == 1) {
    for (int j = threadIdx.x; j < kNCols; j += kThreads) post(j, j < N ? contrib(j) : 0.f);
  } else {
    float* mine = sm.xbuf + sy.xcur * 2 * kNCols;
    uint64_t* bar = &sy.bars[kXchg + sy.xcur];
    const int peer = sy.rank ^ 1;
    if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, (uint32_t)(N * sizeof(float)));
    const uint32_t rbar = cluster_addr(bar, peer);
    for (int j = threadIdx.x; j < N; j += kThreads) {
      const float c = contrib(j);
      mine[sy.rank * kNCols + j] = c;
      st_async(cluster_addr(&mine[sy.rank * kNCols + j], peer), c, rbar);
    }
    mbar_wait_cluster(bar, (sy.xpar >> sy.xcur) & 1);
    sy.xpar ^= 1u << sy.xcur;
    for (int j = threadIdx.x; j < kNCols; j += kThreads)
      post(j, j < N ? mine[j] + mine[kNCols + j] : 0.f);
    sy.xcur ^= 1;
  }
  cbar();
}

// A column pass of the chain: db[j] = Σ_i A_ij·w_i over the item's rows
// (plus the block's db[j] first when add), w0 at the thread's row g, w1 at
// row g + 8, and dc from it (post_cols). Each warp's column sums by a
// reduce-scatter over its 8 row groups (lane bits 4, 3, 2; the 50 values a
// lane holds padded to 56), the warps' partials summed in warp order.
template <int CL>
__device__ __forceinline__ void col_pass(const float (&A)[kAcc], float w0, float w1,
                                         const BwdSmem& sm, int N, bool add, float* dc,
                                         const float* bn, Sync& sy) {
  constexpr int V = 56;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  float v[V];
#pragma unroll
  for (int s = 0; s < kNCols / 8; ++s) {
    v[2 * s] = fmaf(A[4 * s], w0, A[4 * s + 2] * w1);
    v[2 * s + 1] = fmaf(A[4 * s + 1], w0, A[4 * s + 3] * w1);
  }
#pragma unroll
  for (int i = kNCols / 4; i < V; ++i) v[i] = 0.f;
  int base = 0;
  rs_step<V / 2>(v, 16, base);
  rs_step<V / 4>(v, 8, base);
  rs_step<V / 8>(v, 4, base);
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const int idx = base + i;
    if (idx < kNCols / 4) sm.part[warp * kNCols + 8 * (idx >> 1) + 2 * t + (idx & 1)] = v[i];
  }
  cbar();
  post_cols<CL>(sm, N, sy, [&](int j) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sm.part[w * kNCols + j];
    return add ? sm.db[j] + s : s;
  }, dc, bn);
}

// A warpgroup's n64 tile (v in the accumulator layout: this thread's rows
// 16·wq + g + 8·hr, columns 8·nt + 2t + e at v[4nt + 2hr + e]) times `scale`
// as bf16 rows row0.. of out (row stride ld_out), rows ≥ n dropped: each
// warp puts its 16 rows into `buf` (the warpgroup's 8 KB: rows of 128
// bytes, the 128-byte swizzle) by stmatrix and copies them out 16 bytes a
// lane, a row by 8 lanes.
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, size_t ld_out, int row0, int n,
                                           float scale, const float (&v)[32], uint8_t* buf) {
  const int wq = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int m = lane / 8, r = lane % 8;
  auto word = [&](int nt, int hr) {
    const __nv_bfloat162 h =
        __floats2bfloat162_rn(scale * v[4 * nt + 2 * hr], scale * v[4 * nt + 2 * hr + 1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  };
#pragma unroll
  for (int nt = 0; nt < 8; nt += 2) {
    const int row = 16 * wq + 8 * (m % 2) + r, chunk = nt + m / 2;
    hopper::stmatrix_x4(buf + row * 128 + ((chunk ^ (row & 7)) << 4), word(nt, 0), word(nt, 1),
                        word(nt + 1, 0), word(nt + 1, 1));
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i, row = 16 * wq + idx / 8, c = idx % 8;
    if (row0 + row < n)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + row) * ld_out + 8 * c) =
          *reinterpret_cast<const uint4*>(buf + row * 128 + ((c ^ (row & 7)) << 4));
  }
  __syncwarp();
}

// One block of two consumer warpgroups (the matrix) and a producer
// warpgroup (TMA); in a cluster of CL blocks an item's rows are split 128 a
// block. The block is launched at 168 registers a thread; the producer
// drops to 24 and the consumers rise to 240.
template <int CL>
__global__ void __launch_bounds__(kBwdThreads, 1)
packed_resident_bwd_kernel(const __grid_constant__ CUtensorMap tm_full,
                           const __grid_constant__ CUtensorMap tm_half,
                           const __grid_constant__ CUtensorMap tm_dout,
                           const float* __restrict__ vecs, __nv_bfloat16* __restrict__ dqkv, int B,
                           int N, int H, float scale, int robust, int iters, int final_row) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kBars];
  const BwdSmem sm(align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int rank = CL == 2 ? (int)cg::this_cluster().block_rank() : 0;
  const int items = B * H, HD = H * kD;
  const int clusters = gridDim.x / CL, cluster = blockIdx.x / CL;

  if (tid == 0) {
    for (int s = 0; s < kRingSlots; ++s) {
      hopper::mbar_init(&bars[kFull + s], 1);
      hopper::mbar_init(&bars[kEmpty + s], kWarps);
    }
    hopper::mbar_init(&bars[kVecFull], 32);
    hopper::mbar_init(&bars[kVecEmpty], kWarps);
    for (int i = kXchg; i < kBars; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_mbar_init();
  }
  if (CL == 2)
    cg::this_cluster().sync();
  else
    __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (warp >= kWarps) {
    // the producer warpgroup, which gives its registers to the consumers.
    // Its first thread issues the rounds k | q, dout | v, k | q of each
    // item into the ring's slots in turn, each once its previous round is
    // released; robust, its second warp copies each item's b rows and a
    // rows (at the block's rows) into the vectors, once the item before has
    // read them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kWarps + 1 && robust) {
      const int lane = tid % 32, R = num_vecs(iters, final_row, robust);
      const int ka = num_arows(iters, final_row);
      uint32_t n = 0;
      for (int item = cluster; item < items; item += clusters, ++n) {
        const float* vec = vecs + (size_t)item * R * N;
        if (n > 0) hopper::mbar_wait(&bars[kVecEmpty], (n - 1) & 1);
        for (int idx = lane; idx < iters * kNCols; idx += 32) {
          const int r = idx / kNCols, j = idx % kNCols;
          cp_async4(sm.colb + idx, vec + (j < N ? (size_t)(ka + r) * N + j : 0), j < N);
        }
        for (int idx = lane; idx < ka * kBlockRows; idx += 32) {
          const int r = idx / kBlockRows, i = kBlockRows * rank + idx % kBlockRows;
          cp_async4(sm.rowa + idx, vec + (i < N ? (size_t)r * N + i : 0), i < N);
        }
        cp_async_arrive(&bars[kVecFull]);
      }
    }
    if (tid == kThreads) {
      uint32_t rd = 0;
      for (int item = cluster; item < items; item += clusters) {
        const int b = item / H, h = item % H;
        for (int kind = 0; kind < 3; ++kind, ++rd) {
          const int s = rd % kRingSlots;
          if (rd >= kRingSlots) hopper::mbar_wait(&bars[kEmpty + s], (rd / kRingSlots - 1) & 1);
          uint8_t* full = sm.ring + s * kSlotBytes;
          uint8_t* half = full + kOpBytes;
          uint64_t* bar = &bars[kFull + s];
          hopper::mbar_expect_tx(bar, kSlotBytes);
          if (kind == 1) {
            hopper::tma_load_3d(full, &tm_full, 2 * HD + h * kD, 0, b, bar);
            hopper::tma_load_3d(half, &tm_dout, h * kD, kBlockRows * rank, b, bar);
          } else {
            hopper::tma_load_3d(full, &tm_full, HD + h * kD, 0, b, bar);
            hopper::tma_load_3d(half, &tm_half, h * kD, kBlockRows * rank, b, bar);
          }
        }
      }
    }
    __syncwarp();
    if (CL == 2) cg::this_cluster().sync();  // no block leaves while its peer may write to it
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warpgroup(), wq = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rl0 = kTileRows * wg + 16 * wq + g, rl1 = rl0 + 8;  // the thread's rows in the block
  const int r0 = kBlockRows * rank + rl0, r1 = r0 + 8;          // and in the item
  const bool v0 = r0 < N, v1 = r1 < N;
  const size_t ld3 = 3 * (size_t)HD;
  const int R = num_vecs(iters, final_row, robust);
  const int ka = num_arows(iters, final_row);
  const float scale_log2 = scale * kLog2e;
  constexpr int T = kTilesPerWg<CL>;
  const int jt_own = own_tile<CL>(rank);
  Sync sy{bars, rank};
  uint32_t rd = 0, vn = 0;  // rounds of the ring; items' vectors (robust)
  PRES_PHASE_INIT
  auto wait_round = [&]() {
    const int s = rd % kRingSlots;
    hopper::mbar_wait(&bars[kFull + s], (rd / kRingSlots) & 1);
    return sm.ring + s * kSlotBytes;
  };
  auto release_round = [&]() {  // each warp, once its reads of the slot are done
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&bars[kEmpty + rd % kRingSlots]);
    ++rd;
  };
  // where a warpgroup's output rows wait: over its kept partials once read
  // (dV, dK), and past them (dQ, while dK's are kept)
  uint8_t* keep_buf = sm.stage + kKeepArea + wg * kPartBytes;
  uint8_t* out_buf = sm.stage + kOutArea + wg * kPartBytes;
  auto wg_sync = [&]() { named_sync(2 + wg, 128); };
  // the rows of the own tile of a transposed product: epi(j, hr)
  auto own_rows = [&](auto epi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = kTileRows * jt_own + 16 * wq + g + 8 * hr;
      epi(j, hr);
    }
  };
  // the previous item's dK: its own tile once the peer's partials are in,
  // so that their flight overlaps the next item's q·kᵀ
  __nv_bfloat16* dk_pending = nullptr;
  auto finish_dk = [&]() {
    if (dk_pending == nullptr) return;
    float v[32];
    tp_take<CL>(v, sm.stage, N, sy);
    wg_sync();  // the warpgroup's kept partials are read
    store_tile(dk_pending, ld3, kTileRows * jt_own, N, scale, v, keep_buf);
    dk_pending = nullptr;
  };

  for (int item = cluster; item < items; item += clusters) {
    const int b = item / H, h = item % H;
    __nv_bfloat16* dq = dqkv + (size_t)b * N * ld3 + h * kD;
    __nv_bfloat16* dk = dq + HD;
    __nv_bfloat16* dv = dq + 2 * HD;

    const float* vec = vecs + (size_t)item * R * N;
    const float lse0 = v0 ? vec[(size_t)(R - 1) * N + r0] : 0.f;  // used once S is formed
    const float lse1 = v1 ? vec[(size_t)(R - 1) * N + r1] : 0.f;
    PRES_PHASE(13);
    // A = exp(scale·q·kᵀ − lse) from the stored log-normalizer; zero past
    // N in both directions
    uint8_t* full = wait_round();  // k | q
    uint8_t* half = full + kOpBytes;
    PRES_PHASE(0);
    float A[kAcc];
    wg_tile(A, half + wg * kTileBytes, full);
    release_round();
    const float l0 = lse0 * kLog2e, l1 = lse1 * kLog2e;
#pragma unroll
    for (int s = 0; s < kNCols / 8; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = 8 * s + 2 * t + e < N;
        A[4 * s + e] = v0 && in ? ex2(fmaf(A[4 * s + e], scale_log2, -l0)) : 0.f;
        A[4 * s + 2 + e] = v1 && in ? ex2(fmaf(A[4 * s + 2 + e], scale_log2, -l1)) : 0.f;
      }
    if (robust)
      for (int j = tid; j < kNCols; j += kThreads) sm.db[j] = 0.f;
    PRES_PHASE(1);
    finish_dk();
    cbar();  // the receive area is read before the staging area is written
    PRES_PHASE(12);

    full = wait_round();  // dout | v
    half = full + kOpBytes;
    const uint8_t* gtile = half + wg * kTileBytes;
    PRES_PHASE(2);
    if (robust) {
      hopper::mbar_wait(&bars[kVecFull], vn & 1);  // the b rows and a rows
      const float* b_fin = sm.colb + (iters - 1) * kNCols;
      const float af0 = ka > 0 ? sm.rowa[(ka - 1) * kBlockRows + rl0] : 1.f;
      const float af1 = ka > 0 ? sm.rowa[(ka - 1) * kBlockRows + rl1] : 1.f;
      // t1 = (A ⊙ a)ᵀ·G, sent to its owner while o/a runs
      {
        float tp[T][32];
        tp_product<CL>(tp, sm.stage, half, rank, [&](int s, int hr, uint32_t& hi, uint32_t& lo) {
          const float w = hr ? af1 : af0;
          hopper::split_bf16x2(A[4 * s + 2 * hr] * w, A[4 * s + 2 * hr + 1] * w, hi, lo);
        });
        tp_park<CL>(tp, sm.stage, N, sy);
      }
      PRES_PHASE(3);
      // o/a = (A ⊙ b)·V: da = rowsum(G ⊙ o/a)
      float da0, da1;
      {
        float o[32];
        scaled_product(o, A, b_fin, full);
        PRES_PHASE(4);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 g0 = op_pair(half, rl0, 8 * nt + 2 * t);
          const float2 g1 = op_pair(half, rl1, 8 * nt + 2 * t);
          s0 = fmaf(o[4 * nt], g0.x, fmaf(o[4 * nt + 1], g0.y, s0));
          s1 = fmaf(o[4 * nt + 2], g1.x, fmaf(o[4 * nt + 3], g1.y, s1));
        }
        da0 = quad_sum(s0);
        da1 = quad_sum(s1);
      }
      PRES_PHASE(5);
      // the own tile of t1: dV = b ⊙ t1 and this block's db = rowsum(t1 ⊙ V)
      float t1[32];
      tp_take<CL>(t1, sm.stage, N, sy);
      own_rows([&](int j, int hr) {
        float s = 0.f;
        const float bj = j < N ? b_fin[j] : 0.f;
        if (j < N) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float2 vv = op_pair(full, j, 8 * nt + 2 * t);
            s = fmaf(t1[4 * nt + 2 * hr], vv.x, fmaf(t1[4 * nt + 2 * hr + 1], vv.y, s));
          }
        }
        s = quad_sum(s);
        if (j < N && t == 0) sm.db[j] = s;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          t1[4 * nt + 2 * hr] *= bj;
          t1[4 * nt + 2 * hr + 1] *= bj;
        }
      });
      wg_sync();  // the warpgroup's kept partials are read
      store_tile(dv, ld3, kTileRows * jt_own, N, 1.f, t1, keep_buf);
      cbar();  // this block's db entries are in place
      PRES_PHASE(6);

      // the reverse chain (_reverse_chain_inner): the row term sv in
      // registers, the rank-1 factors dc_t (coldc row t) and dr_t (rowdr
      // row t; the final row's dr in row 0); db_row whole in both blocks
      // from the first column pass (or exchange) on
      float sv0 = 0.f, sv1 = 0.f;
      float* dc_last = sm.coldc + (iters - 1) * kNCols;
      if (final_row) {
        const float tmp0 = da0 * af0, tmp1 = da1 * af1;
        const float dr0 = -(tmp0 * af0), dr1 = -(tmp1 * af1);
        sv0 = -tmp0;
        sv1 = -tmp1;
        if (t == 0) {
          sm.rowdr[rl0] = dr0;
          sm.rowdr[rl1] = dr1;
        }
        col_pass<CL>(A, dr0, dr1, sm, N, true, dc_last, b_fin, sy);
      } else {
        post_cols<CL>(sm, N, sy, [&](int j) { return sm.db[j]; }, dc_last, b_fin);
      }
      for (int tt = iters - 1; tt >= 0; --tt) {
        const float2 m = row_pass(A, sm.coldc + tt * kNCols);
        if (tt == 0) {  // a_0 is the constant 1: its own gradient is dropped
          sv0 += m.x;
          sv1 += m.y;
          break;
        }
        const float at0 = sm.rowa[(tt - 1) * kBlockRows + rl0];
        const float at1 = sm.rowa[(tt - 1) * kBlockRows + rl1];
        const bool da_live = !final_row && tt == iters - 1;
        const float tmp0 = (da_live ? da0 + m.x : m.x) * at0;
        const float tmp1 = (da_live ? da1 + m.y : m.y) * at1;
        const float dr0 = -(tmp0 * at0), dr1 = -(tmp1 * at1);
        sv0 = sv0 + at0 * m.x - tmp0;
        sv1 = sv1 + at1 * m.y - tmp1;
        if (t == 0) {
          sm.rowdr[tt * kBlockRows + rl0] = dr0;
          sm.rowdr[tt * kBlockRows + rl1] = dr1;
        }
        col_pass<CL>(A, dr0, dr1, sm, N, false, sm.coldc + (tt - 1) * kNCols,
                     sm.colb + (tt - 1) * kNCols, sy);
      }
      sv0 += af0 * da0;
      sv1 += af1 * da1;
      PRES_PHASE(7);

      // dS = A ⊙ ((a ⊙ (G·Vᵀ) ⊙ b − sv) + Σ_k u_k v_kᵀ), 40 columns at a time;
      // the final row's term (dr_0, b_fin) folded into the first: (a ⊙
      // (G·Vᵀ) + dr_0) ⊙ b
      const float d0 = final_row ? sm.rowdr[rl0] : 0.f;
      const float d1 = final_row ? sm.rowdr[rl1] : 0.f;
      gv_chunks(gtile, full, [&](int c, float(&x)[4 * kChunkTiles]) {
#pragma unroll
        for (int sc = 0; sc < kChunkTiles; ++sc) {
          const float2 bb = lds_f2(b_fin + 8 * (kChunkTiles * c + sc) + 2 * t);
          x[4 * sc] = fmaf(af0, x[4 * sc], d0) * bb.x - sv0;
          x[4 * sc + 1] = fmaf(af0, x[4 * sc + 1], d0) * bb.y - sv0;
          x[4 * sc + 2] = fmaf(af1, x[4 * sc + 2], d1) * bb.x - sv1;
          x[4 * sc + 3] = fmaf(af1, x[4 * sc + 3], d1) * bb.y - sv1;
        }
        auto term = [&](float u0, float u1, const float* w) {
#pragma unroll
          for (int sc = 0; sc < kChunkTiles; ++sc) {
            const float2 wj = lds_f2(w + 8 * (kChunkTiles * c + sc) + 2 * t);
            x[4 * sc] = fmaf(u0, wj.x, x[4 * sc]);
            x[4 * sc + 1] = fmaf(u0, wj.y, x[4 * sc + 1]);
            x[4 * sc + 2] = fmaf(u1, wj.x, x[4 * sc + 2]);
            x[4 * sc + 3] = fmaf(u1, wj.y, x[4 * sc + 3]);
          }
        };
        for (int tt = iters - 1; tt >= 0; --tt) {
          if (tt > 0)
            term(sm.rowa[(tt - 1) * kBlockRows + rl0], sm.rowa[(tt - 1) * kBlockRows + rl1],
                 sm.coldc + tt * kNCols);
          else
            term(1.f, 1.f, sm.coldc);
          if (tt > 0)
            term(sm.rowdr[tt * kBlockRows + rl0], sm.rowdr[tt * kBlockRows + rl1],
                 sm.colb + (tt - 1) * kNCols);
        }
#pragma unroll
        for (int i = 0; i < 4 * kChunkTiles; ++i) A[4 * kChunkTiles * c + i] *= x[i];
      });
      __syncwarp();  // this warp's reads of the b rows and a rows are done
      if (lane == 0) hopper::mbar_arrive(&bars[kVecEmpty]);
      ++vn;
      PRES_PHASE(8);
    } else {
      // dV = Aᵀ·G, sent to its owner while dS is formed
      {
        float tp[T][32];
        tp_product<CL>(tp, sm.stage, half, rank, [&](int s, int hr, uint32_t& hi, uint32_t& lo) {
          hopper::split_bf16x2(A[4 * s + 2 * hr], A[4 * s + 2 * hr + 1], hi, lo);
        });
        tp_park<CL>(tp, sm.stage, N, sy);
      }
      PRES_PHASE(3);
      // dS = A ⊙ (dA − rowsum(dA ⊙ A)), dA = G·Vᵀ formed twice, 40 columns
      // at a time: the row sums, then dS
      float s0 = 0.f, s1 = 0.f;
      gv_chunks(gtile, full, [&](int c, float(&x)[4 * kChunkTiles]) {
#pragma unroll
        for (int sc = 0; sc < kChunkTiles; ++sc) {
          const int a = 4 * (kChunkTiles * c + sc);
          s0 = fmaf(x[4 * sc], A[a], fmaf(x[4 * sc + 1], A[a + 1], s0));
          s1 = fmaf(x[4 * sc + 2], A[a + 2], fmaf(x[4 * sc + 3], A[a + 3], s1));
        }
      });
      s0 = quad_sum(s0);
      s1 = quad_sum(s1);
      PRES_PHASE(4);
      gv_chunks(gtile, full, [&](int c, float(&x)[4 * kChunkTiles]) {
#pragma unroll
        for (int i = 0; i < 4 * kChunkTiles; ++i)
          A[4 * kChunkTiles * c + i] *= x[i] - ((i % 4) < 2 ? s0 : s1);
      });
      PRES_PHASE(5);
      float dvt[32];
      tp_take<CL>(dvt, sm.stage, N, sy);
      wg_sync();  // the warpgroup's kept partials are read
      store_tile(dv, ld3, kTileRows * jt_own, N, 1.f, dvt, keep_buf);
      PRES_PHASE(6);
      PRES_PHASE(7);
      PRES_PHASE(8);
    }
    release_round();

    // dK = scale·dSᵀ·Q from dS's hi and lo planes, its partials sent to
    // their owner after dQ = scale·dS·K from the same planes in registers
    full = wait_round();  // k | q
    half = full + kOpBytes;
    PRES_PHASE(9);
    uint32_t fh[kAcc / 2 + 2], fl[kAcc / 2 + 2];  // fragment (s, hr) at 2s + hr
#pragma unroll
    for (int s = 0; s < kNCols / 8; ++s)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        hopper::split_bf16x2(A[4 * s + 2 * hr], A[4 * s + 2 * hr + 1], fh[2 * s + hr],
                             fl[2 * s + hr]);
    fh[kAcc / 2] = fh[kAcc / 2 + 1] = fl[kAcc / 2] = fl[kAcc / 2 + 1] = 0u;
    cbar();  // the staging area's last contents (an exchange's receive) are read
    {
      float tp[T][32];
      tp_product<CL>(tp, sm.stage, half, rank, [&](int s, int hr, uint32_t& hi, uint32_t& lo) {
        hi = fh[2 * s + hr];
        lo = fl[2 * s + hr];
      });
      tp_park<CL>(tp, sm.stage, N, sy);
    }
    PRES_PHASE(10);
    {
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      hopper::fence_regs(o);
      hopper::fence_regs(fh);
      hopper::fence_regs(fl);
      hopper::wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kOpRows / 16; ++kb) {
        const uint32_t ah[4] = {fh[4 * kb], fh[4 * kb + 1], fh[4 * kb + 2], fh[4 * kb + 3]};
        const uint32_t al[4] = {fl[4 * kb], fl[4 * kb + 1], fl[4 * kb + 2], fl[4 * kb + 3]};
        const uint64_t db = hopper::desc_sw128(full + kb * 16 * hopper::kSwizzleRowBytes);
        hopper::wgmma_m64n64k16_rs(o, ah, db, 1);
        hopper::wgmma_m64n64k16_rs(o, al, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      store_tile(dq, ld3, kBlockRows * rank + kTileRows * wg, N, scale, o, out_buf);
    }
    release_round();
    PRES_PHASE(11);
    dk_pending = dk;  // its own tile is received and stored after the next item's A
  }
  finish_dk();
  if (CL == 2) cg::this_cluster().sync();  // no block leaves while its peer may write to it
}

// The persistent grid: as many clusters as the card holds at once (asked
// of the occupancy calculator, not assumed), at most one an item and at
// most `grid` blocks.
template <int CL>
int launch_bwd(const void* qkv, const void* dout, const void* vecs, void* dqkv, int B, int N, int H,
               float scale, int robust, int iters, int final_row, int grid, cudaStream_t stream) {
  CUtensorMap full, half, gout;
  cudaError_t err = hopper::make_operand_map(&full, qkv, B, N, 3 * H * kD, kOpRows);
  if (err == cudaSuccess) err = hopper::make_operand_map(&half, qkv, B, N, 3 * H * kD, kBlockRows);
  if (err == cudaSuccess) err = hopper::make_operand_map(&gout, dout, B, N, H * kD, kBlockRows);
  if (err != cudaSuccess) return (int)err;
  auto kernel = packed_resident_bwd_kernel<CL>;
  const size_t smem = bwd_smem_bytes();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(CL);
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  int clusters = B * H;
  if (clusters > resident) clusters = resident;
  if (clusters > grid / CL) clusters = grid / CL > 0 ? grid / CL : 1;
  cfg.gridDim = dim3(clusters * CL);
  err = cudaLaunchKernelEx(&cfg, kernel, full, half, gout, static_cast<const float*>(vecs),
                           static_cast<__nv_bfloat16*>(dqkv), B, N, H, scale, robust, iters,
                           final_row);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace res
}  // namespace nrv

// bf16 only; refuses what resident_fits does not take. terms: unused (the
// chain's vectors stay in shared memory); null is fine. grid: at most this
// many blocks. Returns cudaGetLastError() after the launch.
extern "C" int nrv_packed_resident_bwd(const void* qkv, const void* dout, const void* vecs,
                                       void* dqkv, void* terms, int B, int N, int H, int D,
                                       float scale, int robust, int iters, int final_row,
                                       int grid, void* stream) {
  (void)terms;
  if (B < 1 || H < 1 || grid < 1 || iters < 1 || iters > nrv::kMaxIters ||
      !nrv::res::resident_fits(N, D))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (N > nrv::res::kBlockRows)
    return nrv::res::launch_bwd<2>(qkv, dout, vecs, dqkv, B, N, H, scale, robust, iters,
                                   final_row, grid, s);
  return nrv::res::launch_bwd<1>(qkv, dout, vecs, dqkv, B, N, H, scale, robust, iters, final_row,
                                 grid, s);
}

// The branch rule and its formulas, for the host: 1 when the resident
// kernels take (N, D).
extern "C" int nrv_packed_resident_fits(int N, int D) {
  return nrv::res::resident_fits(N, D) ? 1 : 0;
}
