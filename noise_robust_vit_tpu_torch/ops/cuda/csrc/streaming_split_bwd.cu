// Streaming q/k/v-interface Sinkhorn attention, backward, split branch:
// (q, k, v, the upstream gradient g, the residual vectors) → (dq, dk, dv),
// bf16, the hand-derived gradient of streaming_split_fwd.cu, without the
// N×M matrix in device memory. Either branch's forward residuals serve.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// streaming_sinkhorn.py::_stream_bwd_impl (pl.pallas_call at :449; body
// _stream_bwd_kernel), at the shapes of the split branch
// (streaming_split.cuh: the design, and what bounds it).
//
// The math is the tile branch's (streaming_attention_bwd.cu): go =
// rowsum(a_F·g ⊙ en·(b_F ⊙ v)); T = enᵀ·(a_F ⊙ g), dv = b_F ⊙ T, db =
// rowsum(v ⊙ T) + enᵀ·du_F; the reverse chain's links dw = −db·b_i², du =
// −(en·dw + head)·a_{i−1}², db = enᵀ·du; then ρ = Σ_t u_t ⊙ (en·w_t) + go,
// ds = en ⊙ (Σ_t u_t w_tᵀ + a_F b_Fᵀ ⊙ (g·vᵀ) − ρ), dq = scale·ds·K, dK =
// scale·dsᵀ·Q. Launches, in stream order (iters + 3 passes and the sums):
//   out_kernel<kGo>       go (and du_F into U row 0), query-major;
//   keys_kernel<kT>       T, dv, dcol and the first link's dw, key-major;
//   for i = iters − 1 … 1:
//     rows_kernel<kChain> du into U, the column partials of en ⊙ du;
//     reduce_kernel       dw_{i−1} = −Σ partials · b_{i−1}² into W;
//   split_kernel          the rank-1 factors (the computed rows of U and W,
//                         the residual rows a_i and b_i, ones) as bf16 hi +
//                         lo rows over 16 terms;
//   ds_kernel             ρ (a row pass), then ds and dq (a second), query-major;
//   keys_kernel<kDk>      dK, key-major.
#include "streaming_split.cuh"

namespace nrv {
namespace ssplit {

// The W row of the chain's dw for b_i (i = iters − 1 … 0) and, one after
// it, the U row of the link's du; term 0 is (du_F, b_F) with the final
// row norm, the last (ones, dw_0).
inline int dw_term(int i, int iters, int final_row) { return final_row + 2 * (iters - 1 - i); }

// Where each factor comes from: usrc[t] ≥ 0 an av row, −2 ones; wsrc[t] ≥
// 0 a bv row; −1 the U or W row t that a launch computes.
inline void term_sources(Args& a) {
  for (int t = 0; t < kTerms; ++t) a.usrc[t] = a.wsrc[t] = -1;
  if (a.final_row) a.wsrc[0] = a.iters - 1;
  for (int i = a.iters - 1; i >= 1; --i) {
    const int t = dw_term(i, a.iters, a.final_row);
    a.usrc[t] = i;
    a.wsrc[t + 1] = i - 1;
  }
  a.usrc[a.nt - 1] = -2;
}

// The rank-1 factors as bf16 hi + lo rows over the 16 terms, zero past
// nt: us [K, N, 32], ws [K, M, 32]; one thread a row. A factor comes from
// U or W where a launch computed it, else from its residual row (usrc,
// wsrc) or ones.
__global__ void __launch_bounds__(256) split_kernel(const Args p) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  const size_t nu = (size_t)p.K * p.N;
  if (idx >= nu + (size_t)p.K * p.M) return;
  const bool is_u = idx < nu;
  const size_t r = is_u ? idx : idx - nu;
  const int rows = is_u ? p.N : p.M;
  const int item = r / rows, i = r % rows;
  auto factor = [&](int t) {
    if (t >= p.nt) return 0.f;
    const int src = is_u ? p.usrc[t] : p.wsrc[t];
    if (src == -2) return 1.f;
    if (src >= 0)
      return is_u ? p.av[((size_t)item * (1 + p.n_av) + src) * p.N + i]
                  : p.bv[((size_t)item * p.iters + src) * p.M + i];
    return (is_u ? p.U : p.W)[((size_t)item * p.nt + t) * rows + i];
  };
  uint32_t hi[kTerms / 2], lo[kTerms / 2];
#pragma unroll
  for (int t = 0; t < kTerms; t += 2)
    hopper::split_bf16x2(factor(t), factor(t + 1), hi[t / 2], lo[t / 2]);
  uint4* dst = reinterpret_cast<uint4*>((is_u ? p.us : p.ws) + r * kSplitLd);
  dst[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  dst[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  dst[2] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  dst[3] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
}

// ---- ρ, ds and dq ----------------------------------------------------------

constexpr int kSplitTile = kChunk * kSplitLd;  // bf16 of a chunk's split factors (4 KB)
constexpr size_t kDsSmem = 2 * (2 * 2 * (size_t)kTile + 2 * (size_t)kSplitTile) +
                           4 * (2 * (size_t)kChunk);

// One block a (item, 128 rows), a warp a 16-row strip with its rank-1 row
// factors (U, hi + lo), g and q in registers. Pass 1: ρ = Σ_j e_ij·R1_ij +
// go (R1 = U·Wᵀ, the rank-1 stack, on the tensor cores); pass 2: ds = e ⊙
// (R1 + a_F b_F (g·vᵀ) − ρ), dq = scale·ds·K. Writes dq and ρ.
__global__ void __launch_bounds__(kRowThreads) ds_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* kt = reinterpret_cast<bf16*>(smem_raw);  // [2][kChunk, 64]
  bf16* vt = kt + 2 * kTile;                      // [2][kChunk, 64]
  bf16* wt = vt + 2 * kTile;                      // [2][kChunk, 32]: W, split
  float* cvec = reinterpret_cast<float*>(wt + 2 * kSplitTile);  // [2][kChunk]: b_F
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int blocks = (p.N + kProductRows - 1) / kProductRows;
  const int item = blockIdx.x / blocks, i0 = (blockIdx.x % blocks) * kProductRows;
  const int rows = min(kProductRows, p.N - i0), r0 = 16 * warp;
  const bf16* k = p.k + (size_t)item * p.M * kD;
  const bf16* v = p.v + (size_t)item * p.M * kD;
  const bf16* ws = p.ws + (size_t)item * p.M * kSplitLd;
  const float* bcol = p.bv + ((size_t)item * p.iters + p.iters - 1) * p.M;
  const size_t avi = (size_t)item * (1 + p.n_av) * p.N;
  const int nchunks = (p.M + kChunk - 1) / kChunk;
  auto stage = [&](int ch, bool with_v) {
    if (ch < nchunks) {
      load_tile(kt + (ch & 1) * kTile, k, ch * kChunk, p.M, tid, kRowThreads);
      if (with_v) load_tile(vt + (ch & 1) * kTile, v, ch * kChunk, p.M, tid, kRowThreads);
      load_split_tile(wt + (ch & 1) * kSplitTile, ws, ch * kChunk, p.M, tid, kRowThreads);
      if (tid < kChunk) load_vec(cvec + (ch & 1) * kChunk, bcol, ch * kChunk, p.M, tid);
    }
    cp_async_commit();
  };
  stage(0, false);
  const bool active = r0 < rows;
  uint32_t qa[4][4], ga[4][4], uh[4], ul[4];
  frags_global(qa, p.q + ((size_t)item * p.N + i0) * kD, r0, rows);
  frags_global(ga, p.g + ((size_t)item * p.N + i0) * kD, r0, rows);
  split_afrags(uh, ul, p.us + ((size_t)item * p.N + i0) * kSplitLd, r0, rows);
  float l2[2], aF[2], go[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    const bool valid = r < rows;
    const size_t row = (size_t)i0 + r;
    l2[h] = valid ? p.av[avi + row] * kLog2e : kBig;
    aF[h] = valid && p.n_av ? p.av[avi + (size_t)p.n_av * p.N + row] : 1.f;
    go[h] = valid ? p.go[(size_t)item * p.N + row] : 0.f;
  }

  // ---- pass 1: ρ
  float racc[2] = {};
  for (int ch = 0; ch < nchunks; ++ch) {
    stage(ch + 1, false);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kc = kt + (ch & 1) * kTile;
    const bf16* wc = wt + (ch & 1) * kSplitTile;
    if (active) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4][4], wh[4], wl[4];
        bfrags_pair(b, kc, 16 * np);
        split_bfrags_pair(wh, wl, wc, 16 * np);
        float acc[2][4], r1[2][4];
        nt_pair(acc, qa, b);
        rank1_pair(r1, uh, ul, wh, wl);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            racc[e >> 1] = fmaf(entry(acc[n][e], p.c, l2[e >> 1]), r1[n][e], racc[e >> 1]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  float rho[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) rho[h] = quad_sum(racc[h]) + go[h];

  // ---- pass 2: ds and dq
  stage(0, true);
  float dq[8][4] = {};
  for (int ch = 0; ch < nchunks; ++ch) {
    stage(ch + 1, true);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kc = kt + (ch & 1) * kTile;
    const bf16* vc = vt + (ch & 1) * kTile;
    const bf16* wc = wt + (ch & 1) * kSplitTile;
    const float* cv = cvec + (ch & 1) * kChunk;
    if (active) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4][4], wh[4], wl[4];
        bfrags_pair(b, kc, 16 * np);
        float acc[2][4], gv[2][4], r1[2][4];
        nt_pair(acc, qa, b);
        bfrags_pair(b, vc, 16 * np);
        nt_pair(gv, ga, b);
        split_bfrags_pair(wh, wl, wc, 16 * np);
        rank1_pair(r1, uh, ul, wh, wl);
        float x[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float2 bf = lds_f2(cv + 16 * np + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float de = fmaf(aF[h] * (e & 1 ? bf.y : bf.x), gv[n][e], r1[n][e]);
            x[n][e] = entry(acc[n][e], p.c, l2[h]) * (de - rho[h]);
          }
        }
        tn_pair(dq, x, kc, 16 * np);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= rows) continue;
    const size_t row = (size_t)item * p.N + i0 + r;
    uint32_t* dst = reinterpret_cast<uint32_t*>(p.out + row * kD);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      dst[4 * dt + t] = pack_bf16(p.scale * dq[dt][2 * h], p.scale * dq[dt][2 * h + 1]);
    if (t == 0) p.rho[row] = rho[h];
  }
}

// ---- the key-major launches ------------------------------------------------

constexpr size_t kKeysSmem = 2 * (2 * 2 * (size_t)kTile + 2 * (size_t)kSplitTile) +
                             4 * (2 * 3 * (size_t)kChunk);

// One block a (item, 64 keys), a warp a 16-key strip (k, and for kDk v and
// its rank-1 factors W, in registers as A operands); the block walks all N
// queries in chunks of 64 (q, g, the row vectors lse, a_F and go or ρ, and
// for kDk the split rank-1 factors U, by cp.async). kT: x = en ⊙ a_F
// (transposed: keys are rows), T += xᵀ·G, dc += xᵀ·go; writes dv = b_F ⊙ T
// and the first link's dw = −(rowsum(v ⊙ T) − dc·final)·b_F² into W row
// wrow. kDk: dsᵀ as ds_kernel forms ds, dK += dsᵀ·Q; writes dk = scale·dK.
template <int kKind>
__global__ void __launch_bounds__(kKeyThreads) keys_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qt = reinterpret_cast<bf16*>(smem_raw);  // [2][kChunk, 64]
  bf16* gt = qt + 2 * kTile;                      // [2][kChunk, 64]
  bf16* ut = gt + 2 * kTile;                      // [2][kChunk, 32]: U, split (kDk)
  float* rvec = reinterpret_cast<float*>(ut + 2 * kSplitTile);  // [2][3][kChunk]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int blocks = (p.M + kKeyRows - 1) / kKeyRows;
  const int item = blockIdx.x / blocks, j0 = (blockIdx.x % blocks) * kKeyRows + 16 * warp;
  const bf16* q = p.q + (size_t)item * p.N * kD;
  const bf16* gg = p.g + (size_t)item * p.N * kD;
  const bf16* k = p.k + (size_t)item * p.M * kD;
  const bf16* v = p.v + (size_t)item * p.M * kD;
  const bf16* us = p.us + (size_t)item * p.N * kSplitLd;
  const size_t avi = (size_t)item * (1 + p.n_av) * p.N;
  const float* lse = p.av + avi;
  const float* aFv = p.n_av ? p.av + avi + (size_t)p.n_av * p.N : lse;  // unused without a-rows
  const float* third = (kKind == kT ? p.go : p.rho) + (size_t)item * p.N;
  const int nchunks = (p.N + kChunk - 1) / kChunk;
  auto stage = [&](int ch) {
    if (ch < nchunks) {
      load_tile(qt + (ch & 1) * kTile, q, ch * kChunk, p.N, tid, kKeyThreads);
      load_tile(gt + (ch & 1) * kTile, gg, ch * kChunk, p.N, tid, kKeyThreads);
      if constexpr (kKind == kDk)
        load_split_tile(ut + (ch & 1) * kSplitTile, us, ch * kChunk, p.N, tid, kKeyThreads);
      for (int idx = tid; idx < 3 * kChunk; idx += kKeyThreads) {
        const int vv = idx / kChunk, i = idx % kChunk;
        const float* src = vv == 0 ? lse : vv == 1 ? aFv : third;
        load_vec(rvec + (ch & 1) * 3 * kChunk + vv * kChunk, src, ch * kChunk, p.N, i);
      }
    }
    cp_async_commit();
  };
  stage(0);
  uint32_t ka[4][4], va[4][4], wh[4], wl[4];
  frags_global(ka, k, j0, p.M);
  if constexpr (kKind == kDk) {
    frags_global(va, v, j0, p.M);
    split_afrags(wh, wl, p.ws + (size_t)item * p.M * kSplitLd, j0, p.M);
  }
  float bF[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + g + 8 * h;
    bF[h] = j < p.M ? p.bv[((size_t)item * p.iters + p.iters - 1) * p.M + j] : 0.f;
  }
  const bool a_one = p.n_av == 0;
  float acc_o[8][4] = {}, dc[2] = {};
  for (int ch = 0; ch < nchunks; ++ch) {
    stage(ch + 1);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qc = qt + (ch & 1) * kTile;
    const bf16* gc = gt + (ch & 1) * kTile;
    const bf16* uc = ut + (ch & 1) * kSplitTile;
    const float* rv = rvec + (ch & 1) * 3 * kChunk;
    const int live = min(kChunk, p.N - ch * kChunk);  // queries of the chunk
    for (int qp = 0; 16 * qp < live; ++qp) {
      uint32_t b[4][4];
      bfrags_pair(b, qc, 16 * qp);
      float acc[2][4], gv[2][4], r1[2][4];
      nt_pair(acc, ka, b);
      if constexpr (kKind == kDk) {
        bfrags_pair(b, gc, 16 * qp);
        nt_pair(gv, va, b);
        uint32_t uh[4], ul[4];
        split_bfrags_pair(uh, ul, uc, 16 * qp);
        rank1_pair(r1, wh, wl, uh, ul);
      }
      float x[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * qp + 8 * n + 2 * t;
        const float2 l = lds_f2(rv + col);
        const float2 af = a_one ? make_float2(1.f, 1.f) : lds_f2(rv + kChunk + col);
        const float2 th = lds_f2(rv + 2 * kChunk + col);
        const bool ok0 = col < live, ok1 = col + 1 < live;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float e0 = ok0 ? entry(acc[n][2 * h], p.c, l.x * kLog2e) : 0.f;
          const float e1 = ok1 ? entry(acc[n][2 * h + 1], p.c, l.y * kLog2e) : 0.f;
          if constexpr (kKind == kT) {
            x[n][2 * h] = e0 * af.x;
            x[n][2 * h + 1] = e1 * af.y;
            dc[h] = fmaf(x[n][2 * h], th.x, fmaf(x[n][2 * h + 1], th.y, dc[h]));
          } else {
            const float de0 = fmaf(af.x * bF[h], gv[n][2 * h], r1[n][2 * h]);
            const float de1 = fmaf(af.y * bF[h], gv[n][2 * h + 1], r1[n][2 * h + 1]);
            x[n][2 * h] = e0 * (de0 - th.x);
            x[n][2 * h + 1] = e1 * (de1 - th.y);
          }
        }
      }
      tn_pair(acc_o, x, kKind == kT ? gc : qc, 16 * qp);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + g + 8 * h;
    const bool valid = j < p.M;
    const size_t key = (size_t)item * p.M + j;
    if constexpr (kKind == kT) {
      float db = 0.f;
      if (valid) {
        const uint32_t* vr = reinterpret_cast<const uint32_t*>(p.v + key * kD);
        uint32_t* dst = reinterpret_cast<uint32_t*>(p.out + key * kD);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          const uint32_t wv = vr[4 * dt + t];
          const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv));
          db = fmaf(vv.x, acc_o[dt][2 * h], fmaf(vv.y, acc_o[dt][2 * h + 1], db));
          dst[4 * dt + t] = pack_bf16(bF[h] * acc_o[dt][2 * h], bF[h] * acc_o[dt][2 * h + 1]);
        }
      }
      db = quad_sum(db);
      const float dcol = quad_sum(dc[h]);
      if (valid && t == 0) {
        if (p.final_row) db -= dcol;
        p.W[((size_t)item * p.nt + p.wrow) * p.M + j] = -db * bF[h] * bF[h];
      }
    } else if (valid) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(p.out + key * kD);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        dst[4 * dt + t] = pack_bf16(p.scale * acc_o[dt][2 * h], p.scale * acc_o[dt][2 * h + 1]);
    }
  }
}

}  // namespace ssplit
}  // namespace nrv

// q, g, dq [K, N, 64], k, v, dk, dv [K, M, 64] bf16; av, bv float32 from
// either branch's forward. Scratch, float32: part [K, S, M] (S =
// nrv_streaming_split_splits(N)), U [K, nt, N], W [K, nt, M] (nt = 2·iters −
// 1 + final_row), go and
// rho [K, N]; bf16: us [K, N, 32], ws [K, M, 32]. Returns the first launch
// error, or cudaGetLastError().
extern "C" int nrv_streaming_split_bwd(const void* q, const void* k, const void* v,
                                       const void* g, void* av, void* bv, void* dq, void* dk,
                                       void* dv, void* part, void* U, void* W, void* go,
                                       void* rho, void* us, void* ws, int K, int N, int M, int D,
                                       float scale, int iters, int final_row, void* stream) {
  using namespace nrv::ssplit;
  if (int err = check(K, N, M, D, iters, final_row)) return err;
  auto st = static_cast<cudaStream_t>(stream);
  Args a = base_args(K, N, M, scale, iters, final_row);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.av = static_cast<float*>(av);
  a.bv = static_cast<float*>(bv);
  a.part = static_cast<float*>(part);
  a.U = static_cast<float*>(U);
  a.W = static_cast<float*>(W);
  a.go = static_cast<float*>(go);
  a.rho = static_cast<float*>(rho);
  a.us = static_cast<bf16*>(us);
  a.ws = static_cast<bf16*>(ws);
  term_sources(a);
  const int row_blocks = K * ((N + kProductRows - 1) / kProductRows);
  const int key_blocks = K * ((M + kKeyRows - 1) / kKeyRows);
  cudaError_t err = launch(out_kernel<kGo>, row_blocks, kRowThreads, kOutSmem, st, a);
  if (err == cudaSuccess) {
    Args s = a;
    s.out = static_cast<bf16*>(dv);
    s.wrow = dw_term(iters - 1, iters, final_row);
    err = launch(keys_kernel<kT>, key_blocks, kKeyThreads, kKeysSmem, st, s);
  }
  for (int i = iters - 1; i >= 1 && err == cudaSuccess; --i) {
    Args s = a;
    s.wrow = dw_term(i, iters, final_row);
    s.urow = s.wrow + 1;
    s.arow = i;
    s.head = !final_row && i == iters - 1;
    err = launch(rows_kernel<kChain>, K * a.S, kRowThreads, kRowsSmem, st, s);
    if (err == cudaSuccess) {
      Args r = a;
      r.vrow = i - 1;
      r.wrow = dw_term(i - 1, iters, final_row);
      err = launch(reduce_kernel<kReduceDw>, (int)(((size_t)K * M + 255) / 256), 256, 0, st, r);
    }
  }
  if (err == cudaSuccess)
    err = launch(split_kernel, (int)(((size_t)K * (N + M) + 255) / 256), 256, 0, st, a);
  if (err == cudaSuccess) {
    Args s = a;
    s.out = static_cast<bf16*>(dq);
    err = launch(ds_kernel, row_blocks, kRowThreads, kDsSmem, st, s);
  }
  if (err == cudaSuccess) {
    Args s = a;
    s.out = static_cast<bf16*>(dk);
    err = launch(keys_kernel<kDk>, key_blocks, kKeyThreads, kKeysSmem, st, s);
  }
  return (int)err;
}
