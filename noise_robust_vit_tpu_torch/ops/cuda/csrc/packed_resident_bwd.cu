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
// What bounds it on the card (H100): as the forward, the products (two on
// wgmma, four split products with a float32 side, at ~2·N²·D·2 flops
// each) and the passes over the matrix, not the bytes. The scratch branch
// held A and dA/dS in a device-memory slot and made every pass and product
// go through L2. Here:
//   * A stays in shared memory and dS is formed over it in place; one
//     persistent block per SM; no N×N device scratch (a per-block slot of
//     2·iters vectors holds the chain's rank-1 factors dc and dr);
//   * two TMA operand buffers take k and q (S = q·kᵀ on wgmma), then dout
//     and v (t1, o/a and G·Vᵀ), then k and q again (dQ, dK);
//   * t1 and o/a carry their scaling vector on the float32 side, (A ⊙ a)
//     and (A ⊙ b), so that G and V stay exact bf16: two wgmma (hi, lo)
//     each with A from registers and B read MN-major from the swizzled
//     buffers, as dQ and dK; dV, db and da come out of their epilogues
//     (no N×D float32 buffers);
//   * the reverse chain fuses each m_dc row sum with the db_row column sum
//     that depends on it (one read of A a step, per-warp partials summed in
//     a fixed order, no atomics);
//   * dS: G·Vᵀ on wgmma a 64-row tile a warpgroup, combined in its
//     registers with A, the vectors and the rank-1 terms, stored over A;
//     vanilla takes rowsum(dA ⊙ A) in the same registers.
// Measured (PERF.md, ops/cuda/packed_phases.py): ~10× the byte bound
// robust, ~5× vanilla; the four split products take ~40% of a robust
// item, the chain and dS ~20% each. One block of 8 warps a SM, as the
// forward; every thread at 255 registers.
#include "packed_resident.cuh"

namespace nrv {
namespace res {

// Rows a pass takes at once: 4, each summed across the warp by all lanes
// (measured faster here than 8 rows, which spilled).
constexpr int kRows = 4;

// v[r] summed across the warp into every lane, the kRows butterflies
// interleaved.
__device__ __forceinline__ void warp_sums(float (&v)[kRows]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
}

// dst[j] += Σ_i A_ij·w[i], a warp a row (kRows at once), each lane
// keeping its columns' partials; the warps' partials summed in warp order.
__device__ __forceinline__ void col_pass(const float* P, int n, int ld, const float* w,
                                         float* dst, float* part) {
  const int warp = threadIdx.x / 32;
  float cacc[kPassCols];
#pragma unroll
  for (int c = 0; c < kPassCols; ++c) cacc[c] = 0.f;
  const float my_w = warp_rows_of(w, n);
  for (int q0 = 0; warp + kWarps * q0 < n; q0 += kRows) {
    float p[kRows][kPassCols];
    load_rows(P, n, ld, q0, p);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float wi = __shfl_sync(0xffffffffu, my_w, q0 + r);
#pragma unroll
      for (int c = 0; c < kPassCols; ++c) cacc[c] = fmaf(p[r][c], wi, cacc[c]);
    }
  }
  col_sums(cacc, n, part, [&](int j, float s) { dst[j] += s; });
  __syncthreads();
}

// One step t of the reverse chain in one pass over A: m_i = Σ_j A_ij·dc_j
// (a warp a row, kRows at once); t > 0 (a_t given): svec_i += a_t·m_i −
// tmp_i with tmp_i = (m_i, plus da_i when da_live)·a_t, dr_i = −tmp_i·a_t
// to drt, and db_row[j] = Σ_i A_ij·dr_i from the same rows; t = 0 (a_0 ≡
// 1): svec_i += m_i.
__device__ __forceinline__ void chain_pass(const float* P, int n, int ld, const float* dc,
                                           const float* at, const float* da, float* svec,
                                           bool da_live, float* drt, float* db_row,
                                           float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool col = at != nullptr;
  float w[kPassCols], cacc[kPassCols];
  load_cols(dc, n, w);
#pragma unroll
  for (int c = 0; c < kPassCols; ++c) cacc[c] = 0.f;
  const float my_a = col ? warp_rows_of(at, n) : 0.f;
  const float my_sv = warp_rows_of(svec, n);
  const float my_da = warp_rows_of(da, n);
  for (int q0 = 0; warp + kWarps * q0 < n; q0 += kRows) {
    float p[kRows][kPassCols];
    load_rows(P, n, ld, q0, p);
    float m[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kPassCols; ++c) m[r] = fmaf(p[r][c], w[c], m[r]);
    }
    warp_sums(m);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kWarps * (q0 + r);
      const float sv = __shfl_sync(0xffffffffu, my_sv, q0 + r);
      float dr = 0.f, nsv = sv + m[r];
      if (col) {
        const float a = __shfl_sync(0xffffffffu, my_a, q0 + r);
        const float d = __shfl_sync(0xffffffffu, my_da, q0 + r);
        const float tmp = (da_live ? d + m[r] : m[r]) * a;
        dr = -(tmp * a);
        nsv = sv + a * m[r] - tmp;
#pragma unroll
        for (int c = 0; c < kPassCols; ++c) cacc[c] = fmaf(p[r][c], dr, cacc[c]);
      }
      if (lane == 0 && i < n) {
        svec[i] = nsv;
        if (col) drt[i] = dr;
      }
    }
  }
  if (col) col_sums(cacc, n, part, [&](int j, float s) { db_row[j] = s; });
  __syncthreads();
}

// A = exp(scale·q·kᵀ − lse) over the matrix, a 64-row wgmma tile a
// warpgroup (k in X, q in Y); columns N..ld − 1 set to zero.
__device__ __forceinline__ void attn_phase(const uint8_t* X, const uint8_t* Y, float* P, int N,
                                        int ld, const float* lse, float scale_log2) {
  const int wg = threadIdx.x / 128, wl = threadIdx.x % 128;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  for (int rt = wg; rt < (N + kTileRows - 1) / kTileRows; rt += 2) {
    float acc[kAcc];
    wg_tile(acc, Y + rt * kTileBytes, X);
    const int r0 = kTileRows * rt + 16 * (wl / 32) + g;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 8 * hr;
      if (r >= N) continue;
      const float l = lse[r] * kLog2e;  // in base 2
      float* dst = P + (size_t)r * ld;
#pragma unroll
      for (int s = 0; s < kNCols / 8; ++s) {
        const int c = 8 * s + 2 * t;
        if (c < ld)
          *reinterpret_cast<float2*>(dst + c) =
              make_float2(c < N ? exp2f(fmaf(acc[4 * s + 2 * hr], scale_log2, -l)) : 0.f,
                          c + 1 < N ? exp2f(fmaf(acc[4 * s + 2 * hr + 1], scale_log2, -l))
                                    : 0.f);
      }
    }
  }
}

// Robust dS over A: dS = A ⊙ ((a ⊙ (G·Vᵀ) ⊙ b − row term) + Σ_k u_k v_kᵀ),
// G·Vᵀ a 64-row wgmma tile a warpgroup (dout in X, v in Y); u null means
// ones. STAGED: the column factors sit in shared memory at the even row
// stride nv and, like b_fin (8-byte aligned, nv columns readable), are
// read as pairs; otherwise one at a time from where they are.
template <bool STAGED>
__device__ __forceinline__ void ds_tiles_robust(const uint8_t* X, const uint8_t* Y, float* P,
                                                int N, int ld, int nv, const float* a_fin,
                                                const float* b_fin, const float* row_term,
                                                const float* const* tu, const float* const* tv,
                                                int nt) {
  const int wg = threadIdx.x / 128, wl = threadIdx.x % 128;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  // the pair of columns (c, c + 1) of a vector
  auto pair = [&](const float* v, int c) {
    if (STAGED) return c < nv ? *reinterpret_cast<const float2*>(v + c) : make_float2(0.f, 0.f);
    return make_float2(c < N ? v[c] : 0.f, c + 1 < N ? v[c + 1] : 0.f);
  };
  for (int rt = wg; rt < (N + kTileRows - 1) / kTileRows; rt += 2) {
    float acc[kAcc];
    wg_tile(acc, X + rt * kTileBytes, Y);
    const int r0 = kTileRows * rt + 16 * (wl / 32) + g, r1 = r0 + 8;
    const float a0 = r0 < N ? a_fin[r0] : 0.f, a1 = r1 < N ? a_fin[r1] : 0.f;
    const float t0 = r0 < N ? row_term[r0] : 0.f, t1 = r1 < N ? row_term[r1] : 0.f;
#pragma unroll
    for (int s = 0; s < kNCols / 8; ++s) {
      const float2 b = pair(b_fin, 8 * s + 2 * t);
      acc[4 * s] = a0 * acc[4 * s] * b.x - t0;
      acc[4 * s + 1] = a0 * acc[4 * s + 1] * b.y - t0;
      acc[4 * s + 2] = a1 * acc[4 * s + 2] * b.x - t1;
      acc[4 * s + 3] = a1 * acc[4 * s + 3] * b.y - t1;
    }
    // the row factors of the next term load while this one's FMAs run
    auto row_factor = [&](int k, int r) {
      return tu[k] == nullptr ? 1.f : (r < N ? tu[k][r] : 0.f);
    };
    float u0 = nt > 0 ? row_factor(0, r0) : 0.f, u1 = nt > 0 ? row_factor(0, r1) : 0.f;
    for (int k = 0; k < nt; ++k) {
      const float* w = tv[k];
      float n0 = 0.f, n1 = 0.f;
      if (k + 1 < nt) {
        n0 = row_factor(k + 1, r0);
        n1 = row_factor(k + 1, r1);
      }
#pragma unroll
      for (int s = 0; s < kNCols / 8; ++s) {
        const float2 wj = pair(w, 8 * s + 2 * t);
        acc[4 * s] = fmaf(u0, wj.x, acc[4 * s]);
        acc[4 * s + 1] = fmaf(u0, wj.y, acc[4 * s + 1]);
        acc[4 * s + 2] = fmaf(u1, wj.x, acc[4 * s + 2]);
        acc[4 * s + 3] = fmaf(u1, wj.y, acc[4 * s + 3]);
      }
      u0 = n0;
      u1 = n1;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 8 * hr;
      if (r >= N) continue;
      float* dst = P + (size_t)r * ld;
#pragma unroll
      for (int s = 0; s < kNCols / 8; ++s) {
        const int c = 8 * s + 2 * t;
        if (c >= N) continue;
        float2 p = *reinterpret_cast<const float2*>(dst + c);  // column N.. is zero
        p.x *= acc[4 * s + 2 * hr];
        p.y = c + 1 < N ? p.y * acc[4 * s + 2 * hr + 1] : 0.f;
        *reinterpret_cast<float2*>(dst + c) = p;
      }
    }
  }
}

// Robust dS (ds_tiles_robust), the rank-1 column factors first copied into
// part at an even row stride when there are at most kWarps of them.
__device__ __forceinline__ void ds_phase_robust(const uint8_t* X, const uint8_t* Y, float* P,
                                                int N, int ld, const float* a_fin,
                                                const float* b_fin, const float* row_term,
                                                const float** tu, const float** tv, int nt,
                                                float* part) {
  const int nv = (N + 1) & ~1;
  if (nt > kWarps) {
    ds_tiles_robust<false>(X, Y, P, N, ld, nv, a_fin, b_fin, row_term, tu, tv, nt);
    return;
  }
  for (int k = 0; k < nt; ++k) {
    float* v = part + (size_t)k * nv;
    for (int j = threadIdx.x; j < N; j += kThreads) v[j] = tv[k][j];
    tv[k] = v;
  }
  __syncthreads();
  ds_tiles_robust<true>(X, Y, P, N, ld, nv, a_fin, b_fin, row_term, tu, tv, nt);
}

// Vanilla dS over A: dS = A ⊙ (dA − rowsum(dA ⊙ A)), dA = G·Vᵀ a 64-row
// wgmma tile a warpgroup, the row sums in its registers.
__device__ __forceinline__ void ds_phase_vanilla(const uint8_t* X, const uint8_t* Y, float* P,
                                              int N, int ld) {
  const int wg = threadIdx.x / 128, wl = threadIdx.x % 128;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  for (int rt = wg; rt < (N + kTileRows - 1) / kTileRows; rt += 2) {
    float acc[kAcc];
    wg_tile(acc, X + rt * kTileBytes, Y);
    const int r0 = kTileRows * rt + 16 * (wl / 32) + g;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 8 * hr;
      float* dst = P + (size_t)(r < N ? r : 0) * ld;
      float2 p[kNCols / 8];
      float s = 0.f;
#pragma unroll
      for (int sc = 0; sc < kNCols / 8; ++sc) {
        const int c = 8 * sc + 2 * t;
        p[sc] = (r < N && c < ld) ? *reinterpret_cast<const float2*>(dst + c)
                                  : make_float2(0.f, 0.f);  // zero from column N on
        s = fmaf(acc[4 * sc + 2 * hr], p[sc].x, fmaf(acc[4 * sc + 2 * hr + 1], p[sc].y, s));
      }
      s = quad_sum(s);
      if (r >= N) continue;
#pragma unroll
      for (int sc = 0; sc < kNCols / 8; ++sc) {
        const int c = 8 * sc + 2 * t;
        if (c < ld)
          *reinterpret_cast<float2*>(dst + c) =
              make_float2(p[sc].x * (acc[4 * sc + 2 * hr] - s),
                          p[sc].y * (acc[4 * sc + 2 * hr + 1] - s));
      }
    }
  }
}

// bf16 pairs of one row of a product's output, times `scale`, at column
// 8·nt + 2·(lane % 4) of row `row` of a [*, ld_out] bf16 tensor.
__device__ __forceinline__ void store_row(__nv_bfloat16* out, size_t ld_out, int row,
                                          float scale, const float (&v)[16]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    store_bf16x2(out + (size_t)row * ld_out + 8 * nt + 2 * t, scale * v[2 * nt],
                 scale * v[2 * nt + 1]);
}

__global__ void __launch_bounds__(kThreads, 1)
packed_resident_bwd_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                           const __grid_constant__ CUtensorMap tm_dout,
                           const float* __restrict__ vecs, __nv_bfloat16* __restrict__ dqkv,
                           float* __restrict__ terms_all, int B, int N, int H, float scale,
                           int robust, int iters, int final_row) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];  // buffer X, buffer Y
  uint8_t* base = align_smem(smem_raw);
  uint8_t* X = base;
  uint8_t* Y = base + kOpBytes;
  float* P = reinterpret_cast<float*>(base + 2 * kOpBytes);
  const int ld = resident_ld(N);
  float* b_fin = P + (size_t)N * ld;  // 8-byte aligned: read as float2
  float* a_fin = b_fin + N;
  float* da = a_fin + N;
  float* db_row = da + N;
  float* svec = db_row + N;
  // kWarps × N, or kWarps rows of N rounded up to even: 8-byte aligned
  float* part = P + ((size_t)N * ld + 5 * (size_t)N + 1) / 2 * 2;

  const int tid = threadIdx.x, t = tid % 4;
  const int items = B * H, HD = H * kD;
  const size_t ld3 = 3 * (size_t)HD;  // row stride of qkv and dqkv
  const int R = num_vecs(iters, final_row, robust);
  const int ka = num_arows(iters, final_row);
  const float scale_log2 = scale * kLog2e;
  float* terms = terms_all + (size_t)blockIdx.x * bwd_terms_floats(N, iters);

  if (tid == 0) {
    hopper::mbar_init(&bars[0], 1);
    hopper::mbar_init(&bars[1], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  // stage 0: X ← k, Y ← q; stage 1: X ← dout, Y ← v
  auto issue = [&](int bh, int stage) {
    const int b = bh / H, h = bh % H;
    hopper::mbar_expect_tx(&bars[0], kOpBytes);
    hopper::mbar_expect_tx(&bars[1], kOpBytes);
    if (stage == 0) {
      hopper::tma_load_3d(X, &tm_qkv, HD + h * kD, 0, b, &bars[0]);
      hopper::tma_load_3d(Y, &tm_qkv, h * kD, 0, b, &bars[1]);
    } else {
      hopper::tma_load_3d(X, &tm_dout, h * kD, 0, b, &bars[0]);
      hopper::tma_load_3d(Y, &tm_qkv, 2 * HD + h * kD, 0, b, &bars[1]);
    }
  };
  uint32_t phase = 0;  // X and Y are always loaded together
  auto wait_xy = [&]() {
    hopper::mbar_wait(&bars[0], phase);
    hopper::mbar_wait(&bars[1], phase);
    phase ^= 1;
  };
  // every thread's shared-memory accesses done, then thread 0 refills
  auto refill = [&](int bh, int stage) {
    hopper::fence_proxy_async();
    __syncthreads();
    if (tid == 0 && bh < items) issue(bh, stage);
  };
  if (tid == 0 && (int)blockIdx.x < items) issue(blockIdx.x, 0);

  for (int bh = blockIdx.x; bh < items; bh += gridDim.x) {
    const int b = bh / H, h = bh % H;
    const float* vec = vecs + (size_t)bh * R * N;
    __nv_bfloat16* dq = dqkv + (size_t)b * N * ld3 + h * kD;
    __nv_bfloat16* dk = dq + HD;
    __nv_bfloat16* dv = dq + 2 * HD;

    // A from the stored log-normalizer: no max/sum replay
    wait_xy();
    attn_phase(X, Y, P, N, ld, vec + (size_t)(R - 1) * N, scale_log2);
    if (robust) {  // a_fin (ones when no a-row is stored) and b_fin
      for (int i = tid; i < N; i += kThreads) {
        a_fin[i] = ka > 0 ? vec[(size_t)(ka - 1) * N + i] : 1.f;
        b_fin[i] = vec[(size_t)(ka + iters - 1) * N + i];
      }
    }
    refill(bh, 1);
    wait_xy();

    if (robust) {
      // t1 = (A ⊙ a)ᵀ·G: dV = b ⊙ t1 and db = rowsum(t1 ⊙ V)
      resident_product<true, true>(P, N, ld, a_fin, X, [=](int j, bool valid, float(&v)[16]) {
        float s = 0.f;
        if (valid) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float2 vv = op_pair(Y, j, 8 * nt + 2 * t);
            s = fmaf(v[2 * nt], vv.x, fmaf(v[2 * nt + 1], vv.y, s));
          }
          store_row(dv, ld3, j, b_fin[j], v);
        }
        s = quad_sum(s);
        if (valid && t == 0) db_row[j] = s;
      });
      // o/a = (A ⊙ b)·V: da = rowsum(G ⊙ o/a)
      resident_product<false, true>(P, N, ld, b_fin, Y, [=](int i, bool valid, float(&v)[16]) {
        float s = 0.f;
        if (valid) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float2 gg = op_pair(X, i, 8 * nt + 2 * t);
            s = fmaf(v[2 * nt], gg.x, fmaf(v[2 * nt + 1], gg.y, s));
          }
        }
        s = quad_sum(s);
        if (valid && t == 0) da[i] = s;
      });
      __syncthreads();

      // the reverse chain (_reverse_chain_inner): svec, then the row term
      // in its place; the rank-1 factors dc_t (terms row t) and dr_t (row
      // iters + t; the final row's dr in row iters)
      auto a_row = [&](int t_) { return t_ == 0 ? nullptr : vec + (size_t)(t_ - 1) * N; };
      auto b_row = [&](int t_) { return vec + (size_t)(ka + t_ - 1) * N; };
      auto dc_row = [&](int t_) { return terms + (size_t)t_ * N; };
      auto dr_row = [&](int t_) { return terms + (size_t)(iters + t_) * N; };
      if (final_row) {
        float* dr = dr_row(0);
        for (int i = tid; i < N; i += kThreads) {
          const float tmp = da[i] * a_fin[i];
          dr[i] = -(tmp * a_fin[i]);
          svec[i] = -tmp;
        }
        __syncthreads();
        col_pass(P, N, ld, dr, db_row, part);
      } else {
        for (int i = tid; i < N; i += kThreads) svec[i] = 0.f;
        __syncthreads();
      }
      for (int tt = iters - 1; tt >= 0; --tt) {
        const float* bt = b_row(tt + 1);
        float* dc = dc_row(tt);
        for (int j = tid; j < N; j += kThreads) dc[j] = db_row[j] * -(bt[j] * bt[j]);
        __syncthreads();
        // a_0 is the constant 1: its own gradient is dropped
        chain_pass(P, N, ld, dc, a_row(tt), da, svec, !final_row && tt == iters - 1,
                   tt > 0 ? dr_row(tt) : nullptr, db_row, part);
      }
      for (int i = tid; i < N; i += kThreads) svec[i] += a_fin[i] * da[i];
      __syncthreads();

      // the rank-1 terms (row factor, column factor)
      const float* tu[kMaxTerms];
      const float* tv[kMaxTerms];
      int nterms = 0;
      if (final_row) {
        tu[nterms] = dr_row(0);
        tv[nterms++] = b_row(iters);
      }
      for (int tt = iters - 1; tt >= 0; --tt) {
        tu[nterms] = a_row(tt);
        tv[nterms++] = dc_row(tt);
        if (tt > 0) {
          tu[nterms] = dr_row(tt);
          tv[nterms++] = b_row(tt);
        }
      }
      ds_phase_robust(X, Y, P, N, ld, a_fin, b_fin, svec, tu, tv, nterms, part);
    } else {
      // dV = Aᵀ·G
      resident_product<true, false>(P, N, ld, nullptr, X, [=](int j, bool valid, float(&v)[16]) {
        if (valid) store_row(dv, ld3, j, 1.f, v);
      });
      __syncthreads();  // all of A read before dS takes its place
      ds_phase_vanilla(X, Y, P, N, ld);
    }

    refill(bh, 0);
    wait_xy();
    // dQ = scale·dS·K, dK = scale·dSᵀ·Q
    resident_product<false, false>(P, N, ld, nullptr, X, [=](int i, bool valid, float(&v)[16]) {
      if (valid) store_row(dq, ld3, i, scale, v);
    });
    resident_product<true, false>(P, N, ld, nullptr, Y, [=](int j, bool valid, float(&v)[16]) {
      if (valid) store_row(dk, ld3, j, scale, v);
    });
    refill(bh + gridDim.x, 0);
  }
}

int launch_resident_bwd(const void* qkv, const void* dout, const void* vecs, void* dqkv,
                        void* terms, int B, int N, int H, float scale, int robust, int iters,
                        int final_row, int grid, cudaStream_t stream) {
  CUtensorMap tq, tg;
  cudaError_t err = hopper::make_operand_map(&tq, qkv, B, N, 3 * H * kD, kOpRows);
  if (err != cudaSuccess) return (int)err;
  err = hopper::make_operand_map(&tg, dout, B, N, H * kD, kOpRows);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bwd_smem_bytes(N);
  err = cudaFuncSetAttribute(packed_resident_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  packed_resident_bwd_kernel<<<grid, kThreads, smem, stream>>>(
      tq, tg, static_cast<const float*>(vecs), static_cast<__nv_bfloat16*>(dqkv),
      static_cast<float*>(terms), B, N, H, scale, robust, iters, final_row);
  return (int)cudaGetLastError();
}

}  // namespace res
}  // namespace nrv

// bf16 only; refuses what resident_fits does not take. terms: grid ×
// bwd_terms_floats(N, iters) float32 (unused when vanilla). Returns
// cudaGetLastError() after the launch.
extern "C" int nrv_packed_resident_bwd(const void* qkv, const void* dout, const void* vecs,
                                       void* dqkv, void* terms, int B, int N, int H, int D,
                                       float scale, int robust, int iters, int final_row,
                                       int grid, void* stream) {
  if (B < 1 || H < 1 || grid < 1 || iters < 1 || iters > nrv::kMaxIters ||
      !nrv::res::resident_fits(N, D))
    return (int)cudaErrorInvalidValue;
  return nrv::res::launch_resident_bwd(qkv, dout, vecs, dqkv, terms, B, N, H, scale, robust,
                                       iters, final_row, grid,
                                       static_cast<cudaStream_t>(stream));
}

// The branch rule and its formulas, for the host: 1 when the resident
// kernels take (N, D).
extern "C" int nrv_packed_resident_fits(int N, int D) {
  return nrv::res::resident_fits(N, D) ? 1 : 0;
}
