// Biased (windowed) attention, backward, resident branch: dq, dk, dv and
// dbias = Σ over the BW / nW images of dS (float32 [nW, H, N, N]) of the
// forward in biased_resident_fwd.cu (or biased_attention_fwd.cu: the
// residual rows are the same), from q, k, v, the bias, the upstream
// gradient g and the stored residual rows; bf16, N ≤ 64, D and DV each 16,
// 32 or 64.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// biased_attention.py::_biased_bwd_impl (pl.pallas_call at :296), whose
// body is sinkhorn_attention.py::_bwd_math_batched with want_ds, at the
// shapes of the resident branch (biased_resident.cuh: the design, the walk
// over units that share a bias row, and what bounds it). A = exp(scale·q·kᵀ
// + bias − lse) is formed once an image, on the tensor cores, and stays in
// registers; each step below is a pass over it or a product with it (as in
// fused_resident_bwd.cu, with D and DV up to 64):
//   B1 da = Σ_j A_ij·b_j·(G_i·V_j) (G·Vᵀ on m16n8k16); robust with a final
//      row norm: dr_F = −da·a², svec = −da·a.
//   B2 t1 = (A⊙a)ᵀ·G (movmatrix-transposed fragments): dV = b ⊙ t1, db =
//      rowsum(t1 ⊙ V), plus Aᵀ·dr_F; dc = db·(−b²) for the last b-node.
//   robust, for t = iters − 1 … 0, the reverse chain: m = A·dc_t; t > 0:
//      svec += a_t·m − da'·a_t, dr_t = −da'·a_t², dc_{t−1} = (Aᵀ·dr_t)·
//      (−b_t²); t = 0: svec += m.
//   dS in place of A: ds_ij = A_ij·((a_i·(G_i·V_j)·b_j − ρ_i) + Σ_k u_k[i]·
//      v_k[j]), ρ = a ⊙ da + svec, the rank-1 terms as a product over the
//      terms; dS added into the unit's dbias accumulator.
//   dQ = scale·dS·K; dK = scale·dSᵀ·Q.
// Vanilla: A, da, Aᵀ·G = dV, ds = A ⊙ (G·Vᵀ − da), dQ, dK.
//
// dbias: each slot walks the images of its unit (a chunk of the images that
// share bias row w) and adds their dS into registers in image order; the
// unit's float32 partial [chunks, nW, H, N, N] is written once, after its
// last image, and biased_dbias_reduce sums the chunks in chunk order (one
// chunk: the partial is dbias itself). Two runs give the same bits.
#include "biased_resident.cuh"

namespace nrv {
namespace bres {

// ds_ij = A_ij·((a_i·gv_ij·b_j − ρ_i) + Σ_k u_k[i]·v_k[j]) in place of A,
// for this warp's rows: gv = G·Vᵀ, U [rows, terms] the row factors
// (vector codes tu, read through row_of) as this warp's A fragments, the
// column factors as bf16 pairs of consecutive terms, split already (rkh
// the hi halves, rkl the lo, [NC, kRankLd / 2] each), KB blocks of 16
// terms, each side split into bf16 hi + lo (hi·hi + hi·lo + lo·hi on
// m16n8k16; terms past nterms are zero).
template <int NC, int KB, class RowOf>
__device__ __forceinline__ void ds_inplace(float (&e)[NC / 8][4], const float (&gv)[NC / 8][4],
                                           int nterms, const int* tu, RowOf row_of,
                                           const uint32_t* rkh, const uint32_t* rkl, int rowA,
                                           int rowB, const Warp& p, const float* bfin, float aF0,
                                           float aF1, float rt0, float rt1) {
  uint32_t uh[KB > 0 ? KB : 1][4], ul[KB > 0 ? KB : 1][4];
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = (f & 1) ? rowB : rowA, k0 = 16 * kb + 2 * p.t + 8 * (f >> 1);
      const float x0 = k0 < nterms ? row_of(tu[k0])[row] : 0.f;
      const float x1 = k0 + 1 < nterms ? row_of(tu[k0 + 1])[row] : 0.f;
      hopper::split_bf16x2(x0, x1, uh[kb][f], ul[kb][f]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) {
    const float2 bc = lds_f2(bfin + 8 * nt + 2 * p.t);
    float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const int at = (8 * nt + p.g) * (kRankLd / 2) + 8 * kb + p.t;  // terms 16kb + 2t, + 1
      const uint32_t bh[2] = {rkh[at], rkh[at + 4]}, bl[2] = {rkl[at], rkl[at + 4]};
      mma_bf16(r, uh[kb], bh);
      mma_bf16(r, uh[kb], bl);
      mma_bf16(r, ul[kb], bh);
    }
    e[nt][0] *= (aF0 * gv[nt][0] * bc.x - rt0) + r[0];
    e[nt][1] *= (aF0 * gv[nt][1] * bc.y - rt0) + r[1];
    e[nt][2] *= (aF1 * gv[nt][2] * bc.x - rt1) + r[2];
    e[nt][3] *= (aF1 * gv[nt][3] * bc.y - rt1) + r[3];
  }
}

// Three blocks an SM (12 warps; shared memory takes no more at Swin-T's
// shape): 168 registers a thread, with ~160 bytes of spills at N > 32.
template <int NC>
__global__ void __launch_bounds__(kThreads, 3)
biased_resident_bwd_kernel(const __nv_bfloat16* __restrict__ q_all,
                           const __nv_bfloat16* __restrict__ k_all,
                           const __nv_bfloat16* __restrict__ v_all,
                           const float* __restrict__ bias, const __nv_bfloat16* __restrict__ g_all,
                           const float* __restrict__ vecs_all, __nv_bfloat16* __restrict__ dq_all,
                           __nv_bfloat16* __restrict__ dk_all, __nv_bfloat16* __restrict__ dv_all,
                           float* __restrict__ partial, Shape s, float scale, int robust,
                           int iters, int final_row) {
  constexpr int NT = NC / 8, S = NC / 16, ITEMS = kWarps / S;
  // rank-1 terms of dA: row factor of vector code tu[k], column factor tv[k]
  __shared__ int tu[kMaxTerms], tv[kMaxTerms];
  extern __shared__ __align__(16) uint8_t smem[];
  const int N = s.N, D = s.D, DV = s.DV;
  const int it = robust ? iters : 0;
  const int ka = robust ? num_arows(iters, final_row) : 0;
  const int R = num_vecs(iters, final_row, robust);
  const int RM = res_vec_rows(it), CR = bwd_comp_rows(it), PF = bwd_part_floats(N, it);
  const bool fin = robust && final_row;
  const int slot_elems = NC * (2 * D + 2 * DV);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][ITEMS][q | k | v | g]
  float* biasf = reinterpret_cast<float*>(tiles + 2 * ITEMS * slot_elems);  // [kWarps][16·NC]
  float* parts = biasf + kWarps * 16 * NC;                                  // [ITEMS][PF]
  float* stored = parts + ITEMS * PF;  // [2][ITEMS][RM][NC]: the residual rows
  float* comps = stored + 2 * ITEMS * RM * NC;  // [ITEMS][CR][NC]
  const Walk walk(s);
  const Warp p = warp_of(S);
  const int tid = p.strip * 32 + p.lane, nthreads = 2 * NC;
  auto tile = [&](int buf, int which) {
    __nv_bfloat16* b = tiles + (size_t)(buf * ITEMS + p.slot) * slot_elems;
    return which < 2 ? b + which * NC * D : b + 2 * NC * D + (which - 2) * NC * DV;
  };
  auto stored_of = [&](int buf) { return stored + (size_t)(buf * ITEMS + p.slot) * RM * NC; };
  auto issue = [&](int buf, size_t item) {
    load_rows<NC>(tile(buf, 0), q_all, item, N, D, tid, nthreads);
    load_rows<NC>(tile(buf, 1), k_all, item, N, D, tid, nthreads);
    load_rows<NC>(tile(buf, 2), v_all, item, N, DV, tid, nthreads);
    load_rows<NC>(tile(buf, 3), g_all, item, N, DV, tid, nthreads);
    load_vecs<NC>(stored_of(buf), vecs_all, item, R, N, tid, nthreads);
  };
  float* frag = biasf + p.warp * 16 * NC;
  float* part = parts + p.slot * PF;
  // robust, while dS is formed: the rank-1 column factors, hi and lo
  uint32_t* rkh = reinterpret_cast<uint32_t*>(part);
  uint32_t* rkl = rkh + NC * kRankLd / 2;
  __nv_bfloat16* tt = reinterpret_cast<__nv_bfloat16*>(part);  // the transposed products' Aᵀ
  // The computed vectors: row 0 ones, 1 + t the dc-vector of b-node t, 1 +
  // it the final row norm's dr, 1 + it + t the chain's dr of node t ≥ 1. A
  // vector code c ≥ kComp names computed row c − kComp, below it residual
  // row c (a-rows, b-rows, lse).
  float* comp = comps + p.slot * CR * NC;
  auto dc_row = [&](int t) { return 1 + t; };
  auto dr_row = [&](int t) { return 1 + it + t; };  // t = 0: the final row norm's
  const int rowA = p.r0 + p.g, rowB = rowA + 8;
  const bool vA = rowA < N, vB = rowB < N;

  // the rank-1 terms in _reverse_chain_inner's order (a_0 = 1 is the ones
  // row, a_t the residual a-row t − 1, b_t the b-row t − 1)
  int nterms = 0;
  auto term = [&](int u_code, int v_code) {
    if (threadIdx.x == 0) {
      tu[nterms] = u_code;
      tv[nterms] = v_code;
    }
    ++nterms;
  };
  if (robust) {
    if (fin) term(kComp + dr_row(0), ka + iters - 1);
    for (int t = iters - 1; t >= 0; --t) {
      term(t == 0 ? kComp : t - 1, kComp + dc_row(t));
      if (t == 0) break;
      term(kComp + dr_row(t), ka + t - 1);
    }
  }
  for (int idx = tid; idx < CR * NC; idx += nthreads) comp[idx] = idx < NC ? 1.f : 0.f;
  __syncthreads();
  BRES_PHASE_INIT

  const int stride = gridDim.x * ITEMS;
  int u = blockIdx.x * ITEMS + p.slot;
  size_t first = 0;
  int count = 0;
  if (u < walk.units) {
    walk.span(u, first, count);
    if (bias) load_bias<NC>(frag, bias, walk.pair(u), N, p);
    issue(0, first);
  }
  cp_async_commit();
  float dacc[NT][4];  // this unit's dbias, image by image
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) dacc[nt][0] = dacc[nt][1] = dacc[nt][2] = dacc[nt][3] = 0.f;
  for (int i = 0, buf = 0; u < walk.units; buf ^= 1) {
    int nu = u, ni = i + 1, ncount = count;
    size_t nfirst = first;
    if (ni == count) {
      nu = u + stride;
      ni = 0;
      if (nu < walk.units) walk.span(nu, nfirst, ncount);
    }
    if (nu < walk.units) issue(buf ^ 1, nfirst + (size_t)ni * walk.pairs);
    cp_async_commit();
    cp_async_wait<1>();
    slot_sync<NC>(p, S);
    BRES_PHASE(0);

    const size_t item = first + (size_t)i * walk.pairs;
    const __nv_bfloat16* qt = tile(buf, 0);
    const __nv_bfloat16* kt = tile(buf, 1);
    const __nv_bfloat16* vt = tile(buf, 2);
    const __nv_bfloat16* gt = tile(buf, 3);
    const float* sv = stored_of(buf);
    auto row_of = [&](int code) -> const float* {
      return code >= kComp ? comp + (code - kComp) * NC : sv + code * NC;
    };
    const float* bfin = robust ? sv + (ka + iters - 1) * NC : comp;  // ones when vanilla
    const float aF0 = vA ? (ka > 0 ? sv[(ka - 1) * NC + rowA] : 1.f) : 0.f;
    const float aF1 = vB ? (ka > 0 ? sv[(ka - 1) * NC + rowB] : 1.f) : 0.f;

    // A = exp(scale·q·kᵀ + bias − lse); lse in log2 units, +∞ on a dead row
    float e[NT][4];
    nt_product<NC>(e, qt, kt, D, p);
    {
      const float l0 = vA ? sv[(R - 1) * NC + rowA] * kLog2e : INFINITY;
      const float l1 = vB ? sv[(R - 1) * NC + rowB] * kLog2e : INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 b = bias ? *reinterpret_cast<const float4*>(frag + (nt * 32 + p.lane) * 4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        const int col = 8 * nt + 2 * p.t;
        e[nt][0] = col < N ? ex2(fmaf(fmaf(e[nt][0], scale, b.x), kLog2e, -l0)) : 0.f;
        e[nt][1] = col + 1 < N ? ex2(fmaf(fmaf(e[nt][1], scale, b.y), kLog2e, -l0)) : 0.f;
        e[nt][2] = col < N ? ex2(fmaf(fmaf(e[nt][2], scale, b.z), kLog2e, -l1)) : 0.f;
        e[nt][3] = col + 1 < N ? ex2(fmaf(fmaf(e[nt][3], scale, b.w), kLog2e, -l1)) : 0.f;
      }
    }
    // the bias entries are read: the next unit's row may replace them
    if (ni == 0 && nu < walk.units && bias) {
      __syncwarp();
      load_bias<NC>(frag, bias, walk.pair(nu), N, p);
    }
    cp_async_commit();
    BRES_PHASE(1);

    // B1: da = Σ_j A_ij·b_j·(G_i·V_j)
    float gv[NT][4];
    nt_product<NC>(gv, gt, vt, DV, p);
    float da0 = 0.f, da1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 bc = lds_f2(bfin + 8 * nt + 2 * p.t);
      da0 = fmaf(e[nt][0] * bc.x, gv[nt][0], fmaf(e[nt][1] * bc.y, gv[nt][1], da0));
      da1 = fmaf(e[nt][2] * bc.x, gv[nt][2], fmaf(e[nt][3] * bc.y, gv[nt][3], da1));
    }
    da0 = quad_sum(da0);
    da1 = quad_sum(da1);
    float sv0 = 0.f, sv1 = 0.f, dr0 = 0.f, dr1 = 0.f;
    if (fin) {
      const float tmp0 = da0 * aF0, tmp1 = da1 * aF1;
      dr0 = -(tmp0 * aF0);
      dr1 = -(tmp1 * aF1);
      sv0 = -tmp0;
      sv1 = -tmp1;
      if (p.t == 0) {
        if (vA) comp[dr_row(0) * NC + rowA] = dr0;
        if (vB) comp[dr_row(0) * NC + rowB] = dr1;
      }
    }
    BRES_PHASE(2);

    // B2: Aᵀ·dr_F; t1 = (A⊙a)ᵀ·G, dV = b ⊙ t1, db = rowsum(t1 ⊙ V); the
    // last b-node's dc
    if (fin)
      col_reduce<NC>(e, dr0, dr1, part, p, S,
                     [&](int j, float sum) { comp[dc_row(iters - 1) * NC + j] = sum; });
    {
      uint32_t th[NC / 16][4], tl[NC / 16][4];
      col_frags<NC>(th, tl, e, aF0, aF1);
      const float bA = bfin[rowA], bB = bfin[rowB];  // b at this warp's rows of t1
      float db0 = 0.f, db1 = 0.f;
      __nv_bfloat16* dvp = dv_all + item * N * DV;
      col_product<NC>(th, tl, gt, DV, tt, p, S, [&](int c, const float(&t1)[4]) {
        const int cc = c + 2 * p.t;
        const float2 va = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            vt + tile_at(rowA, cc >> 3, DV) + (cc & 7)));
        const float2 vb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            vt + tile_at(rowB, cc >> 3, DV) + (cc & 7)));
        db0 = fmaf(t1[0], va.x, fmaf(t1[1], va.y, db0));
        db1 = fmaf(t1[2], vb.x, fmaf(t1[3], vb.y, db1));
        if (vA)
          *reinterpret_cast<__nv_bfloat162*>(dvp + (size_t)rowA * DV + cc) =
              __floats2bfloat162_rn(bA * t1[0], bA * t1[1]);
        if (vB)
          *reinterpret_cast<__nv_bfloat162*>(dvp + (size_t)rowB * DV + cc) =
              __floats2bfloat162_rn(bB * t1[2], bB * t1[3]);
      });
      if (robust) {
        db0 = quad_sum(db0);
        db1 = quad_sum(db1);
        if (p.t == 0) {
          float* dc = comp + dc_row(iters - 1) * NC;
          dc[rowA] = (db0 + (fin ? dc[rowA] : 0.f)) * -(bA * bA);
          dc[rowB] = (db1 + (fin ? dc[rowB] : 0.f)) * -(bB * bB);
        }
        slot_sync<NC>(p, S);
      }
    }
    BRES_PHASE(3);

    // the reverse chain
    float rt0 = da0, rt1 = da1;
    if (robust) {
      for (int t = iters - 1; t >= 0; --t) {
        const float2 m = row_pass<NC>(e, comp + dc_row(t) * NC);
        if (t == 0) {
          sv0 += m.x;
          sv1 += m.y;
          break;
        }
        const float at0 = sv[(t - 1) * NC + rowA], at1 = sv[(t - 1) * NC + rowB];
        const bool head = !final_row && t == iters - 1;
        sv0 += at0 * m.x;
        sv1 += at1 * m.y;
        const float tmp0 = (head ? da0 + m.x : m.x) * at0;
        const float tmp1 = (head ? da1 + m.y : m.y) * at1;
        sv0 -= tmp0;
        sv1 -= tmp1;
        dr0 = vA ? -(tmp0 * at0) : 0.f;
        dr1 = vB ? -(tmp1 * at1) : 0.f;
        if (p.t == 0) {
          if (vA) comp[dr_row(t) * NC + rowA] = dr0;
          if (vB) comp[dr_row(t) * NC + rowB] = dr1;
        }
        col_reduce<NC>(e, dr0, dr1, part, p, S, [&](int j, float sum) {
          const float bt = sv[(ka + t - 1) * NC + j];
          comp[dc_row(t - 1) * NC + j] = sum * -(bt * bt);
        });
      }
      rt0 = aF0 * da0 + sv0;
      rt1 = aF1 * da1 + sv1;
    }
    BRES_PHASE(4);

    // dS in place of A, added into the unit's dbias
    if (robust) {
      // the column factors, two terms at a time split into bf16 hi + lo:
      // half the slot's threads take the even pairs, half the odd ones, a
      // column each
      const int kmax = nterms <= 16 ? 16 : 32;
      const int j = tid % NC;
      for (int k = 2 * (tid / NC); k < kmax; k += 4) {
        const float x0 = k < nterms ? row_of(tv[k])[j] : 0.f;
        const float x1 = k + 1 < nterms ? row_of(tv[k + 1])[j] : 0.f;
        const int at = j * (kRankLd / 2) + k / 2;
        hopper::split_bf16x2(x0, x1, rkh[at], rkl[at]);
      }
      slot_sync<NC>(p, S);
    }
    nt_product<NC>(gv, gt, vt, DV, p);
    if (nterms == 0)
      ds_inplace<NC, 0>(e, gv, nterms, tu, row_of, rkh, rkl, rowA, rowB, p, bfin, aF0,
                            aF1, rt0, rt1);
    else if (nterms <= 16)
      ds_inplace<NC, 1>(e, gv, nterms, tu, row_of, rkh, rkl, rowA, rowB, p, bfin, aF0,
                            aF1, rt0, rt1);
    else
      ds_inplace<NC, 2>(e, gv, nterms, tu, row_of, rkh, rkl, rowA, rowB, p, bfin, aF0,
                            aF1, rt0, rt1);
    if (bias) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) dacc[nt][k] += e[nt][k];
    }
    if (robust) slot_sync<NC>(p, S);  // rkh, rkl read before dK's Aᵀ takes their place
    BRES_PHASE(5);

    // dQ = scale·dS·K
    {
      uint32_t hi[NC / 16][4], lo[NC / 16][4];
      row_frags<NC>(hi, lo, e, nullptr, p.t);
      __nv_bfloat16* dq = dq_all + item * N * D;
      row_product<NC>(hi, lo, kt, D, p, [&](int c, const float(&acc)[4]) {
        if (vA)
          *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)rowA * D + c + 2 * p.t) =
              __floats2bfloat162_rn(scale * acc[0], scale * acc[1]);
        if (vB)
          *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)rowB * D + c + 2 * p.t) =
              __floats2bfloat162_rn(scale * acc[2], scale * acc[3]);
      });
    }
    // dK = scale·dSᵀ·Q (ends with a slot barrier: this step's tiles and
    // vectors are read before the prefetch replaces them)
    {
      uint32_t th[NC / 16][4], tl[NC / 16][4];
      col_frags<NC>(th, tl, e, 1.f, 1.f);
      __nv_bfloat16* dk = dk_all + item * N * D;
      col_product<NC>(th, tl, qt, D, tt, p, S, [&](int c, const float(&acc)[4]) {
        if (vA)
          *reinterpret_cast<__nv_bfloat162*>(dk + (size_t)rowA * D + c + 2 * p.t) =
              __floats2bfloat162_rn(scale * acc[0], scale * acc[1]);
        if (vB)
          *reinterpret_cast<__nv_bfloat162*>(dk + (size_t)rowB * D + c + 2 * p.t) =
              __floats2bfloat162_rn(scale * acc[2], scale * acc[3]);
      });
    }
    BRES_PHASE(6);

    // the unit's dbias partial, after its last image
    if (bias && ni == 0) {
      float* dst = partial + (size_t)u * N * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = rowA + 8 * (k >> 1), c = 8 * nt + 2 * p.t + (k & 1);
          if (r < N && c < N) dst[r * N + c] = dacc[nt][k];
          dacc[nt][k] = 0.f;
        }
      }
    }
    BRES_PHASE(7);
    u = nu;
    i = ni;
    first = nfirst;
    count = ncount;
  }
}

template <int NC>
int launch_bwd(const void* q, const void* k, const void* v, const void* bias, const void* g,
               const void* vecs, void* dq, void* dk, void* dv, void* partial, void* dbias,
               const Shape& s, float scale, int robust, int iters, int final_row,
               cudaStream_t stream) {
  const auto kernel = biased_resident_bwd_kernel<NC>;
  const size_t smem = bwd_smem_bytes(s.N, s.D, s.DV, robust ? iters : 0);
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  const int items = res_items(s.N), units = Walk(s).units;
  const int need = (units + items - 1) / items, grid = need < blocks ? need : blocks;
  // one chunk: the single partial is dbias itself
  float* part = static_cast<float*>(bias == nullptr ? nullptr : s.chunks == 1 ? dbias : partial);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(vecs),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part, s, scale, robust, iters, final_row);
  err = cudaGetLastError();
  if (err != cudaSuccess || bias == nullptr || s.chunks == 1) return (int)err;
  return (int)biased_dbias_reduce(static_cast<const float*>(partial), static_cast<float*>(dbias),
                                  (size_t)s.nW * s.H * s.N * s.N, s.chunks, stream);
}

cudaError_t bwd_resident_blocks(int n, int d, int dv, int it, int& blocks) {
  const size_t smem = bwd_smem_bytes(n, d, dv, it);
  switch (res_cols(n)) {
    case 16: return resident_blocks(biased_resident_bwd_kernel<16>, smem, blocks);
    case 32: return resident_blocks(biased_resident_bwd_kernel<32>, smem, blocks);
    default: return resident_blocks(biased_resident_bwd_kernel<64>, smem, blocks);
  }
}

}  // namespace bres
}  // namespace nrv

// bf16 only. bias and dbias are null when there is no bias; partial holds
// chunks·nW·H·N·N floats (unused when chunks == 1). Returns
// cudaErrorInvalidValue for a shape the branch does not take or a walk that
// does not cover the images, else the launches' error.
extern "C" int nrv_biased_resident_bwd(const void* q, const void* k, const void* v,
                                       const void* bias, const void* dout, const void* vecs,
                                       void* dq, void* dk, void* dv, void* partial, void* dbias,
                                       int BW, int H, int N, int D, int DV, int nW, float scale,
                                       int robust, int iters, int final_row, int chunks, int per,
                                       void* stream) {
  using namespace nrv::bres;
  const Shape s{BW, H, N, D, DV, nW, chunks, per};
  if (!walk_ok(s) || !resident_fits(N, D, DV, robust, iters) || (bias && !dbias) ||
      (bias && chunks > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define NRV_BRES_BWD(nc)                                                                    \
  launch_bwd<nc>(q, k, v, bias, dout, vecs, dq, dk, dv, partial, dbias, s, scale, robust,   \
                 iters, final_row, st)
  switch (res_cols(N)) {
    case 16: return NRV_BRES_BWD(16);
    case 32: return NRV_BRES_BWD(32);
    default: return NRV_BRES_BWD(64);
  }
#undef NRV_BRES_BWD
}
