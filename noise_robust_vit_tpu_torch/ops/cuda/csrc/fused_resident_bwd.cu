// Fused q/k/v attention, backward, resident branch: dq, dk, dv of the
// forward in fused_resident_fwd.cu (or fused_attention_fwd.cu: the residual
// rows are the same) from q, k, v, the upstream gradient g and the stored
// residual rows; bf16 [K, N, 8], N ≤ 256.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// sinkhorn_attention.py::_fused_attention_bwd_impl (pl.pallas_call at
// :694), whose body is _bwd_math_batched with _restore_vec_rows and
// _reverse_chain_inner, at the shapes of the resident branch
// (fused_resident.cuh: the design, and what bounds it). A = exp(scale·q·kᵀ
// − lse) is formed once, on the tensor cores, and stays in registers; each
// step below is a pass over it or a product with it:
//   B1 da = rowsum(G ⊙ o/a) with o/a = (A⊙b)·V, read as Σ_j A_ij·b_j·
//      (G_i·V_j) (G·Vᵀ on m16n8k8, exact); robust with a final row norm:
//      dr_F = −da·a², svec = −da·a.
//   B2 (A⊙a)ᵀ·G (movmatrix-transposed fragments): t1, dV = b ⊙ t1, db =
//      rowsum(t1 ⊙ V), plus Aᵀ·dr_F; dc = db·(−b²) for the last b-node.
//   robust, for t = iters − 1 … 0, the reverse chain:
//     rows:     m = A·dc_t; t > 0: svec += a_t·m − da'·a_t (da' = m, plus
//               da at the chain's head when there is no final row norm),
//               dr_t = −da'·a_t²; t = 0: svec += m.
//     columns (t > 0): dc_{t−1} = (Aᵀ·dr_t)·(−b_t²).
//   dS in place of A: ds_ij = A_ij·((a_i·(G_i·V_j)·b_j − ρ_i) + Σ_k u_k[i]·
//      v_k[j]), G·Vᵀ one m16n8k8 MMA a tile, ρ = a ⊙ da + svec, the rank-1
//      terms of _reverse_chain_inner as a product U·Vᵀ over the terms
//      (m16n8k16, both sides split into bf16 hi + lo).
//   dQ = scale·dS·K (m16n8k16, dS split hi + lo); dK = scale·dSᵀ·Q
//      (transposed fragments), summed over the item's rows.
// Vanilla: A, da, Aᵀ·G = dV, ds = A ⊙ (G·Vᵀ − da), dQ, dK.
#include "fused_resident.cuh"

namespace nrv {
namespace fres {

// ds_ij = A_ij·((a_i·(G_i·V_j)·b_j − ρ_i) + Σ_k u_k[i]·v_k[j]) in place of
// A, for this warp's rows. The rank-1 sum is a product too: U [rows, terms]
// (row factors, this warp's A fragments) times the column factors rk
// [NC, kRankLd], KB blocks of 16 terms, each side split into bf16 hi + lo
// (hi·hi + hi·lo + lo·hi on m16n8k16; terms past nterms are zero).
template <int NC, int KB>
__device__ __forceinline__ void ds_inplace(float (&e)[NC / 8][4], int nterms, const int* tu,
                                           const float* rv, const float* rk, int rowA, int rowB,
                                           uint32_t ga0, uint32_t ga1, const __nv_bfloat16* vt,
                                           const float* bfin, float aF0, float aF1, float rt0,
                                           float rt1) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  uint32_t uh[KB > 0 ? KB : 1][4], ul[KB > 0 ? KB : 1][4];
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = (f & 1) ? rowB : rowA, k0 = 16 * kb + 2 * t + 8 * (f >> 1);
      const float x0 = k0 < nterms ? rv[tu[k0] * NC + row] : 0.f;
      const float x1 = k0 + 1 < nterms ? rv[tu[k0 + 1] * NC + row] : 0.f;
      hopper::split_bf16x2(x0, x1, uh[kb][f], ul[kb][f]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) {
    const int c = 8 * nt + 2 * t;
    float gv[4] = {0.f, 0.f, 0.f, 0.f};
    mma_k8(gv, ga0, ga1, lds_u32(vt + (size_t)(8 * nt + g) * kD + 2 * t));
    const float2 bc = lds_f2(bfin + c);
    float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const float* w = rk + (size_t)(8 * nt + g) * kRankLd + 16 * kb + 2 * t;
      const float2 w0 = lds_f2(w), w1 = lds_f2(w + 8);
      uint32_t bh[2], bl[2];
      hopper::split_bf16x2(w0.x, w0.y, bh[0], bl[0]);
      hopper::split_bf16x2(w1.x, w1.y, bh[1], bl[1]);
      mma_bf16(r, uh[kb], bh);
      mma_bf16(r, uh[kb], bl);
      mma_bf16(r, ul[kb], bh);
    }
    e[nt][0] *= (aF0 * gv[0] * bc.x - rt0) + r[0];
    e[nt][1] *= (aF0 * gv[1] * bc.y - rt0) + r[1];
    e[nt][2] *= (aF1 * gv[2] * bc.x - rt1) + r[2];
    e[nt][3] *= (aF1 * gv[3] * bc.y - rt1) + r[3];
  }
}

template <int NC, int CL>
__global__ void __launch_bounds__(kThreads, 1)
fused_resident_bwd_kernel(const __nv_bfloat16* __restrict__ q_all,
                          const __nv_bfloat16* __restrict__ k_all,
                          const __nv_bfloat16* __restrict__ v_all,
                          const __nv_bfloat16* __restrict__ g_all,
                          const float* __restrict__ vecs_all, __nv_bfloat16* __restrict__ dq_all,
                          __nv_bfloat16* __restrict__ dk_all, __nv_bfloat16* __restrict__ dv_all,
                          int K, int N, float scale, int robust, int iters, int final_row) {
  constexpr int NT = NC / 8;
  // rank-1 terms of dA: row factor at row vector tu[k], column factor at
  // column vector tv[k]
  __shared__ int tu[kMaxTerms], tv[kMaxTerms];
  __shared__ uint64_t xbar[4];  // the cluster exchanges' mbarriers
  extern __shared__ __align__(16) uint8_t smem[];
  const int items = res_items(N);
  const int ic = items * NC;
  const int it = robust ? iters : 0;
  const int ka = robust ? num_arows(iters, final_row) : 0;
  const int R = num_vecs(iters, final_row, robust);
  const bool fin = robust && final_row;
  const int CV = bwd_col_vecs(it), RV = bwd_row_vecs(it);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][4][ic][8]
  float* part = reinterpret_cast<float*>(tiles + (size_t)8 * ic * kD);
  float* rk = part;  // robust, while dS is formed: [items, NC, kRankLd]
  float* csum8 = part + bwd_part_floats(N, it);
  float* tot8 = csum8 + (size_t)4 * ic * kD;
  float* csumv = tot8 + (size_t)ic * kD;
  float* vecs2 = csumv + 4 * ic;  // [2][columns ic·CV, rows ic·RV]
  auto tile = [&](int buf, int which) { return tiles + (size_t)(4 * buf + which) * ic * kD; };
  auto colv_of = [&](int buf) { return vecs2 + (size_t)buf * ic * (CV + RV); };
  auto rowv_of = [&](int buf) { return colv_of(buf) + (size_t)ic * CV; };
  const int rank = CL == 2 ? (int)cg::this_cluster().block_rank() : 0;
  const int units = res_units(K, N), stride = gridDim.x / CL;
  // vector indices. Columns: 0 ones, 1 + r the b-row r (bs_r(s) = s), then
  // the dc-vectors. Rows: 0 lse, 1 ones, 2 + r the a-row r (as_r(s) = 1 +
  // s), then dr_F and the chain's dr-vectors.
  auto dc_idx = [&](int s) { return 1 + it + s; };
  auto dr_idx = [&](int s) { return 2 + it + (fin ? 1 : 0) + iters - 1 - s; };
  // a unit's tiles and stored rows into buffer `buf` by cp.async (zero past
  // N and K)
  auto issue = [&](int unit, int buf) {
    const size_t first = (size_t)unit * items;
    load_tiles<NC>(tile(buf, 0), q_all, first, items, K, N);
    load_tiles<NC>(tile(buf, 1), k_all, first, items, K, N);
    load_tiles<NC>(tile(buf, 2), v_all, first, items, K, N);
    load_tiles<NC>(tile(buf, 3), g_all, first, items, K, N);
    for (int idx = threadIdx.x; idx < ic; idx += kThreads) {
      const int slot = idx / NC, j = idx % NC;
      const size_t item = first + slot;
      const bool valid = item < (size_t)K && j < N;
      const float* vec = vecs_all + (valid ? item : 0) * R * N;
      float* cv = colv_of(buf) + (size_t)slot * CV * NC;
      float* rv = rowv_of(buf) + (size_t)slot * RV * NC;
      for (int r = 0; r < it; ++r)
        cp_async4(cv + (1 + r) * NC + j, vec + (size_t)(ka + r) * N + j, valid);
      cp_async4(rv + j, vec + (size_t)(R - 1) * N + j, valid);
      for (int r = 0; r < ka; ++r) cp_async4(rv + (2 + r) * NC + j, vec + (size_t)r * N + j, valid);
    }
  };
  // the rank-1 terms in _reverse_chain_inner's order
  int nterms = 0;
  if (robust) {
    if (fin) {
      if (threadIdx.x == 0) {
        tu[nterms] = 2 + it;
        tv[nterms] = iters;
      }
      ++nterms;
    }
    for (int s = iters - 1; s >= 0; --s) {
      if (threadIdx.x == 0) {
        tu[nterms] = 1 + s;
        tv[nterms] = dc_idx(s);
      }
      ++nterms;
      if (s == 0) break;
      if (threadIdx.x == 0) {
        tu[nterms] = dr_idx(s);
        tv[nterms] = s;
      }
      ++nterms;
    }
  }
  // the cluster exchanges of the transposed products' and the column
  // passes' block sums
  Xchg x8{csum8, xbar}, xv{csumv, xbar + 2};
  if (CL == 2) exchange_init(xbar, 4);
  FRES_PHASE_INIT

  int unit = blockIdx.x / CL;
  if (unit < units) issue(unit, 0);
  cp_async_commit();
  for (int i = 0; unit < units; ++i, unit += stride) {
    const int cur = i & 1;
    const size_t item0 = (size_t)unit * items;
    if (unit + stride < units) issue(unit + stride, cur ^ 1);
    cp_async_commit();
    const __nv_bfloat16* qs = tile(cur, 0);
    const __nv_bfloat16* ks = tile(cur, 1);
    const __nv_bfloat16* vs = tile(cur, 2);
    const __nv_bfloat16* gs = tile(cur, 3);
    float* colv = colv_of(cur);
    float* rowv = rowv_of(cur);
    // the vectors the kernel forms itself (the stored ones arrive above)
    for (int idx = threadIdx.x; idx < ic; idx += kThreads) {
      const int slot = idx / NC, j = idx % NC;
      float* cv = colv + (size_t)slot * CV * NC;
      float* rv = rowv + (size_t)slot * RV * NC;
      cv[j] = 1.f;
      for (int r = 0; r < it; ++r) cv[(1 + it + r) * NC + j] = 0.f;
      for (int r = 1; r < RV; ++r)
        if (r < 2 || r >= 2 + ka) rv[r * NC + j] = r == 1 ? 1.f : 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();
    FRES_PHASE(0);

    const WarpPos p = warp_pos<CL>(K, N, rank, unit);
    const int t = p.t;
    const int rowA = p.r0 + p.g, rowB = rowA + 8;
    const bool vA = p.live && rowA < N, vB = p.live && rowB < N;
    const __nv_bfloat16* qt = qs + (size_t)p.slot * NC * kD;
    const __nv_bfloat16* kt = ks + (size_t)p.slot * NC * kD;
    const __nv_bfloat16* vt = vs + (size_t)p.slot * NC * kD;
    const __nv_bfloat16* gt = gs + (size_t)p.slot * NC * kD;
    float* cv = colv + (size_t)p.slot * CV * NC;
    float* rv = rowv + (size_t)p.slot * RV * NC;
    const float* bfin = cv + it * NC;  // ones when vanilla
    const float aF0 = vA ? rv[(1 + ka) * NC + rowA] : 0.f;
    const float aF1 = vB ? rv[(1 + ka) * NC + rowB] : 0.f;

    // A = exp(scale·q·kᵀ − lse)
    const uint32_t qa0 = lds_u32(qt + (size_t)rowA * kD + 2 * t);
    const uint32_t qa1 = lds_u32(qt + (size_t)rowB * kD + 2 * t);
    const float sl2 = scale * kLog2e;
    // lse in log2 units; +∞ on a dead row, whose A is then 0
    const float l0 = vA ? rv[rowA] * kLog2e : INFINITY, l1 = vB ? rv[rowB] * kLog2e : INFINITY;
    float e[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s_tile(e[nt], qa0, qa1, kt, nt, N);
      e[nt][0] = ex2(fmaf(e[nt][0], sl2, -l0));
      e[nt][1] = ex2(fmaf(e[nt][1], sl2, -l0));
      e[nt][2] = ex2(fmaf(e[nt][2], sl2, -l1));
      e[nt][3] = ex2(fmaf(e[nt][3], sl2, -l1));
    }
    FRES_PHASE(1);

    // B1: da = rowsum(G ⊙ o/a) = Σ_j A_ij·b_j·(G_i·V_j), G·Vᵀ a tile at a
    // time on m16n8k8 (exact bf16 products; o/a itself is not needed)
    const uint32_t ga0 = lds_u32(gt + (size_t)rowA * kD + 2 * t);
    const uint32_t ga1 = lds_u32(gt + (size_t)rowB * kD + 2 * t);
    float da0 = 0.f, da1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k8(gv, ga0, ga1, lds_u32(vt + (size_t)(8 * nt + p.g) * kD + 2 * t));
      const float2 bc = lds_f2(bfin + 8 * nt + 2 * t);
      da0 = fmaf(e[nt][0] * bc.x, gv[0], fmaf(e[nt][1] * bc.y, gv[1], da0));
      da1 = fmaf(e[nt][2] * bc.x, gv[2], fmaf(e[nt][3] * bc.y, gv[3], da1));
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
      if (t == 0) {
        if (vA) rv[(2 + it) * NC + rowA] = dr0;
        if (vB) rv[(2 + it) * NC + rowB] = dr1;
      }
    }
    FRES_PHASE(2);

    // B2: t1 = (A⊙a)ᵀ·G, Aᵀ·dr_F; dV, db and the last b-node's dc
    colprod_reduce<NC, CL>(e, aF0, aF1, gt, p.r0, part, x8, N,
                           [&](int slot, int j, int h, float4 s) {
                             reinterpret_cast<float4*>(tot8)[((size_t)slot * NC + j) * 2 + h] = s;
                           });
    if (fin)
      col_reduce<NC, CL>(e, dr0, dr1, part, xv, N, [&](int slot, int j, float s) {
        colv[((size_t)slot * CV + dc_idx(iters - 1)) * NC + j] = s;
      });
    for (int idx = threadIdx.x; idx < ic; idx += kThreads) {
      const int slot = idx / NC, j = idx % NC;
      const size_t item = item0 + slot;
      const float4 lo = reinterpret_cast<const float4*>(tot8)[(size_t)idx * 2];
      const float4 hi = reinterpret_cast<const float4*>(tot8)[(size_t)idx * 2 + 1];
      const float t1[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float* cvs = colv + (size_t)slot * CV * NC;
      const float b = cvs[it * NC + j];
      const uint4 vraw = *reinterpret_cast<const uint4*>(vs + (size_t)idx * kD);
      const __nv_bfloat162* vp = reinterpret_cast<const __nv_bfloat162*>(&vraw);
      float db = 0.f;
      uint4 out;
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 vv = __bfloat1622float2(vp[c]);
        db = fmaf(t1[2 * c], vv.x, db);
        db = fmaf(t1[2 * c + 1], vv.y, db);
        op[c] = __floats2bfloat162_rn(b * t1[2 * c], b * t1[2 * c + 1]);
      }
      if (rank == 0 && j < N && item < (size_t)K)
        *reinterpret_cast<uint4*>(dv_all + (item * N + j) * kD) = out;
      if (robust) {
        float* dc = cvs + dc_idx(iters - 1) * NC + j;
        *dc = (db + (fin ? *dc : 0.f)) * -(b * b);
      }
    }
    __syncthreads();
    FRES_PHASE(3);

    // the reverse chain
    float rt0 = da0, rt1 = da1;
    if (robust) {
      for (int s = iters - 1; s >= 0; --s) {
        const float2 m = row_pass<NC>(e, cv + dc_idx(s) * NC);
        if (s == 0) {
          sv0 += m.x;
          sv1 += m.y;
          break;
        }
        const float at0 = rv[(1 + s) * NC + rowA], at1 = rv[(1 + s) * NC + rowB];
        const bool head = !final_row && s == iters - 1;
        sv0 += at0 * m.x;
        sv1 += at1 * m.y;
        const float tmp0 = (head ? da0 + m.x : m.x) * at0;
        const float tmp1 = (head ? da1 + m.y : m.y) * at1;
        sv0 -= tmp0;
        sv1 -= tmp1;
        dr0 = vA ? -(tmp0 * at0) : 0.f;
        dr1 = vB ? -(tmp1 * at1) : 0.f;
        if (t == 0) {
          if (vA) rv[dr_idx(s) * NC + rowA] = dr0;
          if (vB) rv[dr_idx(s) * NC + rowB] = dr1;
        }
        col_reduce<NC, CL>(e, dr0, dr1, part, xv, N, [&](int slot, int j, float sum) {
          float* cvs = colv + (size_t)slot * CV * NC;
          const float bt = cvs[s * NC + j];
          cvs[dc_idx(s - 1) * NC + j] = sum * -(bt * bt);
        });
      }
      rt0 = aF0 * da0 + sv0;
      rt1 = aF1 * da1 + sv1;
    }
    __syncthreads();
    FRES_PHASE(4);

    // dS in place of A
    if (robust) {
      // term by term (the blocks of 16 the product reads), the lanes of a
      // warp on consecutive columns: conflict-free reads
      const int kmax = nterms <= 16 ? 16 : 32;
#pragma unroll 4
      for (int k = 0; k < kmax; ++k) {
        const int src = k < nterms ? tv[k] : -1;
        for (int idx = threadIdx.x; idx < ic; idx += kThreads) {
          const int slot = idx / NC, j = idx % NC;
          rk[((size_t)slot * NC + j) * kRankLd + k] =
              src >= 0 ? colv[((size_t)slot * CV + src) * NC + j] : 0.f;
        }
      }
      __syncthreads();
    }
    const float* rks = rk + (size_t)p.slot * NC * kRankLd;
    if (nterms == 0)
      ds_inplace<NC, 0>(e, nterms, tu, rv, rks, rowA, rowB, ga0, ga1, vt, bfin, aF0, aF1, rt0,
                        rt1);
    else if (nterms <= 16)
      ds_inplace<NC, 1>(e, nterms, tu, rv, rks, rowA, rowB, ga0, ga1, vt, bfin, aF0, aF1, rt0,
                        rt1);
    else
      ds_inplace<NC, 2>(e, nterms, tu, rv, rks, rowA, rowB, ga0, ga1, vt, bfin, aF0, aF1, rt0,
                        rt1);
    if (robust) __syncthreads();  // rk read before dK's partials take its place
    FRES_PHASE(5);

    // dQ = scale·dS·K
    {
      float dq[4];
      rowprod<NC>(dq, e, nullptr, kt);
      __nv_bfloat16* out = dq_all + (p.live ? p.item : 0) * N * kD;
      if (vA)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rowA * kD + 2 * t) =
            __floats2bfloat162_rn(scale * dq[0], scale * dq[1]);
      if (vB)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rowB * kD + 2 * t) =
            __floats2bfloat162_rn(scale * dq[2], scale * dq[3]);
    }
    // dK = scale·dSᵀ·Q
    colprod_reduce<NC, CL>(e, 1.f, 1.f, qt, p.r0, part, x8, N,
                           [&](int slot, int j, int h, float4 s) {
                             const size_t item = item0 + slot;
                             if (rank == 0 && j < N && item < (size_t)K) {
                               uint2 o;
                               __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
                               op[0] = __floats2bfloat162_rn(scale * s.x, scale * s.y);
                               op[1] = __floats2bfloat162_rn(scale * s.z, scale * s.w);
                               *reinterpret_cast<uint2*>(dk_all + (item * N + j) * kD + 4 * h) = o;
                             }
                           });
    FRES_PHASE(6);
    __syncthreads();  // this unit's tiles and vectors read before they are replaced
  }
}

template <int NC>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, const void* vecs,
               void* dq, void* dk, void* dv, int K, int N, float scale, int robust, int iters,
               int final_row, cudaStream_t stream) {
  constexpr int CL = NC > kRows ? 2 : 1;
  return (int)launch(fused_resident_bwd_kernel<NC, CL>, res_units(K, N), CL,
                     bwd_smem_bytes(N, robust ? iters : 0), stream,
                     static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
                     static_cast<const float*>(vecs), static_cast<__nv_bfloat16*>(dq),
                     static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), K, N,
                     scale, robust, iters, final_row);
}

}  // namespace fres
}  // namespace nrv

// bf16 only. Returns cudaErrorInvalidValue for a shape the branch does not
// take, else the launch's error.
extern "C" int nrv_fused_resident_bwd(const void* q, const void* k, const void* v, const void* g,
                                      const void* vecs, void* dq, void* dk, void* dv, int K,
                                      int N, int D, int DV, float scale, int robust, int iters,
                                      int final_row, void* stream) {
  using namespace nrv::fres;
  if (K < 1 || !resident_fits(N, D, DV, robust, iters)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
#define NRV_FRES_BWD(nc)                                                                    \
  launch_bwd<nc>(q, k, v, g, vecs, dq, dk, dv, K, N, scale, robust, iters, final_row, s)
  switch (res_cols(N)) {
    case 16: return NRV_FRES_BWD(16);
    case 32: return NRV_FRES_BWD(32);
    case 64: return NRV_FRES_BWD(64);
    case 128: return NRV_FRES_BWD(128);
    default: return NRV_FRES_BWD(256);
  }
#undef NRV_FRES_BWD
}
