// Fused q/k/v attention, forward, resident branch: out = diag(a)·A·diag(b)·v
// with A the row softmax of scale·q·kᵀ and (a, b) the Sinkhorn scaling
// vectors (robust), or out = A·v (vanilla), and the residual rows the
// backward starts from; bf16 q, k, v [K, N, 8], N ≤ 256.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// sinkhorn_attention.py::_fused_attention_impl (pl.pallas_call at :147),
// whose body is _fwd_math_batched, at the shapes of the resident branch
// (fused_resident.cuh: the design, and what bounds it). The matrix is formed
// once, on the tensor cores, and every pass reads it from registers:
//   1. e = exp(s − m) with s = scale·q·kᵀ (one m16n8k8 MMA a tile), m the
//      row max; r = Σ_j e_ij, lse = m + log r, inv_r = 1 / r (the row
//      normalizer folded into the row scale, as in ops/cuda/plain.py).
//   2. robust, for t = 0 … iters − 1: (t > 0) a row pass, a = recip(e·b ·
//      inv_r); a column pass, b = recip(eᵀ·(a·inv_r)). recip is the
//      clamped reciprocal of ops/sinkhorn.py. With final_row, one more row
//      pass for the final a.
//   3. out = ((e⊙b)·V)·a·inv_r on m16n8k16 with e split into bf16 hi + lo.
// Vanilla is steps 1 and 3: one pass over the registers, P·V from them.
//
// Layout: q, k, v and out [K, N, 8] bf16, contiguous; vecs [K, R, N]
// float32: the a-rows (iters − 1, plus the final one), the iters b-rows and
// lse when robust; lse alone when vanilla.
#include "fused_resident.cuh"

namespace nrv {
namespace fres {

template <int NC, int CL>
__global__ void __launch_bounds__(kThreads, 1)
fused_resident_fwd_kernel(const __nv_bfloat16* __restrict__ q_all,
                          const __nv_bfloat16* __restrict__ k_all,
                          const __nv_bfloat16* __restrict__ v_all,
                          __nv_bfloat16* __restrict__ out_all, float* __restrict__ vecs_all,
                          int K, int N, float scale, int robust, int iters, int final_row) {
  constexpr int NT = NC / 8;
  __shared__ uint64_t xbar[2];  // the cluster exchange's mbarriers
  extern __shared__ __align__(16) uint8_t smem[];
  const int items = res_items(N);
  const int ic = items * NC;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][3][ic][8]
  float* part = reinterpret_cast<float*>(tiles + (size_t)6 * ic * kD);
  float* csum = part + kWarps * NC;
  float* bcol = csum + 4 * ic;
  auto tile = [&](int buf, int which) { return tiles + (size_t)(3 * buf + which) * ic * kD; };
  const int rank = CL == 2 ? (int)cg::this_cluster().block_rank() : 0;
  const int units = res_units(K, N), stride = gridDim.x / CL;
  const int R = num_vecs(iters, final_row, robust);
  const int ka = robust ? num_arows(iters, final_row) : 0;
  const float sl2 = scale * kLog2e;
  Xchg xs{csum, xbar};
  if (CL == 2) exchange_init(xbar, 2);
  FRES_PHASE_INIT

  int unit = blockIdx.x / CL;
  if (unit < units) {
    load_tiles<NC>(tile(0, 0), q_all, (size_t)unit * items, items, K, N);
    load_tiles<NC>(tile(0, 1), k_all, (size_t)unit * items, items, K, N);
    load_tiles<NC>(tile(0, 2), v_all, (size_t)unit * items, items, K, N);
  }
  cp_async_commit();
  for (int i = 0; unit < units; ++i, unit += stride) {
    const int cur = i & 1;
    const size_t item0 = (size_t)unit * items;
    if (unit + stride < units) {  // the next unit's tiles, in flight during this one
      const size_t next0 = (size_t)(unit + stride) * items;
      load_tiles<NC>(tile(cur ^ 1, 0), q_all, next0, items, K, N);
      load_tiles<NC>(tile(cur ^ 1, 1), k_all, next0, items, K, N);
      load_tiles<NC>(tile(cur ^ 1, 2), v_all, next0, items, K, N);
    }
    cp_async_commit();
    if (robust)
      for (int idx = threadIdx.x; idx < ic; idx += kThreads) bcol[idx] = 1.f;
    cp_async_wait<1>();
    __syncthreads();
    FRES_PHASE(0);

    const WarpPos p = warp_pos<CL>(K, N, rank, unit);
    const int t = p.t;
    const int rowA = p.r0 + p.g, rowB = rowA + 8;
    const bool vA = p.live && rowA < N, vB = p.live && rowB < N;
    const __nv_bfloat16* qt = tile(cur, 0) + (size_t)p.slot * NC * kD;
    const __nv_bfloat16* kt = tile(cur, 1) + (size_t)p.slot * NC * kD;
    const __nv_bfloat16* vt = tile(cur, 2) + (size_t)p.slot * NC * kD;
    const float* bv = bcol + p.slot * NC;
    float* vec = vecs_all + (p.live ? p.item : 0) * R * N;

    // 1. e, the row max and sum, lse
    const uint32_t qa0 = lds_u32(qt + (size_t)rowA * kD + 2 * t);
    const uint32_t qa1 = lds_u32(qt + (size_t)rowB * kD + 2 * t);
    float e[NT][4];
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s_tile(e[nt], qa0, qa1, kt, nt, N);
      m0 = fmaxf(m0, fmaxf(e[nt][0], e[nt][1]));
      m1 = fmaxf(m1, fmaxf(e[nt][2], e[nt][3]));
    }
    // the row max in log2 units; +∞ on a dead row, whose e is then 0 (every
    // lane shuffles)
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    m0 = vA ? m0 * sl2 : INFINITY;
    m1 = vB ? m1 * sl2 : INFINITY;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      e[nt][0] = ex2(fmaf(e[nt][0], sl2, -m0));
      e[nt][1] = ex2(fmaf(e[nt][1], sl2, -m0));
      e[nt][2] = ex2(fmaf(e[nt][2], sl2, -m1));
      e[nt][3] = ex2(fmaf(e[nt][3], sl2, -m1));
      r0 += e[nt][0] + e[nt][1];
      r1 += e[nt][2] + e[nt][3];
    }
    r0 = quad_sum(r0);
    r1 = quad_sum(r1);
    const float ir0 = vA ? 1.f / r0 : 0.f, ir1 = vB ? 1.f / r1 : 0.f;
    if (t == 0) {
      if (vA) vec[(size_t)(R - 1) * N + rowA] = (m0 + log2f(r0)) * kLn2;
      if (vB) vec[(size_t)(R - 1) * N + rowB] = (m1 + log2f(r1)) * kLn2;
    }
    float as0 = ir0, as1 = ir1;  // a·inv_r, with a_0 = 1
    FRES_PHASE(1);

    // 2. the Sinkhorn chain
    if (robust) {
      for (int it = 0; it < iters; ++it) {
        if (it > 0) {
          const float2 rs = row_pass<NC>(e, bv);
          const float a0 = recip_rn(rs.x * ir0), a1 = recip_rn(rs.y * ir1);
          as0 = vA ? a0 * ir0 : 0.f;
          as1 = vB ? a1 * ir1 : 0.f;
          if (t == 0) {
            if (vA) vec[(size_t)(it - 1) * N + rowA] = a0;
            if (vB) vec[(size_t)(it - 1) * N + rowB] = a1;
          }
        }
        col_reduce<NC, CL>(e, as0, as1, part, xs, N, [&](int slot, int j, float s) {
          const float b = recip_rn(s);
          bcol[slot * NC + j] = j < N ? b : 1.f;
          const size_t item = item0 + slot;
          if (rank == 0 && j < N && item < (size_t)K)
            vecs_all[(item * R + ka + it) * N + j] = b;
        });
      }
      if (final_row) {
        const float2 rs = row_pass<NC>(e, bv);
        const float a0 = recip_rn(rs.x * ir0), a1 = recip_rn(rs.y * ir1);
        as0 = vA ? a0 * ir0 : 0.f;
        as1 = vB ? a1 * ir1 : 0.f;
        if (t == 0) {
          if (vA) vec[(size_t)(ka - 1) * N + rowA] = a0;
          if (vB) vec[(size_t)(ka - 1) * N + rowB] = a1;
        }
      }
    }
    FRES_PHASE(2);

    // 3. the output
    float acc[4];
    rowprod<NC>(acc, e, robust ? bv : nullptr, vt);
    __nv_bfloat16* out = out_all + (p.live ? p.item : 0) * N * kD;
    if (vA)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rowA * kD + 2 * t) =
          __floats2bfloat162_rn(acc[0] * as0, acc[1] * as0);
    if (vB)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rowB * kD + 2 * t) =
          __floats2bfloat162_rn(acc[2] * as1, acc[3] * as1);
    FRES_PHASE(3);
    __syncthreads();  // this unit's tiles and b read before they are replaced
  }
}

template <int NC>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* vecs, int K, int N,
               float scale, int robust, int iters, int final_row, cudaStream_t stream) {
  constexpr int CL = NC > kRows ? 2 : 1;
  return (int)launch(fused_resident_fwd_kernel<NC, CL>, res_units(K, N), CL,
                     fwd_smem_bytes(N), stream, static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                     static_cast<__nv_bfloat16*>(out), static_cast<float*>(vecs), K, N, scale,
                     robust, iters, final_row);
}

}  // namespace fres
}  // namespace nrv

// The branch rule, for the wrapper's check against its Python mirror.
extern "C" int nrv_fused_resident_fits(int N, int D, int DV, int robust, int iters) {
  return nrv::fres::resident_fits(N, D, DV, robust, iters) ? 1 : 0;
}

// bf16 only. Returns cudaErrorInvalidValue for a shape the branch does not
// take, else the launch's error.
extern "C" int nrv_fused_resident_fwd(const void* q, const void* k, const void* v, void* out,
                                      void* vecs, int K, int N, int D, int DV, float scale,
                                      int robust, int iters, int final_row, void* stream) {
  using namespace nrv::fres;
  if (K < 1 || !resident_fits(N, D, DV, robust, iters)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (res_cols(N)) {
    case 16: return launch_fwd<16>(q, k, v, out, vecs, K, N, scale, robust, iters, final_row, s);
    case 32: return launch_fwd<32>(q, k, v, out, vecs, K, N, scale, robust, iters, final_row, s);
    case 64: return launch_fwd<64>(q, k, v, out, vecs, K, N, scale, robust, iters, final_row, s);
    case 128:
      return launch_fwd<128>(q, k, v, out, vecs, K, N, scale, robust, iters, final_row, s);
    default:
      return launch_fwd<256>(q, k, v, out, vecs, K, N, scale, robust, iters, final_row, s);
  }
}
