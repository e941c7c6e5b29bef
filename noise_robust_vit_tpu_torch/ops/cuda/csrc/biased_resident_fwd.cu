// Biased (windowed) attention, forward, resident branch: softmax, or softmax
// + Sinkhorn in scaling-vector form, of s = scale·q·kᵀ + bias, and the
// residual rows the backward starts from; bf16 q, k [BW, H, N, D], v [BW,
// H, N, DV], N ≤ 64, D and DV each 16, 32 or 64.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// biased_attention.py::_biased_fwd_impl (pl.pallas_call at :230), whose
// body is sinkhorn_attention.py::_fwd_math_batched with _add_bias, at the
// shapes of the resident branch (biased_resident.cuh: the design, the walk
// over units that share a bias row, and what bounds it). Each image's
// matrix is formed once, on the tensor cores, and every pass reads it from
// registers:
//   1. s = scale·q·kᵀ + bias (the bias after the scale, read from the
//      unit's fragment-order copy), −∞ past N; e = exp(s − m), m the row
//      max; r = Σ_j e_ij, lse = m + log r, inv_r = 1 / r.
//   2. robust, for t = 0 … iters − 1: (t > 0) a row pass, a = recip(e·b ·
//      inv_r); a column pass, b = recip(eᵀ·(a·inv_r)). With final_row, one
//      more row pass for the final a.
//   3. out = ((e⊙b)·V)·a·inv_r on m16n8k16, e split into bf16 hi + lo.
// Vanilla is steps 1 and 3.
//
// Layout as the shared-memory kernels': out [BW, H, N, DV] bf16; vecs [BW,
// H, R, N] float32, the a-rows, the b-rows and lse (robust), lse alone
// (vanilla), so either branch's forward feeds either branch's backward.
#include "biased_resident.cuh"

namespace nrv {
namespace bres {

// Four blocks an SM (16 warps): the forward fits 128 registers a thread
// (8 bytes of spills at N ≤ 32), and twice the warps of one block an SM
// hide more of each image's latency.
template <int NC>
__global__ void __launch_bounds__(kThreads, 4)
biased_resident_fwd_kernel(const __nv_bfloat16* __restrict__ q_all,
                           const __nv_bfloat16* __restrict__ k_all,
                           const __nv_bfloat16* __restrict__ v_all,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out_all,
                           float* __restrict__ vecs_all, Shape s, float scale, int robust,
                           int iters, int final_row) {
  constexpr int NT = NC / 8, S = NC / 16, ITEMS = kWarps / S;
  extern __shared__ __align__(16) uint8_t smem[];
  const int N = s.N, D = s.D, DV = s.DV;
  const int slot_elems = NC * (2 * D + DV);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][ITEMS][q | k | v]
  float* biasf = reinterpret_cast<float*>(tiles + 2 * ITEMS * slot_elems);  // [kWarps][16·NC]
  float* parts = biasf + kWarps * 16 * NC;                                  // [ITEMS][S·NC]
  float* bcol = parts + kWarps * NC;                                        // [ITEMS][NC]
  const Walk walk(s);
  const Warp p = warp_of(S);
  const int tid = p.strip * 32 + p.lane, nthreads = 2 * NC;
  const int R = num_vecs(iters, final_row, robust);
  const int ka = robust ? num_arows(iters, final_row) : 0;
  auto tile = [&](int buf, int which) {
    __nv_bfloat16* b = tiles + (size_t)(buf * ITEMS + p.slot) * slot_elems;
    return which == 0 ? b : which == 1 ? b + NC * D : b + 2 * NC * D;
  };
  auto issue = [&](int buf, size_t item) {
    load_rows<NC>(tile(buf, 0), q_all, item, N, D, tid, nthreads);
    load_rows<NC>(tile(buf, 1), k_all, item, N, D, tid, nthreads);
    load_rows<NC>(tile(buf, 2), v_all, item, N, DV, tid, nthreads);
  };
  float* frag = biasf + p.warp * 16 * NC;
  float* part = parts + p.slot * S * NC;
  float* bv = bcol + p.slot * NC;
  const int rowA = p.r0 + p.g, rowB = rowA + 8;
  const bool vA = rowA < N, vB = rowB < N;
  BRES_PHASE_INIT

  // this slot's units: blockIdx.x·ITEMS + slot, then every stride-th
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
  for (int i = 0, buf = 0; u < walk.units; buf ^= 1) {
    // the next step: the unit's next image, or the next unit's first
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
    float* vec = vecs_all + item * R * N;

    // 1. s = scale·q·kᵀ + bias, the row max, e, lse
    float e[NT][4];
    nt_product<NC>(e, tile(buf, 0), tile(buf, 1), D, p);
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 b = bias ? *reinterpret_cast<const float4*>(frag + (nt * 32 + p.lane) * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const int col = 8 * nt + 2 * p.t;
      e[nt][0] = col < N ? fmaf(e[nt][0], scale, b.x) : -INFINITY;
      e[nt][1] = col + 1 < N ? fmaf(e[nt][1], scale, b.y) : -INFINITY;
      e[nt][2] = col < N ? fmaf(e[nt][2], scale, b.z) : -INFINITY;
      e[nt][3] = col + 1 < N ? fmaf(e[nt][3], scale, b.w) : -INFINITY;
      m0 = fmaxf(m0, fmaxf(e[nt][0], e[nt][1]));
      m1 = fmaxf(m1, fmaxf(e[nt][2], e[nt][3]));
    }
    // the row max in log2 units; +∞ on a dead row, whose e is then 0 (every
    // lane shuffles)
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    // the bias entries are read: the next unit's row may replace them
    if (ni == 0 && nu < walk.units && bias) {
      __syncwarp();
      load_bias<NC>(frag, bias, walk.pair(nu), N, p);
    }
    cp_async_commit();
    const float l0 = vA ? m0 * kLog2e : INFINITY, l1 = vB ? m1 * kLog2e : INFINITY;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      e[nt][0] = ex2(fmaf(e[nt][0], kLog2e, -l0));
      e[nt][1] = ex2(fmaf(e[nt][1], kLog2e, -l0));
      e[nt][2] = ex2(fmaf(e[nt][2], kLog2e, -l1));
      e[nt][3] = ex2(fmaf(e[nt][3], kLog2e, -l1));
      r0 += e[nt][0] + e[nt][1];
      r1 += e[nt][2] + e[nt][3];
    }
    r0 = quad_sum(r0);
    r1 = quad_sum(r1);
    const float ir0 = vA ? 1.f / r0 : 0.f, ir1 = vB ? 1.f / r1 : 0.f;
    if (p.t == 0) {
      if (vA) vec[(size_t)(R - 1) * N + rowA] = (l0 + log2f(r0)) * kLn2;
      if (vB) vec[(size_t)(R - 1) * N + rowB] = (l1 + log2f(r1)) * kLn2;
    }
    float as0 = ir0, as1 = ir1;  // a·inv_r, with a_0 = 1
    BRES_PHASE(1);

    // 2. the Sinkhorn chain
    if (robust) {
      for (int it = 0; it < iters; ++it) {
        if (it > 0) {
          const float2 rs = row_pass<NC>(e, bv);
          const float a0 = recip_rn(rs.x * ir0), a1 = recip_rn(rs.y * ir1);
          as0 = vA ? a0 * ir0 : 0.f;
          as1 = vB ? a1 * ir1 : 0.f;
          if (p.t == 0) {
            if (vA) vec[(size_t)(it - 1) * N + rowA] = a0;
            if (vB) vec[(size_t)(it - 1) * N + rowB] = a1;
          }
        }
        col_reduce<NC>(e, as0, as1, part, p, S, [&](int j, float sum) {
          const float b = recip_rn(sum);
          bv[j] = j < N ? b : 1.f;
          if (j < N) vec[(size_t)(ka + it) * N + j] = b;
        });
      }
      if (final_row) {
        const float2 rs = row_pass<NC>(e, bv);
        const float a0 = recip_rn(rs.x * ir0), a1 = recip_rn(rs.y * ir1);
        as0 = vA ? a0 * ir0 : 0.f;
        as1 = vB ? a1 * ir1 : 0.f;
        if (p.t == 0) {
          if (vA) vec[(size_t)(ka - 1) * N + rowA] = a0;
          if (vB) vec[(size_t)(ka - 1) * N + rowB] = a1;
        }
      }
    }
    BRES_PHASE(2);

    // 3. the output
    {
      uint32_t hi[NC / 16][4], lo[NC / 16][4];
      row_frags<NC>(hi, lo, e, robust ? bv : nullptr, p.t);
      __nv_bfloat16* out = out_all + item * N * DV;
      row_product<NC>(hi, lo, tile(buf, 2), DV, p, [&](int c, const float(&acc)[4]) {
        if (vA)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rowA * DV + c + 2 * p.t) =
              __floats2bfloat162_rn(acc[0] * as0, acc[1] * as0);
        if (vB)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rowB * DV + c + 2 * p.t) =
              __floats2bfloat162_rn(acc[2] * as1, acc[3] * as1);
      });
    }
    BRES_PHASE(3);
    slot_sync<NC>(p, S);  // this step's tiles and b read before they are replaced
    u = nu;
    i = ni;
    first = nfirst;
    count = ncount;
  }
}

template <int NC>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
               void* vecs, const Shape& s, float scale, int robust, int iters, int final_row,
               cudaStream_t stream) {
  const auto kernel = biased_resident_fwd_kernel<NC>;
  const size_t smem = fwd_smem_bytes(s.N, s.D, s.DV);
  int blocks = 0;
  const cudaError_t err = resident_blocks(kernel, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  const int items = res_items(s.N), units = Walk(s).units;
  const int need = (units + items - 1) / items, grid = need < blocks ? need : blocks;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(vecs), s, scale, robust, iters,
      final_row);
  return (int)cudaGetLastError();
}

// Blocks of the forward resident on the card at once (the persistent grid).
cudaError_t fwd_resident_blocks(int n, int d, int dv, int& blocks) {
  const size_t smem = fwd_smem_bytes(n, d, dv);
  switch (res_cols(n)) {
    case 16: return resident_blocks(biased_resident_fwd_kernel<16>, smem, blocks);
    case 32: return resident_blocks(biased_resident_fwd_kernel<32>, smem, blocks);
    default: return resident_blocks(biased_resident_fwd_kernel<64>, smem, blocks);
  }
}

}  // namespace bres
}  // namespace nrv

// The branch rule, for the wrapper's check against its Python mirror.
extern "C" int nrv_biased_resident_fits(int N, int D, int DV, int robust, int iters) {
  return nrv::bres::resident_fits(N, D, DV, robust, iters) ? 1 : 0;
}

// Blocks of one direction's kernel (bwd 0 or 1) resident on the card at
// once at this shape: the persistent grid's size, for the wrapper's choice
// of chunks. Returns minus the CUDA error on failure.
extern "C" int nrv_biased_resident_blocks(int N, int D, int DV, int robust, int iters, int bwd) {
  using namespace nrv::bres;
  if (!resident_fits(N, D, DV, robust, iters)) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = bwd ? bwd_resident_blocks(N, D, DV, robust ? iters : 0, blocks)
                              : fwd_resident_blocks(N, D, DV, blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// bf16 only; bias null when there is none. Returns cudaErrorInvalidValue
// for a shape the branch does not take or a walk that does not cover the
// images, else the launch's error.
extern "C" int nrv_biased_resident_fwd(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, void* vecs, int BW, int H,
                                       int N, int D, int DV, int nW, float scale, int robust,
                                       int iters, int final_row, int chunks, int per,
                                       void* stream) {
  using namespace nrv::bres;
  const Shape s{BW, H, N, D, DV, nW, chunks, per};
  if (!walk_ok(s) || !resident_fits(N, D, DV, robust, iters)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define NRV_BRES_FWD(nc) \
  launch_fwd<nc>(q, k, v, bias, out, vecs, s, scale, robust, iters, final_row, st)
  switch (res_cols(N)) {
    case 16: return NRV_BRES_FWD(16);
    case 32: return NRV_BRES_FWD(32);
    default: return NRV_BRES_FWD(64);
  }
#undef NRV_BRES_FWD
}
