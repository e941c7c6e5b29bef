// Fused q/k/v attention, backward: dq, dk, dv of the forward in
// fused_attention_fwd.cu from q, k, v, the upstream gradient g and the
// stored residual rows.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// sinkhorn_attention.py::_fused_attention_bwd_impl (pl.pallas_call at
// :694), whose body is _bwd_math_batched with the residual stack. The
// design, and what bounds it, are in fused_attention.cuh: no N×N matrix is
// stored; each pass forms the entries A_ij = exp(scale·q_i·k_j − lse_i) it
// needs from q, k and lse in shared memory.
//
// Forward is O = diag(a)·A·diag(b)·V (a = b = 1 when vanilla). The math is
// sinkhorn_chain.cuh's (_bwd_math_batched, _reverse_chain_inner), with
// each N×N product a pass:
//   B1 rows:    o/a = A·(b⊙V), da = rowsum(G ⊙ o/a); robust with a final
//               row norm: dr_F = −da·a², svec = −da·a (its reverse node).
//   B2 columns: t1 = Aᵀ·(a⊙G), dV = b ⊙ t1, db = rowsum(t1 ⊙ V), plus
//               Aᵀ·dr_F; dc = db·(−b²) for the last b-node.
//   robust, for t = iters − 1 … 0, the reverse chain:
//     rows:     m = A·dc_t; t > 0: svec += a_t·m − da'·a_t (da' = m, plus
//               da at the chain's head when there is no final row norm),
//               dr_t = −da'·a_t²; t = 0: svec += m.
//     columns (t > 0): dc_{t−1} = (Aᵀ·dr_t)·(−b_t²).
//   The rank-1 terms u_k·v_kᵀ of dA are not formed: ds reads them as Σ_k
//   u_k[i]·v_k[j] while it walks the entries.
//   DQ rows:    ds_ij = A_ij·((a_i·(G_i·V_j)·b_j − ρ_i) + Σ_k u_k[i]·v_k[j])
//               with ρ = a ⊙ da + svec (rowsum(dA ⊙ A) by identity);
//               dQ_i = scale·Σ_j ds_ij·K_j.
//   DK columns: the same ds_ij; dK_j = scale·Σ_i ds_ij·Q_i.
// At (3, final) that is nine passes; vanilla takes four.
#include "fused_attention.cuh"

namespace nrv {

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
fused_attention_bwd_kernel(const T* __restrict__ q_all, const T* __restrict__ k_all,
                           const T* __restrict__ v_all, const T* __restrict__ g_all,
                           const float* __restrict__ vecs_all, T* __restrict__ dq_all,
                           T* __restrict__ dk_all, T* __restrict__ dv_all, int K, int N, int D,
                           int DV, float scale, int robust, int iters, int final_row) {
  extern __shared__ float smem[];
  // rank-1 terms of dA: row factor at vb + tu[k], column factor at vb + tv[k]
  __shared__ int tu[kMaxTerms], tv[kMaxTerms];
  const int P = fused_threads_per_item(N);
  const int slot = threadIdx.x / P, t = threadIdx.x % P;
  const size_t item = (size_t)blockIdx.x * (kThreads / P) + slot;
  const bool live = item < (size_t)K;
  const int it = robust ? iters : 0;
  const int ka = robust ? num_arows(iters, final_row) : 0;
  const int R = num_vecs(iters, final_row, robust);
  const bool fin = robust && final_row;
  const int ldv = padded_ld(N);
  float* qs = smem + slot * fused_bwd_item_floats(N, D, DV, it);
  float* ks = qs + (size_t)N * D;
  float* vs = ks + (size_t)N * D;
  float* gs = vs + (size_t)N * DV;
  float* vb = gs + (size_t)N * DV;  // the item's vectors
  float* lse = vb;
  float* ones = lse + ldv;
  float* da = ones + ldv;
  float* svec = da + ldv;
  float* rterm = svec + ldv;
  float* arows = rterm + ldv;
  float* brows = arows + (size_t)it * ldv;
  float* dcs = brows + (size_t)it * ldv;
  float* drs = dcs + (size_t)it * ldv;
  auto as_r = [&](int s) { return s == 0 ? ones : arows + (size_t)(s - 1) * ldv; };
  auto bs_r = [&](int s) { return s == 0 ? ones : brows + (size_t)(s - 1) * ldv; };
  // dr_F takes slot 0; the chain's step s the next ones, from the top down
  auto dr_at = [&](int s) { return drs + (size_t)((fin ? 1 : 0) + iters - 1 - s) * ldv; };
  const float* a_fin = as_r(ka);
  const float* b_fin = robust ? bs_r(iters) : ones;

  // the rank-1 terms in _reverse_chain_inner's order
  int nt = 0;
  if (robust) {
    if (fin) {
      if (threadIdx.x == 0) {
        tu[nt] = (int)(drs - vb);
        tv[nt] = (int)(bs_r(iters) - vb);
      }
      ++nt;
    }
    for (int s = iters - 1; s >= 0; --s) {
      if (threadIdx.x == 0) {
        tu[nt] = (int)(as_r(s) - vb);
        tv[nt] = (int)(dcs + (size_t)s * ldv - vb);
      }
      ++nt;
      if (s == 0) break;
      if (threadIdx.x == 0) {
        tu[nt] = (int)(dr_at(s) - vb);
        tv[nt] = (int)(bs_r(s) - vb);
      }
      ++nt;
    }
  }

  if (live) {
    fused_load(qs, q_all + item * N * D, N * D, t, P);
    fused_load(ks, k_all + item * N * D, N * D, t, P);
    fused_load(vs, v_all + item * N * DV, N * DV, t, P);
    fused_load(gs, g_all + item * N * DV, N * DV, t, P);
    const float* vec = vecs_all + item * R * N;
    for (int i = t; i < N; i += P) {
      lse[i] = vec[(size_t)(R - 1) * N + i];
      ones[i] = 1.f;
      for (int r = 0; r < ka; ++r) arows[(size_t)r * ldv + i] = vec[(size_t)r * N + i];
      for (int r = 0; r < it; ++r) brows[(size_t)r * ldv + i] = vec[(size_t)(ka + r) * N + i];
    }
  }
  __syncthreads();

  // B1 rows: da, and the final row norm's reverse node
  if (live) {
    for (int i = t; i < N; i += P) {
      float qi[DM], gi[DM], oa[DM];
      row_load(qi, qs + (size_t)i * D, D);
      row_load(gi, gs + (size_t)i * DV, DV);
#pragma unroll
      for (int c = 0; c < DM; ++c) oa[c] = 0.f;
      const float li = lse[i];
      for (int j = 0; j < N; ++j)
        row_axpy(oa, fused_weight(qi, ks + (size_t)j * D, D, scale, li) * b_fin[j],
                 vs + (size_t)j * DV, DV);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < DM; ++c) d = fmaf(gi[c], oa[c], d);
      da[i] = d;
      if (fin) {
        const float tmp = d * a_fin[i];
        drs[i] = -(tmp * a_fin[i]);
        svec[i] = -tmp;
      } else {
        svec[i] = 0.f;
      }
      if (!robust) rterm[i] = d;
    }
  }
  __syncthreads();

  // B2 columns: dV, db (+ Aᵀ·dr_F), and the last b-node's dc
  if (live) {
    T* dv = dv_all + item * N * DV;
    for (int j = t; j < N; j += P) {
      float kj[DM], vj[DM], t1[DM];
      row_load(kj, ks + (size_t)j * D, D);
      row_load(vj, vs + (size_t)j * DV, DV);
#pragma unroll
      for (int c = 0; c < DM; ++c) t1[c] = 0.f;
      float cs = 0.f;
      for (int i = 0; i < N; ++i) {
        const float w = fused_weight(kj, qs + (size_t)i * D, D, scale, lse[i]);
        row_axpy(t1, w * a_fin[i], gs + (size_t)i * DV, DV);
        if (fin) cs = fmaf(w, drs[i], cs);
      }
      const float bj = b_fin[j];
      float db = 0.f;
#pragma unroll
      for (int c = 0; c < DM; ++c) {
        if (c < DV) store_f(dv + (size_t)j * DV + c, bj * t1[c]);
        db = fmaf(t1[c], vj[c], db);
      }
      if (robust) dcs[(size_t)(iters - 1) * ldv + j] = (db + cs) * -(bj * bj);
    }
  }
  __syncthreads();

  // the reverse chain
  if (robust) {
    for (int s = iters - 1; s >= 0; --s) {
      const float* dc = dcs + (size_t)s * ldv;
      if (live) {
        const float* a_t = as_r(s);
        float* dr = s > 0 ? dr_at(s) : nullptr;
        const bool head = !final_row && s == iters - 1;
        for (int i = t; i < N; i += P) {
          float qi[DM];
          row_load(qi, qs + (size_t)i * D, D);
          const float li = lse[i];
          float m = 0.f;
          for (int j = 0; j < N; ++j)
            m = fmaf(fused_weight(qi, ks + (size_t)j * D, D, scale, li), dc[j], m);
          if (s == 0) {
            const float sv = svec[i] + m;
            svec[i] = sv;
            rterm[i] = a_fin[i] * da[i] + sv;
          } else {
            const float at = a_t[i];
            const float sv = svec[i] + at * m;
            const float tmp = (head ? da[i] + m : m) * at;
            svec[i] = sv - tmp;
            dr[i] = -(tmp * at);
          }
        }
      }
      __syncthreads();
      if (s == 0) break;
      if (live) {
        const float* dr = dr_at(s);
        const float* b_t = bs_r(s);
        float* dc_next = dcs + (size_t)(s - 1) * ldv;
        for (int j = t; j < N; j += P) {
          float kj[DM];
          row_load(kj, ks + (size_t)j * D, D);
          float cs = 0.f;
          for (int i = 0; i < N; ++i)
            cs = fmaf(fused_weight(kj, qs + (size_t)i * D, D, scale, lse[i]), dr[i], cs);
          dc_next[j] = cs * -(b_t[j] * b_t[j]);
        }
      }
      __syncthreads();
    }
  }

  // DQ rows
  if (live) {
    T* dq = dq_all + item * N * D;
    for (int i = t; i < N; i += P) {
      float qi[DM], gi[DM], acc[DM], u[kMaxTerms];
      row_load(qi, qs + (size_t)i * D, D);
      row_load(gi, gs + (size_t)i * DV, DV);
#pragma unroll
      for (int c = 0; c < DM; ++c) acc[c] = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxTerms; ++k) u[k] = k < nt ? vb[tu[k] + i] : 0.f;
      const float li = lse[i], ai = a_fin[i], rt = rterm[i];
      for (int j = 0; j < N; ++j) {
        const float w = fused_weight(qi, ks + (size_t)j * D, D, scale, li);
        const float gv = row_dot(gi, vs + (size_t)j * DV, DV);
        float r1 = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxTerms; ++k)
          if (k < nt) r1 = fmaf(u[k], vb[tv[k] + j], r1);
        const float ds = w * ((ai * gv * b_fin[j] - rt) + r1);
        row_axpy(acc, ds, ks + (size_t)j * D, D);
      }
#pragma unroll
      for (int c = 0; c < DM; ++c)
        if (c < D) store_f(dq + (size_t)i * D + c, scale * acc[c]);
    }
  }

  // DK columns (reads only what the passes above left; no barrier needed)
  if (live) {
    T* dk = dk_all + item * N * D;
    for (int j = t; j < N; j += P) {
      float kj[DM], vj[DM], acc[DM], w_[kMaxTerms];
      row_load(kj, ks + (size_t)j * D, D);
      row_load(vj, vs + (size_t)j * DV, DV);
#pragma unroll
      for (int c = 0; c < DM; ++c) acc[c] = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxTerms; ++k) w_[k] = k < nt ? vb[tv[k] + j] : 0.f;
      const float bj = b_fin[j];
      for (int i = 0; i < N; ++i) {
        const float w = fused_weight(kj, qs + (size_t)i * D, D, scale, lse[i]);
        const float gv = row_dot(vj, gs + (size_t)i * DV, DV);
        float r1 = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxTerms; ++k)
          if (k < nt) r1 = fmaf(vb[tu[k] + i], w_[k], r1);
        const float ds = w * ((a_fin[i] * gv * bj - rterm[i]) + r1);
        row_axpy(acc, ds, qs + (size_t)i * D, D);
      }
#pragma unroll
      for (int c = 0; c < DM; ++c)
        if (c < D) store_f(dk + (size_t)j * D + c, scale * acc[c]);
    }
  }
}

template <typename T, int DM>
int launch_fused_bwd(const void* q, const void* k, const void* v, const void* g,
                     const void* vecs, void* dq, void* dk, void* dv, int K, int N, int D, int DV,
                     float scale, int robust, int iters, int final_row, cudaStream_t stream) {
  auto kernel = fused_attention_bwd_kernel<T, DM>;
  size_t limit = 0;
  cudaError_t err = fused_smem_limit(kernel, limit);
  if (err != cudaSuccess) return (int)err;
  if (!fused_check(K, N, D, DV, robust, iters, limit)) return (int)cudaErrorInvalidValue;
  const size_t smem = fused_bwd_smem_bytes(N, D, DV, robust ? iters : 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kThreads / fused_threads_per_item(N);
  kernel<<<(K + per_block - 1) / per_block, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(vecs), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), K, N, D, DV, scale, robust, iters, final_row);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused_bwd_width(const void* q, const void* k, const void* v, const void* g,
                           const void* vecs, void* dq, void* dk, void* dv, int K, int N, int D,
                           int DV, float scale, int robust, int iters, int final_row,
                           cudaStream_t stream) {
  const int w = D > DV ? D : DV;
  if (w <= 8)
    return launch_fused_bwd<T, 8>(q, k, v, g, vecs, dq, dk, dv, K, N, D, DV, scale, robust,
                                  iters, final_row, stream);
  if (w <= 16)
    return launch_fused_bwd<T, 16>(q, k, v, g, vecs, dq, dk, dv, K, N, D, DV, scale, robust,
                                   iters, final_row, stream);
  return launch_fused_bwd<T, 32>(q, k, v, g, vecs, dq, dk, dv, K, N, D, DV, scale, robust,
                                 iters, final_row, stream);
}

}  // namespace nrv

// dtype: 0 float32, 1 bfloat16. Returns cudaErrorInvalidValue for a shape
// outside the gate, else cudaGetLastError() after the launch.
extern "C" int nrv_fused_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* g, const void* vecs, void* dq, void* dk,
                                       void* dv, int dtype, int K, int N, int D, int DV,
                                       float scale, int robust, int iters, int final_row,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nrv::launch_fused_bwd_width<float>(q, k, v, g, vecs, dq, dk, dv, K, N, D, DV, scale,
                                              robust, iters, final_row, s);
  if (dtype == 1)
    return nrv::launch_fused_bwd_width<__nv_bfloat16>(q, k, v, g, vecs, dq, dk, dv, K, N, D,
                                                      DV, scale, robust, iters, final_row, s);
  return (int)cudaErrorInvalidValue;
}
