// Streaming q/k/v-interface Sinkhorn attention, forward, split branch: bf16
// q [K, N, 64], k, v [K, M, 64] → out [K, N, 64] = a ⊙ (en·(b ⊙ v)) and the
// residual vectors av [K, 1 + n_av, N], bv [K, iters, M] (float32, as the
// tile branch's), without the N×M matrix in device memory.
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/
// streaming_sinkhorn.py::_stream_fwd_impl (pl.pallas_call at :397; body
// _stream_fwd_kernel), at the shapes of the split branch
// (streaming_split.cuh: the design, and what bounds it).
//
// Launches, in stream order (iters + 1 sweeps and iters reductions):
//   rows_kernel<kLse>     lse per row (online max), the first column sum of
//                         en (the first row norm is the identity after a
//                         softmax) as split partials;
//   reduce_kernel         b_0 = recip(Σ partials) into bv row 0;
//   for it = 1 … iters − 1:
//     rows_kernel<kSweep> a_it = recip(en·b_{it−1}) into av row it, the
//                         column partials of en ⊙ a_it;
//     reduce_kernel       b_it into bv row it;
//   out_kernel<kOut>      o = en·(b ⊙ v), r = en·b; out = a ⊙ o with a =
//                         recip(r) (final row norm, into av) or the last a.
#include "streaming_split.cuh"

namespace nrv {
namespace ssplit {

inline cudaError_t reduce_b(const Args& a, int row, cudaStream_t st) {
  Args r = a;
  r.vrow = row;
  return launch(reduce_kernel<kReduceB>, (int)(((size_t)a.K * a.M + 255) / 256), 256, 0, st, r);
}

}  // namespace ssplit
}  // namespace nrv

// The splits S of N query rows: the column partials' [K, S, M] rows.
extern "C" int nrv_streaming_split_splits(int N) {
  return (N + nrv::ssplit::kSplitRows - 1) / nrv::ssplit::kSplitRows;
}

// q, out [K, N, 64], k, v [K, M, 64] bf16; av float32 [K, 1 + n_av, N],
// bv float32 [K, iters, M]; part float32 scratch [K, S, M] with S =
// nrv_streaming_split_splits(N). Returns the first launch error, or
// cudaGetLastError().
extern "C" int nrv_streaming_split_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* av, void* bv, void* part, int K, int N, int M,
                                       int D, float scale, int iters, int final_row,
                                       void* stream) {
  using namespace nrv::ssplit;
  if (int err = check(K, N, M, D, iters, final_row)) return err;
  auto st = static_cast<cudaStream_t>(stream);
  Args a = base_args(K, N, M, scale, iters, final_row);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.av = static_cast<float*>(av);
  a.bv = static_cast<float*>(bv);
  a.part = static_cast<float*>(part);
  const int sweep_blocks = K * a.S;
  cudaError_t err = launch(rows_kernel<kLse>, sweep_blocks, kRowThreads, kRowsSmem, st, a);
  if (err == cudaSuccess) err = reduce_b(a, 0, st);
  for (int it = 1; it < iters && err == cudaSuccess; ++it) {
    Args s = a;
    s.vrow = it - 1;
    s.arow = it;
    err = launch(rows_kernel<kSweep>, sweep_blocks, kRowThreads, kRowsSmem, st, s);
    if (err == cudaSuccess) err = reduce_b(a, it, st);
  }
  if (err == cudaSuccess) {
    const int blocks = K * ((N + kProductRows - 1) / kProductRows);
    err = launch(out_kernel<kOut>, blocks, kRowThreads, kOutSmem, st, a);
  }
  return (int)err;
}
