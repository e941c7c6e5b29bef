// Fused LayerNorm, backward: from x [R, D] (float32 or bfloat16), the
// float32 scale g [D] and the upstream gradient dy [R, D] (x's dtype), the
// row moments recomputed in float32 as in the forward, then
//   xhat = (x − mean)·rstd, dxhat = dy·g,
//   dx = rstd·(dxhat − mean(dxhat) − xhat·mean(dxhat·xhat))   (x's dtype),
//   dg = Σ_rows dy·xhat, db = Σ_rows dy                       (float32 [D]).
//
// Replaces the TPU kernel noise_robust_vit_tpu/ops/pallas/fused_ln.py
// ::_bwd_impl (pl.pallas_call at :111, body _bwd_kernel :55-78), which
// writes per-block dg/db partials that XLA sums outside the kernel (:131).
// Here a second kernel sums them.
//
// What bounds it on the card (H100): the bytes. At SimpleViT-B/16's
// [50176, 768] bf16 it must read x and dy and write dx, 3 × 77.07 MB, ≥
// 0.069 ms at 3.35 TB/s; the partials add 2 × 4 bytes × D a block (2.4 MB
// there, 1% more). The design reads x and dy once and writes dx once.
//
// Design. The forward's layout. A warp or 8 lanes a row (fused_ln.cuh
// row_lanes): a lane's D/G elements in registers, the four row means from
// butterfly shuffles over the row's lanes; a block of 256 threads walks 128
// consecutive rows at G = 32 (16 a warp, a warp every 8th) or 256 at G = 8
// (8 a group, a group every 32nd), each lane adding dy·xhat and dy into
// per-column registers; the four groups of a warp then add their columns
// by shuffles in a fixed order. At G = 8 the groups walk 8 rows, not 16:
// their 98-195 registers a thread leave 1-2 blocks an SM, and 512-row
// blocks left a last, part-filled wave (on an H100 at [100352, 192] bf16
// 0.0632 against 0.0566 ms). Block path: one block a row at a time over 32
// consecutive rows, the rows of x and dy held in shared memory as float32,
// each thread on its own runs of four (and its own columns of the dg/db
// accumulators, also in shared memory). Each block writes its float32
// partials [blocks, D]: the warps' registers added in warp order through
// shared memory. The second kernel adds the partials over blocks in a
// fixed order (32 columns × NG strided groups a block, the groups added in
// order; NG = 8, or 32 after the 8-lane path, whose few columns leave few
// blocks for many partials). No atomics: two runs give the same bits.
#include "fused_ln.cuh"

namespace nrv {
namespace fln {

// v plus lane (lane ^ o)'s v, each component; the whole warp takes part.
__device__ __forceinline__ float4 add_xor4(float4 v, int o) {
  return make_float4(v.x + __shfl_xor_sync(0xffffffffu, v.x, o),
                     v.y + __shfl_xor_sync(0xffffffffu, v.y, o),
                     v.z + __shfl_xor_sync(0xffffffffu, v.z, o),
                     v.w + __shfl_xor_sync(0xffffffffu, v.w, o));
}

// G lanes a row, NC = D / (4G) runs of four a lane. Static shared memory:
// the warps' per-column partials, kWarps × D floats (32 KB at D = 1024).
template <typename T, int G, int NC>
__global__ void __launch_bounds__(kThreads)
fused_ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ g,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dg_part, float* __restrict__ db_part, int R,
                         float eps) {
  constexpr int D = 4 * G * NC;
  constexpr int kGroups = kThreads / G;        // rows a block holds at once
  constexpr int kRows = group_rows(G) * kGroups;  // rows a block walks
  __shared__ float4 stage[kWarps * D / 4];
  const int lane = threadIdx.x % G, warp = threadIdx.x >> 5, grp = threadIdx.x / G;
  float4 gv[NC], adg[NC], adb[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    gv[c] = load4(g + 4 * (G * c + lane));
    adg[c] = adb[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int row0 = blockIdx.x * kRows;
  for (int i = grp; i < kRows; i += kGroups) {
    const int row = row0 + i;
    if (row >= R) break;  // the row's lanes together
    const T* xr = x + (size_t)row * D;
    const T* dyr = dy + (size_t)row * D;
    float4 v[NC], w[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      v[c] = load4(xr + 4 * (G * c + lane));
      w[c] = load4(dyr + 4 * (G * c + lane));
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) s += sum4(v[c]);
    const float mu = lanes_sum<G>(s) / (float)D;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      v[c] = make_float4(v[c].x - mu, v[c].y - mu, v[c].z - mu, v[c].w - mu);
      q += ((v[c].x * v[c].x + v[c].y * v[c].y) + v[c].z * v[c].z) + v[c].w * v[c].w;
    }
    const float rstd = rsqrtf(lanes_sum<G>(q) / (float)D + eps);
    // v becomes xhat; m1 = Σ dxhat, m2 = Σ dxhat·xhat
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      v[c] = make_float4(v[c].x * rstd, v[c].y * rstd, v[c].z * rstd, v[c].w * rstd);
      const float4 d = make_float4(w[c].x * gv[c].x, w[c].y * gv[c].y, w[c].z * gv[c].z,
                                   w[c].w * gv[c].w);
      m1 += sum4(d);
      m2 += ((d.x * v[c].x + d.y * v[c].y) + d.z * v[c].z) + d.w * v[c].w;
    }
    m1 = lanes_sum<G>(m1) / (float)D;
    m2 = lanes_sum<G>(m2) / (float)D;
    T* dxr = dx + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 d = make_float4(w[c].x * gv[c].x, w[c].y * gv[c].y, w[c].z * gv[c].z,
                                   w[c].w * gv[c].w);
      store4(dxr + 4 * (G * c + lane),
             make_float4(rstd * (d.x - m1 - v[c].x * m2), rstd * (d.y - m1 - v[c].y * m2),
                         rstd * (d.z - m1 - v[c].z * m2), rstd * (d.w - m1 - v[c].w * m2)));
      adg[c].x += w[c].x * v[c].x;
      adg[c].y += w[c].y * v[c].y;
      adg[c].z += w[c].z * v[c].z;
      adg[c].w += w[c].w * v[c].w;
      adb[c].x += w[c].x;
      adb[c].y += w[c].y;
      adb[c].z += w[c].z;
      adb[c].w += w[c].w;
    }
  }
  // G < 32: the warp's groups hold the same columns; butterfly adds over
  // them leave every group with the warp's sums, in a fixed order
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      adg[c] = add_xor4(adg[c], o);
      adb[c] = add_xor4(adb[c], o);
    }
  }
  // the block's partials: the warps' columns added in warp order, dg then db
  for (int pass = 0; pass < 2; ++pass) {
    if ((threadIdx.x & 31) < G) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        stage[warp * (D / 4) + G * c + lane] = pass ? adb[c] : adg[c];
    }
    __syncthreads();
    float* out = (pass ? db_part : dg_part) + (size_t)blockIdx.x * D;
    for (int q = threadIdx.x; q < D / 4; q += kThreads) {
      float4 t = stage[q];
      for (int ww = 1; ww < kWarps; ++ww) {
        const float4 u = stage[ww * (D / 4) + q];
        t = make_float4(t.x + u.x, t.y + u.y, t.z + u.z, t.w + u.w);
      }
      store4(out + 4 * q, t);
    }
    __syncthreads();
  }
}

// One block a row, over kBlockRowsPerBlock consecutive rows. Dynamic shared
// memory: the rows of x and dy and the dg, db accumulators, 4 × D floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ln_bwd_block_kernel(const T* __restrict__ x, const float* __restrict__ g,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ dg_part, float* __restrict__ db_part, int R,
                          int D, float eps) {
  extern __shared__ float4 sm4[];
  __shared__ float red[kWarps];
  const int nq = D / 4;
  float4* xs = sm4;
  float4* ws = xs + nq;
  float4* adg = ws + nq;
  float4* adb = adg + nq;
  // every array is touched by a thread only at its own runs q ≡ tid (mod
  // kThreads): no barrier but block_sum's is needed
  for (int q = threadIdx.x; q < nq; q += kThreads)
    adg[q] = adb[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int row0 = blockIdx.x * kBlockRowsPerBlock;
  for (int i = 0; i < kBlockRowsPerBlock; ++i) {
    const int row = row0 + i;
    if (row >= R) break;  // the whole block
    const T* xr = x + (size_t)row * D;
    const T* dyr = dy + (size_t)row * D;
    float s = 0.f;
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const float4 v = load4(xr + 4 * q);
      xs[q] = v;
      ws[q] = load4(dyr + 4 * q);
      s += sum4(v);
    }
    const float mu = block_sum(s, red) / (float)D;
    float ss = 0.f;
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const float4 v = xs[q];
      const float4 c = make_float4(v.x - mu, v.y - mu, v.z - mu, v.w - mu);
      xs[q] = c;
      ss += ((c.x * c.x + c.y * c.y) + c.z * c.z) + c.w * c.w;
    }
    const float rstd = rsqrtf(block_sum(ss, red) / (float)D + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const float4 c = xs[q], w = ws[q], gg = load4(g + 4 * q);
      const float4 h = make_float4(c.x * rstd, c.y * rstd, c.z * rstd, c.w * rstd);
      xs[q] = h;
      const float4 d = make_float4(w.x * gg.x, w.y * gg.y, w.z * gg.z, w.w * gg.w);
      m1 += sum4(d);
      m2 += ((d.x * h.x + d.y * h.y) + d.z * h.z) + d.w * h.w;
    }
    m1 = block_sum(m1, red) / (float)D;
    m2 = block_sum(m2, red) / (float)D;
    T* dxr = dx + (size_t)row * D;
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const float4 h = xs[q], w = ws[q], gg = load4(g + 4 * q);
      const float4 d = make_float4(w.x * gg.x, w.y * gg.y, w.z * gg.z, w.w * gg.w);
      store4(dxr + 4 * q, make_float4(rstd * (d.x - m1 - h.x * m2), rstd * (d.y - m1 - h.y * m2),
                                      rstd * (d.z - m1 - h.z * m2), rstd * (d.w - m1 - h.w * m2)));
      float4 a = adg[q], bb = adb[q];
      a.x += w.x * h.x;
      a.y += w.y * h.y;
      a.z += w.z * h.z;
      a.w += w.w * h.w;
      bb.x += w.x;
      bb.y += w.y;
      bb.z += w.z;
      bb.w += w.w;
      adg[q] = a;
      adb[q] = bb;
    }
  }
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    store4(dg_part + (size_t)blockIdx.x * D + 4 * q, adg[q]);
    store4(db_part + (size_t)blockIdx.x * D + 4 * q, adb[q]);
  }
}

// dg[j] = Σ_b dg_part[b, j], db likewise. A block of 32 columns × NG
// groups; group y adds blocks y, y + NG, … in order, then the NG group sums
// are added in group order.
template <int NG>
__global__ void __launch_bounds__(32 * NG)
fused_ln_partials_sum_kernel(const float* __restrict__ dg_part,
                             const float* __restrict__ db_part, float* __restrict__ dg,
                             float* __restrict__ db, int blocks, int D) {
  __shared__ float sg[NG][32], sb[NG][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;  // D % 32 == 0: always < D
  float a = 0.f, b = 0.f;
  for (int k = grp; k < blocks; k += NG) {
    a += dg_part[(size_t)k * D + j];
    b += db_part[(size_t)k * D + j];
  }
  sg[grp][lane] = a;
  sb[grp][lane] = b;
  __syncthreads();
  if (grp == 0) {
    for (int y = 1; y < NG; ++y) {
      a += sg[y][lane];
      b += sb[y][lane];
    }
    dg[j] = a;
    db[j] = b;
  }
}

// The row kernels' arguments, for the dispatch by path.
struct BwdArgs {
  const void *x, *g, *dy;
  void* dx;
  float *dg_part, *db_part;
  int R;
  float eps;
  int blocks;
  cudaStream_t stream;
};

template <typename T, int G, int NC>
int launch_group(const BwdArgs& a) {
  fused_ln_bwd_rows_kernel<T, G, NC><<<a.blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.g), static_cast<const T*>(a.dy),
      static_cast<T*>(a.dx), a.dg_part, a.db_part, a.R, a.eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* x, const void* g, const void* dy, void* dx, float* dg_part,
                float* db_part, int R, int D, float eps, int blocks, cudaStream_t stream) {
  const BwdArgs a{x, g, dy, dx, dg_part, db_part, R, eps, blocks, stream};
  switch (row_lanes(D)) {  // the lane-group paths, by the runs a lane
    case 32:
      switch (D / 128) {
        case 1: return launch_group<T, 32, 1>(a);
        case 2: return launch_group<T, 32, 2>(a);
        case 3: return launch_group<T, 32, 3>(a);
        case 4: return launch_group<T, 32, 4>(a);
        case 5: return launch_group<T, 32, 5>(a);
        case 6: return launch_group<T, 32, 6>(a);
        case 7: return launch_group<T, 32, 7>(a);
        case 8: return launch_group<T, 32, 8>(a);
      }
      break;
    case 8:
      switch (D / 32) {  // 4 and 8 are the warp path's
        case 1: return launch_group<T, 8, 1>(a);
        case 2: return launch_group<T, 8, 2>(a);
        case 3: return launch_group<T, 8, 3>(a);
        case 5: return launch_group<T, 8, 5>(a);
        case 6: return launch_group<T, 8, 6>(a);
        case 7: return launch_group<T, 8, 7>(a);
      }
      break;
  }
  const size_t smem = 4 * sizeof(float) * (size_t)D;  // 128 KB at D = 8192
  cudaError_t err = cudaFuncSetAttribute(fused_ln_bwd_block_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_ln_bwd_block_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const T*>(dy),
      static_cast<T*>(dx), dg_part, db_part, R, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace fln
}  // namespace nrv

// Rows of the dg/db partials that nrv_fused_ln_bwd needs for R rows of D
// (the caller sizes its scratch with it); -1 outside the gate.
extern "C" int nrv_fused_ln_bwd_blocks(int R, int D) {
  using namespace nrv::fln;
  return R >= 1 && supported(D) ? bwd_blocks(R, D) : -1;
}

// dtype: 0 float32, 1 bfloat16. x, dy and dx [R, D] contiguous, 16-byte
// aligned; g float32 [D]; dg_part, db_part float32 [blocks, D] scratch with
// blocks = nrv_fused_ln_bwd_blocks(R, D); dg, db float32 [D]. Two launches
// on `stream`; returns cudaGetLastError() after them.
extern "C" int nrv_fused_ln_bwd(const void* x, const void* g, const void* dy, void* dx,
                                void* dg_part, void* db_part, void* dg, void* db, int dtype,
                                int R, int D, float eps, void* stream) {
  using namespace nrv::fln;
  if (R < 1 || !supported(D)) return (int)cudaErrorInvalidValue;
  const int blocks = bwd_blocks(R, D);
  auto s = static_cast<cudaStream_t>(stream);
  auto* pg = static_cast<float*>(dg_part);
  auto* pb = static_cast<float*>(db_part);
  int err;
  if (dtype == 0)
    err = launch_rows<float>(x, g, dy, dx, pg, pb, R, D, eps, blocks, s);
  else if (dtype == 1)
    err = launch_rows<__nv_bfloat16>(x, g, dy, dx, pg, pb, R, D, eps, blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  if (row_lanes(D) == 8)
    fused_ln_partials_sum_kernel<32><<<D / 32, 32 * 32, 0, s>>>(
        pg, pb, static_cast<float*>(dg), static_cast<float*>(db), blocks, D);
  else
    fused_ln_partials_sum_kernel<kWarps><<<D / 32, kThreads, 0, s>>>(
        pg, pb, static_cast<float*>(dg), static_cast<float*>(db), blocks, D);
  return (int)cudaGetLastError();
}
