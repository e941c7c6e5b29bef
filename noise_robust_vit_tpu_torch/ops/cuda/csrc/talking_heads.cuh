// Pieces shared by the talking-heads kernels (talking_heads_{fwd,bwd}.cu):
// the head mix of an image's H planes into one matrix, the elementwise mix
// of whole planes, and the per-block sums of the H×H parameter gradients.
#pragma once

#include "sinkhorn_softmax.cuh"

namespace nrv {

constexpr int kMaxHeads = 16;

// E[i, j] = op(i, Σ_h coef[h]·planes[h·nn + i·n + j]) in float32 for an
// image's H contiguous n×n planes (nn = n·n apart), E with row stride ld.
// Runs of four along a row when n is a multiple of 4, else one element a
// thread; a thread issues all H loads before it uses any. Ends with a
// barrier.
template <typename T, class Op>
__device__ inline void mix_load(const T* planes, size_t nn, int H, const float* coef, int n,
                                int ld, float* E, Op op) {
  if (n % 4 == 0) {
    for (int r = threadIdx.x; r < n * n / 4; r += kThreads) {
      const int f = 4 * r, i = f / n, j = f - i * n;
      float4 x[kMaxHeads];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) x[h] = value(run4(planes + h * nn + f));
      float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) {
          const float c = coef[h];
          m = make_float4(fmaf(c, x[h].x, m.x), fmaf(c, x[h].y, m.y), fmaf(c, x[h].z, m.z),
                          fmaf(c, x[h].w, m.w));
        }
      *reinterpret_cast<float4*>(E + (size_t)i * ld + j) =
          make_float4(op(i, m.x), op(i, m.y), op(i, m.z), op(i, m.w));
    }
  } else {
    for (int f = threadIdx.x; f < n * n; f += kThreads) {
      const int i = f / n, j = f - i * n;
      float x[kMaxHeads];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) x[h] = to_f(planes[h * nn + f]);
      float m = 0.f;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) m = fmaf(coef[h], x[h], m);
      E[(size_t)i * ld + j] = op(i, m);
    }
  }
  __syncthreads();
}

// out[h] = Σ over the block's threads of acc[h], h < H, summed in a fixed
// order (each warp, then the warps in turn). `red` holds kWarps·kMaxHeads
// floats. Ends with a barrier.
__device__ inline void block_sum_heads(const float (&acc)[kMaxHeads], int H, float* red,
                                       float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h)
    if (h < H) {
      const float s = warp_sum(acc[h]);
      if (lane == 0) red[warp * kMaxHeads + h] = s;
    }
  __syncthreads();
  if (threadIdx.x < H) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w * kMaxHeads + threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// Y[b, r] = Σ_c mix(c, r)·X[b, c] over whole planes of nn elements, with
// mix(c, r) = mix[c·H + r] (the forward's post-mix, y_q = Σ_g post[g, q]·w_g)
// or, transposed, mix[r·H + c] (the backward's pre-mix,
// ds_h = Σ_g pre[h, g]·dm_g). X float32 [B, H, nn]; Y in T. Runs of four
// when nn is a multiple of 4.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mix_planes_kernel(const float* __restrict__ X, const float* __restrict__ mix,
                  T* __restrict__ Y, int B, int H, size_t nn, int transpose) {
  __shared__ float coef[kMaxHeads * kMaxHeads];  // coef[c·kMaxHeads + r]
  for (int t = threadIdx.x; t < H * H; t += kThreads) {
    const int c = t / H, r = t % H;
    coef[c * kMaxHeads + r] = transpose ? mix[r * H + c] : mix[c * H + r];
  }
  __syncthreads();
  const int vec = nn % 4 == 0 ? 4 : 1;
  const size_t per_plane = nn / vec;
  const size_t units = (size_t)B * per_plane;
  for (size_t u = (size_t)blockIdx.x * kThreads + threadIdx.x; u < units;
       u += (size_t)gridDim.x * kThreads) {
    const size_t b = u / per_plane, f = (u - b * per_plane) * vec;
    const float* x0 = X + b * H * nn + f;
    T* y0 = Y + b * H * nn + f;
    if (vec == 4) {
      float4 x[kMaxHeads];
#pragma unroll
      for (int c = 0; c < kMaxHeads; ++c)
        if (c < H) x[c] = *reinterpret_cast<const float4*>(x0 + c * nn);
      for (int r = 0; r < H; ++r) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kMaxHeads; ++c)
          if (c < H) {
            const float w = coef[c * kMaxHeads + r];
            acc = make_float4(fmaf(w, x[c].x, acc.x), fmaf(w, x[c].y, acc.y),
                              fmaf(w, x[c].z, acc.z), fmaf(w, x[c].w, acc.w));
          }
        store4(y0 + r * nn, acc);
      }
    } else {
      float x[kMaxHeads];
#pragma unroll
      for (int c = 0; c < kMaxHeads; ++c)
        if (c < H) x[c] = x0[c * nn];
      for (int r = 0; r < H; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxHeads; ++c)
          if (c < H) acc = fmaf(coef[c * kMaxHeads + r], x[c], acc);
        store_f(y0 + r * nn, acc);
      }
    }
  }
}

template <typename T>
int launch_mix_planes(const float* X, const float* mix, T* Y, int B, int H, size_t nn,
                      int transpose, cudaStream_t stream) {
  const size_t units = (size_t)B * (nn % 4 == 0 ? nn / 4 : nn);
  const size_t blocks = (units + kThreads - 1) / kThreads;
  mix_planes_kernel<T><<<(unsigned)(blocks < 65535 ? blocks : 65535), kThreads, 0, stream>>>(
      X, mix, Y, B, H, nn, transpose);
  return (int)cudaGetLastError();
}

}  // namespace nrv
