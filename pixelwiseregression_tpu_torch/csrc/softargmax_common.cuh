// Pieces shared by the soft-argmax decoder's forward (softargmax_fwd.cu) and
// backward (softargmax_bwd.cu) kernels: block-wide sums and maxima in f32 and
// the COM filter tables (the 8-wide vector loads and stores are vec8.cuh's).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vec8.cuh"

namespace softargmax {

using pwr::kVec;
using pwr::load8;
using pwr::store8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-14f;

// Sum of N per-thread values over the block; every thread gets the totals.
// scratch holds (kWarps + 1) * N floats.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[warp * N + i] = v[i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float t = lane < kWarps ? scratch[lane * N + i] : 0.f;
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) scratch[kWarps * N + i] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = scratch[kWarps * N + i];
  __syncthreads();
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? scratch[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (lane == 0) scratch[kWarps] = t;
  }
  __syncthreads();
  v = scratch[kWarps];
  __syncthreads();
  return v;
}

// fu[W] then fv[H]: ops/heatmap.com_filter, computed in double from the pixel
// index and rounded to float, exactly as numpy does on the host.
__device__ __forceinline__ void fill_com_tables(float* fu, float* fv, int H, int W) {
  for (int c = threadIdx.x; c < W; c += kThreads)
    fu[c] = static_cast<float>(static_cast<double>(c - W / 2) / static_cast<double>(W - 1));
  for (int r = threadIdx.x; r < H; r += kThreads)
    fv[r] = static_cast<float>(static_cast<double>(r - H / 2) / static_cast<double>(H - 1));
  __syncthreads();
}

// Row max of z = x * w, then s = sum exp(z - zmax), for one f32 or bf16 row.
// __fmul_rn keeps z rounded on its own (no FMA contraction into the
// subtraction), as the plain version computes it.
template <typename T>
__device__ __forceinline__ void softmax_stats(const T* __restrict__ x, int hw, float wj,
                                              float* scratch, float& zmax, float& s) {
  float v[kVec];
  zmax = -INFINITY;
  for (int k = threadIdx.x * kVec; k < hw; k += kThreads * kVec) {
    load8(x + k, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) zmax = fmaxf(zmax, __fmul_rn(v[i], wj));
  }
  zmax = block_max(zmax, scratch);
  float acc[1] = {0.f};
  for (int k = threadIdx.x * kVec; k < hw; k += kThreads * kVec) {
    load8(x + k, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[0] += expf(__fmul_rn(v[i], wj) - zmax);
  }
  block_sum<1>(acc, scratch);
  s = acc[0];
}

}  // namespace softargmax
