// Pieces shared by the soft-argmax decoder's forward (softargmax_fwd.cu) and
// backward (softargmax_bwd.cu) kernels: the plan a row runs, block-wide
// sums and maxima, the COM filter values, a division without a branch and
// the softmax of a row held on chip (the 8-wide vector loads and stores are
// vec8.cuh's).
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

constexpr int kOnChipThreads = 512;  // the most a block of the on-chip plan has
constexpr int kStreamThreads = 256;  // a block of the streamed plan
constexpr int kMaxWarps = kOnChipThreads / 32;
constexpr int kScratch = kMaxWarps * 4;  // one reduction of up to four values
constexpr float kEps = 1e-14f;

// How a row of hw pixels runs. On chip: one block a row, each thread holding
// one 8-pixel chunk of every input of the row in registers from one wave of
// loads, so the row is read from device memory once and p is computed once;
// the block has as many threads as the row has chunks, rounded up to a warp.
// A row of more than kOnChipThreads chunks (a label_size above 64) is
// streamed: its block loops over it once per pass, recomputing p each time.
// The rule is the same for both kernels and every dtype (a bf16 row is
// widened to f32 in registers).
enum Plan : int { kOnChip = 0, kStreamed = 1 };

struct RowPlan {
  int plan;
  int threads;
};

inline RowPlan plan_for(int hw) {
  const int chunks = hw / kVec;
  if (chunks <= kOnChipThreads) return {kOnChip, (chunks + 31) / 32 * 32};
  return {kStreamed, kStreamThreads};
}

// Two scratch buffers of shared memory used in turn by the block-wide
// reductions below (a buffer may be written again only after the next
// barrier); an offset rather than an index, so nothing lands in local memory.
struct Scratch {
  float* base;
  int at;
  __device__ __forceinline__ explicit Scratch(float* b) : base(b), at(0) {}
  __device__ __forceinline__ float* next() {
    float* p = base + at;
    at ^= kScratch;
    return p;
  }
};

// Block-wide reductions with one barrier each: every warp reduces its
// lanes, lane 0 writes the warp's value to scratch, and after the barrier
// every warp reduces the warps' values itself. The xor butterfly sums each
// pair the same way in every lane, so every thread gets the same bits, in
// the same order on every call: no atomics. A (T = double) sums f32
// partials without the f32 rounding of the tree.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], float* scratch_f) {
  static_assert(N * kMaxWarps * sizeof(T) <= kScratch * sizeof(float), "scratch too small");
  T* scratch = reinterpret_cast<T*>(scratch_f);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[i * kMaxWarps + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T t = lane < nwarps ? scratch[i * kMaxWarps + lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    v[i] = t;
  }
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? scratch[lane] : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
  return t;
}

// ops/heatmap.com_filter at index i of n: (i - n/2) / (n - 1). The plain
// version divides in double and rounds to f32; one f32 division of the two
// (exact) small integers gives the same value, since a quotient with a
// denominator below 2^29 cannot fall within 2^-53 of an f32 rounding
// midpoint without being one.
__device__ __forceinline__ float com(int i, int n) {
  return __fdiv_rn(static_cast<float>(i - n / 2), static_cast<float>(n - 1));
}

// The column and row of pixel k in a map of width W.
struct Pixel {
  int r, c;
  __device__ __forceinline__ Pixel(int k, int W) : r(k / W), c(k - (k / W) * W) {}
  __device__ __forceinline__ void next(int W) {
    if (++c == W) {
      c = 0;
      ++r;
    }
  }
};

// The COM values of a W x H map in shared memory, fu[W] then fv[H] (one
// array), filled in f32 by the block's threads, one value each. Read only
// after the block's first reduction, whose barrier orders the fill first.
__device__ __forceinline__ void fill_com(float* fuv, int H, int W) {
  for (int t = threadIdx.x; t < W + H; t += blockDim.x) fuv[t] = t < W ? com(t, W) : com(t - W, H);
}

// a / b rounded to nearest, given rb = __frcp_rn(b), without a branch: the
// product by the reciprocal corrected twice by its exact remainder (FMAs).
// For |a| >= 2^-100 and a normal quotient it is the correctly rounded one
// that a true division gives (softargmax_div_mismatches counts the pairs
// where the two differ; the card tests hold it to 0); a smaller a may
// round one ulp apart. A thread's eight divisions by one row's denominator
// pipeline where __fdiv_rn's slow-path branch would make each wait.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  float q = __fmul_rn(a, rb);
  float r = __fmaf_rn(-q, b, a);
  q = __fmaf_rn(r, rb, q);
  r = __fmaf_rn(-q, b, a);
  return __fmaf_rn(r, rb, q);
}

// z = x * w, rounded on its own (no FMA contraction into what follows), as
// the plain version computes it.
__device__ __forceinline__ float logit(float x, float wj) { return __fmul_rn(x, wj); }

// Row max of z, then s = sum exp(z - zmax), streamed over an f32 or bf16
// row of hw pixels (the streamed plan's first two passes).
template <typename T>
__device__ __forceinline__ void softmax_stats(const T* __restrict__ x, int hw, float wj,
                                              Scratch& scratch, float& zmax, float& s) {
  float v[kVec];
  zmax = -INFINITY;
  for (int k = threadIdx.x * kVec; k < hw; k += blockDim.x * kVec) {
    load8(x + k, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) zmax = fmaxf(zmax, logit(v[i], wj));
  }
  zmax = block_max(zmax, scratch.next());
  float acc[1] = {0.f};
  for (int k = threadIdx.x * kVec; k < hw; k += blockDim.x * kVec) {
    load8(x + k, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[0] += expf(logit(v[i], wj) - zmax);
  }
  block_sum(acc, scratch.next());
  s = acc[0];
}

// The on-chip plan's softmax of a thread's chunk: e = exp(z - zmax) in
// place of z, then p = e / s (a true division, as the TPU kernel does), with
// zmax and s reduced over the block from what is on chip. A thread without
// a chunk holds z = -inf, so its e and p are 0.
__device__ __forceinline__ void softmax_on_chip(float (&z)[kVec], Scratch& scratch) {
  float zmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < kVec; ++i) zmax = fmaxf(zmax, z[i]);
  zmax = block_max(zmax, scratch.next());
  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    z[i] = expf(z[i] - zmax);
    s[0] += z[i];
  }
  block_sum(s, scratch.next());
  const float rs = __frcp_rn(s[0]);
#pragma unroll
  for (int i = 0; i < kVec; ++i) z[i] = div_rn(z[i], s[0], rs);
}

}  // namespace softargmax
