// Fused conv + instance-norm unit (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelwiseregression_tpu/ops/pallas_fused.py::_fused_chain_kernel.
// One unit is [relu(norm(x)) prologue] -> 1x1 or 3x3 conv (stride 1, zero
// padding, + bias) -> [relu(norm(y)) epilogue] -> [+ skip], on NHWC
// activations in bf16 or f32, with the TPU kernel's rounding points:
//   * prologue: y32*a + b in f32 (two roundings, no FMA), relu, cast;
//   * conv: f32 accumulation, + bias in f32, cast;
//   * epilogue: statistics of the cast conv output, then as the prologue;
//   * skip: added in the act dtype.
// Zero padding is applied after the prologue: a padded tap is a zero of the
// normalised input. Statistics are the exact two-pass mean and biased
// variance per (sample, channel) in f32, eps inside the rsqrt.
//
// What bounds it: tensor-core operations at the full-width shapes (the 3x3
// 128->128 head unit at batch 256 is 309 GFLOP against 0.54 GB of
// activations), the statistics and the apply by device-memory bytes. The TPU
// kernel kept a whole sample ([HW, C], 1-2 MiB) in VMEM to take both passes
// of the statistics there; an SM's 227 KB of shared memory cannot hold one,
// so here the statistics go through device memory:
//   * norm_stats_kernel: one block per (sample, 32 channels), 8 pixel rows
//     of 32 channel lanes, both passes in a fixed order (deterministic, no
//     atomics); it folds the affine into a = rsqrt(var+eps)*scale and
//     b = bias - mean*a;
//   * conv_kernel: an implicit GEMM over M = B*H*W pixels, N = Co, K = k*k*C,
//     64x64 output tiles per 128-thread block, K steps of one tap by 32
//     channels staged in shared memory; the prologue is applied as each
//     input tile loads; bf16 runs on the tensor cores (wmma, f32
//     accumulators), f32 by f32 FMA (never TF32); the epilogue adds the bias
//     (and the skip) from a shared-memory copy of the accumulators;
//   * norm_apply_kernel: the epilogue norm, one pass over the conv output.
// A unit therefore reads its input twice for the prologue statistics and
// once for the conv, and writes the pre-norm conv output once more when it
// has an epilogue. wgmma, TMA, a pipelined K loop and statistics summed by
// the conv's own epilogue are later work.

#include <mma.h>

#include <type_traits>

#include "fused_common.cuh"
#include "vec8.cuh"

namespace fused {
namespace {

using pwr::copy8;
using pwr::kVec;
using pwr::load8;
using pwr::round_act;
using pwr::store8;
using pwr::zero8;

constexpr int kBM = 64;   // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // input channels per K step (of one tap)
constexpr int kConvThreads = 128;
constexpr int kCStride = kBN + 4;  // f32 accumulator tile rows (wmma ldm % 4 == 0)
constexpr int kStatRows = 8;       // pixel rows of the statistics block
constexpr int kApplyThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// shared-memory rows: 16-byte aligned, wmma ldm a multiple of 8 bf16 values
template <typename T>
__host__ __device__ constexpr int a_stride() { return std::is_same<T, float>::value ? kBK + 4 : kBK + 8; }
template <typename T>
__host__ __device__ constexpr int b_stride() { return std::is_same<T, float>::value ? kBN + 4 : kBN + 8; }

template <typename T, bool kSplit>
constexpr size_t conv_smem_bytes() {
  const size_t main = static_cast<size_t>(kBM * a_stride<T>() + kBK * b_stride<T>()) * sizeof(T);
  const size_t epi = static_cast<size_t>(kSplit ? 2 : 1) * kBM * kCStride * sizeof(float);
  return main > epi ? main : epi;
}

// ---------------------------------------------------------------- statistics

// grid (ceil(C/32), B); 32 channel lanes x kStatRows pixel rows.
template <typename T>
__global__ void __launch_bounds__(32 * kStatRows) norm_stats_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ a, float* __restrict__ b, int HW, int C, float eps) {
  __shared__ float part[kStatRows][32];
  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int n = blockIdx.y;
  const bool on = c < C;
  const T* xs = x + static_cast<size_t>(n) * HW * C + c;

  float s = 0.f;
  if (on)
    for (int p = row; p < HW; p += kStatRows) s += to_f32(xs[static_cast<size_t>(p) * C]);
  part[row][lane] = s;
  __syncthreads();
  float mean = 0.f;
#pragma unroll
  for (int r = 0; r < kStatRows; ++r) mean += part[r][lane];
  mean = mean / static_cast<float>(HW);
  __syncthreads();

  float q = 0.f;
  if (on)
    for (int p = row; p < HW; p += kStatRows) {
      const float d = to_f32(xs[static_cast<size_t>(p) * C]) - mean;
      q = fmaf(d, d, q);
    }
  part[row][lane] = q;
  __syncthreads();
  if (row == 0 && on) {
    float var = 0.f;
#pragma unroll
    for (int r = 0; r < kStatRows; ++r) var += part[r][lane];
    var = var / static_cast<float>(HW);
    const float inv = 1.0f / sqrtf(var + eps);
    const float ai = __fmul_rn(inv, scale[c]);
    a[static_cast<size_t>(n) * C + c] = ai;
    b[static_cast<size_t>(n) * C + c] = __fsub_rn(bias[c], __fmul_rn(mean, ai));
  }
}

// ---------------------------------------------------------------- norm apply

// one thread per 8 channels of a pixel
template <typename T>
__global__ void __launch_bounds__(kApplyThreads) norm_apply_kernel(
    const T* __restrict__ y, const float* __restrict__ a, const float* __restrict__ b,
    const T* __restrict__ skip, T* __restrict__ z, size_t n8, int HW, int C) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kApplyThreads + threadIdx.x;
  if (i >= n8) return;
  const size_t e = i * kVec;
  const int c = static_cast<int>(e % C);
  const size_t nc = (e / (static_cast<size_t>(HW) * C)) * C + c;
  float v[kVec];
  load8(y + e, v);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    v[k] = round_act<T>(fmaxf(__fadd_rn(__fmul_rn(v[k], a[nc + k]), b[nc + k]), 0.f));
  if (skip != nullptr) {
    float s[kVec];
    load8(skip + e, s);
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = __fadd_rn(v[k], s[k]);
  }
  store8(z + e, v);
}

// ---------------------------------------------------------------- conv

template <typename T>
__device__ __forceinline__ void prologue(float v[kVec], const float* __restrict__ a,
                                         const float* __restrict__ b, int mode) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (mode == kProF32) {
      v[k] = fmaxf(__fadd_rn(__fmul_rn(v[k], a[k]), b[k]), 0.f);
    } else {
      const float ad = round_act<T>(a[k]);
      const float bd = round_act<T>(b[k]);
      v[k] = fmaxf(round_act<T>(__fadd_rn(round_act<T>(__fmul_rn(v[k], ad)), bd)), 0.f);
    }
  }
}

// grid (ceil(M/kBM), ceil(Co/kBN)), kConvThreads threads.
template <typename T, bool kSplit>
__global__ void __launch_bounds__(kConvThreads) conv_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int AS = a_stride<T>();
  constexpr int BS = b_stride<T>();
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kBM * AS;
  float* Cs = reinterpret_cast<float*>(smem);  // reuses the tiles after the K loop
  float* Cs2 = Cs + kBM * kCStride;

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const int HW = p.H * p.W;
  const int M = p.B * HW;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int r = p.k >> 1;

  // the input row this thread loads: pixel m0 + arow, channels ahalf*16 + [0, 16)
  const int arow = threadIdx.x >> 1;
  const int ahalf = threadIdx.x & 1;
  const int am = m0 + arow;
  int an = 0, ay = 0, ax = 0;
  if (am < M) {
    an = am / HW;
    const int pix = am - an * HW;
    ay = pix / p.W;
    ax = pix - ay * p.W;
  }
  // the weight row this thread loads: channel brow, output channels bq*16 + [0, 16)
  const int brow = threadIdx.x >> 2;
  const int bq = threadIdx.x & 3;

  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], acc2[2][2];
  float facc[4][8], facc2[4][8];
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;  // bf16: warp tile rows wr*32, cols wc*32
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;  // f32: rows ty*4, cols tx*8
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) facc[i][j] = facc2[i][j] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(acc[i][j], 0.f);
        wmma::fill_fragment(acc2[i][j], 0.f);
      }
  }

  const int taps = p.k * p.k;
  for (int tap = 0; tap < taps; ++tap) {
    const int ys = ay + tap / p.k - r;
    const int xs = ax + tap % p.k - r;
    const bool avalid = am < M && ys >= 0 && ys < p.H && xs >= 0 && xs < p.W;
    const bool odd = kSplit && (tap & 1);
    for (int c0 = 0; c0 < p.C; c0 += kBK) {
      // input tile [kBM, kBK], normalised as it loads; padding and channels past C are zeros
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int cc = c0 + ahalf * 16 + v * kVec;
        T* dst = As + arow * AS + ahalf * 16 + v * kVec;
        if (avalid && cc < p.C) {
          const T* src = x + ((static_cast<size_t>(an) * p.H + ys) * p.W + xs) * p.C + cc;
          if (p.pro_mode == kProNone) {
            copy8(src, dst);
          } else {
            float f[kVec];
            load8(src, f);
            const size_t nc = static_cast<size_t>(an) * p.C + cc;
            prologue<T>(f, p.pro_a + nc, p.pro_b + nc, p.pro_mode);
            store8(dst, f);
          }
        } else {
          zero8(dst);
        }
      }
      // weight tile [kBK, kBN]
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int c = c0 + brow;
        const int nn = n0 + bq * 16 + v * kVec;
        T* dst = Bs + brow * BS + bq * 16 + v * kVec;
        if (c < p.C && nn < p.Co)
          copy8(w + (static_cast<size_t>(tap) * p.C + c) * p.Co + nn, dst);
        else
          zero8(dst);
      }
      __syncthreads();
      if constexpr (std::is_same<T, float>::value) {
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
          float av[4], bv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = As[(ty * 4 + i) * AS + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * BS + tx * 8 + j];
          if (odd) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) facc2[i][j] = fmaf(av[i], bv[j], facc2[i][j]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < kBK; ks += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * AS + ks, AS);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + ks * BS + wc * 32 + j * 16, BS);
          if (odd) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) wmma::mma_sync(acc2[i][j], fa[i], fb[j], acc2[i][j]);
          } else {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

  // accumulators -> shared memory (over the dead tiles)
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Cs[(ty * 4 + i) * kCStride + tx * 8 + j] = facc[i][j];
        if (kSplit) Cs2[(ty * 4 + i) * kCStride + tx * 8 + j] = facc2[i][j];
      }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = (wr * 32 + i * 16) * kCStride + wc * 32 + j * 16;
        wmma::store_matrix_sync(Cs + off, acc[i][j], kCStride, wmma::mem_row_major);
        if (kSplit) wmma::store_matrix_sync(Cs2 + off, acc2[i][j], kCStride, wmma::mem_row_major);
      }
  }
  __syncthreads();

  // bias, rounding, skip; 8 output channels per thread-step
  const T* __restrict__ skip = static_cast<const T*>(p.skip);
  T* __restrict__ y = static_cast<T*>(p.y);
  for (int e = threadIdx.x; e < kBM * kBN / kVec; e += kConvThreads) {
    const int row = e / (kBN / kVec);
    const int col = (e - row * (kBN / kVec)) * kVec;
    const int m = m0 + row;
    const int nn = n0 + col;
    if (m >= M || nn >= p.Co) continue;
    float v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float s = Cs[row * kCStride + col + k];
      if (kSplit) s = __fadd_rn(round_act<T>(s), round_act<T>(Cs2[row * kCStride + col + k]));
      v[k] = round_act<T>(__fadd_rn(s, p.bias[nn + k]));
    }
    if (skip != nullptr) {
      float sk[kVec];
      load8(skip + static_cast<size_t>(m) * p.Co + nn, sk);
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = __fadd_rn(v[k], sk[k]);
    }
    store8(y + static_cast<size_t>(m) * p.Co + nn, v);
  }
}

template <typename T>
cudaError_t launch_stats(const void* x, const float* scale, const float* bias, float* a,
                         float* b, int B, int HW, int C, float eps, cudaStream_t s) {
  const dim3 grid((C + 31) / 32, B);
  norm_stats_kernel<T><<<grid, 32 * kStatRows, 0, s>>>(static_cast<const T*>(x), scale, bias, a,
                                                       b, HW, C, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply(const void* y, const float* a, const float* b, const void* skip, void* z,
                         int B, int HW, int C, cudaStream_t s) {
  const size_t n8 = static_cast<size_t>(B) * HW * C / kVec;
  const unsigned blocks = static_cast<unsigned>((n8 + kApplyThreads - 1) / kApplyThreads);
  norm_apply_kernel<T><<<blocks, kApplyThreads, 0, s>>>(
      static_cast<const T*>(y), a, b, static_cast<const T*>(skip), static_cast<T*>(z), n8, HW, C);
  return cudaGetLastError();
}

template <typename T, bool kSplit>
cudaError_t launch_conv(const ConvArgs& p, cudaStream_t s) {
  const size_t m = static_cast<size_t>(p.B) * p.H * p.W;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM), (p.Co + kBN - 1) / kBN);
  conv_kernel<T, kSplit><<<grid, kConvThreads, conv_smem_bytes<T, kSplit>(), s>>>(p);
  return cudaGetLastError();
}

}  // namespace

cudaError_t norm_stats(bool bf16, const void* x, const float* scale, const float* bias, float* a,
                       float* b, int B, int HW, int C, float eps, cudaStream_t s) {
  return bf16 ? launch_stats<__nv_bfloat16>(x, scale, bias, a, b, B, HW, C, eps, s)
              : launch_stats<float>(x, scale, bias, a, b, B, HW, C, eps, s);
}

cudaError_t norm_apply(bool bf16, const void* y, const float* a, const float* b, const void* skip,
                       void* z, int B, int HW, int C, cudaStream_t s) {
  return bf16 ? launch_apply<__nv_bfloat16>(y, a, b, skip, z, B, HW, C, s)
              : launch_apply<float>(y, a, b, skip, z, B, HW, C, s);
}

cudaError_t conv(bool bf16, const ConvArgs& p, cudaStream_t s) {
  if (bf16)
    return p.split_taps ? launch_conv<__nv_bfloat16, true>(p, s)
                        : launch_conv<__nv_bfloat16, false>(p, s);
  return p.split_taps ? launch_conv<float, true>(p, s) : launch_conv<float, false>(p, s);
}

}  // namespace fused

// One K3 unit: [prologue statistics] -> conv -> [epilogue statistics -> apply].
// x [B,H,W,C], w [k,k,C,Co] (HWIO), skip and y [B,H,W,Co], all in the act
// dtype (bf16 if bf16, else f32); bias [Co] and the norm scales and biases
// ([C] for the prologue, [Co] for the epilogue; null to leave one out) f32.
// tmp [B,H,W,Co] act dtype holds the pre-norm conv output when there is an
// epilogue; coef_a and coef_b hold B*max(C, Co) floats. C and Co are
// multiples of 8, k is 1 or 3, every pointer 16-byte aligned; the caller
// checks. Returns the first launch's cudaError_t.
extern "C" int fused_unit(int bf16, const void* x, const void* w, const float* bias,
                          const float* pro_scale, const float* pro_bias, const float* epi_scale,
                          const float* epi_bias, const void* skip, void* y, void* tmp,
                          float* coef_a, float* coef_b, int B, int H, int W, int C, int Co, int k,
                          float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pro = pro_scale != nullptr;
  const bool epi = epi_scale != nullptr;
  cudaError_t err = cudaSuccess;
  if (pro) {
    err = fused::norm_stats(bf16, x, pro_scale, pro_bias, coef_a, coef_b, B, H * W, C, eps, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused::ConvArgs args{x, w, bias, pro ? coef_a : nullptr, pro ? coef_b : nullptr,
                       epi ? nullptr : skip, epi ? tmp : y, B, H, W, C, Co, k,
                       pro ? fused::kProF32 : fused::kProNone, 0};
  err = fused::conv(bf16, args, s);
  if (err != cudaSuccess || !epi) return static_cast<int>(err);
  err = fused::norm_stats(bf16, tmp, epi_scale, epi_bias, coef_a, coef_b, B, H * W, Co, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fused::norm_apply(bf16, tmp, coef_a, coef_b, skip, y, B, H * W, Co, s));
}

// K3's statistics and apply alone, y = round(relu(x*a + b)) with a, b from
// x's own statistics: the stats-only probe of the ablation tools (K6).
// x and y [B, HW, C] in the act dtype, C a multiple of 8; scale and bias
// [C], coef_a and coef_b B*C floats. Returns the first launch's cudaError_t.
extern "C" int norm_stats_apply(int bf16, const void* x, const float* scale, const float* bias,
                                void* y, float* coef_a, float* coef_b, int B, int HW, int C,
                                float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = fused::norm_stats(bf16, x, scale, bias, coef_a, coef_b, B, HW, C, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fused::norm_apply(bf16, x, coef_a, coef_b, nullptr, y, B, HW, C, s));
}
