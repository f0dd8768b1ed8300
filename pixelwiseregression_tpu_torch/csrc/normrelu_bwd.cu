// Backward of relu(instance_norm(x)) (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelwiseregression_tpu/ops/fused_normrelu.py::_bwd_kernel.
// From the saved x (NHWC, bf16 or f32), the per-(sample, channel) f32 mean
// and rsqrt, the f32 scale and bias and the cotangent g of the relu output:
//   a = inv*scale, b = bias - mean*a;
//   m = round(x*a + b) > 0, the forward's relu mask after the rounding to
//       the act dtype (x*a and + b are two roundings, never an FMA: a
//       contracted y near 0 could flip a mask bit);
//   gm = m ? g : 0, xhat = (x - mean)*inv;
//   dx = round(a*((gm - mean(gm)) - xhat*mean(gm*xhat)));
//   dscale = sum(gm*xhat), dbias = sum(gm) over the batch and the pixels.
// A channel whose scale and bias are 0 has y = 0, so its mask is empty and
// its gradients are exact zeros.
//
// What bounds it: device-memory bytes (g and x read, dx written: 6 bytes an
// element in bf16, ~12 f32 operations). The TPU kernel held a sample's g
// and x (2 MiB in bf16 at [64*64, 128]) in VMEM to take the reductions and
// the dx pass on one read; an SM's 227 KB cannot, so here they go through
// device memory, in a fixed order and without atomics:
//   * nr_partial_kernel: one block per (sample, chunk of kChunk pixels),
//     8 channels a thread (16-byte loads), sums gm and gm*xhat into f32
//     partials per (sample, chunk, channel);
//   * nr_dx_kernel: the same blocks; each sums its sample's partials in
//     chunk order into mean(gm) and mean(gm*xhat), then writes dx; the
//     chunk-0 block also stores the per-sample sums;
//   * nr_param_kernel: dscale and dbias, summed over the samples in order.
// g and x are read twice: 10 bytes an element against the bound's 6.
// Keeping a sample resident in a thread-block cluster's shared memory is
// later work.

#include "vec8.cuh"

namespace {

using pwr::kVec;
using pwr::load8;
using pwr::round_act;
using pwr::store8;

constexpr int kThreads = 256;
constexpr int kChunk = 512;  // pixels per block
constexpr int kParamThreads = 128;

__host__ __device__ inline int chunks(int HW) { return (HW + kChunk - 1) / kChunk; }

// The block's shape: G = C/8 channel groups by R pixel rows.
struct Tile {
  int G, R;
  __host__ __device__ explicit Tile(int C)
      : G(C / kVec), R(kThreads / G > 0 ? kThreads / G : 1) {}
};

// The per-channel constants of one thread's 8 channels.
struct Coef {
  float mu[kVec], iv[kVec], a[kVec], b[kVec];
  __device__ Coef(const float* mean, const float* inv, const float* scale, const float* bias,
                  size_t nc, int c) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      mu[j] = mean[nc + j];
      iv[j] = inv[nc + j];
      a[j] = __fmul_rn(iv[j], scale[c + j]);
      b[j] = __fsub_rn(bias[c + j], __fmul_rn(mu[j], a[j]));
    }
  }
};

// gm and xhat of 8 elements
template <typename T>
__device__ __forceinline__ void masked(const Coef& k, const T* g, const T* x, float gm[kVec],
                                       float xhat[kVec]) {
  float xv[kVec];
  load8(x, xv);
  load8(g, gm);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float y = round_act<T>(__fadd_rn(__fmul_rn(xv[j], k.a[j]), k.b[j]));
    if (!(y > 0.f)) gm[j] = 0.f;
    xhat[j] = __fmul_rn(__fsub_rn(xv[j], k.mu[j]), k.iv[j]);
  }
}

// grid (chunks, B); dynamic shared memory 2*R*C floats
template <typename T>
__global__ void __launch_bounds__(kThreads) nr_partial_kernel(
    const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ inv, const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ part_g, float* __restrict__ part_gx, int HW, int C) {
  extern __shared__ float red[];
  const Tile t(C);
  const int n = blockIdx.y, k = blockIdx.x, nk = gridDim.x;
  const int gi = threadIdx.x % t.G, r = threadIdx.x / t.G;
  const int c = gi * kVec;
  const int p1 = min(HW, (k + 1) * kChunk);
  float sg[kVec] = {}, sgx[kVec] = {};
  if (r < t.R) {
    const Coef coef(mean, inv, scale, bias, static_cast<size_t>(n) * C + c, c);
    for (int p = k * kChunk + r; p < p1; p += t.R) {
      const size_t e = (static_cast<size_t>(n) * HW + p) * C + c;
      float gm[kVec], xhat[kVec];
      masked(coef, g + e, x + e, gm, xhat);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sg[j] = __fadd_rn(sg[j], gm[j]);
        sgx[j] = __fadd_rn(sgx[j], __fmul_rn(gm[j], xhat[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      red[r * C + c + j] = sg[j];
      red[(t.R + r) * C + c + j] = sgx[j];
    }
  }
  __syncthreads();
  for (int cc = threadIdx.x; cc < C; cc += blockDim.x) {
    float s = 0.f, sx = 0.f;
    for (int rr = 0; rr < t.R; ++rr) {
      s = __fadd_rn(s, red[rr * C + cc]);
      sx = __fadd_rn(sx, red[(t.R + rr) * C + cc]);
    }
    const size_t o = (static_cast<size_t>(n) * nk + k) * C + cc;
    part_g[o] = s;
    part_gx[o] = sx;
  }
}

// grid (chunks, B); dynamic shared memory 2*C floats
template <typename T>
__global__ void __launch_bounds__(kThreads) nr_dx_kernel(
    const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ inv, const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ part_g, const float* __restrict__ part_gx, float* __restrict__ sum_g,
    float* __restrict__ sum_gx, T* __restrict__ dx, int HW, int C) {
  extern __shared__ float mom[];  // mean(gm) [C], mean(gm*xhat) [C]
  const Tile t(C);
  const int n = blockIdx.y, k = blockIdx.x, nk = gridDim.x;
  for (int cc = threadIdx.x; cc < C; cc += blockDim.x) {
    float s = 0.f, sx = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
      const size_t o = (static_cast<size_t>(n) * nk + kk) * C + cc;
      s = __fadd_rn(s, part_g[o]);
      sx = __fadd_rn(sx, part_gx[o]);
    }
    if (k == 0) {
      sum_g[static_cast<size_t>(n) * C + cc] = s;
      sum_gx[static_cast<size_t>(n) * C + cc] = sx;
    }
    mom[cc] = __fdiv_rn(s, static_cast<float>(HW));
    mom[C + cc] = __fdiv_rn(sx, static_cast<float>(HW));
  }
  __syncthreads();
  const int gi = threadIdx.x % t.G, r = threadIdx.x / t.G;
  if (r >= t.R) return;
  const int c = gi * kVec;
  const Coef coef(mean, inv, scale, bias, static_cast<size_t>(n) * C + c, c);
  const int p1 = min(HW, (k + 1) * kChunk);
  for (int p = k * kChunk + r; p < p1; p += t.R) {
    const size_t e = (static_cast<size_t>(n) * HW + p) * C + c;
    float gm[kVec], xhat[kVec], d[kVec];
    masked(coef, g + e, x + e, gm, xhat);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      d[j] = __fmul_rn(coef.a[j], __fsub_rn(__fsub_rn(gm[j], mom[c + j]),
                                            __fmul_rn(xhat[j], mom[C + c + j])));
    store8(dx + e, d);
  }
}

__global__ void __launch_bounds__(kParamThreads) nr_param_kernel(
    const float* __restrict__ sum_g, const float* __restrict__ sum_gx, float* __restrict__ dscale,
    float* __restrict__ dbias, int B, int C) {
  const int c = blockIdx.x * kParamThreads + threadIdx.x;
  if (c >= C) return;
  float ds = 0.f, db = 0.f;
  for (int n = 0; n < B; ++n) {
    ds = __fadd_rn(ds, sum_gx[static_cast<size_t>(n) * C + c]);
    db = __fadd_rn(db, sum_g[static_cast<size_t>(n) * C + c]);
  }
  dscale[c] = ds;
  dbias[c] = db;
}

template <typename T>
cudaError_t launch(const void* g, const void* x, const float* mean, const float* inv,
                   const float* scale, const float* bias, void* dx, float* dscale, float* dbias,
                   float* work, int B, int HW, int C, cudaStream_t s) {
  const Tile t(C);
  const int nk = chunks(HW);
  const size_t np = static_cast<size_t>(B) * nk * C;
  float* part_g = work;
  float* part_gx = part_g + np;
  float* sum_g = part_gx + np;
  float* sum_gx = sum_g + static_cast<size_t>(B) * C;
  const dim3 grid(nk, B);
  const int threads = t.G * t.R;
  nr_partial_kernel<T><<<grid, threads, 2 * t.R * C * sizeof(float), s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), mean, inv, scale, bias, part_g, part_gx,
      HW, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nr_dx_kernel<T><<<grid, threads, 2 * C * sizeof(float), s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), mean, inv, scale, bias, part_g, part_gx,
      sum_g, sum_gx, static_cast<T*>(dx), HW, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nr_param_kernel<<<(C + kParamThreads - 1) / kParamThreads, kParamThreads, 0, s>>>(
      sum_g, sum_gx, dscale, dbias, B, C);
  return cudaGetLastError();
}

}  // namespace

// f32 workspace that normrelu_bwd needs: per-(sample, chunk) partials and
// per-sample sums of gm and gm*xhat.
extern "C" long long normrelu_bwd_workspace_floats(int B, int HW, int C) {
  return 2LL * B * C * (chunks(HW) + 1);
}

// g, x and dx [B, HW, C] in the act dtype (bf16 if bf16, else f32); mean and
// inv [B, C], scale and bias [C], dscale and dbias [C] f32; work holds
// normrelu_bwd_workspace_floats floats. C is a multiple of 8 and at most
// 2048, every pointer 16-byte aligned; the caller checks. Returns the first
// failed launch's cudaError_t.
extern "C" int normrelu_bwd(int bf16, const void* g, const void* x, const float* mean,
                            const float* inv, const float* scale, const float* bias, void* dx,
                            float* dscale, float* dbias, float* work, int B, int HW, int C,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(g, x, mean, inv, scale, bias, dx, dscale, dbias, work, B, HW, C, s)
           : launch<float>(g, x, mean, inv, scale, bias, dx, dscale, dbias, work, B, HW, C, s);
  return static_cast<int>(err);
}
