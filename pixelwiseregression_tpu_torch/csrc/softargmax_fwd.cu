// Fused soft-argmax decoder forward for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelwiseregression_tpu/ops/pallas_softargmax.py::_fwd_kernel.
// For one row (b, j) of HW pixels it computes
//   z = x * w[j];  p = exp(z - max z) / sum exp(z - max z)
//   u = sum fu * p;  v = sum fv * p
//   d = sum p*m * (dm + label)*m / (sum p*m + 1e-14)
// and writes p (f32, or bf16 on the inference fast boundary) and uvd[b, j, :].
// fu / fv are ops/heatmap.com_filter: computed in double from the pixel
// index and rounded to float, exactly as numpy does on the host.
//
// What bounds it: device-memory bytes. Per row it reads two maps (x, dm) and
// the per-sample label and mask, and writes one map; there are ~10 flops per
// element. The design therefore touches each byte once from device memory:
//   * one block per (b, j) row, so B*J independent blocks (448 at batch 32)
//     spread over the 132 SMs with no cross-block reduction or atomics;
//   * 16-byte vector loads and stores (8 bf16 or 2x4 f32 per thread-step);
//   * the three passes over x (max, sum of exp, final) re-read a row of at
//     most a few tens of KB, which stays in L1/L2, so device memory sees x
//     once; label and mask rows are shared by the J blocks of a sample and
//     are served from L2 after the first;
//   * every reduction runs in f32 through warp shuffles and shared memory.
// The kernel launches on the caller's stream, allocates nothing and reports
// launch errors through the return code of the C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // elements per thread-step
constexpr float kEps = 1e-14f;

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

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

// grid: one block per (b, j) row. Dynamic shared memory: fu[W] then fv[H].
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads) softargmax_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dm, const T* __restrict__ label,
    const T* __restrict__ mask, const float* __restrict__ w, O* __restrict__ hm,
    float* __restrict__ uvd, int J, int H, int W) {
  extern __shared__ float tables[];
  __shared__ float scratch[(kWarps + 1) * 4];
  float* fu = tables;
  float* fv = tables + W;
  for (int c = threadIdx.x; c < W; c += kThreads)
    fu[c] = static_cast<float>(static_cast<double>(c - W / 2) / static_cast<double>(W - 1));
  for (int r = threadIdx.x; r < H; r += kThreads)
    fv[r] = static_cast<float>(static_cast<double>(r - H / 2) / static_cast<double>(H - 1));
  __syncthreads();

  const int hw = H * W;
  const int row = blockIdx.x;
  const int b = row / J;
  const int j = row - b * J;
  const size_t off = static_cast<size_t>(row) * hw;
  const size_t off1 = static_cast<size_t>(b) * hw;
  const float wj = w[j];
  float v[kVec];

  // pass 1: row max of z. __fmul_rn keeps z rounded on its own (no FMA
  // contraction into the subtraction below), as the plain version computes it.
  float zmax = -INFINITY;
  for (int k = threadIdx.x * kVec; k < hw; k += kThreads * kVec) {
    load8(x + off + k, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) zmax = fmaxf(zmax, __fmul_rn(v[i], wj));
  }
  zmax = block_max(zmax, scratch);

  // pass 2: s = sum exp(z - zmax)
  float s[1] = {0.f};
  for (int k = threadIdx.x * kVec; k < hw; k += kThreads * kVec) {
    load8(x + off + k, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) s[0] += expf(__fmul_rn(v[i], wj) - zmax);
  }
  block_sum<1>(s, scratch);

  // pass 3: p = e / s (a true division, as the TPU kernel does), the four sums, p out.
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // sum fu*p, sum fv*p, sum mh*recon, sum mh
  float d[kVec], lb[kVec], mk[kVec], p[kVec];
  for (int k = threadIdx.x * kVec; k < hw; k += kThreads * kVec) {
    load8(x + off + k, v);
    load8(dm + off + k, d);
    load8(label + off1 + k, lb);
    load8(mask + off1 + k, mk);
    int r = k / W;
    int c = k - r * W;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      p[i] = expf(__fmul_rn(v[i], wj) - zmax) / s[0];
      acc[0] += fu[c] * p[i];
      acc[1] += fv[r] * p[i];
      const float recon = (d[i] + lb[i]) * mk[i];
      const float mh = p[i] * mk[i];
      acc[2] += mh * recon;
      acc[3] += mh;
      if (++c == W) {
        c = 0;
        ++r;
      }
    }
    store8(hm + off + k, p);
  }
  block_sum<4>(acc, scratch);
  if (threadIdx.x == 0) {
    float* out = uvd + static_cast<size_t>(row) * 3;
    out[0] = acc[0];
    out[1] = acc[1];
    out[2] = acc[2] / (acc[3] + kEps);
  }
}

template <typename T, typename O>
void launch(const void* x, const void* dm, const void* label, const void* mask, const float* w,
            void* hm, float* uvd, int B, int J, int H, int W, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(W + H) * sizeof(float);
  softargmax_fwd_kernel<T, O><<<B * J, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dm), static_cast<const T*>(label),
      static_cast<const T*>(mask), w, static_cast<O*>(hm), uvd, J, H, W);
}

}  // namespace

// x, dm: [B, J, H*W]; label, mask: [B, 1, H*W], all of one dtype (bf16 if
// in_bf16, else f32); w: [J] f32; hm: [B, J, H*W] (bf16 if hm_bf16, else f32);
// uvd: [B, J, 3] f32. H*W must be a multiple of 8 and every pointer 16-byte
// aligned; the caller checks both. Returns the cudaError_t of the launch.
extern "C" int softargmax_fwd(int in_bf16, int hm_bf16, const void* x, const void* dm,
                              const void* label, const void* mask, const float* w, void* hm,
                              float* uvd, int B, int J, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (hm_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(x, dm, label, mask, w, hm, uvd, B, J, H, W, s);
    else
      launch<__nv_bfloat16, float>(x, dm, label, mask, w, hm, uvd, B, J, H, W, s);
  } else {
    if (hm_bf16)
      launch<float, __nv_bfloat16>(x, dm, label, mask, w, hm, uvd, B, J, H, W, s);
    else
      launch<float, float>(x, dm, label, mask, w, hm, uvd, B, J, H, W, s);
  }
  return static_cast<int>(cudaGetLastError());
}
