// Fused soft-argmax decoder forward for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelwiseregression_tpu/ops/pallas_softargmax.py::_fwd_kernel.
// For one row (b, j) of HW pixels it computes
//   z = x * w[j];  p = exp(z - max z) / sum exp(z - max z)
//   u = sum fu * p;  v = sum fv * p
//   d = sum p*m * (dm + label)*m / (sum p*m + 1e-14)
// and writes p (f32, or bf16 on the inference fast boundary) and uvd[b, j, :].
// fu / fv are ops/heatmap.com_filter (softargmax_common.cuh).
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

#include "softargmax_common.cuh"

namespace {

using namespace softargmax;

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
  fill_com_tables(fu, fv, H, W);

  const int hw = H * W;
  const int row = blockIdx.x;
  const int b = row / J;
  const int j = row - b * J;
  const size_t off = static_cast<size_t>(row) * hw;
  const size_t off1 = static_cast<size_t>(b) * hw;
  const float wj = w[j];

  // passes 1 and 2: zmax and s = sum exp(z - zmax)
  float zmax, s;
  softmax_stats(x + off, hw, wj, scratch, zmax, s);

  // pass 3: p = e / s (a true division, as the TPU kernel does), the four sums, p out.
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // sum fu*p, sum fv*p, sum mh*recon, sum mh
  float v[kVec], d[kVec], lb[kVec], mk[kVec], p[kVec];
  for (int k = threadIdx.x * kVec; k < hw; k += kThreads * kVec) {
    load8(x + off + k, v);
    load8(dm + off + k, d);
    load8(label + off1 + k, lb);
    load8(mask + off1 + k, mk);
    int r = k / W;
    int c = k - r * W;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      p[i] = expf(__fmul_rn(v[i], wj) - zmax) / s;
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
