// Fused soft-argmax decoder backward for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelwiseregression_tpu/ops/pallas_softargmax.py::_bwd_kernel.
// For one row (b, j) of HW pixels it recomputes the forward of
// softargmax_fwd.cu (p, num = sum mh*recon, den = sum mh + 1e-14, with
// mh = p*m, recon = (dm + label)*m) and, from the cotangents g_hm[b, j, :]
// and g_uvd[b, j, :] = (g_u, g_v, g_d), computes
//   g_p   = g_hm + g_u*fu + g_v*fv + g_d * m*(recon/den - num/den^2)
//   dz    = p * (g_p - sum p*g_p)          (softmax backward)
//   dx    = dz * w[j]
//   ddm   = g_d * mh / den * m              (quotient rule of d = num/den)
//   dw    = sum dz * x                      (one value per row; the caller
//                                            sums it over the batch)
// and a second small kernel sums ddm over the J rows of each sample into
// dlabel[b, :] in a fixed order, so the result is deterministic without
// atomics. The mask gets no cotangent. Everything is f32: the training
// boundary of the JAX package is f32.
//
// What bounds it: device-memory bytes, as for the forward. Per row it reads
// x, dm, g_hm and the shared label and mask rows and writes dx and ddm.
// One 256-thread block per row (B*J independent blocks, no cross-block
// reduction); five passes over a row of 16 KB, which stays in L1/L2, so
// device memory sees each input once: max, sum of exp, (num, den),
// sum p*g_p, and the pass that writes. 16-byte vector loads and stores, f32
// reductions through warp shuffles and shared memory. The dlabel pass
// re-reads ddm once, one thread per pixel with coalesced loads.
// Both kernels launch on the caller's stream and allocate nothing; the C
// entry point returns the first launch error.

#include "softargmax_common.cuh"

namespace {

using namespace softargmax;

// The cotangent reaching p, as the TPU kernel forms it.
__device__ __forceinline__ float grad_p(float g_hm, float g_u, float g_v, float g_d, float fu,
                                        float fv, float m, float recon, float num, float den) {
  const float dd_dp = m * (recon / den - num / (den * den));
  return g_hm + g_u * fu + g_v * fv + g_d * dd_dp;
}

// grid: one block per (b, j) row. Dynamic shared memory: fu[W] then fv[H].
__global__ void __launch_bounds__(kThreads) softargmax_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dm, const float* __restrict__ label,
    const float* __restrict__ mask, const float* __restrict__ w, const float* __restrict__ g_hm,
    const float* __restrict__ g_uvd, float* __restrict__ dx, float* __restrict__ ddm,
    float* __restrict__ dw, int J, int H, int W) {
  extern __shared__ float tables[];
  __shared__ float scratch[(kWarps + 1) * 2];
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
  const float g_u = g_uvd[static_cast<size_t>(row) * 3 + 0];
  const float g_v = g_uvd[static_cast<size_t>(row) * 3 + 1];
  const float g_d = g_uvd[static_cast<size_t>(row) * 3 + 2];

  // passes 1 and 2: zmax and s, as the forward computes them
  float zmax, s;
  softmax_stats(x + off, hw, wj, scratch, zmax, s);

  float v[kVec], d[kVec], lb[kVec], mk[kVec], g[kVec];

  // pass 3: num = sum mh*recon, den = sum mh
  float nd[2] = {0.f, 0.f};
  for (int k = threadIdx.x * kVec; k < hw; k += kThreads * kVec) {
    load8(x + off + k, v);
    load8(dm + off + k, d);
    load8(label + off1 + k, lb);
    load8(mask + off1 + k, mk);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float p = expf(__fmul_rn(v[i], wj) - zmax) / s;
      const float mh = p * mk[i];
      nd[0] += mh * ((d[i] + lb[i]) * mk[i]);
      nd[1] += mh;
    }
  }
  block_sum<2>(nd, scratch);
  const float num = nd[0];
  const float den = nd[1] + kEps;

  // pass 4: inner = sum p*g_p
  float inner[1] = {0.f};
  for (int k = threadIdx.x * kVec; k < hw; k += kThreads * kVec) {
    load8(x + off + k, v);
    load8(dm + off + k, d);
    load8(label + off1 + k, lb);
    load8(mask + off1 + k, mk);
    load8(g_hm + off + k, g);
    int r = k / W;
    int c = k - r * W;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float p = expf(__fmul_rn(v[i], wj) - zmax) / s;
      const float recon = (d[i] + lb[i]) * mk[i];
      inner[0] += p * grad_p(g[i], g_u, g_v, g_d, fu[c], fv[r], mk[i], recon, num, den);
      if (++c == W) {
        c = 0;
        ++r;
      }
    }
  }
  block_sum<1>(inner, scratch);

  // pass 5: dx, ddm out; dw = sum dz*x
  float dwacc[1] = {0.f};
  float out_dx[kVec], out_ddm[kVec];
  for (int k = threadIdx.x * kVec; k < hw; k += kThreads * kVec) {
    load8(x + off + k, v);
    load8(dm + off + k, d);
    load8(label + off1 + k, lb);
    load8(mask + off1 + k, mk);
    load8(g_hm + off + k, g);
    int r = k / W;
    int c = k - r * W;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float p = expf(__fmul_rn(v[i], wj) - zmax) / s;
      const float recon = (d[i] + lb[i]) * mk[i];
      const float mh = p * mk[i];
      const float gp = grad_p(g[i], g_u, g_v, g_d, fu[c], fv[r], mk[i], recon, num, den);
      const float dz = p * (gp - inner[0]);
      out_dx[i] = dz * wj;
      out_ddm[i] = g_d * mh / den * mk[i];
      dwacc[0] += dz * v[i];
      if (++c == W) {
        c = 0;
        ++r;
      }
    }
    store8(dx + off + k, out_dx);
    store8(ddm + off + k, out_ddm);
  }
  block_sum<1>(dwacc, scratch);
  if (threadIdx.x == 0) dw[row] = dwacc[0];
}

// dlabel[b, k] = sum_j ddm[b, j, k], j in order: one thread per pixel.
__global__ void __launch_bounds__(kThreads) dlabel_kernel(const float* __restrict__ ddm,
                                                         float* __restrict__ dlabel, int B,
                                                         int J, int hw) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * hw) return;
  const size_t b = idx / hw;
  const size_t k = idx - b * hw;
  const float* src = ddm + b * J * hw + k;
  float acc = 0.f;
  for (int j = 0; j < J; ++j) acc += src[static_cast<size_t>(j) * hw];
  dlabel[idx] = acc;
}

}  // namespace

// x, dm, g_hm, dx, ddm: [B, J, H*W]; label, mask, dlabel: [B, 1, H*W];
// w: [J]; g_uvd: [B, J, 3]; dw: [B, J]; all f32. H*W must be a multiple of 8
// and every pointer 16-byte aligned; the caller checks both. Returns the
// cudaError_t of the first launch that failed, or 0.
extern "C" int softargmax_bwd(const float* x, const float* dm, const float* label,
                              const float* mask, const float* w, const float* g_hm,
                              const float* g_uvd, float* dx, float* ddm, float* dlabel,
                              float* dw, int B, int J, int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(W + H) * sizeof(float);
  softargmax_bwd_kernel<<<B * J, kThreads, smem, st>>>(x, dm, label, mask, w, g_hm, g_uvd, dx,
                                                       ddm, dw, J, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * H * W;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  dlabel_kernel<<<blocks, kThreads, 0, st>>>(ddm, dlabel, B, J, H * W);
  return static_cast<int>(cudaGetLastError());
}
