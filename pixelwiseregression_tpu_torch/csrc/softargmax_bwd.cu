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
// and, only when the caller asks for dlabel, a second small kernel sums ddm
// over the J rows of each sample into dlabel[b, :] in a fixed order, so the
// result is deterministic without atomics. The mask gets no cotangent.
// The maps are f32 (the training boundary of the JAX package is f32); the
// row's sums cross the block in double, and d/dp is formed as
// m*(recon - d)/den (grad_p), so that the cancellation in dz loses less.
//
// What bounds it: device-memory bytes. Per row it reads x, dm, g_hm and the
// sample's label and mask rows (shared by its J rows) and writes dx and
// ddm: at [128, 14, 64*64] f32 5 maps and 2 sample rows, about 151 MB,
// 0.0451 ms at 3.35 TB/s (dlabel adds a row a sample), against ~30 f32
// operations an element. The design waits on device memory once a row and
// computes each element's p once:
//   * on-chip plan (a row of at most 4096 pixels: every main-path shape):
//     one block a row, one 8-pixel chunk a thread; the block asks for all
//     five of its row's inputs in one wave of 16-byte vector loads into
//     registers (x, p, m, recon and g_hm, then g_p in its place: 40 values
//     a thread), reduces zmax and s, (num, den), sum p*g_p and dw over the
//     block from registers, and writes dx and ddm once; its divisions by a
//     row's s and den are div_rn (no branch), and 64 registers let two
//     blocks share an SM;
//   * streamed plan (larger rows): the same block loops over its row in
//     five passes (max, sum of exp, (num, den), sum p*g_p, and the pass
//     that writes), the row coming back from L1/L2;
//   * the COM values are a float table in shared memory, as in the forward;
//   * every reduction runs through warp shuffles and one barrier, in a
//     fixed order: no atomics, two calls give the same bits.
// On the training path label needs no gradient, so the call is this one
// kernel; the dlabel kernel, when asked, reads ddm back.
// Both kernels launch on the caller's stream and allocate nothing; the C
// entry point returns the first launch error.

#include "softargmax_common.cuh"

namespace {

using namespace softargmax;

// Blocks of the on-chip plan an SM holds at once, set by the registers a
// thread may take (it holds 40 f32 of its row: x, p, m, recon and g_hm,
// then g_p): two leave 64, enough; one block an SM took 80 and ran slower.
constexpr int kBwdBlocksPerSM = 2;

// What the backward needs of the row's depth d = num / den: den (with its
// 1e-14), its reciprocal, and d in two floats (d_hi + d_lo), from num and
// sum p*m summed in double. d is the f32 quotient refined once in double
// (one FMA, no double division): about 2^-46 relative.
struct Depth {
  float den, rden, d_hi, d_lo;
  __device__ __forceinline__ Depth(double num, double den_sum) {
    const double den_d = den_sum + static_cast<double>(kEps);
    den = static_cast<float>(den_d);
    rden = __frcp_rn(den);
    const double d0 = num * static_cast<double>(rden);
    const double d = fma(fma(-d0, den_d, num), static_cast<double>(rden), d0);
    d_hi = static_cast<float>(d);
    d_lo = static_cast<float>(d - static_cast<double>(d_hi));
  }
};

// The cotangent reaching p: g_hm + g_u*fu + g_v*fv + g_d * dd/dp, with the
// TPU kernel's dd/dp = m*(recon/den - num/den^2) formed as
// m*(recon - d)/den: the same quantity, without the cancellation of two
// terms near d/den, which left the cancellation of dz = p*(g_p - sum p*g_p)
// an f32 ulp of d/den (times g_d) to amplify.
__device__ __forceinline__ float grad_p(float g_hm, float g_u, float g_v, float g_d, float fu,
                                        float fv, float m, float recon, const Depth& dp) {
  const float dd_dp = m * div_rn((recon - dp.d_hi) - dp.d_lo, dp.den, dp.rden);
  return g_hm + g_u * fu + g_v * fv + g_d * dd_dp;
}

// grid: one block per (b, j) row; block: plan_for(H * W).threads. Dynamic
// shared memory: fu[W] then fv[H]. The row's sums (num, den and
// inner = sum p*g_p) are f32 within a thread and double across the block;
// inner then enters dz in two floats.
template <int P>
__global__ void __launch_bounds__(P == kOnChip ? kOnChipThreads : kStreamThreads,
                                  P == kOnChip ? kBwdBlocksPerSM : 1)
    softargmax_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dm,
                          const float* __restrict__ label, const float* __restrict__ mask,
                          const float* __restrict__ w, const float* __restrict__ g_hm,
                          const float* __restrict__ g_uvd, float* __restrict__ dx,
                          float* __restrict__ ddm, float* __restrict__ dw, int J, int H, int W) {
  extern __shared__ float fuv[];
  __shared__ float scratch_buf[2 * kScratch];
  Scratch scratch(scratch_buf);
  fill_com(fuv, H, W);  // before the loads: at 64 registers a thread, after them it spills
  const int hw = H * W;
  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * hw;
  const size_t off1 = static_cast<size_t>(row / J) * hw;
  const float wj = w[row % J];
  const float g_u = g_uvd[static_cast<size_t>(row) * 3 + 0];
  const float g_v = g_uvd[static_cast<size_t>(row) * 3 + 1];
  const float g_d = g_uvd[static_cast<size_t>(row) * 3 + 2];

  float dwacc[1] = {0.f};
  if constexpr (P == kOnChip) {
    const int k = threadIdx.x * kVec;
    const bool has = k < hw;
    float v[kVec], p[kVec], mk[kVec], recon[kVec], g[kVec];
    if (has) {
      float d[kVec], lb[kVec];
      load8(x + off + k, v);
      load8(dm + off + k, d);
      load8(label + off1 + k, lb);
      load8(mask + off1 + k, mk);
      load8(g_hm + off + k, g);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        p[i] = logit(v[i], wj);
        recon[i] = (d[i] + lb[i]) * mk[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        p[i] = -INFINITY;
        mk[i] = recon[i] = 0.f;
      }
    }
    softmax_on_chip(p, scratch);

    // num = sum mh*recon, den = sum mh
    float nd[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float mh = p[i] * mk[i];
      nd[0] += mh * recon[i];
      nd[1] += mh;
    }
    double ndd[2] = {nd[0], nd[1]};
    block_sum(ndd, scratch.next());
    const Depth dp(ndd[0], ndd[1]);

    // g_p in place of g_hm; inner = sum p*g_p
    float part[1] = {0.f};
    if (has) {
      Pixel px(k, W);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        g[i] = grad_p(g[i], g_u, g_v, g_d, fuv[px.c], fuv[W + px.r], mk[i], recon[i], dp);
        part[0] += p[i] * g[i];
        px.next(W);
      }
    }
    double inner[1] = {part[0]};
    block_sum(inner, scratch.next());
    const float in_hi = static_cast<float>(inner[0]);
    const float in_lo = static_cast<float>(inner[0] - static_cast<double>(in_hi));

    // dx, ddm out; dw = sum dz*x
    if (has) {
      float out_dx[kVec], out_ddm[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float dz = p[i] * ((g[i] - in_hi) - in_lo);
        out_dx[i] = dz * wj;
        out_ddm[i] = div_rn(g_d * (p[i] * mk[i]), dp.den, dp.rden) * mk[i];
        dwacc[0] += dz * v[i];
      }
      store8(dx + off + k, out_dx);
      store8(ddm + off + k, out_ddm);
    }
  } else {
    // passes 1 and 2: zmax and s, as the forward computes them
    float zmax, s;
    softmax_stats(x + off, hw, wj, scratch, zmax, s);
    const float rs = __frcp_rn(s);

    float v[kVec], d[kVec], lb[kVec], mk[kVec], g[kVec];

    // pass 3: num = sum mh*recon, den = sum mh
    float nd[2] = {0.f, 0.f};
    for (int k = threadIdx.x * kVec; k < hw; k += blockDim.x * kVec) {
      load8(x + off + k, v);
      load8(dm + off + k, d);
      load8(label + off1 + k, lb);
      load8(mask + off1 + k, mk);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float mh = div_rn(expf(logit(v[i], wj) - zmax), s, rs) * mk[i];
        nd[0] += mh * ((d[i] + lb[i]) * mk[i]);
        nd[1] += mh;
      }
    }
    double ndd[2] = {nd[0], nd[1]};
    block_sum(ndd, scratch.next());
    const Depth dp(ndd[0], ndd[1]);

    // pass 4: inner = sum p*g_p
    float part[1] = {0.f};
    for (int k = threadIdx.x * kVec; k < hw; k += blockDim.x * kVec) {
      load8(x + off + k, v);
      load8(dm + off + k, d);
      load8(label + off1 + k, lb);
      load8(mask + off1 + k, mk);
      load8(g_hm + off + k, g);
      Pixel px(k, W);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float p = div_rn(expf(logit(v[i], wj) - zmax), s, rs);
        const float recon = (d[i] + lb[i]) * mk[i];
        part[0] += p * grad_p(g[i], g_u, g_v, g_d, fuv[px.c], fuv[W + px.r], mk[i], recon, dp);
        px.next(W);
      }
    }
    double inner[1] = {part[0]};
    block_sum(inner, scratch.next());
    const float in_hi = static_cast<float>(inner[0]);
    const float in_lo = static_cast<float>(inner[0] - static_cast<double>(in_hi));

    // pass 5: dx, ddm out; dw = sum dz*x
    float out_dx[kVec], out_ddm[kVec];
    for (int k = threadIdx.x * kVec; k < hw; k += blockDim.x * kVec) {
      load8(x + off + k, v);
      load8(dm + off + k, d);
      load8(label + off1 + k, lb);
      load8(mask + off1 + k, mk);
      load8(g_hm + off + k, g);
      Pixel px(k, W);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float p = div_rn(expf(logit(v[i], wj) - zmax), s, rs);
        const float recon = (d[i] + lb[i]) * mk[i];
        const float gp = grad_p(g[i], g_u, g_v, g_d, fuv[px.c], fuv[W + px.r], mk[i], recon, dp);
        const float dz = p * ((gp - in_hi) - in_lo);
        out_dx[i] = dz * wj;
        out_ddm[i] = div_rn(g_d * (p * mk[i]), dp.den, dp.rden) * mk[i];
        dwacc[0] += dz * v[i];
        px.next(W);
      }
      store8(dx + off + k, out_dx);
      store8(ddm + off + k, out_ddm);
    }
  }
  block_sum(dwacc, scratch.next());
  if (threadIdx.x == 0) dw[row] = dwacc[0];
}

// dlabel[b, k] = sum_j ddm[b, j, k], j in order from 0: one thread per four
// pixels (16-byte loads and stores; H*W is a multiple of 8).
__global__ void __launch_bounds__(kStreamThreads) dlabel_kernel(const float* __restrict__ ddm,
                                                                float* __restrict__ dlabel,
                                                                int B, int J, int hw) {
  const size_t idx = (static_cast<size_t>(blockIdx.x) * kStreamThreads + threadIdx.x) * 4;
  if (idx >= static_cast<size_t>(B) * hw) return;
  const size_t b = idx / hw;
  const size_t k = idx - b * hw;
  const float* src = ddm + b * J * hw + k;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < J; ++j) {
    const float4 t = *reinterpret_cast<const float4*>(src + static_cast<size_t>(j) * hw);
    acc.x += t.x;
    acc.y += t.y;
    acc.z += t.z;
    acc.w += t.w;
  }
  *reinterpret_cast<float4*>(dlabel + idx) = acc;
}

}  // namespace

// x, dm, g_hm, dx, ddm: [B, J, H*W]; label, mask, dlabel: [B, 1, H*W];
// w: [J]; g_uvd: [B, J, 3]; dw: [B, J]; all f32. dlabel may be null: then
// it is not computed and the call is one kernel. H*W must be a multiple of 8
// and every pointer 16-byte aligned; the caller checks both. Returns the
// cudaError_t of the first launch that failed, or 0.
extern "C" int softargmax_bwd(const float* x, const float* dm, const float* label,
                              const float* mask, const float* w, const float* g_hm,
                              const float* g_uvd, float* dx, float* ddm, float* dlabel,
                              float* dw, int B, int J, int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowPlan plan = plan_for(H * W);
  auto kernel = plan.plan == kOnChip ? softargmax_bwd_kernel<kOnChip>
                                     : softargmax_bwd_kernel<kStreamed>;
  kernel<<<B * J, plan.threads, (W + H) * sizeof(float), st>>>(x, dm, label, mask, w, g_hm,
                                                                g_uvd, dx, ddm, dw, J, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dlabel == nullptr) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * H * W / 4;
  const unsigned blocks = static_cast<unsigned>((n + kStreamThreads - 1) / kStreamThreads);
  dlabel_kernel<<<blocks, kStreamThreads, 0, st>>>(ddm, dlabel, B, J, H * W);
  return static_cast<int>(cudaGetLastError());
}
