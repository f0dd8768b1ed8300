// Fused soft-argmax decoder forward for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelwiseregression_tpu/ops/pallas_softargmax.py::_fwd_kernel.
// For one row (b, j) of HW pixels it computes
//   z = x * w[j];  p = exp(z - max z) / sum exp(z - max z)
//   u = sum fu * p;  v = sum fv * p
//   d = sum p*m * (dm + label)*m / (sum p*m + 1e-14)
// and writes p (f32, or bf16 on the inference fast boundary) and uvd[b, j, :].
// fu / fv are ops/heatmap.com_filter (softargmax_common.cuh's com).
//
// What bounds it: device-memory bytes. Per row it reads x and dm, the
// sample's label and mask rows (shared by its J rows, so mostly from L2),
// and writes hm: at [128, 14, 64*64] f32 about 92 MB, 0.0276 ms at
// 3.35 TB/s, against ~16 f32 operations an element. The design waits on
// device memory once a row and computes each element's p once:
//   * on-chip plan (a row of at most 4096 pixels: every main-path shape):
//     one block a row, one 8-pixel chunk a thread; the block asks for all
//     of its row's x, dm, label and mask in one wave of 16-byte vector loads
//     into registers (24 f32 a thread stay: p, recon, m), reduces zmax and
//     s over the block from registers, forms p with one expf and one
//     division an element (div_rn: the correctly rounded quotient without
//     __fdiv_rn's branch), writes hm once and reduces the four sums of uvd;
//     40 registers, so three blocks share an SM and one block's loads
//     overlap another's reductions;
//   * streamed plan (larger rows): the same block loops over its row in
//     three passes (max, sum of exp, p and the sums), the row coming back
//     from L1/L2;
//   * the COM values are a float table of W + H values in shared memory,
//     filled while the loads are in flight (one division a thread);
//   * every reduction runs in f32 through warp shuffles and one barrier,
//     in a fixed order: no atomics, two calls give the same bits.
// The kernel launches on the caller's stream, allocates nothing and reports
// launch errors through the return code of the C entry point.

#include "softargmax_common.cuh"

namespace {

using namespace softargmax;

// Blocks of the on-chip plan an SM holds at once, set by the registers a
// thread may take (it holds 24 f32 of its row after the loads, 32 during
// them): three leave 40, enough; four leave 32 and spill. More blocks an
// SM overlap one block's loads with another's reductions.
constexpr int kFwdBlocksPerSM = 3;

// grid: one block per (b, j) row; block: plan_for(H * W).threads. Dynamic
// shared memory: fu[W] then fv[H].
template <typename T, typename O, int P>
__global__ void __launch_bounds__(P == kOnChip ? kOnChipThreads : kStreamThreads,
                                  P == kOnChip ? kFwdBlocksPerSM : 1)
    softargmax_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dm,
                          const T* __restrict__ label, const T* __restrict__ mask,
                          const float* __restrict__ w, O* __restrict__ hm,
                          float* __restrict__ uvd, int J, int H, int W) {
  extern __shared__ float fuv[];
  __shared__ float scratch_buf[2 * kScratch];
  Scratch scratch(scratch_buf);
  const int hw = H * W;
  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * hw;
  const size_t off1 = static_cast<size_t>(row / J) * hw;
  const float wj = w[row % J];

  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // sum fu*p, sum fv*p, sum mh*recon, sum mh
  if constexpr (P == kOnChip) {
    const int k = threadIdx.x * kVec;
    const bool has = k < hw;
    float p[kVec], recon[kVec], mk[kVec];
    if (has) {
      float d[kVec], lb[kVec];
      load8(x + off + k, p);
      load8(dm + off + k, d);
      load8(label + off1 + k, lb);
      load8(mask + off1 + k, mk);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        p[i] = logit(p[i], wj);
        recon[i] = (d[i] + lb[i]) * mk[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) p[i] = -INFINITY;
    }
    fill_com(fuv, H, W);  // while the loads are in flight
    softmax_on_chip(p, scratch);
    if (has) {
      store8(hm + off + k, p);
      Pixel px(k, W);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[0] += fuv[px.c] * p[i];
        acc[1] += fuv[W + px.r] * p[i];
        const float mh = p[i] * mk[i];
        acc[2] += mh * recon[i];
        acc[3] += mh;
        px.next(W);
      }
    }
  } else {
    fill_com(fuv, H, W);
    float zmax, s;
    softmax_stats(x + off, hw, wj, scratch, zmax, s);
    const float rs = __frcp_rn(s);
    float v[kVec], d[kVec], lb[kVec], mk[kVec], p[kVec];
    for (int k = threadIdx.x * kVec; k < hw; k += blockDim.x * kVec) {
      load8(x + off + k, v);
      load8(dm + off + k, d);
      load8(label + off1 + k, lb);
      load8(mask + off1 + k, mk);
      Pixel px(k, W);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        p[i] = div_rn(expf(logit(v[i], wj) - zmax), s, rs);
        acc[0] += fuv[px.c] * p[i];
        acc[1] += fuv[W + px.r] * p[i];
        const float mh = p[i] * mk[i];
        acc[2] += mh * ((d[i] + lb[i]) * mk[i]);
        acc[3] += mh;
        px.next(W);
      }
      store8(hm + off + k, p);
    }
  }
  block_sum(acc, scratch.next());
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
  const RowPlan plan = plan_for(H * W);
  auto kernel = plan.plan == kOnChip ? softargmax_fwd_kernel<T, O, kOnChip>
                                     : softargmax_fwd_kernel<T, O, kStreamed>;
  kernel<<<B * J, plan.threads, (W + H) * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dm), static_cast<const T*>(label),
      static_cast<const T*>(mask), w, static_cast<O*>(hm), uvd, J, H, W);
}

// Counts the pairs (a, b) on which div_rn and __fdiv_rn differ: pair i has a
// hashed significand and an exponent in [2^-100, 2^13) for a, and b in
// [lo, hi); quotients below 2^-126 are not counted.
__global__ void div_check_kernel(unsigned long long n, float lo, float hi,
                                 unsigned long long* count) {
  const unsigned long long step = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * static_cast<unsigned long long>(blockDim.x) +
                              threadIdx.x;
       i < n; i += step) {
    unsigned h = static_cast<unsigned>(i * 2654435761ull);
    h ^= h >> 13;
    h *= 0x5bd1e995u;
    h ^= h >> 15;
    unsigned h2 = h * 0x27d4eb2du + 12345u;
    h2 ^= h2 >> 16;
    const float a = __uint_as_float((h & 0x007fffffu) | (((h >> 23) % 113u + 27u) << 23));
    const float b = lo + (hi - lo) * ((h2 >> 8) * (1.0f / 16777216.0f));
    const float want = __fdiv_rn(a, b);
    if (want >= 1.17549435e-38f && div_rn(a, b, __frcp_rn(b)) != want) atomicAdd(count, 1ull);
  }
}

}  // namespace

// div_check_kernel over n pairs with b in [lo, hi), adding to *count (a
// device counter). Returns the cudaError_t of the launch.
extern "C" int softargmax_div_mismatches(float lo, float hi, long long n,
                                         unsigned long long* count, void* stream) {
  div_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long>(n), lo, hi, count);
  return static_cast<int>(cudaGetLastError());
}

// The plan a row of hw pixels runs in either kernel: out[0] = 0 (on chip) or
// 1 (streamed), out[1] = threads a block. Returns 0.
extern "C" int softargmax_plan(int hw, int* out) {
  const RowPlan plan = plan_for(hw);
  out[0] = plan.plan;
  out[1] = plan.threads;
  return 0;
}

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
