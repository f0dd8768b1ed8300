// Whole-hourglass forward (K4) for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelwiseregression_tpu/ops/pallas_hourglass.py::_hg_kernel:
// a level-L hourglass of 2L+3 pre-activation bottleneck ResBlocks
// ([norm, relu, 1x1 C->C/2, norm, relu, 3x3, norm, relu, 1x1 C/2->C] + x),
// 2x2 max-pools, nearest 2x upsamples and skip adds, inference only,
// instance norm only, on NHWC activations in bf16 or f32, with the TPU
// kernel's numerics:
//   * norm: exact two-pass f32 statistics; a = rsqrt(var+eps)*scale and
//     b = bias - mean*a rounded to the act dtype, x*a rounded, + b rounded,
//     relu (the apply runs in the act dtype);
//   * 1x1 convs: f32 accumulation, + bias, cast;
//   * 3x3 conv: the even taps (0, 2, 4, 6, 8) and the odd taps (1, 3, 5, 7)
//     summed apart in f32, each sum cast, the two added in f32 with the bias,
//     cast;
//   * the residual and the upsample skip adds in the act dtype.
//
// What bounds it: tensor-core operations at the full-width shape
// ([256, 64, 64, 128] bf16, level 4: 186 GFLOP against 0.54 GB of input and
// output). The TPU kernel ran all of it on one sample in VMEM; a 64x64x128
// bf16 sample is 1 MiB and an SM has 227 KB of shared memory. So this K4 is
// a host-side recursion over the stacked weights that launches K3's kernels
// (fused_common.cuh: statistics, then each conv with the norm applied as its
// input loads) and two kernels of its own here (the max-pool, and the
// upsample with the skip add), every level's activations in a workspace in
// device memory that the caller allocates, down to the first level whose
// sub-hourglass fits one block's shared memory (hourglass_tail.cuh): bf16,
// C a multiple of 16 and at most 128, h*w at most 256. That sub-hourglass,
// hg(x, h, w, lv) with its 2*lv + 3 ResBlocks, runs as one kernel of one
// block per sample (hourglass_tail.cu); at full width ([B, 64, 64, 128],
// level 4) it is level 2 at 16x16, and a call makes 29 launches where it
// made 76. f32 runs every level here (a 16x16x128 f32 sample is 128 KB),
// as do samples wider than 128 channels.

#include "fused_common.cuh"
#include "hourglass_tail.cuh"
#include "vec8.cuh"

namespace {

using pwr::kVec;
using pwr::load8;
using pwr::store8;

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;

// one thread per 8 channels of an output pixel
template <typename T>
__global__ void __launch_bounds__(kThreads) maxpool2_kernel(const T* __restrict__ x,
                                                            T* __restrict__ y, size_t n8, int H,
                                                            int W, int C) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n8) return;
  const int c8 = C / kVec;
  const int ho = H / 2, wo = W / 2;
  const int c = static_cast<int>(i % c8) * kVec;
  size_t pix = i / c8;
  const int xo = static_cast<int>(pix % wo);
  pix /= wo;
  const int yo = static_cast<int>(pix % ho);
  const size_t n = pix / ho;
  const T* src = x + ((n * H + 2 * yo) * W + 2 * xo) * C + c;
  float m[kVec], v[kVec];
  load8(src, m);
  const size_t offs[3] = {static_cast<size_t>(C), static_cast<size_t>(W) * C,
                          static_cast<size_t>(W) * C + C};
  for (int t = 0; t < 3; ++t) {
    load8(src + offs[t], v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) m[k] = fmaxf(m[k], v[k]);
  }
  store8(y + i * kVec, m);
}

// out [B,H,W,C] = skip + h[b, y/2, x/2, :], in the act dtype
template <typename T>
__global__ void __launch_bounds__(kThreads) upsample2_add_kernel(const T* __restrict__ h,
                                                                 const T* __restrict__ skip,
                                                                 T* __restrict__ out, size_t n8,
                                                                 int H, int W, int C) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n8) return;
  const int c8 = C / kVec;
  const int c = static_cast<int>(i % c8) * kVec;
  size_t pix = i / c8;
  const int xx = static_cast<int>(pix % W);
  pix /= W;
  const int yy = static_cast<int>(pix % H);
  const size_t n = pix / H;
  float a[kVec], b[kVec];
  load8(skip + i * kVec, a);
  load8(h + ((n * (H / 2) + yy / 2) * (W / 2) + xx / 2) * C + c, b);
#pragma unroll
  for (int k = 0; k < kVec; ++k) a[k] = __fadd_rn(a[k], b[k]);
  store8(out + i * kVec, a);
}

inline unsigned blocks_for(size_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// Hands out 256-byte aligned pieces of the workspace; with a null base it
// only counts the bytes.
struct Carver {
  char* base;
  size_t off = 0;
  void* take(size_t bytes) {
    off = (off + 255) & ~static_cast<size_t>(255);
    void* p = base ? base + off : nullptr;
    off += bytes;
    return p;
  }
};

// Buffers of one level at resolution h x w: the first ResBlock's output x1
// [B,h,w,C] (the skip), then p (pooled), q (inner) and r (second ResBlock)
// at h/2 x w/2.
struct Level {
  void *x1, *p, *q, *r;
};

constexpr int kMaxLevel = 16;

struct Hourglass {
  bool bf16;
  size_t es;  // bytes of one activation
  int B, C;
  cudaStream_t s;
  const char *w0, *w1, *w2;
  const float *b0, *b1, *b2, *s0, *sb0, *s1, *sb1, *s2, *sb2;
  float *ca, *cb;  // [B, C] norm coefficients
  void *t1, *t2;   // [B, H, W, C/2] ResBlock intermediates
  Level lev[kMaxLevel + 1];
  int idx = 0;     // next ResBlock of the stacked weights
  // what the call launched: every kernel, the tail kernels among them, and
  // the tail's dynamic shared memory a block (0 without a tail)
  int kernels = 0, tails = 0, tail_smem = 0;

  // counts a kernel launch that returned err
  cudaError_t launched(cudaError_t err) {
    kernels += err == cudaSuccess;
    return err;
  }

  void carve(Carver& cv, int H, int W, int level) {
    const size_t top = static_cast<size_t>(B) * H * W * C;
    ca = static_cast<float*>(cv.take(static_cast<size_t>(B) * C * sizeof(float)));
    cb = static_cast<float*>(cv.take(static_cast<size_t>(B) * C * sizeof(float)));
    t1 = cv.take(top / 2 * es);
    t2 = cv.take(top / 2 * es);
    // the levels above the tail's (which keeps its own in shared memory)
    for (int lv = level; lv >= 0 && !tail::fits(bf16, H >> (level - lv), W >> (level - lv), C, lv);
         --lv) {
      const size_t full = top >> (2 * (level - lv));
      lev[lv].x1 = cv.take(full * es);
      lev[lv].p = cv.take(full / 4 * es);
      lev[lv].q = cv.take(full / 4 * es);
      lev[lv].r = cv.take(full / 4 * es);
    }
  }

  cudaError_t resblock(const void* x, void* y, int h, int w) {
    const int i = idx++;
    const int ch = C / 2;
    const int hw = h * w;
    cudaError_t err =
        launched(fused::norm_stats(bf16, x, s0 + i * C, sb0 + i * C, ca, cb, B, hw, C, kEps, s));
    if (err != cudaSuccess) return err;
    fused::ConvArgs c0{x, w0 + static_cast<size_t>(i) * C * ch * es, b0 + i * ch, ca, cb, nullptr,
                       t1, B, h, w, C, ch, 1, fused::kProAct, 0};
    if ((err = launched(fused::conv(bf16, c0, s))) != cudaSuccess) return err;
    err = launched(
        fused::norm_stats(bf16, t1, s1 + i * ch, sb1 + i * ch, ca, cb, B, hw, ch, kEps, s));
    if (err != cudaSuccess) return err;
    fused::ConvArgs c1{t1, w1 + static_cast<size_t>(i) * 9 * ch * ch * es, b1 + i * ch, ca, cb,
                       nullptr, t2, B, h, w, ch, ch, 3, fused::kProAct, 1};
    if ((err = launched(fused::conv(bf16, c1, s))) != cudaSuccess) return err;
    err = launched(
        fused::norm_stats(bf16, t2, s2 + i * ch, sb2 + i * ch, ca, cb, B, hw, ch, kEps, s));
    if (err != cudaSuccess) return err;
    fused::ConvArgs c2{t2, w2 + static_cast<size_t>(i) * ch * C * es, b2 + i * C, ca, cb, x, y, B,
                       h, w, ch, C, 1, fused::kProAct, 0};
    return launched(fused::conv(bf16, c2, s));
  }

  cudaError_t pool(const void* x, void* y, int h, int w) {
    const size_t n8 = static_cast<size_t>(B) * (h / 2) * (w / 2) * C / kVec;
    if (bf16)
      maxpool2_kernel<__nv_bfloat16><<<blocks_for(n8), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n8, h, w, C);
    else
      maxpool2_kernel<float><<<blocks_for(n8), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(y), n8, h, w, C);
    return launched(cudaGetLastError());
  }

  cudaError_t upsample_add(const void* hsmall, const void* skip, void* out, int h, int w) {
    const size_t n8 = static_cast<size_t>(B) * h * w * C / kVec;
    if (bf16)
      upsample2_add_kernel<__nv_bfloat16><<<blocks_for(n8), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(hsmall), static_cast<const __nv_bfloat16*>(skip),
          static_cast<__nv_bfloat16*>(out), n8, h, w, C);
    else
      upsample2_add_kernel<float><<<blocks_for(n8), kThreads, 0, s>>>(
          static_cast<const float*>(hsmall), static_cast<const float*>(skip),
          static_cast<float*>(out), n8, h, w, C);
    return launched(cudaGetLastError());
  }

  // the traversal of pallas_hourglass.py::_hg_kernel.hg, block by block in
  // the order of the stacked weights
  cudaError_t hg(const void* x, void* out, int h, int w, int lv) {
    if (tail::fits(bf16, h, w, C, lv)) {
      const size_t i = static_cast<size_t>(idx);
      const int ch = C / 2;
      idx += 2 * lv + 3;
      const tail::Args a{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
                         reinterpret_cast<const __nv_bfloat16*>(w0) + i * C * ch,
                         reinterpret_cast<const __nv_bfloat16*>(w1) + i * 9 * ch * ch,
                         reinterpret_cast<const __nv_bfloat16*>(w2) + i * ch * C,
                         b0 + i * ch, b1 + i * ch, b2 + i * C, s0 + i * C, sb0 + i * C,
                         s1 + i * ch, sb1 + i * ch, s2 + i * ch, sb2 + i * ch, B, h, w, C, lv};
      const cudaError_t err = launched(tail::run(a, s));
      if (err == cudaSuccess) {
        ++tails;
        tail_smem = tail::smem_bytes(h, w, C, lv);
      }
      return err;
    }
    const Level& L = lev[lv];
    cudaError_t err;
    if ((err = resblock(x, L.x1, h, w)) != cudaSuccess) return err;
    if ((err = pool(L.x1, L.p, h, w)) != cudaSuccess) return err;
    err = lv > 0 ? hg(L.p, L.q, h / 2, w / 2, lv - 1) : resblock(L.p, L.q, h / 2, w / 2);
    if (err != cudaSuccess) return err;
    if ((err = resblock(L.q, L.r, h / 2, w / 2)) != cudaSuccess) return err;
    return upsample_add(L.r, L.x1, out, h, w);
  }
};

}  // namespace

// Bytes of device workspace that hourglass_fwd needs for this shape.
extern "C" size_t hourglass_workspace_bytes(int bf16, int B, int H, int W, int C, int level) {
  Hourglass run{};
  run.bf16 = bf16 != 0;
  run.B = B;
  run.C = C;
  run.es = bf16 ? 2 : 4;
  Carver cv{nullptr};
  run.carve(cv, H, W, level);
  return cv.off;
}

// x, out [B,H,W,C] act dtype (bf16 if bf16, else f32); stacked weights as
// ops/cuda_hourglass.stack_hourglass_params orders them: w0 [N,C,C/2],
// w1 [N,3,3,C/2,C/2], w2 [N,C/2,C] in the act dtype; b0, b1 [N,C/2], b2
// [N,C], s0, sb0 [N,C], s1, sb1, s2, sb2 [N,C/2] f32; N = 2*level+3.
// workspace holds hourglass_workspace_bytes. H and W are multiples of
// 2^(level+1), C a multiple of 16, every pointer 16-byte aligned; the caller
// checks. launched[3] receives what the call launched: the kernels, the tail
// kernels among them, and the tail's dynamic shared memory a block in bytes
// (0 without a tail). Returns the first launch's cudaError_t.
extern "C" int hourglass_fwd(int bf16, const void* x, void* out, const void* w0, const void* w1,
                             const void* w2, const float* b0, const float* b1, const float* b2,
                             const float* s0, const float* sb0, const float* s1, const float* sb1,
                             const float* s2, const float* sb2, void* workspace, int B, int H,
                             int W, int C, int level, void* stream, int* launched) {
  if (level < 0 || level > kMaxLevel) return static_cast<int>(cudaErrorInvalidValue);
  Hourglass run{};
  run.bf16 = bf16 != 0;
  run.es = bf16 ? 2 : 4;
  run.B = B;
  run.C = C;
  run.s = static_cast<cudaStream_t>(stream);
  run.w0 = static_cast<const char*>(w0);
  run.w1 = static_cast<const char*>(w1);
  run.w2 = static_cast<const char*>(w2);
  run.b0 = b0; run.b1 = b1; run.b2 = b2;
  run.s0 = s0; run.sb0 = sb0; run.s1 = s1; run.sb1 = sb1; run.s2 = s2; run.sb2 = sb2;
  Carver cv{static_cast<char*>(workspace)};
  run.carve(cv, H, W, level);
  const cudaError_t err = run.hg(x, out, H, W, level);
  launched[0] = run.kernels;
  launched[1] = run.tails;
  launched[2] = run.tail_smem;
  return static_cast<int>(err);
}
