// The pieces of the fused conv + instance-norm unit (K3) timed apart by the
// ablation tools (K6) for Hopper (sm_90a).
//
// Replaces the probe kernels of the TPU tools: tools/ablate_fused_unit.py
// (run_variant :61, dots_only :152), tools/ablate_fused2.py (run_k :69) and
// tools/ablate_fused3.py (run_copy :113, call2 :136). K3's own kernels
// (fused_chain.cu) serve the probes that run a whole unit or its
// statistics; this file holds the three pieces K3 has no kernel for:
//
//   * ablate_copy: src -> dst, 16 bytes a thread per access, four accesses
//     in flight. Bound by device-memory bytes: the floor of any pass over
//     the activations (the TPU tools' pipeline floor, in three block
//     shapes there; one here).
//   * build_xm: the 3x3 conv's tap operand of the TPU kernel,
//     xm[r, dj*C + c] = x[r - W + dj - 1, c] for r in [W, W + HW), with zero
//     rows above and below (the vertical padding) and zeros where the
//     horizontal tap crosses an image row, materialised in device memory:
//     [(H+2)W, 3C] per sample. The same index map serves the probes that
//     read a few of its blocks: out[p] = concat_k xm[p + ro_k, blk cb_k]
//     (up to 3 blocks), or with `sum` the two blocks added in f32 and
//     rounded once. Bound by bytes; exact data movement.
//   * xm_dots: y[b, p] = sum_di xm[b, p + off_di] @ wcat[di], three K-deep
//     products on a prebuilt operand, as K3's conv main loop runs them:
//     64x64 output tiles per 128-thread block, K steps of 32 staged in
//     shared memory, bf16 wmma with f32 accumulators, bf16 out. Bound by
//     tensor-core operations at the head shape. Offsets (0, W, 2W) take
//     the three vertical taps of xm; (0, 0, 0) the one row of an operand
//     repeated three times.
// Each launcher enqueues on the given stream, allocates nothing and returns
// the launch's cudaError_t.

#include <mma.h>

#include "vec8.cuh"

namespace {

using pwr::copy8;
using pwr::kVec;
using pwr::load8;
using pwr::store8;
using pwr::zero8;

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;
constexpr int kBuildThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kDotThreads = 128;
constexpr int kAS = kBK + 8;   // bf16 rows of the staged tiles: 16-byte aligned, ldm % 8 == 0
constexpr int kBS = kBN + 8;
constexpr int kCS = kBN + 4;   // f32 accumulator rows

__global__ void __launch_bounds__(kCopyThreads) copy_kernel(const uint4* __restrict__ src,
                                                            uint4* __restrict__ dst, size_t n) {
  const size_t i0 = static_cast<size_t>(blockIdx.x) * kCopyThreads * kCopyUnroll + threadIdx.x;
  uint4 v[kCopyUnroll];
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u) {
    const size_t i = i0 + static_cast<size_t>(u) * kCopyThreads;
    if (i < n) v[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u) {
    const size_t i = i0 + static_cast<size_t>(u) * kCopyThreads;
    if (i < n) dst[i] = v[u];
  }
}

struct XmArgs {
  const void* x;  // [B, H*W, C]
  void* out;      // [B, R, nblk*C]
  int B, H, W, C, R, nblk, sum;
  int ro[3], cb[3];
};

// 8 channels of xm[b, row, cb*C + c], or null where xm holds zeros
template <typename T>
__device__ __forceinline__ const T* xm_at(const XmArgs& a, int b, int row, int cb, int c) {
  const int HW = a.H * a.W;
  const int q = row - a.W;
  if (q < 0 || q >= HW) return nullptr;
  const int col = q % a.W;
  const int dj = cb - 1;
  if ((dj < 0 && col == 0) || (dj > 0 && col == a.W - 1)) return nullptr;
  return static_cast<const T*>(a.x) + (static_cast<size_t>(b) * HW + q + dj) * a.C + c;
}

// one thread per 8 channels of one output block of one row
template <typename T>
__global__ void __launch_bounds__(kBuildThreads) build_xm_kernel(const XmArgs a, size_t items) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kBuildThreads + threadIdx.x;
  if (i >= items) return;
  const int groups = a.C / kVec;
  const int c = static_cast<int>(i % groups) * kVec;
  size_t t = i / groups;
  const int k = static_cast<int>(t % a.nblk);
  t /= a.nblk;
  const int r = static_cast<int>(t % a.R);
  const int b = static_cast<int>(t / a.R);
  T* dst = static_cast<T*>(a.out) + ((static_cast<size_t>(b) * a.R + r) * a.nblk + k) * a.C + c;
  if (a.sum) {  // both operands, a zero of xm included, as the probe adds them
    float v[2][kVec] = {};
    for (int s = 0; s < 2; ++s) {
      const T* src = xm_at<T>(a, b, r + a.ro[s], a.cb[s], c);
      if (src != nullptr) load8(src, v[s]);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[0][j] = __fadd_rn(v[0][j], v[1][j]);
    store8(dst, v[0]);
    return;
  }
  const T* src = xm_at<T>(a, b, r + a.ro[k], a.cb[k], c);
  if (src != nullptr)
    copy8(src, dst);
  else
    zero8(dst);
}

struct DotArgs {
  const __nv_bfloat16* xm;  // [B, R, K]
  const __nv_bfloat16* w;   // [3, K, Co]
  __nv_bfloat16* y;         // [B, HW, Co]
  int B, R, HW, K, Co;
  int off[3];
};

// grid (ceil(B*HW / kBM), ceil(Co / kBN)), kDotThreads threads
__global__ void __launch_bounds__(kDotThreads) xm_dots_kernel(const DotArgs p) {
  __shared__ __align__(128) unsigned char smem[kBM * kCS * sizeof(float)];
  static_assert(kBM * kCS * sizeof(float) >= (kBM * kAS + kBK * kBS) * sizeof(__nv_bfloat16),
                "the accumulator tile reuses the staged tiles");
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kBM * kAS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int M = p.B * p.HW;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  // the operand row this thread loads: row m0 + arow, columns ahalf*16 + [0, 16)
  const int arow = threadIdx.x >> 1, ahalf = threadIdx.x & 1;
  const int am = m0 + arow;
  const bool avalid = am < M;
  const int ab = avalid ? am / p.HW : 0;
  const int ap = avalid ? am - ab * p.HW : 0;
  // the weight row this thread loads: row brow, columns bq*16 + [0, 16)
  const int brow = threadIdx.x >> 2, bq = threadIdx.x & 3;

  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;  // warp tile rows wr*32, cols wc*32

  for (int di = 0; di < 3; ++di) {
    const __nv_bfloat16* arow_ptr = p.xm + (static_cast<size_t>(ab) * p.R + ap + p.off[di]) * p.K;
    const __nv_bfloat16* wd = p.w + static_cast<size_t>(di) * p.K * p.Co;
    for (int k0 = 0; k0 < p.K; k0 += kBK) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int kk = k0 + ahalf * 16 + v * kVec;
        __nv_bfloat16* dst = As + arow * kAS + ahalf * 16 + v * kVec;
        if (avalid && kk < p.K)
          copy8(arow_ptr + kk, dst);
        else
          zero8(dst);
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int kr = k0 + brow;
        const int nn = n0 + bq * 16 + v * kVec;
        __nv_bfloat16* dst = Bs + brow * kBS + bq * 16 + v * kVec;
        if (kr < p.K && nn < p.Co)
          copy8(wd + static_cast<size_t>(kr) * p.Co + nn, dst);
        else
          zero8(dst);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * kAS + ks, kAS);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + ks * kBS + wc * 32 + j * 16, kBS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * kCS + wc * 32 + j * 16, acc[i][j], kCS,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * kBN / kVec; e += kDotThreads) {
    const int row = e / (kBN / kVec);
    const int col = (e - row * (kBN / kVec)) * kVec;
    const int m = m0 + row, nn = n0 + col;
    if (m >= M || nn >= p.Co) continue;
    store8(p.y + static_cast<size_t>(m) * p.Co + nn, Cs + row * kCS + col);
  }
}

}  // namespace

// nbytes (a multiple of 16) from src to dst, both 16-byte aligned.
extern "C" int ablate_copy(const void* src, void* dst, long long nbytes, void* stream) {
  const size_t n = static_cast<size_t>(nbytes) / 16;
  const size_t per_block = static_cast<size_t>(kCopyThreads) * kCopyUnroll;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  if (blocks == 0) return 0;
  copy_kernel<<<blocks, kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}

// x [B, H*W, C] -> out [B, R, nblk*C], both bf16 (if bf16) or f32, C a
// multiple of 8; block k of row r is xm[r + ro_k, block cb_k]; with sum,
// out [B, R, C] is xm[r + ro_0, cb_0] + xm[r + ro_1, cb_1].
extern "C" int ablate_build_xm(int bf16, const void* x, void* out, int B, int H, int W, int C,
                               int R, int nblk, int sum, int ro0, int ro1, int ro2, int cb0,
                               int cb1, int cb2, void* stream) {
  const XmArgs a{x, out, B, H, W, C, R, nblk, sum, {ro0, ro1, ro2}, {cb0, cb1, cb2}};
  const size_t items = static_cast<size_t>(B) * R * nblk * (C / kVec);
  const unsigned blocks = static_cast<unsigned>((items + kBuildThreads - 1) / kBuildThreads);
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    build_xm_kernel<__nv_bfloat16><<<blocks, kBuildThreads, 0, s>>>(a, items);
  else
    build_xm_kernel<float><<<blocks, kBuildThreads, 0, s>>>(a, items);
  return static_cast<int>(cudaGetLastError());
}

// y [B, HW, Co] = sum_di xm[:, off_di : off_di + HW] @ w[di], bf16 in and
// out, f32 accumulation; xm [B, R, K], w [3, K, Co]; K and Co multiples of
// 8, off_di + HW <= R, pointers 16-byte aligned.
extern "C" int ablate_xm_dots(const void* xm, const void* w, void* y, int B, int R, int HW, int K,
                              int Co, int off0, int off1, int off2, void* stream) {
  const DotArgs p{static_cast<const __nv_bfloat16*>(xm), static_cast<const __nv_bfloat16*>(w),
                  static_cast<__nv_bfloat16*>(y), B, R, HW, K, Co, {off0, off1, off2}};
  const size_t m = static_cast<size_t>(B) * HW;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM), (Co + kBN - 1) / kBN);
  if (m == 0) return 0;
  xm_dots_kernel<<<grid, kDotThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
