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
//     products on a prebuilt operand, on K3's bf16 conv main loop
//     (fused_chain.cu, conv_wgmma_kernel): 256 pixels by 64 or 128 output
//     channels per 512-thread block, four warpgroups of 64 rows running
//     wgmma m64n64k16 or m64n128k16 (sm90_wgmma.cuh) from 128-byte-swizzled
//     shared memory into f32 registers, 64-deep K steps over the flattened
//     taps x K (a step may straddle two taps; past the last tap it is
//     zeros), a three-stage ring that cp.async fills two steps ahead, bf16
//     out through a shared-memory tile in 16-byte stores. Each pixel row
//     resolves its own sample, so a tile may span two. Bound by
//     tensor-core operations at the head shape (K = 384 a tap, Co = 128):
//     18 steps of 32 KB of operand and 16 KB of weights a block, as K3's
//     head conv. Offsets (0, W, 2W) take the three vertical taps of xm;
//     (0, 0, 0) the one row of an operand repeated three times.
// Each launcher enqueues on the given stream, allocates nothing and returns
// the launch's cudaError_t.

#include "sm90_wgmma.cuh"
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
// xm_dots
constexpr int kDotBM = 256;                          // output pixels per block: four warpgroups
constexpr int kDotBK = 64;                           // K slots per step: one 128-byte row
constexpr int kDotThreads = 512;
constexpr int kDotStages = 3;
constexpr int kChunks = kDotBK / kVec;               // 16-byte chunks per row and step
constexpr int kRowsPerPass = kDotThreads / kChunks;  // rows the threads copy at once
constexpr int kAPer = kDotBM / kRowsPerPass;         // A chunks per thread and step
constexpr int kABytes = kDotBM * sm90::kSwRow;
constexpr int kTaps = 3;
static_assert(kDotBK * 2 == sm90::kSwRow, "a K step is one swizzled row");

template <int BN>
__host__ __device__ constexpr int dot_stage_bytes() { return kABytes + kDotBK * BN * 2; }
template <int BN>
__host__ __device__ constexpr int dot_cs_stride() { return BN + 8; }  // float2 stores free of conflicts

template <int BN>
constexpr size_t dot_smem_bytes() {
  const size_t ring = kDotStages * static_cast<size_t>(dot_stage_bytes<BN>());
  const size_t cs = static_cast<size_t>(kDotBM) * dot_cs_stride<BN>() * sizeof(float);
  return (ring > cs ? ring : cs) + sm90::kSwAtom;  // + the alignment of the ring to an atom
}

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

// grid (ceil(B*HW / kDotBM), ceil(Co / BN)), kDotThreads threads; warpgroup
// wg computes tile rows wg*64 + [0, 64) by BN output channels.
//
// A K step is 64 slots of the flattened taps x K: one 128-byte row per
// pixel of A [256 pixels, 64] (K-major) and per K row of B [64, BN]
// (MN-major, in 64-column atoms), under the 128-byte swizzle, multiplied
// by sm90::mma_k64 as in K3's conv_wgmma_kernel. The ring holds kDotStages stages,
// kDotStages-1 steps ahead: step s's products are issued right after the
// barrier and run while the threads issue step s+2's copies and wait for
// step s+1's; wgmma.wait_group 0 before the next barrier frees the stage
// the next copies refill.
template <int BN>
__global__ void __launch_bounds__(kDotThreads, 1) xm_dots_kernel(const DotArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kAtom = sm90::kSwAtom;
  constexpr int kAtomsN = BN / 64;  // 64-column atoms of B
  constexpr int kBPer = kDotBK * BN / kVec / kDotThreads;
  constexpr int kStage = dot_stage_bytes<BN>();
  // the swizzle repeats every atom: the ring starts on an atom boundary
  unsigned char* smem =
      smem_raw + ((kAtom - (__cvta_generic_to_shared(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  const __nv_bfloat16* __restrict__ xm = p.xm;
  const __nv_bfloat16* __restrict__ w = p.w;
  const int t = threadIdx.x;
  const int wg = t >> 7;
  const int M = p.B * p.HW;
  const int m0 = blockIdx.x * kDotBM;
  const int n0 = blockIdx.y * BN;
  const int cpt = p.K / kVec;  // K chunks per tap

  // A: chunk c of tile rows t/8 + 64i; each row resolves its own sample
  // (a tile may span two): its operand row at offset 0, or -1 past M
  const int c = t & (kChunks - 1);
  const int arow = t >> 3;
  int abase[kAPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int m = m0 + arow + kRowsPerPass * i;
    const int b = m / p.HW;
    abase[i] = m < M ? b * p.R + (m - b * p.HW) : -1;
  }
  // B: chunk c of output channels n0 + bcol, K rows brow(i)
  const int batom = (t >> 3) % kAtomsN;
  const int bcol = batom * 64 + c * kVec;
  const bool bon = n0 + bcol < p.Co;

  // copies of the step whose first chunk is at `at` into stage `stage`
  auto issue = [&](sm90::KPos at, int stage) {
    unsigned char* sa = smem + stage * kStage;
    unsigned char* sb = sa + kABytes;
    const sm90::KPos a = at.plus(c, cpt);
    const bool kin = a.tap < kTaps;
    const int off = a.tap == 0 ? p.off[0] : a.tap == 1 ? p.off[1] : p.off[2];
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const bool ok = kin && abase[i] >= 0;
      sm90::cp_async16(sa + sm90::sw128(arow + kRowsPerPass * i, c),
                       ok ? xm + static_cast<size_t>(abase[i] + off) * p.K + a.chunk * kVec : xm, ok);
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int brow = (i * kRowsPerPass + (t >> 3)) / kAtomsN;  // K row of the step
      const sm90::KPos b = at.plus(brow >> 3, cpt);
      const bool ok = bon && b.tap < kTaps;
      const int row = b.tap * p.K + b.chunk * kVec + (brow & 7);
      sm90::cp_async16(sb + ((brow >> 3) * kAtomsN + batom) * kAtom + sm90::sw128(brow & 7, c),
                       ok ? w + static_cast<size_t>(row) * p.Co + n0 + bcol : w, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  const int steps = (kTaps * cpt + kChunks - 1) / kChunks;
  sm90::KPos load_at{0, 0};
  int load_stage = 0, use_stage = 0;
#pragma unroll
  for (int j = 0; j < kDotStages - 1; ++j) {
    if (j < steps) issue(load_at, load_stage);
    sm90::cp_async_commit();
    load_at = load_at.plus(kChunks, cpt);
    load_stage = load_stage + 1 == kDotStages ? 0 : load_stage + 1;
  }
  for (int s = 0; s < steps; ++s) {
    sm90::cp_async_wait<kDotStages - 2>();  // this thread's copies of step s
    sm90::fence_proxy_async();
    sm90::wait<0>();                        // this warpgroup's products of step s-1
    sm90::fence_operands(acc);
    __syncthreads();                        // step s in place; step s-1's stage free
    const unsigned char* sa = smem + use_stage * kStage + wg * 64 * sm90::kSwRow;
    const unsigned char* sb = smem + use_stage * kStage + kABytes;
    sm90::mma_k64<BN>(acc, sa, sb);
    use_stage = use_stage + 1 == kDotStages ? 0 : use_stage + 1;
    if (s + kDotStages - 1 < steps) issue(load_at, load_stage);  // while the products run
    sm90::cp_async_commit();
    load_at = load_at.plus(kChunks, cpt);
    load_stage = load_stage + 1 == kDotStages ? 0 : load_stage + 1;
  }
  sm90::wait<0>();
  sm90::fence_operands(acc);
  __syncthreads();  // every warpgroup is done with the ring

  // accumulators -> shared memory (over the ring) -> y in 16-byte stores
  float* Cs = reinterpret_cast<float*>(smem);
  constexpr int CS = dot_cs_stride<BN>();
  const int row0 = wg * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
  const int col0 = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(Cs + (row0 + 8 * h) * CS + 8 * j + col0) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
  constexpr int kPerRow = BN / kVec;
  const int col = (t % kPerRow) * kVec;
  if (n0 + col >= p.Co) return;
  for (int row = t / kPerRow; row < kDotBM && m0 + row < M; row += kDotThreads / kPerRow) {
    const float4 lo = *reinterpret_cast<const float4*>(Cs + row * CS + col);
    const float4 hi = *reinterpret_cast<const float4*>(Cs + row * CS + col + 4);
    const float v[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    store8(p.y + static_cast<size_t>(m0 + row) * p.Co + n0 + col, v);
  }
}

template <int BN>
cudaError_t launch_xm_dots(const DotArgs& p, cudaStream_t s) {
  constexpr size_t smem = dot_smem_bytes<BN>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      xm_dots_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const size_t m = static_cast<size_t>(p.B) * p.HW;
  const dim3 grid(static_cast<unsigned>((m + kDotBM - 1) / kDotBM), (p.Co + BN - 1) / BN);
  xm_dots_kernel<BN><<<grid, kDotThreads, smem, s>>>(p);
  return cudaGetLastError();
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
  if (static_cast<size_t>(B) * HW == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128 output channels a block where Co allows it, as K3's conv
  return static_cast<int>(Co >= 128 ? launch_xm_dots<128>(p, s) : launch_xm_dots<64>(p, s));
}
