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

using pwr::kVec;
using pwr::store8;

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;
constexpr int kBuildThreads = 256;
constexpr int kBuildPasses = 4;  // rows a build_xm thread keeps in flight
constexpr int kBuildRounds = 2;  // passes of kBuildPasses rows a block makes
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
  void* out;      // [B, R, nblk*C], or [B, R, C] with sum
  int H, W, C, R, nblk, sum;
  int ro[3], cb[3];
};

// the sum of two 16-byte chunks in f32, rounded once to T
template <typename T>
__device__ __forceinline__ uint4 add_chunks(uint4 a, uint4 b);
template <>
__device__ __forceinline__ uint4 add_chunks<float>(uint4 a, uint4 b) {
  return make_uint4(__float_as_uint(__fadd_rn(__uint_as_float(a.x), __uint_as_float(b.x))),
                    __float_as_uint(__fadd_rn(__uint_as_float(a.y), __uint_as_float(b.y))),
                    __float_as_uint(__fadd_rn(__uint_as_float(a.z), __uint_as_float(b.z))),
                    __float_as_uint(__fadd_rn(__uint_as_float(a.w), __uint_as_float(b.w))));
}
template <>
__device__ __forceinline__ uint4 add_chunks<__nv_bfloat16>(uint4 a, uint4 b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wa[i]));
    const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wb[i]));
    const __nv_bfloat162 h = __floats2bfloat162_rn(__fadd_rn(fa.x, fb.x), __fadd_rn(fa.y, fb.y));
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One source block of a thread's output column: xm's column block cb at
// row offset ro, resolved once per column; its rows are then found with
// 32-bit adds and compares.
struct XmSource {
  int ro_w;    // ro - W: the source row of output row r is q = r + ro_w
  int col_of;  // (ro - W) mod W: q's column is r's column + col_of, mod W
  int dj;      // horizontal tap, -1, 0 or 1
  int cc;      // first element of the chunk within the C channels
};

__device__ __forceinline__ XmSource xm_source(const XmArgs& a, int k, int cc) {
  // selects, not a.ro[k]: an indexed kernel parameter goes through local memory
  const int ro_w = (k == 0 ? a.ro[0] : k == 1 ? a.ro[1] : a.ro[2]) - a.W;
  const int cb = k == 0 ? a.cb[0] : k == 1 ? a.cb[1] : a.cb[2];
  return {ro_w, ((ro_w % a.W) + a.W) % a.W, cb - 1, cc};
}

// the chunk of output row r (column col) that source s reads, or zeros
template <typename T>
__device__ __forceinline__ uint4 xm_fetch(const T* __restrict__ x, const XmArgs& a, int HW,
                                          const XmSource& s, int r, int col) {
  const int q = r + s.ro_w;
  int cq = col + s.col_of;
  if (cq >= a.W) cq -= a.W;
  const bool on = q >= 0 && q < HW && !(s.dj < 0 && cq == 0) && !(s.dj > 0 && cq == a.W - 1);
  return on ? *reinterpret_cast<const uint4*>(x + (q + s.dj) * a.C + s.cc) : make_uint4(0, 0, 0, 0);
}

// grid (row tiles, B). The output rows of a sample are contiguous, cpr
// 16-byte chunks each; the block's threads cover rpp whole rows a pass
// (thread t: chunk t % cpr of row t / cpr, fixed, so its column block and
// source are resolved once), and each thread keeps kBuildPasses rows in
// flight, rpp apart, their loads issued before their stores. All index
// arithmetic is 32-bit within a sample (the host checks the sizes); rows
// of zeros (the vertical padding, a tap across an image row) load nothing.
template <typename T>
__global__ void __launch_bounds__(kBuildThreads) build_xm_kernel(const XmArgs a, int rpp, int tile) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements of a chunk
  const int cpb = a.C / kPer;
  const int cpr = (a.sum ? 1 : a.nblk) * cpb;
  const int HW = a.H * a.W;
  const T* __restrict__ x = static_cast<const T*>(a.x) + static_cast<size_t>(blockIdx.y) * HW * a.C;
  uint4* __restrict__ out = static_cast<uint4*>(a.out) + static_cast<size_t>(blockIdx.y) * a.R * cpr;
  const int r_first = blockIdx.x * tile;
  const int r_end = min(r_first + tile, a.R);
  const int rsub = cpr <= kBuildThreads ? threadIdx.x / cpr : 0;
  if (rsub >= rpp) return;
  const int step = rpp % a.W;  // a pass's move of the column
  for (int j = cpr <= kBuildThreads ? threadIdx.x % cpr : threadIdx.x; j < cpr; j += kBuildThreads) {
    const int k = j / cpb;
    const int cc = (j - k * cpb) * kPer;
    const XmSource s0 = xm_source(a, a.sum ? 0 : k, cc);
    const XmSource s1 = xm_source(a, 1, cc);  // sum's second operand
    int r = r_first + rsub;
    int col = r % a.W;
    for (; r < r_end; r += kBuildPasses * rpp) {
      uint4 v[kBuildPasses];
#pragma unroll
      for (int u = 0; u < kBuildPasses; ++u) {
        const int ru = r + u * rpp;
        if (ru < r_end) {
          v[u] = xm_fetch(x, a, HW, s0, ru, col);
          if (a.sum) v[u] = add_chunks<T>(v[u], xm_fetch(x, a, HW, s1, ru, col));
        }
        col += step;
        if (col >= a.W) col -= a.W;
      }
#pragma unroll
      for (int u = 0; u < kBuildPasses; ++u) {
        const int ru = r + u * rpp;
        if (ru < r_end) out[ru * cpr + j] = v[u];
      }
    }
  }
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
// out [B, R, C] is xm[r + ro_0, cb_0] + xm[r + ro_1, cb_1]. A sample's
// input and output each hold fewer than 2^31 elements, B at most 65535.
extern "C" int ablate_build_xm(int bf16, const void* x, void* out, int B, int H, int W, int C,
                               int R, int nblk, int sum, int ro0, int ro1, int ro2, int cb0,
                               int cb1, int cb2, void* stream) {
  const XmArgs a{x, out, H, W, C, R, nblk, sum, {ro0, ro1, ro2}, {cb0, cb1, cb2}};
  const long long wide = static_cast<long long>(R) * (sum ? 1 : nblk) * C;
  if (static_cast<long long>(H) * W * C >= (1LL << 31) || wide >= (1LL << 31) || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * R == 0 || C == 0) return 0;
  const int cpr = static_cast<int>(wide / R) / (bf16 ? 8 : 4);
  const int rpp = cpr <= kBuildThreads ? kBuildThreads / cpr : 1;
  const int tile = rpp * kBuildPasses * kBuildRounds;
  const dim3 grid((R + tile - 1) / tile, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    build_xm_kernel<__nv_bfloat16><<<grid, kBuildThreads, 0, s>>>(a, rpp, tile);
  else
    build_xm_kernel<float><<<grid, kBuildThreads, 0, s>>>(a, rpp, tile);
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
