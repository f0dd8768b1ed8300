// Fused conv + instance-norm unit (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelwiseregression_tpu/ops/pallas_fused.py::_fused_chain_kernel.
// One unit is [relu(norm(x)) prologue] -> 1x1 or 3x3 conv (stride 1, zero
// padding, + bias) -> [relu(norm(y)) epilogue] -> [+ skip], on NHWC
// activations in bf16 or f32, with the TPU kernel's rounding points:
//   * prologue: y32*a + b in f32 (two roundings, no FMA), relu, cast;
//   * conv: f32 accumulation, + bias in f32, cast;
//   * epilogue: statistics of the cast conv output, then as the prologue;
//   * skip: added in the act dtype.
// Zero padding is applied after the prologue: a padded tap is a zero of the
// normalised input. Statistics are the exact two-pass mean and biased
// variance per (sample, channel) in f32, eps inside the rsqrt.
//
// What bounds it, at batch 256: tensor-core operations for the 3x3 units at
// 64->128 and 128->128 (the head unit is 309 GFLOP against 0.54 GB of
// activations), device-memory bytes for the rest (the 1x1 units, and the
// 3x3 units at 32->64 and 64->64, whose operations take less time than
// their bytes), and bytes alone for the norms. The TPU kernel kept a whole
// sample ([HW, C], 1-2 MiB) in VMEM to take both passes of the statistics
// there; here a unit is at most three kernels:
//   * norm_kernel<T, false>, the prologue statistics: one thread-block
//     cluster a sample, whose blocks hold the sample's slices in shared
//     memory (cluster_norm.cuh), so x leaves device memory once (a sample
//     too large for the cluster is streamed, each pass reading it again);
//     both passes in a fixed order (deterministic, no atomics); it folds
//     the affine into a = rsqrt(var+eps)*scale and b = bias - mean*a;
//   * the conv, an implicit GEMM over M = B*H*W pixels, N = Co, K = k*k*C,
//     with the prologue applied to each input tile once it has landed:
//       - bf16 (conv_wgmma_kernel): 256 pixels by 64 or 128 output channels
//         per 512-thread block, four warpgroups of 64 rows, each running
//         wgmma.mma_async m64n64k16 or m64n128k16 (sm90_wgmma.cuh) from
//         shared-memory descriptors into f32 registers. K steps are 64 deep
//         (8 chunks of 8 channels over the flattened taps x channels, so
//         C = 32 takes two taps a step), in rows of 128 bytes under the
//         128-byte swizzle, over a ring of three stages filled by cp.async:
//         the products of step s run while the threads start step s+2's
//         copies and wait for, normalise and fence step s+1's; one barrier
//         per step. Eight threads copy one pixel's (or one weight row's)
//         128 contiguous bytes, which the swizzle spreads over all 32 banks:
//         with 8 rows x 64 bytes a warp, the copies, not the products, set
//         the loop's speed;
//       - f32 (conv_f32_kernel): 64x64 tiles per 128-thread block, K steps
//         of one tap by 32 channels, by f32 FMA (never TF32);
//     the epilogue adds the bias (and the skip) from a shared-memory copy of
//     the accumulators, with K4's split taps (even and odd taps summed
//     apart) as two passes over the K loop in bf16;
//   * norm_kernel<T, true>, the epilogue: the same cluster kernel, which
//     also writes [skip +] relu(x*a + b) from the slice it holds.
// A unit therefore reads its input once for the prologue statistics and
// once per tap for the conv (from L2 after the first), and writes the
// pre-norm conv output once more, and reads it once, when it has an
// epilogue. Every block streams the whole weight tensor through L2. Later
// work: TMA loads (with multicast of the weights across a cluster) and a
// warp-specialised producer for the ring, a persistent grid, the epilogue
// statistics summed by the conv itself with the apply folded into the next
// unit's prologue, and a tile that loads its input once for all nine taps.

#include "cluster_norm.cuh"
#include "fused_common.cuh"
#include "sm90_wgmma.cuh"
#include "vec8.cuh"

namespace fused {
namespace {

using pwr::copy8;
using pwr::kVec;
using pwr::load8;
using pwr::round_act;
using pwr::store8;
using pwr::zero8;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::KPos;
using sm90::sw128;

// f32 conv
constexpr int kBM = 64;   // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // input channels per K step (of one tap)
constexpr int kConvThreads = 128;
constexpr int kAStride = kBK + 4;  // shared-memory rows, 16-byte aligned
constexpr int kBStride = kBN + 4;
constexpr int kCStride = kBN + 4;  // f32 accumulator tile rows
// bf16 conv (wgmma)
constexpr int kWgBM = 256;                          // output pixels per block: four warpgroups
constexpr int kWgBK = 64;                           // K slots per step
constexpr int kWgThreads = 512;
constexpr int kWgStages = 3;                        // stages of the ring
constexpr int kChunks = kWgBK / kVec;               // 16-byte chunks per row and step
constexpr int kRowBytes = kWgBK * 2;                // one row of a step: 128 bytes
constexpr int kAtom = sm90::kSwAtom;                // 8 rows: the 128-byte swizzle's repeat
static_assert(kRowBytes == sm90::kSwRow, "a K step is one swizzled row");
constexpr int kRowsPerPass = kWgThreads / kChunks;  // rows the threads copy at once
constexpr int kWgAPer = kWgBM / kRowsPerPass;       // A chunks per thread and step
constexpr int kWgABytes = kWgBM * kRowBytes;

template <int BN>
__host__ __device__ constexpr int wg_stage_bytes() { return kWgABytes + kWgBK * BN * 2; }
template <int BN>
__host__ __device__ constexpr int wg_cs_stride() { return BN + 8; }  // float2 stores free of conflicts

template <int BN>
constexpr size_t wg_smem_bytes() {
  const size_t ring = kWgStages * static_cast<size_t>(wg_stage_bytes<BN>());
  const size_t cs = static_cast<size_t>(kWgBM) * wg_cs_stride<BN>() * sizeof(float);
  return (ring > cs ? ring : cs) + kAtom;  // + the alignment of the ring to an atom
}

constexpr size_t f32_smem_bytes() {
  const size_t main = static_cast<size_t>(kBM * kAStride + kBK * kBStride) * sizeof(float);
  const size_t epi = static_cast<size_t>(kBM) * kCStride * sizeof(float);
  return main > epi ? main : epi;
}

// ------------------------------------------------- statistics and apply

struct NormArgs {
  const void* x;       // [B, HW, C]
  const float* scale;  // [C]
  const float* bias;
  float* a;            // [B, C] coefficients out, or null
  float* b;
  const void* skip;    // [B, HW, C] added after the apply, or null
  void* y;             // [B, HW, C] (kApply)
  float eps;
};

// One cluster per sample (cluster_norm.cuh): the exact two-pass mean and
// biased variance of each channel, a = rsqrt(var+eps)*scale and
// b = bias - mean*a (stored by rank 0 where a is given), and with kApply
// y = [skip +] round(relu(x*a + b)) from the slice in shared memory.
template <typename T, bool kApply>
__global__ void __launch_bounds__(cnorm::kThreads, 1) norm_kernel(const __grid_constant__ cnorm::Plan p,
                                                               const NormArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = cnorm::vec<T>();
  const int n = blockIdx.x / p.cs;
  const int rank = blockIdx.x % p.cs;
  const size_t sample = static_cast<size_t>(n) * p.HW * p.C;
  const T* x = static_cast<const T*>(args.x) + sample;
  cnorm::Slices<T, 1> sl(p, smem, {x}, rank);
  const int r_first = rank * p.slice;  // the slice's first pixel in the sample
  float* mu = sl.coef();
  float* ca = mu + p.cw;
  float* cb = ca + p.cw;
  for (int c0 = 0; c0 < p.C; c0 += p.cw) {
    const cnorm::Lanes<V> l(c0, min(p.cw, p.C - c0));
    const int cc = l.channel();
    // this thread's first channel's scale and bias, fetched ahead of the reductions
    const bool own = threadIdx.x < l.ccw;
    const float scale0 = own ? args.scale[c0 + threadIdx.x] : 0.f;
    const float bias0 = own ? args.bias[c0 + threadIdx.x] : 0.f;
    float acc[1][V] = {};
    sl.pass([&](const T* const (&at)[1], int, int rows) {
      if (l.on)
        cnorm::each_row(l, at, p.C, rows, [&](const float (&v)[1][V], int) {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[0][j] += v[0][j];
        });
    });
    const float* tot = sl.reduce(acc, l, false);
    for (int c = threadIdx.x; c < l.ccw; c += cnorm::kThreads) mu[c] = tot[c] / static_cast<float>(p.HW);
    __syncthreads();
    float m[V];
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = l.on ? mu[l.gi * V + j] : 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[0][j] = 0.f;
    sl.pass([&](const T* const (&at)[1], int, int rows) {
      if (l.on)
        cnorm::each_row(l, at, p.C, rows, [&](const float (&v)[1][V], int) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float d = v[0][j] - m[j];
            acc[0][j] = fmaf(d, d, acc[0][j]);
          }
        });
    });
    tot = sl.reduce(acc, l, c0 + p.cw >= p.C);
    for (int c = threadIdx.x; c < l.ccw; c += cnorm::kThreads) {
      const float var = tot[c] / static_cast<float>(p.HW);
      const float inv = 1.0f / sqrtf(var + args.eps);
      const bool first = c == static_cast<int>(threadIdx.x);
      const float ai = __fmul_rn(inv, first ? scale0 : args.scale[c0 + c]);
      const float bi = __fsub_rn(first ? bias0 : args.bias[c0 + c], __fmul_rn(mu[c], ai));
      ca[c] = ai;
      cb[c] = bi;
      if (rank == 0 && args.a != nullptr) {
        args.a[static_cast<size_t>(n) * p.C + c0 + c] = ai;
        args.b[static_cast<size_t>(n) * p.C + c0 + c] = bi;
      }
    }
    if constexpr (kApply) {
      __syncthreads();
      float a[V], b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[j] = l.on ? ca[l.gi * V + j] : 0.f;
        b[j] = l.on ? cb[l.gi * V + j] : 0.f;
      }
      const T* skip = args.skip != nullptr ? static_cast<const T*>(args.skip) + sample : nullptr;
      T* y = static_cast<T*>(args.y) + sample;
      sl.pass([&](const T* const (&at)[1], int r0, int rows) {
        if (l.on)
          cnorm::each_row(l, at, p.C, rows, [&](const float (&in)[1][V], int q) {
            float v[V];
#pragma unroll
            for (int j = 0; j < V; ++j)
              v[j] = round_act<T>(fmaxf(__fadd_rn(__fmul_rn(in[0][j], a[j]), b[j]), 0.f));
            const int e = (r_first + r0 + q) * p.C + cc;
            if (skip != nullptr) {
              float s[V];
              cnorm::ld16(skip + e, s);
#pragma unroll
              for (int j = 0; j < V; ++j) v[j] = __fadd_rn(v[j], s[j]);
            }
            cnorm::st16(y + e, v);
          });
      });
    }
    __syncthreads();  // mu, ca and cb are read before the next chunk writes them
  }
  sl.finish();
}

// ---------------------------------------------------------------- conv

template <typename T>
__device__ __forceinline__ float prologue1(float v, float a, float b, int mode) {
  if (mode == kProF32) return fmaxf(__fadd_rn(__fmul_rn(v, a), b), 0.f);
  return fmaxf(round_act<T>(__fadd_rn(round_act<T>(__fmul_rn(v, round_act<T>(a))), round_act<T>(b))), 0.f);
}

template <typename T>
__device__ __forceinline__ void prologue(float v[kVec], const float* a, const float* b, int mode) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = prologue1<T>(v[k], a[k], b[k], mode);
}

// y = [skip +] round(Cs + bias) for a [kRows, kCols] tile of f32 sums in
// shared memory (rows 16-byte aligned); each thread keeps 8 output channels
// and steps down the rows.
template <typename T, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void store_tile(const float* Cs, int cs_stride, const ConvArgs& p,
                                           int m0, int n0, int M) {
  constexpr int kPerRow = kCols / kVec;
  static_assert(kThreads % kPerRow == 0, "a thread keeps its columns");
  const int col = (threadIdx.x % kPerRow) * kVec;
  const int nn = n0 + col;
  if (nn >= p.Co) return;
  const T* __restrict__ skip = static_cast<const T*>(p.skip);
  T* __restrict__ y = static_cast<T*>(p.y);
  float bias[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) bias[k] = p.bias[nn + k];
  for (int row = threadIdx.x / kPerRow; row < kRows && m0 + row < M; row += kThreads / kPerRow) {
    const size_t m = static_cast<size_t>(m0 + row);
    const float4 lo = *reinterpret_cast<const float4*>(Cs + row * cs_stride + col);
    const float4 hi = *reinterpret_cast<const float4*>(Cs + row * cs_stride + col + 4);
    const float sum[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = round_act<T>(__fadd_rn(sum[k], bias[k]));
    if (skip != nullptr) {
      float sk[kVec];
      load8(skip + m * p.Co + nn, sk);
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = __fadd_rn(v[k], sk[k]);
    }
    store8(y + m * p.Co + nn, v);
  }
}

// f32: grid (ceil(M/kBM), ceil(Co/kBN)), kConvThreads threads.
template <bool kSplit>
__global__ void __launch_bounds__(kConvThreads) conv_f32_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + kBM * kAStride;
  float* Cs = reinterpret_cast<float*>(smem);  // reuses the tiles after the K loop

  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ w = static_cast<const float*>(p.w);
  const int HW = p.H * p.W;
  const int M = p.B * HW;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int r = p.k >> 1;

  // the input row this thread loads: pixel m0 + arow, channels ahalf*16 + [0, 16)
  const int arow = threadIdx.x >> 1;
  const int ahalf = threadIdx.x & 1;
  const int am = m0 + arow;
  int an = 0, ay = 0, ax = 0;
  if (am < M) {
    an = am / HW;
    const int pix = am - an * HW;
    ay = pix / p.W;
    ax = pix - ay * p.W;
  }
  // the weight row this thread loads: channel brow, output channels bq*16 + [0, 16)
  const int brow = threadIdx.x >> 2;
  const int bq = threadIdx.x & 3;

  float facc[4][8], facc2[4][8];
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;  // rows ty*4, cols tx*8
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) facc[i][j] = facc2[i][j] = 0.f;

  const int taps = p.k * p.k;
  for (int tap = 0; tap < taps; ++tap) {
    const int ys = ay + tap / p.k - r;
    const int xs = ax + tap % p.k - r;
    const bool avalid = am < M && ys >= 0 && ys < p.H && xs >= 0 && xs < p.W;
    const bool odd = kSplit && (tap & 1);
    for (int c0 = 0; c0 < p.C; c0 += kBK) {
      // input tile [kBM, kBK], normalised as it loads; padding and channels past C are zeros
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int cc = c0 + ahalf * 16 + v * kVec;
        float* dst = As + arow * kAStride + ahalf * 16 + v * kVec;
        if (avalid && cc < p.C) {
          const float* src = x + ((static_cast<size_t>(an) * p.H + ys) * p.W + xs) * p.C + cc;
          if (p.pro_mode == kProNone) {
            copy8(src, dst);
          } else {
            float f[kVec];
            load8(src, f);
            const size_t nc = static_cast<size_t>(an) * p.C + cc;
            prologue<float>(f, p.pro_a + nc, p.pro_b + nc, p.pro_mode);
            store8(dst, f);
          }
        } else {
          zero8(dst);
        }
      }
      // weight tile [kBK, kBN]
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int c = c0 + brow;
        const int nn = n0 + bq * 16 + v * kVec;
        float* dst = Bs + brow * kBStride + bq * 16 + v * kVec;
        if (c < p.C && nn < p.Co)
          copy8(w + (static_cast<size_t>(tap) * p.C + c) * p.Co + nn, dst);
        else
          zero8(dst);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[(ty * 4 + i) * kAStride + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * kBStride + tx * 8 + j];
        if (odd) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) facc2[i][j] = fmaf(av[i], bv[j], facc2[i][j]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  // accumulators -> shared memory (over the dead tiles); split taps: the two sums added
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Cs[(ty * 4 + i) * kCStride + tx * 8 + j] = kSplit ? __fadd_rn(facc[i][j], facc2[i][j]) : facc[i][j];
  __syncthreads();
  store_tile<float, kBM, kBN, kConvThreads>(Cs, kCStride, p, m0, n0, M);
}

// two f32 values rounded to nearest even into a bf16 pair
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

// bf16: grid (ceil(M/kWgBM), ceil(Co/BN)), kWgThreads threads; warpgroup wg
// computes tile rows wg*64 + [0, 64) by BN output channels.
//
// A K step is 64 channels: one 128-byte row per pixel of A [256 pixels, 64]
// (K-major) and per K row of B [64, BN] (MN-major, in 64-column atoms), both
// under the 128-byte swizzle, 8 rows to an atom of 1024 bytes. A's
// descriptor: SBO (next 8 rows) one atom, the k16 slice ks 32*ks bytes into
// the row; B's: LBO (next 64 columns) one atom, SBO (next 8 K rows) BN/64
// atoms, the slice ks 2*ks atom rows down. Each group of 8 threads copies
// one 128-byte row (a pixel's 64 channels, or 64 output channels of a
// weight row) with 16-byte cp.async: contiguous in device memory, and over
// all 32 banks once in shared memory. A prologue is applied in place by the
// thread that copied the chunk, once its copies have landed, before the
// barrier that hands the stage to the tensor cores.
//
// The ring holds kWgStages stages, kWgStages-1 steps ahead: step s's
// products are issued right after the barrier and run while the threads
// issue step s+kWgStages-1's copies and then wait for, normalise and fence
// step s+1's; wgmma.wait_group 0 before the next barrier frees the stage
// the next copies refill.
template <int BN, bool kSplit>
__global__ void __launch_bounds__(kWgThreads, 1) conv_wgmma_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int tap_off[9];  // element offset of each tap's input pixel
  __shared__ int tap_dy[9], tap_dx[9];
  constexpr int kAtomsN = BN / 64;  // 64-column atoms of B
  constexpr int kBPer = kWgBK * BN / kVec / kWgThreads;
  constexpr int kStage = wg_stage_bytes<BN>();
  // the swizzle repeats every atom: the ring starts on an atom boundary
  unsigned char* smem =
      smem_raw + ((kAtom - (__cvta_generic_to_shared(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* __restrict__ w = static_cast<const __nv_bfloat16*>(p.w);
  const int t = threadIdx.x;
  const int wg = t >> 7;
  const int HW = p.H * p.W;
  const int M = p.B * HW;
  const int m0 = blockIdx.x * kWgBM;
  const int n0 = blockIdx.y * BN;
  const int cpt = p.C / kVec;  // K chunks per tap
  if (t < p.k * p.k) {
    const int r = p.k >> 1;
    tap_dy[t] = t / p.k - r;
    tap_dx[t] = t % p.k - r;
    tap_off[t] = (tap_dy[t] * p.W + tap_dx[t]) * p.C;
  }

  // A: chunk c of tile rows t/8 + 64i; each row resolves its own (sample,
  // y, x), since a tile may span samples; rows past M copy zeros
  const int c = t & (kChunks - 1);
  const int arow = t >> 3;
  int am[kWgAPer], ay[kWgAPer], ax[kWgAPer];
#pragma unroll
  for (int i = 0; i < kWgAPer; ++i) {
    const int m = m0 + arow + kRowsPerPass * i;
    am[i] = min(m, M - 1);
    const int pix = am[i] % HW;
    ay[i] = m < M ? pix / p.W : -(1 << 28);
    ax[i] = pix % p.W;
  }
  const int n_first = m0 / HW;
  const bool one_sample = (min(m0 + kWgBM, M) - 1) / HW == n_first;
  // B: chunk c of output channels n0 + bcol, K rows brow(i)
  const int batom = (t >> 3) % kAtomsN;
  const int bcol = batom * 64 + c * kVec;
  const bool bon = n0 + bcol < p.Co;

  int tap0 = 0, tstride = 1, ntaps = p.k * p.k;
  unsigned amask = 0;  // per stage, 4 bits: the A chunks that hold input data

  // copies of the step whose first chunk is at `at` into stage `stage`
  auto issue = [&](KPos at, int stage) {
    unsigned char* sa = smem + stage * kStage;
    unsigned char* sb = sa + kWgABytes;
    const KPos a = at.plus(c, cpt);
    const bool kin = a.tap < ntaps;
    const int tap = kin ? tap0 + tstride * a.tap : 0;
    const int off = tap_off[tap] + a.chunk * kVec;
    const int dy = tap_dy[tap], dx = tap_dx[tap];
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < kWgAPer; ++i) {
      const int ys = ay[i] + dy, xs = ax[i] + dx;
      const bool ok = kin && ys >= 0 && ys < p.H && xs >= 0 && xs < p.W;
      cp_async16(sa + sw128(arow + kRowsPerPass * i, c),
                 ok ? x + static_cast<size_t>(am[i]) * p.C + off : x, ok);
      m |= static_cast<unsigned>(ok) << i;
    }
    amask = (amask & ~(0xfu << (4 * stage))) | (m << (4 * stage));
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int brow = (i * kRowsPerPass + (t >> 3)) / kAtomsN;  // K row of the step
      const KPos b = at.plus(brow >> 3, cpt);
      const bool ok = bon && b.tap < ntaps;
      const int row = (tap0 + tstride * b.tap) * p.C + b.chunk * kVec + (brow & 7);
      cp_async16(sb + ((brow >> 3) * kAtomsN + batom) * kAtom + sw128(brow & 7, c),
                 ok ? w + static_cast<size_t>(row) * p.Co + n0 + bcol : w, ok);
    }
  };
  // the prologue, in place, on this thread's landed A chunks of stage `stage`
  auto normalise = [&](KPos at, int stage) {
    const unsigned m = (amask >> (4 * stage)) & 0xfu;
    if (p.pro_mode == kProNone || m == 0) return;
    unsigned char* sa = smem + stage * kStage;
    const int ac = at.plus(c, cpt).chunk * kVec;
    float ca[kVec], cb[kVec];
    auto coefs = [&](int n) {
      const size_t nc = static_cast<size_t>(n) * p.C + ac;  // 32-byte aligned
      load8(p.pro_a + nc, ca);
      load8(p.pro_b + nc, cb);
    };
    if (one_sample) coefs(n_first);
#pragma unroll
    for (int i = 0; i < kWgAPer; ++i) {
      if (!((m >> i) & 1u)) continue;
      if (!one_sample) coefs(am[i] / HW);
      uint4* chunk = reinterpret_cast<uint4*>(sa + sw128(arow + kRowsPerPass * i, c));
      const uint4 v = *chunk;
      uint32_t word[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < kVec / 2; ++j) {  // bf16 pairs: widen, normalise, round
        const float lo = prologue1<__nv_bfloat16>(__uint_as_float(word[j] << 16), ca[2 * j], cb[2 * j],
                                                  p.pro_mode);
        const float hi = prologue1<__nv_bfloat16>(__uint_as_float(word[j] & 0xffff0000u),
                                                  ca[2 * j + 1], cb[2 * j + 1], p.pro_mode);
        word[j] = pack2(lo, hi);
      }
      *chunk = make_uint4(word[0], word[1], word[2], word[3]);
    }
  };

  float acc[BN / 2];
  __nv_bfloat162 even[kSplit ? BN / 4 : 1];  // split taps: the even taps' sum, rounded
  __syncthreads();                           // the tap table
#pragma unroll 1
  for (int pass = 0; pass < (kSplit ? 2 : 1); ++pass) {
    if (kSplit) {
      tap0 = pass;
      tstride = 2;
      ntaps = (p.k * p.k - pass + 1) / 2;
    }
    const int steps = (ntaps * cpt + kChunks - 1) / kChunks;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    KPos load_at{0, 0}, use_at{0, 0};
    int load_stage = 0, use_stage = 0;
#pragma unroll
    for (int j = 0; j < kWgStages - 1; ++j) {
      if (j < steps) issue(load_at, load_stage);
      cp_async_commit();
      load_at = load_at.plus(kChunks, cpt);
      load_stage = load_stage + 1 == kWgStages ? 0 : load_stage + 1;
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kWgStages - 2>();  // this thread's copies of step s
      normalise(use_at, use_stage);
      use_at = use_at.plus(kChunks, cpt);
      sm90::fence_proxy_async();
      sm90::wait<0>();                 // this warpgroup's products of step s-1
      sm90::fence_operands(acc);
      __syncthreads();                 // step s in place; step s-1's stage free
      const unsigned char* sa = smem + use_stage * kStage + wg * 64 * kRowBytes;
      const unsigned char* sb = smem + use_stage * kStage + kWgABytes;
      sm90::mma_k64<BN>(acc, sa, sb);
      use_stage = use_stage + 1 == kWgStages ? 0 : use_stage + 1;
      if (s + kWgStages - 1 < steps) issue(load_at, load_stage);  // while the products run
      cp_async_commit();
      load_at = load_at.plus(kChunks, cpt);
      load_stage = load_stage + 1 == kWgStages ? 0 : load_stage + 1;
    }
    sm90::wait<0>();
    sm90::fence_operands(acc);
    __syncthreads();  // every warpgroup is done with the ring
    if constexpr (kSplit) {
      if (pass == 0) {
#pragma unroll
        for (int q = 0; q < BN / 4; ++q) even[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
      }
    }
  }

  // accumulators -> shared memory (over the ring); split taps: round(even) + round(odd)
  float* Cs = reinterpret_cast<float*>(smem);
  constexpr int CS = wg_cs_stride<BN>();
  const int row0 = wg * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
  const int col0 = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (kSplit) {
        const float2 e = __bfloat1622float2(even[2 * j + h]);
        v0 = __fadd_rn(e.x, round_act<__nv_bfloat16>(v0));
        v1 = __fadd_rn(e.y, round_act<__nv_bfloat16>(v1));
      }
      *reinterpret_cast<float2*>(Cs + (row0 + 8 * h) * CS + 8 * j + col0) = make_float2(v0, v1);
    }
  __syncthreads();
  store_tile<__nv_bfloat16, kWgBM, BN, kWgThreads>(Cs, CS, p, m0, n0, M);
}

// K3's statistics (kApply false) or statistics and apply on one cluster a
// sample; out, if given, receives the plan (cnorm::describe).
template <typename T, bool kApply>
cudaError_t launch_norm(const NormArgs& args, int B, int HW, int C, cudaStream_t s, int* out) {
  static bool large = false;
  static const cudaError_t ready = cnorm::prepare(norm_kernel<T, kApply>, &large);
  if (ready != cudaSuccess) return ready;
  if (static_cast<long long>(HW) * C >= (1LL << 31)) return cudaErrorInvalidValue;
  const cnorm::Plan p = cnorm::plan(1, sizeof(T), 1, kApply ? 3 : 2, B, HW, C, large);
  if (p.smem == 0) return cudaErrorInvalidValue;
  if (out != nullptr) {
    cnorm::describe(p, out);
    return cudaSuccess;
  }
  return cnorm::launch(norm_kernel<T, kApply>, p, s, p, args);
}

cudaError_t norm(bool bf16, bool apply, const NormArgs& args, int B, int HW, int C, cudaStream_t s,
                 int* out = nullptr) {
  if (bf16)
    return apply ? launch_norm<__nv_bfloat16, true>(args, B, HW, C, s, out)
                 : launch_norm<__nv_bfloat16, false>(args, B, HW, C, s, out);
  return apply ? launch_norm<float, true>(args, B, HW, C, s, out)
               : launch_norm<float, false>(args, B, HW, C, s, out);
}

template <bool kSplit>
cudaError_t launch_conv_f32(const ConvArgs& p, cudaStream_t s) {
  const size_t m = static_cast<size_t>(p.B) * p.H * p.W;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM), (p.Co + kBN - 1) / kBN);
  conv_f32_kernel<kSplit><<<grid, kConvThreads, f32_smem_bytes(), s>>>(p);
  return cnorm::count(cudaGetLastError(), 1);
}

template <int BN, bool kSplit>
cudaError_t launch_conv_wgmma(const ConvArgs& p, cudaStream_t s) {
  constexpr size_t smem = wg_smem_bytes<BN>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_wgmma_kernel<BN, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const size_t m = static_cast<size_t>(p.B) * p.H * p.W;
  const dim3 grid(static_cast<unsigned>((m + kWgBM - 1) / kWgBM), (p.Co + BN - 1) / BN);
  conv_wgmma_kernel<BN, kSplit><<<grid, kWgThreads, smem, s>>>(p);
  return cnorm::count(cudaGetLastError(), 1);
}

// 128 output channels a block where Co allows it, but 64 with split taps,
// whose second accumulator would not fit beside 128 columns
template <bool kSplit>
cudaError_t launch_conv_bf16(const ConvArgs& p, cudaStream_t s) {
  if (kSplit || p.Co < 128) return launch_conv_wgmma<64, kSplit>(p, s);
  return launch_conv_wgmma<128, false>(p, s);
}

}  // namespace

cudaError_t norm_stats(bool bf16, const void* x, const float* scale, const float* bias, float* a,
                       float* b, int B, int HW, int C, float eps, cudaStream_t s) {
  return norm(bf16, false, NormArgs{x, scale, bias, a, b, nullptr, nullptr, eps}, B, HW, C, s);
}

cudaError_t conv(bool bf16, const ConvArgs& p, cudaStream_t s) {
  if (bf16) return p.split_taps ? launch_conv_bf16<true>(p, s) : launch_conv_bf16<false>(p, s);
  return p.split_taps ? launch_conv_f32<true>(p, s) : launch_conv_f32<false>(p, s);
}

}  // namespace fused

// One K3 unit: [prologue statistics] -> conv -> [epilogue statistics -> apply].
// x [B,H,W,C], w [k,k,C,Co] (HWIO), skip and y [B,H,W,Co], all in the act
// dtype (bf16 if bf16, else f32); bias [Co] and the norm scales and biases
// ([C] for the prologue, [Co] for the epilogue; null to leave one out) f32.
// tmp [B,H,W,Co] act dtype holds the pre-norm conv output when there is an
// epilogue; coef_a and coef_b hold B*max(C, Co) floats. C and Co are
// multiples of 8, k is 1 or 3, every pointer 16-byte aligned; the caller
// checks. Returns the first launch's cudaError_t.
extern "C" int fused_unit(int bf16, const void* x, const void* w, const float* bias,
                          const float* pro_scale, const float* pro_bias, const float* epi_scale,
                          const float* epi_bias, const void* skip, void* y, void* tmp,
                          float* coef_a, float* coef_b, int B, int H, int W, int C, int Co, int k,
                          float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pro = pro_scale != nullptr;
  const bool epi = epi_scale != nullptr;
  cudaError_t err = cudaSuccess;
  if (pro) {
    err = fused::norm_stats(bf16, x, pro_scale, pro_bias, coef_a, coef_b, B, H * W, C, eps, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused::ConvArgs args{x, w, bias, pro ? coef_a : nullptr, pro ? coef_b : nullptr,
                       epi ? nullptr : skip, epi ? tmp : y, B, H, W, C, Co, k,
                       pro ? fused::kProF32 : fused::kProNone, 0};
  err = fused::conv(bf16, args, s);
  if (err != cudaSuccess || !epi) return static_cast<int>(err);
  return static_cast<int>(fused::norm(
      bf16, true, fused::NormArgs{tmp, epi_scale, epi_bias, coef_a, coef_b, skip, y, eps}, B, H * W, Co, s));
}

// K3's statistics and apply alone, y = round(relu(x*a + b)) with a, b from
// x's own statistics: the stats-only probe of the ablation tools (K6).
// x and y [B, HW, C] in the act dtype, C a multiple of 8; scale and bias
// [C], coef_a and coef_b B*C floats. Returns the first launch's cudaError_t.
extern "C" int norm_stats_apply(int bf16, const void* x, const float* scale, const float* bias,
                                void* y, float* coef_a, float* coef_b, int B, int HW, int C,
                                float eps, void* stream) {
  return static_cast<int>(fused::norm(bf16, true,
                                      fused::NormArgs{x, scale, bias, coef_a, coef_b, nullptr, y, eps},
                                      B, HW, C, static_cast<cudaStream_t>(stream)));
}

// The plan K3's statistics (apply 0) or statistics and apply (apply 1)
// would run for [B, HW, C]: out[4] = cluster size, resident tensors (bit
// 0: x), ring slots (0: resident), shared memory a block. Returns a
// cudaError_t.
extern "C" int norm_plan(int bf16, int apply, int B, int HW, int C, int* out) {
  return static_cast<int>(fused::norm(bf16, apply, fused::NormArgs{}, B, HW, C, nullptr, out));
}

// Kernels that K3's and K5's launchers have launched in this process (K4's
// convs and statistics among them): kind 0 the norm kernels (K3's
// statistics and apply, K5's nr_kernel), kind 1 the others (the convs,
// K5's parameter sums).
extern "C" long long norm_launches(int kind) { return cnorm::launched()[kind != 0]; }
