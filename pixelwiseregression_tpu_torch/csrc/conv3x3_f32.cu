// A 3x3 conv, stride 1, padding 1, in float32 on NCHW tensors, for Hopper
// (sm_90a): the pixelwise heads' 128 -> 128 convs at 64x64 in an f32 model.
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA. It was
// added because cuDNN, with TF32 off, runs these convs by its FFT algorithm
// at about 15% of the card's float32 rate, 40% of an f32 train step.
//
// What bounds it: f32 fused multiply-adds outside the tensor cores,
// 2 * 9 * Cin * Cout operations a pixel over 67 TFLOP/s; reading the input
// and writing the output once is ~260 times fewer bytes than operations at
// 128 channels, far below the card's 20 operations a byte.
//
// Design: an implicit GEMM over M = output pixels, N = output channels and
// K = Cin x 9 taps, read and written in NCHW, so the model needs no
// transposes.
//   * A block of 256 threads owns two output rows of one sample (128
//     pixels) by 128 output channels. Each thread holds an 8x8 register
//     tile, 8 neighbouring pixels of one row by 8 channels (two runs of 4,
//     64 apart), and computes it by FFMA, never TF32, in two levels of f32
//     accumulators: a chunk's 72 products a tile element, then the sum of
//     the chunks. One chain of 9 * Cin FMAs would round up to ~3.6x further
//     from exact than cuDNN's FFT algorithm at the worst output (1.08e-5
//     against 3.0e-6 at [128, 128, 64, 64]); two levels of 72 and Cin / 8
//     cut the worst error about sixfold (a float32 simulation of the
//     orders), for 64 more registers (one block an SM) and 64 adds a chunk.
//   * The K loop runs in chunks of 8 input channels. A chunk's input slab (8
//     channels x 4 rows, the halo rows included, each row of 64 between 4
//     zero columns a side) and its weights ([8 x 9][128], laid out so by the
//     wrapper) arrive by 1-D bulk copies (TMA) completing on an mbarrier,
//     two stages in a ring: the next chunk loads while this one computes.
//     Rows outside the image are never copied and stay zero, as do the pad
//     columns: that is the padding.
//   * The block then runs all nine taps from shared memory: a thread loads
//     the 10 inputs of a (channel, tap row) once and uses them for the three
//     taps of that row, so a 16-byte weight load feeds 32 FFMAs.
//   * A warp holds 4 pixel groups by 8 channel groups: a weight load reads
//     128 contiguous bytes, an input load 4 addresses 32 bytes apart, both
//     without bank conflicts.
//   * The epilogue adds the bias in f32 and stores a channel's 8 pixels as
//     two 16-byte stores along W.
// Each output sums its products in one fixed order (within a chunk: input
// channel, tap row, tap column; then the chunks in turn), and the bias
// last: two calls are bit-identical.
// The kernel launches on the caller's stream, allocates nothing and
// reports launch errors through the return code of the C entry point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_norm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kW = 64;                    // the row width the kernel takes
constexpr int kRows = 2;                  // output rows a block
constexpr int kCo = 128;                  // output channels a block
constexpr int kCc = 8;                    // input channels a stage
constexpr int kTaps = 9;
constexpr int kPad = 4;                   // zero columns a side: 16 bytes keep the copies aligned
constexpr int kSlabW = kW + 2 * kPad;     // 72
constexpr int kSlabRows = kRows + 2;      // the halo rows above and below
constexpr int kSlab = kCc * kSlabRows * kSlabW;  // floats of a stage's input slab
constexpr int kWts = kCc * kTaps * kCo;          // floats of a stage's weights
constexpr int kStage = kSlab + kWts;
constexpr int kStages = 2;
constexpr int kSmemBytes = kStages * kStage * 4 + kStages * 8;
constexpr uint32_t kRowBytes = kW * 4;
constexpr uint32_t kWtsBytes = kWts * 4;

static_assert(kCc * kSlabRows == 32, "one warp's lanes issue a stage's row copies");
static_assert(kRows * kW / 8 * (kCo / 8) == kThreads, "an 8x8 tile a thread covers the block");
static_assert((kStage * 4) % 128 == 0 && (kSlab * 4) % 16 == 0, "stages stay aligned");

__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                       const float* __restrict__ bias, float* __restrict__ y, int C, int K, int H) {
  extern __shared__ __align__(128) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pg = (warp >> 1) * 4 + (lane >> 3);  // pixel group: 8 pixels of one row
  const int cg = (warp & 1) * 8 + (lane & 7);    // channel group: 4 + 4 channels
  const int prow = pg >> 3, c0 = (pg & 7) * 8;
  const int bands = H / kRows;
  const int n = blockIdx.x / bands, r0 = (blockIdx.x % bands) * kRows;
  const int chunks = C / kCc;
  const float* xs = x + static_cast<size_t>(n) * C * H * kW;
  const float* ws = wt + static_cast<size_t>(blockIdx.y) * C * kTaps * kCo;

  // zero what no copy writes: each row's pad columns, and the halo rows
  // outside the image (the same rows for every chunk of this block)
  int rows_in = 0;
  for (int rr = 0; rr < kSlabRows; ++rr) rows_in += (r0 - 1 + rr >= 0 && r0 - 1 + rr < H);
  for (int i = tid; i < kStages * kCc * kSlabRows; i += kThreads) {
    float* row = smem + (i / (kCc * kSlabRows)) * kStage + (i % (kCc * kSlabRows)) * kSlabW;
    const int h = r0 - 1 + i % kSlabRows;
    const bool out = h < 0 || h >= H;
    for (int j = 0; j < kSlabW; j += 4)
      if (out || j < kPad || j >= kPad + kW) *reinterpret_cast<float4*>(row + j) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) cnorm::mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0 issues chunk k into its stage: a row copy a lane, the weights on lane 0
  auto load = [&](int k) {
    const int s = k % kStages;
    float* slab = smem + s * kStage;
    if (lane == 0) cnorm::mbar_expect(&bar[s], rows_in * kCc * kRowBytes + kWtsBytes);
    __syncwarp();
    const int ci = lane / kSlabRows, rr = lane % kSlabRows, h = r0 - 1 + rr;
    if (h >= 0 && h < H)
      cnorm::bulk_load(slab + (ci * kSlabRows + rr) * kSlabW + kPad,
                       xs + (static_cast<size_t>(k * kCc + ci) * H + h) * kW, kRowBytes, &bar[s]);
    if (lane == 0)
      cnorm::bulk_load(slab + kSlab, ws + static_cast<size_t>(k) * kWts, kWtsBytes, &bar[s]);
  };
  if (warp == 0)
    for (int k = 0; k < kStages && k < chunks; ++k) load(k);

  // [pixel][channel]: the sum over the chunks, and this chunk's 72 products
  float acc[8][8], part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < chunks; ++k) {
    const int s = k % kStages;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
    cnorm::mbar_wait(&bar[s], (k / kStages) & 1);
    // output column c reads slab column c - 1 + kPad for its leftmost tap
    const float* slab = smem + s * kStage + prow * kSlabW + c0 + kPad - 1;
    const float* wts = smem + s * kStage + kSlab + cg * 4;
#pragma unroll 2
    for (int ci = 0; ci < kCc; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* ar = slab + (ci * kSlabRows + dy) * kSlabW;
        float a[10];
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 1);
        const float4 a2 = *reinterpret_cast<const float4*>(ar + 5);
        a[0] = ar[0];
        a[1] = a1.x, a[2] = a1.y, a[3] = a1.z, a[4] = a1.w;
        a[5] = a2.x, a[6] = a2.y, a[7] = a2.z, a[8] = a2.w;
        a[9] = ar[9];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wr = wts + (ci * kTaps + dy * 3 + dx) * kCo;
          const float4 b0 = *reinterpret_cast<const float4*>(wr);
          const float4 b1 = *reinterpret_cast<const float4*>(wr + kCo / 2);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i + dx], b[j], part[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    __syncthreads();  // every thread is done with stage s
    if (warp == 0 && k + kStages < chunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(k + kStages);
    }
  }

  const int h = r0 + prow;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = blockIdx.y * kCo + cg * 4 + (j & 3) + (j >> 2) * (kCo / 2);
    const float bv = bias[co];
    float* yp = y + ((static_cast<size_t>(n) * K + co) * H + h) * kW + c0;
    *reinterpret_cast<float4*>(yp) =
        make_float4(acc[0][j] + bv, acc[1][j] + bv, acc[2][j] + bv, acc[3][j] + bv);
    *reinterpret_cast<float4*>(yp + 4) =
        make_float4(acc[4][j] + bv, acc[5][j] + bv, acc[6][j] + bv, acc[7][j] + bv);
  }
}

}  // namespace

// x: [B, C, H, 64] f32; wt: the weight [K, C, 3, 3] laid out as
// [K / 128][C * 9][128] (a block's 128 output channels innermost); bias: [K];
// y: [B, K, H, 64]. C a multiple of 8, K of 128, H even, W 64, every pointer
// 16-byte aligned; the caller checks them and this refuses other shapes.
// Returns the cudaError_t of the launch.
extern "C" int conv3x3_f32(const float* x, const float* wt, const float* bias, float* y, int B,
                           int C, int K, int H, int W, void* stream) {
  if (B <= 0 || C <= 0 || C % kCc || K <= 0 || K % kCo || H <= 0 || H % kRows || W != kW ||
      static_cast<long long>(B) * (H / kRows) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // per call: the attribute belongs to the current device
  const cudaError_t attr =
      cudaFuncSetAttribute(conv3x3_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(B * (H / kRows)), K / kCo);
  conv3x3_f32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(x, wt, bias, y,
                                                                                         C, K, H);
  return static_cast<int>(cudaGetLastError());
}
