// V2V-PoseNet's voxeliser for Hopper (sm_90a): raw depth frames [B, H, W]
// float32 -> occupancy grids [B, 1, S, S, S] float32 (axes z, y, x), each
// pixel with a positive depth moved into the sample's cube as
// ops/voxel.py sets out, its voxel set to 1, every other voxel 0.
//
// Replaces no TPU kernel: the JAX package has no 3D model. It was added
// because no op of the port computes this scatter, and torch's own scatter
// takes a boolean mask or a read-back to do it without a spare cell.
//
// What bounds it: bytes. It reads each frame and writes each grid once
// (39 MB of frames and 87 MB of grids at B = 32, 480 x 640, S = 88); the
// transform is ~20 operations a valid pixel.
//
// Design: one block of 512 threads a slab of S / 4 z-planes of one sample
// (B * 4 blocks). The block keeps its slab's occupancy as bits in shared
// memory (S^3 / 128 words: 21 KB at S = 88), so that the grid is written
// once, whole, with no zeroing pass and no atomics in device memory:
//   * every thread clears its words, then walks the sample's pixels four
//     at a time (16-byte loads, four in flight a thread; the four slabs of
//     a sample read the same frame, the later ones from L2), transforms
//     each positive one and sets its voxel's bit with a shared-memory
//     atomicOr when the voxel lies in the slab;
//   * after a barrier, each thread writes float4s of the slab, four voxels
//     of one word's nibble at a time.
// Exactness: the per-sample numbers (camera, centre, s R, t * vox, cube / 2,
// vox) come in as one row of 17 floats that torch computed; the kernel only
// subtracts, multiplies, adds and divides, with __fsub_rn / __fmul_rn /
// __fadd_rn / __fdiv_rn (no contraction into FMAs), in the order of
// ops/voxel.voxelize_plain, so the two give the same grids bit for bit.
// The kernel launches on the caller's stream, allocates nothing and
// reports launch errors through the return code of the C entry point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSlabs = 4;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread
// the row of per-sample numbers, as ops/voxel.COEF_NAMES orders it
enum Coef { HALFU, HALFV, FX, FY, CX, CY, CZ, M00, M01, M10, M11, M22, TX, TY, TZ, HALF, VOX, kCoefs };

__device__ __forceinline__ float cell(float q, const float* c) {
  return floorf(__fdiv_rn(__fadd_rn(q, c[HALF]), c[VOX]));
}

__global__ void __launch_bounds__(kThreads)
    voxelize_kernel(const float* __restrict__ frame, const float* __restrict__ coef,
                    float* __restrict__ grid, int H, int W, int S) {
  extern __shared__ uint32_t bits[];
  __shared__ float c[kCoefs];
  const int b = blockIdx.x / kSlabs;
  const int slab = blockIdx.x % kSlabs;
  const int zs = S / kSlabs;                       // z-planes a slab
  const int vox = zs * S * S;                      // voxels a slab
  const int words = (vox + 31) / 32;
  const float fs = static_cast<float>(S);
  const float z0 = static_cast<float>(slab * zs);
  const float z1 = static_cast<float>((slab + 1) * zs);

  for (int i = threadIdx.x; i < words; i += kThreads) bits[i] = 0u;
  if (threadIdx.x < kCoefs) c[threadIdx.x] = coef[b * kCoefs + threadIdx.x];
  __syncthreads();

  const float4* f4 = reinterpret_cast<const float4*>(frame + static_cast<size_t>(b) * H * W);
  const int n4 = H * W / 4;
  for (int p0 = threadIdx.x; p0 < n4; p0 += kThreads * kUnroll) {
    float4 d4[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int p = p0 + r * kThreads;
      d4[r] = p < n4 ? f4[p] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int p = p0 + r * kThreads;
      const int v = (4 * p) / W;
      const int u0 = 4 * p - v * W;
      const float ds[4] = {d4[r].x, d4[r].y, d4[r].z, d4[r].w};
      const float dv = __fdiv_rn(__fsub_rn(static_cast<float>(v), c[HALFV]), c[FY]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = ds[e];
        if (!(d > 0.f)) continue;
        const float x = __fmul_rn(__fdiv_rn(__fsub_rn(static_cast<float>(u0 + e), c[HALFU]), c[FX]), d);
        const float y = __fmul_rn(dv, d);
        const float dx = __fsub_rn(x, c[CX]);
        const float dy = __fsub_rn(y, c[CY]);
        const float dz = __fsub_rn(d, c[CZ]);
        const float iz = cell(__fadd_rn(__fmul_rn(c[M22], dz), c[TZ]), c);
        if (!(iz >= z0 && iz < z1)) continue;
        const float ix = cell(__fadd_rn(__fadd_rn(__fmul_rn(c[M00], dx), __fmul_rn(c[M01], dy)), c[TX]), c);
        const float iy = cell(__fadd_rn(__fadd_rn(__fmul_rn(c[M10], dx), __fmul_rn(c[M11], dy)), c[TY]), c);
        if (!(ix >= 0.f && ix < fs && iy >= 0.f && iy < fs)) continue;
        const int k = (static_cast<int>(iz - z0) * S + static_cast<int>(iy)) * S + static_cast<int>(ix);
        atomicOr(&bits[k >> 5], 1u << (k & 31));
      }
    }
  }
  __syncthreads();

  float4* out = reinterpret_cast<float4*>(grid + (static_cast<size_t>(b) * S + slab * zs) * S * S);
  for (int i = threadIdx.x; i < vox / 4; i += kThreads) {
    const uint32_t w = bits[i >> 3] >> ((i & 7) * 4);
    out[i] = make_float4(static_cast<float>(w & 1u), static_cast<float>((w >> 1) & 1u),
                         static_cast<float>((w >> 2) & 1u), static_cast<float>((w >> 3) & 1u));
  }
}

}  // namespace

extern "C" int voxelize(const float* frame, const float* coef, float* grid, int B, int H, int W, int S,
                        void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || W % 4 || S <= 0 || S % kSlabs ||
      static_cast<long long>(B) * kSlabs >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (S / kSlabs * S * S + 31) / 32;
  const size_t smem = static_cast<size_t>(words) * sizeof(uint32_t);
  // per call: the attribute belongs to the current device
  const cudaError_t attr =
      cudaFuncSetAttribute(voxelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  voxelize_kernel<<<B * kSlabs, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(frame, coef, grid, H, W,
                                                                                   S);
  return static_cast<int>(cudaGetLastError());
}
