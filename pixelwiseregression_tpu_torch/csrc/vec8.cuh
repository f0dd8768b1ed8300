// 8-element vector loads and stores of f32 or bf16 data (16 bytes of bf16,
// 32 of f32 per call), shared by every kernel of the port. Pointers must be
// 16-byte aligned. bf16 values widen to f32 exactly; store8 rounds f32 to
// the storage type to nearest even.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pwr {

constexpr int kVec = 8;

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// 8 elements copied as they are, or set to zero.
template <typename T>
__device__ __forceinline__ void copy8(const T* src, T* dst) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

template <typename T>
__device__ __forceinline__ void zero8(T* dst) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace pwr
