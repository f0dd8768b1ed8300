// Hopper warpgroup matrix multiply (wgmma) in inline PTX, for sm_90a.
//
// A warpgroup (four consecutive warps, 128 threads) issues an asynchronous
// product of a 64-row tile whose operands it reads from shared memory
// through 64-bit matrix descriptors, and keeps the f32 sum in registers.
// A descriptor holds the operand's start address, a leading byte offset
// (LBO), a stride byte offset (SBO) and the layout. Without swizzle the
// operand is core matrices of 8 rows x 16 bytes, each 128 contiguous
// bytes; LBO is the stride between core matrices along K, SBO along M or
// N. Under the 128-byte swizzle (what the port's wgmma loops use) rows are 128
// bytes, 8 rows make a 1024-byte atom, and 16-byte chunk c of row r sits at
// slot c ^ (r % 8); for a K-major operand SBO is the stride between atoms
// along M or N (LBO unused), and a k16 slice starts 32 bytes further into
// the rows; for an MN-major operand, whose rows run along N, LBO is the
// stride between 64-column atoms and SBO between atoms along K. A is
// K-major ([rows, K], K contiguous); B is MN-major ([K, N], N contiguous),
// which bf16 takes through the instruction's transpose flag.
//
// Accumulator layout of m64nN (N/2 floats per thread): thread t of the
// warpgroup holds d[4*j + 2*h + i] = D[16*(t/32) + (t%32)/4 + 8*h,
// 8*j + 2*(t%4) + i] for j < N/8 and h, i in {0, 1}.
//
// Order: stores to shared memory by threads (the generic proxy) need
// fence_proxy_async() before a barrier and the wgmma that reads them (the
// async proxy); arrive() before the first mma of a group and after any
// other instruction touched the accumulators; commit() closes a group;
// wait<N>() returns once at most N groups are still running, and only then
// may the accumulators be read or the operands' shared memory rewritten.
//
// The operands reach shared memory through a ring of stages that 16-byte
// cp.async copies fill (device memory to shared memory through L2, no
// registers): eight threads copy one 128-byte row, 128 contiguous bytes in
// device memory, which the swizzle spreads over all 32 banks. KPos walks a
// K loop that runs over taps of cpt 8-element chunks each, so that a step
// may straddle two taps.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// The layout field (bits 62-63) of a 128-byte swizzled operand; 0 is no
// swizzle.
constexpr uint64_t kSwizzle128 = 1;

// Descriptor of an operand starting at `smem` (16-byte aligned; a swizzled
// operand's atoms 1024-byte aligned), base offset 0.
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo_bytes, uint32_t sbo_bytes,
                                         uint64_t layout) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 | layout << 62;
}

// One row and one atom (8 rows) under the 128-byte swizzle.
constexpr int kSwRow = 128;
constexpr int kSwAtom = 8 * kSwRow;

__device__ __forceinline__ void arrive() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an arrive() or a wait().
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], bf16 in, f32 accumulators; A K-major,
// B MN-major (the transpose flag), both read from shared memory through
// their descriptors.
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], bf16 in, f32 accumulators; A K-major,
// B MN-major (the transpose flag), both read from shared memory through
// their descriptors.
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// One 64-deep K step of a warpgroup, as one commit group: D[64 x BN] +=
// A[64 x 64] * B[64 x BN], four k16 products. A is 64 K-major rows of 128
// bytes under the 128-byte swizzle (SBO: the next 8 rows, one atom; the k16
// slice ks 32*ks bytes into the rows); B is 64 K rows in BN/64 MN-major
// atoms of 64 columns (LBO: the next 64 columns, one atom; SBO: the next
// 8 K rows, BN/64 atoms; the slice ks 2*ks atom rows down). Both start on
// an atom boundary.
template <int BN>
__device__ __forceinline__ void mma_k64(float (&d)[BN / 2], const unsigned char* sa,
                                        const unsigned char* sb) {
  static_assert(BN == 64 || BN == 128, "m64n64k16 or m64n128k16");
  constexpr int kAtomsN = BN / 64;
  arrive();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t da = desc(sa + ks * 32, 16, kSwAtom, kSwizzle128);
    const uint64_t db = desc(sb + ks * 2 * kAtomsN * kSwAtom, kSwAtom, kAtomsN * kSwAtom, kSwizzle128);
    if constexpr (BN == 64)
      mma_m64n64k16(d, da, db);
    else
      mma_m64n128k16(d, da, db);
  }
  commit();
}

// Byte offset of 16-byte chunk `chunk` of row `row` in rows of 128 bytes
// under the 128-byte swizzle: chunk c of row r sits at slot c ^ (r % 8).
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * kSwRow + ((chunk ^ (row & 7)) << 4);
}

// 16 bytes from device to shared memory without passing through registers
// (cp.async, through L2 only), zeros where !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K position of a chunk: the tap (index into the loop's taps) and the chunk
// of 8 elements within it, cpt chunks per tap.
struct KPos {
  int tap, chunk;
  __device__ __forceinline__ KPos plus(int by, int cpt) const {
    KPos q{tap, chunk + by};
    while (q.chunk >= cpt) {
      q.chunk -= cpt;
      ++q.tap;
    }
    return q;
  }
};

}  // namespace sm90
