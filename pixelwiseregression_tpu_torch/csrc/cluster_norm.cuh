// One thread-block cluster per sample: the skeleton of the port's
// instance-norm kernels for Hopper (sm_90a), K3's statistics and apply
// (fused_chain.cu) and K5's backward (normrelu_bwd.cu).
//
// Both are a per-(sample, channel) f32 reduction over the H*W pixels of an
// NHWC sample, then a pass over the elements that needs the reduction; what
// bounds them is device-memory bytes. The TPU kernels took both on one
// read, a whole sample resident in VMEM. An SM's 227 KB cannot hold a 1-2
// MiB sample; a cluster of SMs can, through distributed shared memory. So a
// sample is one cluster of cs blocks (1 to 8, 16 where the card schedules
// it), and block `rank` holds the contiguous slice of ceil(HW/cs) pixels x
// all C channels that starts at pixel rank*slice: one contiguous byte range
// in NHWC, loaded by 1-D bulk copies (cp.async.bulk global -> shared,
// completed on an mbarrier) in pieces of 16 KB that the threads consume as
// they land. Each reduction: every thread sums its pixel rows of its 8
// (bf16) or 4 (f32) channels in order, the block sums its threads' rows in
// a fixed order (a warp's rows first, by shuffles), and each block sums the
// blocks' sums, loaded over distributed shared memory, in rank order. The
// order is fixed and there are no atomics: two calls are bit-identical.
// Later passes read the slice from shared memory, so the sample leaves
// device memory once.
//
// A block's passes and reductions wait on one another and on the cluster,
// so no block keeps the memory busy alone: a slice of at most 64 KB lets
// three blocks share an SM, one loading while the others reduce. A sample
// that the cluster cannot hold that way is held in 128 KB slices, one block
// an SM; with two tensors (K5's g and x), x may stay resident while g
// streams through a ring of pieces, read once a pass; else both stream,
// each pass reading the slice again, mostly from L2. plan() chooses, on the
// host. Index math is 32-bit within a sample. C wider than kThreads 16-byte
// vectors runs in chunks of channels, each with its own passes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

namespace cnorm {

constexpr int kThreads = 256;
constexpr int kPieceBytes = 16 * 1024;   // one bulk copy
constexpr int kRing = 4;                 // slots of a streamed tensor's ring
constexpr int kSliceBytes = 64 * 1024;   // resident bytes a block, over its tensors: 3 blocks an SM
constexpr int kMaxSmem = 232448;         // a block's shared memory on sm_90
constexpr int kPortable = 8;             // the largest portable cluster
constexpr int kLarge = 16;               // the non-portable one

// channels of a 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / static_cast<int>(sizeof(T)); }

// How a call runs: computed on the host by plan(), read by every block.
struct Plan {
  int B, HW, C;
  int cs;        // blocks a sample: the cluster
  int slice;     // pixels a block (the last block's may be fewer)
  int piece;     // pixels a bulk copy
  int resident;  // bit t: tensor t stays in shared memory for the whole call
  int ring;      // slots of each streamed tensor (0: every tensor resident)
  int cw;        // channels a chunk
  int passes;    // passes over the slice in the call, over all chunks
  int buf[2];    // shared-memory byte offsets: each tensor's slice or ring,
  int bar, red, bsum, coef;  // the mbarriers, the sums and the coefficients
  int smem;      // bytes in all; 0 if the plan does not fit
};

// ------------------------------------------------------------------ host

// The shared-memory layout of p for nt tensors of es-byte elements and
// `sums` sums a channel; false if it exceeds a block's shared memory.
inline bool layout(Plan& p, int nt, int es, int sums) {
  const long long row = static_cast<long long>(p.C) * es;
  long long off = 0;
  auto take = [&](long long bytes) {
    const long long at = off;
    off += (bytes + 127) / 128 * 128;
    return static_cast<int>(at < kMaxSmem ? at : 0);
  };
  for (int t = 0; t < nt; ++t)
    p.buf[t] = take((p.resident >> t & 1) ? p.slice * row : static_cast<long long>(p.ring) * p.piece * row);
  const int pieces = (p.slice + p.piece - 1) / p.piece;
  p.bar = take(8LL * (p.ring ? p.ring : pieces));
  p.red = take(4LL * sums * kThreads * (16 / es));
  p.bsum = take(4LL * 2 * sums * p.cw);
  p.coef = take(4LL * 3 * p.cw);
  p.smem = off <= kMaxSmem ? static_cast<int>(off) : 0;
  return p.smem > 0;
}

// The plan of a call over [B, HW, C] samples of nt tensors (the last one
// x), the first of these that fits: (1) every tensor resident in at most
// kSliceBytes a block, so that three blocks share an SM and one block's
// loads overlap another's reductions; (2) with two tensors, x resident in
// 2*kSliceBytes beside a ring of the other (measured faster than (3) for
// K5's 2 MiB samples); (3) every tensor resident in 2*kSliceBytes, one block
// an SM; (4) every tensor streamed by the largest cluster. Each takes the
// smallest cluster that holds it; large: the card schedules clusters of
// kLarge blocks. smem 0: no plan fits (a pixel row too wide for the ring).
inline Plan plan(int nt, int es, int sums, int passes_per_chunk, int B, int HW, int C, bool large) {
  Plan p{};
  p.B = B;
  p.HW = HW;
  p.C = C;
  p.cw = C < kThreads * (16 / es) ? C : kThreads * (16 / es);
  p.passes = (C + p.cw - 1) / p.cw * passes_per_chunk;
  const long long row = static_cast<long long>(C) * es;
  p.piece = row >= kPieceBytes ? 1 : static_cast<int>(kPieceBytes / row);
  const int top = large ? kLarge : kPortable;
  auto at = [&](int cs, int resident, int ring) {
    p.cs = cs;
    p.slice = (HW + cs - 1) / cs;
    p.resident = resident;
    p.ring = ring;
    return layout(p, nt, es, sums);
  };
  // the smallest cluster whose blocks hold `tensors` slices in `bytes`
  auto first = [&](int tensors, long long bytes, int resident, int ring) {
    for (int cs = 1; cs <= top; cs *= 2)
      if (tensors * ((HW + cs - 1) / cs) * row <= bytes && at(cs, resident, ring)) return true;
    return false;
  };
  const int all = (1 << nt) - 1;
  if (first(nt, kSliceBytes, all, 0)) return p;
  if (nt == 2 && first(1, 2 * kSliceBytes, 2, kRing)) return p;
  if (first(nt, 2 * kSliceBytes, all, 0)) return p;
  if (at(top, 0, kRing)) return p;
  p.smem = 0;
  return p;
}

// Once per kernel: its shared-memory limit and non-portable clusters
// allowed; `large` whether the card schedules a cluster of kLarge blocks
// that take a block's whole shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, bool* large) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kLarge);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kMaxSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kLarge;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  *large = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) == cudaSuccess && clusters > 0;
  cudaGetLastError();  // a refused query is an answer, not an error of the next launch
  return cudaSuccess;
}

// Kernels that K3's and K5's launchers launched in this process, for the
// wrappers to read (norm_launches()): [0] the norm kernels of this file,
// [1] the others (the convs, K5's parameter sums).
inline long long* launched() {
  static long long n[2] = {0, 0};
  return n;
}

// err, counted as a launch of kind `kind` if it is cudaSuccess.
inline cudaError_t count(cudaError_t err, int kind) {
  launched()[kind] += err == cudaSuccess;
  return err;
}

// Launches kernel over p's grid: B clusters of p.cs blocks, sample-major.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), const Plan& p, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.cs) * static_cast<unsigned>(p.B));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return count(err != cudaSuccess ? err : cudaGetLastError(), 0);
}

// What a plan is, for the wrappers: cluster size, resident tensors (bits),
// ring slots (0: all resident), shared memory a block.
inline void describe(const Plan& p, int* out) {
  out[0] = p.cs;
  out[1] = p.resident;
  out[2] = p.ring;
  out[3] = p.smem;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(1u) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from device memory to shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// the float at `local`'s offset in the shared memory of cluster block `rank`
__device__ __forceinline__ float ld_cluster(const float* local, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(saddr(local)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes of T widened to f32, and f32 rounded to nearest even into them
__device__ __forceinline__ void ld16(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float v[8]) { pwr::load8(p, v); }
__device__ __forceinline__ void st16(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(__nv_bfloat16* p, const float v[8]) { pwr::store8(p, v); }

// ld16 from shared memory, as ld.shared (volatile: never above the
// mbarrier wait that makes it valid)
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(saddr(p)));
  return v;
}
__device__ __forceinline__ void lds16(const float* p, float v[4]) {
  const uint4 w = lds128(p);
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void lds16(const __nv_bfloat16* p, float v[8]) {
  const uint4 w = lds128(p);
  const uint32_t word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 pairs widen exactly
    v[2 * i] = __uint_as_float(word[i] << 16);
    v[2 * i + 1] = __uint_as_float(word[i] & 0xffff0000u);
  }
}

// A thread's place in a chunk of ccw channels from c0: channel group gi of
// G (V channels each), pixel row r of R; `on` for the threads that have one.
template <int V>
struct Lanes {
  int c0, ccw, G, R, gi, r;
  bool on;
  __device__ Lanes(int c0_, int ccw_) : c0(c0_), ccw(ccw_), G(ccw_ / V) {
    R = kThreads / G;
    gi = threadIdx.x % G;
    r = threadIdx.x / G;
    on = r < R;
  }
  __device__ int channel() const { return c0 + gi * V; }  // the thread's first channel
};

// f(v, q) for each of this thread's pixel rows q < rows of a piece, in
// order, v[t] its V channels of tensor t from shared memory.
template <typename T, int V, int NT, class F>
__device__ __forceinline__ void each_row(const Lanes<V>& l, const T* const (&at)[NT], int C, int rows,
                                         F&& f) {
  for (int q = l.r; q < rows; q += l.R) {
    float v[NT][V];
#pragma unroll
    for (int t = 0; t < NT; ++t) lds16(at[t] + q * C + l.channel(), v[t]);
    f(v, q);
  }
}

// This block's slices of NT tensors ([B, HW, C] each, the same type T),
// and the cluster's reductions over them.
template <typename T, int NT>
struct Slices {
  const Plan& p;
  unsigned char* smem;
  const T* src[NT];  // the slice of each tensor in device memory
  int rows, pieces, steps, row;
  int next = 0;  // the next load to consume
  int red_k = 0;  // the next reduction
  bool first = true;

  __device__ Slices(const Plan& p_, unsigned char* smem_, const T* const (&base)[NT], int rank)
      : p(p_), smem(smem_) {
    const int p0 = rank * p.slice;
    rows = max(0, min(p.slice, p.HW - p0));
    pieces = (rows + p.piece - 1) / p.piece;
    steps = p.ring ? p.passes * pieces : pieces;
    row = p.C * static_cast<int>(sizeof(T));
#pragma unroll
    for (int t = 0; t < NT; ++t) src[t] = base[t] + p0 * p.C;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bar);
    const int nbar = p.ring ? p.ring : pieces;
    if (threadIdx.x == 0) {  // the copies start before the block's barrier
      for (int b = 0; b < nbar; ++b) mbar_init(bars + b);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < min(nbar, steps); ++s) copy_in(s);
    }
    __syncthreads();  // the mbarriers are initialised before anyone waits on them
  }

  __device__ bool resident(int t) const { return (p.resident >> t) & 1; }

  __device__ const T* at(int t, int slot, int r0) const {
    return reinterpret_cast<const T*>(smem + p.buf[t] +
                                      (resident(t) ? r0 * row : slot * p.piece * row));
  }

  // thread 0: the copies of load `step` (piece step % pieces)
  __device__ void copy_in(int step) {
    const int r0 = (step % pieces) * p.piece;
    const uint32_t bytes = static_cast<uint32_t>(min(p.piece, rows - r0) * row);
    const int slot = p.ring ? step % p.ring : 0;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p.bar) + (p.ring ? slot : step);
    uint32_t total = 0;
#pragma unroll
    for (int t = 0; t < NT; ++t) total += (!resident(t) || step < pieces) ? bytes : 0u;
    mbar_expect(bar, total);
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (!resident(t) || step < pieces)
        bulk_load(const_cast<T*>(at(t, slot, r0)), src[t] + r0 * p.C, bytes, bar);
  }

  // One pass over the slice: f(pieces' rows by tensor, first row, rows) per
  // piece, in order, each once it has landed.
  template <class F>
  __device__ void pass(F&& f) {
    const bool load = p.ring || first;
    if (!load) {  // every tensor resident and landed: the slice at once
      const T* ptr[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) ptr[t] = at(t, 0, 0);
      f(ptr, 0, rows);
      return;
    }
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bar);
    for (int i = 0; i < pieces; ++i) {
      const int r0 = i * p.piece;
      const int slot = p.ring ? next % p.ring : 0;
      mbar_wait(bars + (p.ring ? slot : next), p.ring ? (next / p.ring) & 1 : 0);
      const T* ptr[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) ptr[t] = at(t, slot, r0);
      f(ptr, r0, min(p.piece, rows - r0));
      if (p.ring) {
        __syncthreads();  // the slot is read: it may be loaded again
        if (threadIdx.x == 0 && next + p.ring < steps) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          copy_in(next + p.ring);
        }
      }
      ++next;
    }
    first = false;
  }

  // The cluster's sums of acc (S sums of the thread's V channels over its
  // rows); returns tot, where tot[s * cw + c] is sum s of channel c0 + c
  // over the sample. Rows in order, then the block's rows (a warp's rows
  // first by shuffles where the channel groups divide a warp), then the
  // blocks in rank order. last: the cluster's last reduction; the block
  // then arrives at the barrier that finish() waits on, so that no block
  // leaves while another may still read its sums. A cluster of one block
  // takes no cluster barrier, and its own sums are the totals.
  template <int S, int V>
  __device__ const float* reduce(const float (&acc)[S][V], const Lanes<V>& l, bool last) {
    float* red = reinterpret_cast<float*>(smem + p.red);
    float* mine = reinterpret_cast<float*>(smem + p.bsum) + (red_k++ & 1) * S * p.cw;
    float* tot = red;  // the cluster's sums land where the block's were read
    const bool shfl = 32 % l.G == 0;  // every lane holds a row: a warp's rows sum in registers
    const int rows = shfl ? kThreads / 32 : l.R;
    const int row = shfl ? static_cast<int>(threadIdx.x) / 32 : l.r;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float x = acc[s][v];
        if (shfl)
          for (int o = l.G; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        if (shfl ? (threadIdx.x & 31) < l.G : l.on) red[(s * rows + row) * l.ccw + l.gi * V + v] = x;
      }
    __syncthreads();
    for (int i = threadIdx.x; i < S * l.ccw; i += kThreads) {
      const int s = i / l.ccw, c = i - s * l.ccw;
      float t = 0.f;
#pragma unroll 8
      for (int rr = 0; rr < rows; ++rr) t += red[(s * rows + rr) * l.ccw + c];
      mine[s * p.cw + c] = t;
    }
    if (p.cs == 1) {
      __syncthreads();
      return mine;
    }
    cluster_arrive();
    cluster_wait();
    // every block's sums loaded at once (the loads from other SMs are slow
    // one by one), then added in rank order
    for (int i = threadIdx.x; i < S * l.ccw; i += kThreads) {
      const int o = (i / l.ccw) * p.cw + i % l.ccw;
      float v[kLarge];
#pragma unroll
      for (int q = 0; q < kLarge; ++q) v[q] = q < p.cs ? ld_cluster(mine + o, q) : 0.f;
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kLarge; ++q)
        if (q < p.cs) t += v[q];
      tot[o] = t;
    }
    if (last) cluster_arrive();
    __syncthreads();
    return tot;
  }

  __device__ void finish() {
    if (p.cs > 1) cluster_wait();
  }

  __device__ float* coef() const { return reinterpret_cast<float*>(smem + p.coef); }
};

}  // namespace cnorm
