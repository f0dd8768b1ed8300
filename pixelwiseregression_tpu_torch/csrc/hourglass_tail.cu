// K4's levels at 16x16 and below as one kernel, one block per sample, for
// Hopper (sm_90a).
//
// Replaces, for the sub-hourglasses whose activations fit one block's shared
// memory, the launches that hourglass.cu makes per ResBlock, pool and
// upsample: the part of pallas_hourglass.py::_hg_kernel that the TPU kernel
// ran on a sample in VMEM (hg, :223-229). At full width that is the level-2
// sub-hourglass at 16x16 (7 ResBlocks, 3 pools, 3 upsample-adds), 48 of a
// level-4 call's 76 launches on grids of 4 to 256 blocks. Numerics are K4's
// (hourglass.cu's header): two-pass f32 statistics, the norm's apply in
// bf16 (a and b rounded, x*a rounded, + b rounded, relu), f32 accumulation
// with the bias added before the cast, the 3x3's even and odd taps summed
// apart and each sum rounded, the residual and skip adds in bf16, the exact
// max-pool.
//
// What bounds it: not the card's rates (at [256, 16, 16, 128] the products
// are 11.6 GFLOP, 12 us of tensor cores, and the input and output 16.8 MB,
// 5 us of device memory) but each block's chain of dependent steps: 21
// norms and 21 convs of a sample, one after another, at 256 to 4 pixels (a
// ResBlock takes about as long at 2x2 as at 16x16; PERF.md). A block (512
// threads, 16 warps) keeps the whole sample in shared memory:
//   * one buffer per level, [h*w, C] at each resolution (16x16 down to 2x2),
//     and two [h*w, C/2] intermediates, rows padded by 16 bytes so that the
//     8 rows an ldmatrix phase reads fall on distinct banks; the residual
//     and the upsample-add are written in place;
//   * statistics are a fixed-order reduction over the block's own pixels
//     (channel pairs by pixel groups, then the groups in order); the first
//     norm of a ResBlock is applied to the conv's A fragments as they load
//     (its input is the residual, kept), the other two in place;
//   * products on mma.sync m16n8k16 (bf16 in, f32 accumulators) from
//     ldmatrix: each lane gives the address of its own pixel row, so a 3x3
//     tap is a shifted row and a border is a row of zeros, with no gathered
//     copy; warps split the pixels in 16-row tiles, then the output channels;
//   * weights (106 KB a ResBlock at C = 128, the same for every block, so
//     from L2) stream through two shared-memory stages by cp.async, one
//     piece ahead: w0, the 3x3's taps two at a time (even taps, then odd),
//     w2; each norm's parameters and the next conv's bias load while the
//     norm's passes run.
// The input is read once and the output written once. wgmma is not used:
// its 64-row tiles exceed the 16- and 4-pixel levels, and its shared-memory
// descriptors cannot take a per-row tap shift.

#include "hourglass_tail.cuh"
#include "sm90_wgmma.cuh"
#include "vec8.cuh"

namespace tail {
namespace {

using pwr::round_act;
using sm90::cp_async16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPixels = 256;
constexpr int kMaxC = 128;
constexpr int kMaxLevel = 3;         // at most 256 pixels: 16x16 down to 1x1
constexpr int kSmemLimit = 232448;   // an H100 block's shared memory
constexpr int kPieces = 7;           // weight pieces of a ResBlock
constexpr int kStages = 2;           // weight stages: one piece in flight (three: no faster)
constexpr int kPartFloats = 1024;    // statistics partials: (threads / pairs) x channels
constexpr float kEps = 1e-5f;
// the 3x3's pieces: first tap and tap count (even taps, then odd)
__constant__ int kTapFirst[5] = {0, 4, 8, 1, 5};
__constant__ int kTapCount[5] = {2, 2, 1, 2, 2};

__host__ __device__ inline int align128(int b) { return (b + 127) & ~127; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Bytes of level d's buffer, [(h >> d) * (w >> d), C + 8]; the buffers of
// levels 0..lv+1 open the block's shared memory, in order.
__host__ __device__ inline int level_bytes(int h, int w, int C, int d) {
  return align128((h >> d) * (w >> d) * (C + 8) * 2);
}

// Byte offsets of the rest of the block's shared memory. (No array here: a
// struct indexed at run time would live in local memory, which the L1 left
// beside 227 KB of shared memory cannot hold for 512 threads.)
struct Layout {
  int t1, t2;  // [h * w, C/2 + 8]
  int stage, stage_bytes;
  int part, coef, zero, total;
};

__host__ __device__ inline Layout layout(int h, int w, int C, int lv) {
  Layout L{};
  const int ch = C / 2;
  int off = 0;
  for (int d = 0; d <= lv + 1; ++d) off += level_bytes(h, w, C, d);
  L.t1 = off;
  off += align128(h * w * (ch + 8) * 2);
  L.t2 = off;
  off += align128(h * w * (ch + 8) * 2);
  // a stage holds w0 [C, ch], two taps of w1 [ch, ch] or w2 [ch, C], rows padded by 16 bytes
  L.stage_bytes = align128(imax(imax(C * (ch + 8), 2 * ch * (ch + 8)), ch * (C + 8)) * 2);
  L.stage = off;
  off += kStages * L.stage_bytes;
  L.part = off;
  off += kPartFloats * 4;
  L.coef = off;  // a and b in bf16, the mean and the next conv's bias in f32, kMaxC each
  off += 12 * kMaxC;
  L.zero = off;  // zeros for ldmatrix: the 3x3's border, K past the end
  off += 256;
  L.total = off;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

// K4's apply on a pair of bf16 values: relu(round(round(v * a) + b)) with a
// and b in bf16, each step in f32 and rounded to bf16 (as fused_chain.cu's
// kProAct prologue)
__device__ __forceinline__ float apply1(float v, float a, float b) {
  return fmaxf(round_act<__nv_bfloat16>(__fadd_rn(round_act<__nv_bfloat16>(__fmul_rn(v, a)), b)),
               0.f);
}

__device__ __forceinline__ uint32_t apply2(uint32_t v, __nv_bfloat162 a, __nv_bfloat162 b) {
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return pack2(apply1(lo_f(v), fa.x, fb.x), apply1(hi_f(v), fa.y, fb.y));
}

struct Block {
  const Args& a;  // the kernel's __grid_constant__ parameter
  unsigned char* smem;
  Layout L;
  int ch, ld, ldh;  // C/2; row strides of the C-wide and C/2-wide buffers, in elements

  __device__ __nv_bfloat16* buf(int d) const {
    int off = 0;
    for (int i = 0; i < d; ++i) off += level_bytes(a.h, a.w, a.C, i);
    return reinterpret_cast<__nv_bfloat16*>(smem + off);
  }
  __device__ __nv_bfloat16* t1() const { return reinterpret_cast<__nv_bfloat16*>(smem + L.t1); }
  __device__ __nv_bfloat16* t2() const { return reinterpret_cast<__nv_bfloat16*>(smem + L.t2); }
  __device__ float* part() const { return reinterpret_cast<float*>(smem + L.part); }
  // a and b in bf16, [kMaxC] each, then the means in f32
  __device__ __nv_bfloat16* coef() const { return reinterpret_cast<__nv_bfloat16*>(smem + L.coef); }
  __device__ float* mean() const { return reinterpret_cast<float*>(smem + L.coef + 4 * kMaxC); }
  __device__ float* conv_bias() const { return reinterpret_cast<float*>(smem + L.coef + 8 * kMaxC); }
  __device__ uint32_t zero() const { return smem_u32(smem + L.zero); }
  __device__ unsigned char* stage(int n) const { return smem + L.stage + (n % kStages) * L.stage_bytes; }

  // -------------------------------------------------------------- weights

  // piece n of the stream (ResBlock n / 7): its rows of N elements from
  // device memory into stage n % kStages, row stride N + 8
  __device__ __forceinline__ void issue(int n) const {
    const int rb = n / kPieces, kind = n - rb * kPieces;
    const __nv_bfloat16* src;
    int rows, N, gap = 0;  // gap: rows skipped before a piece's second tap (t + 2)
    if (kind == 0) {
      src = a.w0 + static_cast<size_t>(rb) * a.C * ch;
      rows = a.C;
      N = ch;
    } else if (kind == kPieces - 1) {
      src = a.w2 + static_cast<size_t>(rb) * ch * a.C;
      rows = ch;
      N = a.C;
    } else {
      src = a.w1 + (static_cast<size_t>(rb) * 9 + kTapFirst[kind - 1]) * ch * ch;
      rows = kTapCount[kind - 1] * ch;
      N = ch;
      gap = ch;
    }
    const int cpr = N / 8;
    unsigned char* dst = stage(n);
    for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
      const int row = i / cpr, c8 = i - row * cpr;
      const __nv_bfloat16* s = src + static_cast<size_t>(row + (row >= ch ? gap : 0)) * N + c8 * 8;
      cp_async16(dst + (row * (N + 8) + c8 * 8) * 2, s, true);
    }
  }

  // Piece n in its stage: waits for this thread's copies of it (later
  // pieces may stay in flight), then the barrier (after it every thread is
  // done with piece n - 1 and with the phase before), then starts the copies
  // of piece n + kStages - 1 into piece n - 1's stage. One commit group a
  // piece, empty past the last.
  __device__ __forceinline__ const unsigned char* acquire(int n, int total) const {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (n + kStages - 1 < total) issue(n + kStages - 1);
    sm90::cp_async_commit();
    return stage(n);
  }

  // ---------------------------------------------------------------- norms

  // coef[c] = round(a), coef[kMaxC + c] = round(b) of the instance norm of
  // x [M, Cn] (row stride ldx) with scale and bias; two passes in f32 over
  // the block's pixels in a fixed order. With apply, x = relu(round(round(
  // x*a) + b)) in place. Also stages the next conv's bias [Nb] in shared
  // memory: its loads, and those of scale and bias, are issued first and
  // land while the passes run. Ends with a barrier.
  __device__ __forceinline__ void norm(__nv_bfloat16* x, int ldx, int M, int Cn, const float* scale,
                                       const float* bias, bool apply, const float* next_bias,
                                       int Nb) const {
    const int P = Cn / 2;         // channel pairs
    const int G = kThreads / P;   // pixel groups
    const int t = threadIdx.x;
    const int pair = t % P, grp = t / P;
    const bool on = grp < G;
    float* pt = part();
    float* mn = mean();
    const float sc = t < Cn ? scale[t] : 0.f, bi = t < Cn ? bias[t] : 0.f;
    const float nb = t < Nb ? next_bias[t] : 0.f;
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
    const int ldw = ldx / 2;
    float s0 = 0.f, s1 = 0.f;
    if (on)
      for (int p = grp; p < M; p += G) {
        const uint32_t v = xw[p * ldw + pair];
        s0 += lo_f(v);
        s1 += hi_f(v);
      }
    if (on) {
      pt[grp * Cn + 2 * pair] = s0;
      pt[grp * Cn + 2 * pair + 1] = s1;
    }
    if (t < Nb) conv_bias()[t] = nb;
    __syncthreads();
    if (t < Cn) {
      float m = 0.f;
      for (int g = 0; g < G; ++g) m += pt[g * Cn + t];
      mn[t] = m / static_cast<float>(M);
    }
    __syncthreads();
    const float m0 = mn[2 * pair], m1 = mn[2 * pair + 1];
    s0 = s1 = 0.f;
    if (on)
      for (int p = grp; p < M; p += G) {
        const uint32_t v = xw[p * ldw + pair];
        const float d0 = lo_f(v) - m0, d1 = hi_f(v) - m1;
        s0 = fmaf(d0, d0, s0);
        s1 = fmaf(d1, d1, s1);
      }
    if (on) {
      pt[grp * Cn + 2 * pair] = s0;
      pt[grp * Cn + 2 * pair + 1] = s1;
    }
    __syncthreads();
    if (t < Cn) {
      float var = 0.f;
      for (int g = 0; g < G; ++g) var += pt[g * Cn + t];
      var = var / static_cast<float>(M);
      const float inv = 1.0f / sqrtf(var + kEps);
      const float ai = __fmul_rn(inv, sc);
      coef()[t] = __float2bfloat16_rn(ai);
      coef()[kMaxC + t] = __float2bfloat16_rn(__fsub_rn(bi, __fmul_rn(mn[t], ai)));
    }
    __syncthreads();
    if (!apply) return;
    if (on) {
      uint32_t* xm = reinterpret_cast<uint32_t*>(x);
      const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(coef());
      const __nv_bfloat162 ca = c2[pair], cb = c2[kMaxC / 2 + pair];
      for (int p = grp; p < M; p += G) xm[p * ldw + pair] = apply2(xm[p * ldw + pair], ca, cb);
    }
    __syncthreads();
  }

  // ---------------------------------------------------------------- convs

  // A warp's share of columns [n_from, n_from + N) of a conv's output with
  // M rows: one 16-row tile, n_cnt n8 tiles from n_lo; the warps split the
  // rows first, then the columns.
  struct Tile {
    int m0, n_lo, n_cnt;
    bool on;
  };

  static __device__ __forceinline__ Tile tile_of(int M, int N, int n_from = 0) {
    const int mt = (M + 15) / 16;
    const int g = imax(1, kWarps / mt);
    const int nt = N / 8;
    const int per = (nt + g - 1) / g;
    const int warp = threadIdx.x >> 5;
    const int lo = (warp % g) * per;
    Tile tl;
    tl.m0 = (warp / g) * 16;
    tl.n_lo = n_from / 8 + lo;
    tl.n_cnt = nt - lo < per ? nt - lo : per;
    tl.on = warp / g < mt && tl.n_cnt > 0;
    return tl;
  }

  // acc += the products of one weight piece: `ntaps` taps from tap0 (step
  // 2), each K x N in the stage (row stride N + 8), against A [M pixels of
  // an h x w map, K] (row stride lda) shifted by the tap. With kApply, the
  // first norm is applied to A's fragments (coef). Each lane's row
  // addresses are resolved once per tap (a row of zeros where the tap
  // leaves the map, the tile or K) and step 16 deep down K.
  template <int NT, bool kApply>
  __device__ __forceinline__ void products(float (&acc)[NT][4], const Tile& tl,
                                           const __nv_bfloat16* A, int lda, int M, int K, int h,
                                           int w, const unsigned char* st, int N, int tap0,
                                           int ntaps) const {
    const int lane = threadIdx.x & 31;
    const int r = tl.m0 + (lane & 15);  // this lane's A row
    const int y = r / w, x = r - (r / w) * w;
    const int ka = (lane >> 4) * 8;     // this lane's first K (A) and column (B) of a block
    const int kb = lane & 15;           // this lane's K row of B
    const uint32_t zero_row = zero();
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(coef()) + (lane & 3);
    for (int i = 0; i < ntaps; ++i) {
      const int tap = tap0 + 2 * i;
      const int ys = y + tap / 3 - 1, xs = x + tap % 3 - 1;
      const bool a_on = r < M && ys >= 0 && ys < h && xs >= 0 && xs < w && ka < K;
      uint32_t pa = a_on ? smem_u32(A + (ys * w + xs) * lda + ka) : zero_row;
      const uint32_t da = a_on ? 32 : 0;
      const bool b_on = kb < K;  // (K = 8 only: C = 16)
      uint32_t pb = b_on ? smem_u32(st) + ((i * K + kb) * (N + 8) + tl.n_lo * 8 + ka) * 2 : zero_row;
      const uint32_t db = b_on ? 16 * (N + 8) * 2 : 0;
      for (int k0 = 0; k0 < K; k0 += 16, pa += da, pb += db) {
        uint32_t af[4], bf[NT / 2][4];
        ldsm_x4(pa, af);
#pragma unroll
        for (int j = 0; j < NT; j += 2)  // an odd count's last second half: zeros
          if (j < tl.n_cnt)
            ldsm_x4_trans((tl.n_lo + j) * 8 + ka < N ? pb + j * 16 : zero_row, bf[j / 2]);
        if constexpr (kApply) {
          const __nv_bfloat162 a0 = c2[k0 / 2], a1 = c2[k0 / 2 + 4];
          const __nv_bfloat162 b0 = c2[kMaxC / 2 + k0 / 2], b1 = c2[kMaxC / 2 + k0 / 2 + 4];
          af[0] = apply2(af[0], a0, b0);
          af[1] = apply2(af[1], a0, b0);
          af[2] = apply2(af[2], a1, b1);
          af[3] = apply2(af[3], a1, b1);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (j < tl.n_cnt) mma16816(acc[j], af, bf[j / 2][0], bf[j / 2][1]);
          if (j + 1 < tl.n_cnt) mma16816(acc[j + 1], af, bf[j / 2][2], bf[j / 2][3]);
        }
      }
    }
  }

  // ------------------------------------------------------------ ResBlock

  // X [h*w, C] += conv2(norm(conv1(norm(conv0(norm(X)))))), ResBlock rb of the tail
  __device__ __forceinline__ void resblock(__nv_bfloat16* X, int h, int w, int rb, int total) const {
    const int C = a.C, M = h * w;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q2 = 2 * (lane & 3);
    norm(X, ld, M, C, a.s0 + rb * C, a.sb0 + rb * C, false, a.b0 + rb * ch, ch);

    // conv0: 1x1 C -> ch on the normalised X, + b0 -> T1
    {
      const unsigned char* st = acquire(rb * kPieces, total);
      const Tile tl = tile_of(M, ch);
      float acc[8][4] = {};
      if (tl.on) {
        products<8, true>(acc, tl, X, ld, M, C, h, w, st, ch, 4, 1);
        const float* bias = conv_bias();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= tl.n_cnt) continue;
          const int n = (tl.n_lo + j) * 8 + q2;
          const float bl = bias[n], bh = bias[n + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = tl.m0 + g + 8 * hh;
            if (row < M)
              *reinterpret_cast<uint32_t*>(t1() + row * ldh + n) =
                  pack2(__fadd_rn(acc[j][2 * hh], bl), __fadd_rn(acc[j][2 * hh + 1], bh));
          }
        }
      }
    }
    __syncthreads();
    norm(t1(), ldh, M, ch, a.s1 + rb * ch, a.sb1 + rb * ch, true, a.b1 + rb * ch, ch);

    // conv1: 3x3 ch -> ch, the even taps' sum and the odd taps' sum each
    // rounded, added in f32 with b1 -> T2
    {
      const Tile tl = tile_of(M, ch);
      float acc[8][4] = {};
      uint32_t even[8][2];
      for (int i = 0; i < 5; ++i) {
        const unsigned char* st = acquire(rb * kPieces + 1 + i, total);
        if (tl.on) products<8, false>(acc, tl, t1(), ldh, M, ch, h, w, st, ch, kTapFirst[i], kTapCount[i]);
        if (i == 2) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            even[j][0] = pack2(acc[j][0], acc[j][1]);
            even[j][1] = pack2(acc[j][2], acc[j][3]);
            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
          }
        }
      }
      if (tl.on) {
        const float* bias = conv_bias();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= tl.n_cnt) continue;
          const int n = (tl.n_lo + j) * 8 + q2;
          const float bl = bias[n], bh = bias[n + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = tl.m0 + g + 8 * hh;
            const float vl = __fadd_rn(lo_f(even[j][hh]), round_act<__nv_bfloat16>(acc[j][2 * hh]));
            const float vh = __fadd_rn(hi_f(even[j][hh]), round_act<__nv_bfloat16>(acc[j][2 * hh + 1]));
            if (row < M)
              *reinterpret_cast<uint32_t*>(t2() + row * ldh + n) =
                  pack2(__fadd_rn(vl, bl), __fadd_rn(vh, bh));
          }
        }
      }
    }
    __syncthreads();
    norm(t2(), ldh, M, ch, a.s2 + rb * ch, a.sb2 + rb * ch, true, a.b2 + rb * C, C);

    // conv2: 1x1 ch -> C, + b2, cast, + X in bf16 -> X, in two halves of
    // the columns (each a warp's accumulators)
    {
      const unsigned char* st = acquire(rb * kPieces + kPieces - 1, total);
      const float* bias = conv_bias();
      for (int half = 0; half < 2; ++half) {
        const Tile tl = tile_of(M, ch, half * ch);
        if (!tl.on) continue;
        float acc[8][4] = {};
        products<8, false>(acc, tl, t2(), ldh, M, ch, h, w, st, C, 4, 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= tl.n_cnt) continue;
          const int n = (tl.n_lo + j) * 8 + q2;
          const float bl = bias[n], bh = bias[n + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = tl.m0 + g + 8 * hh;
            if (row >= M) continue;
            uint32_t* px = reinterpret_cast<uint32_t*>(X + row * ld + n);
            const float yl = round_act<__nv_bfloat16>(__fadd_rn(acc[j][2 * hh], bl));
            const float yh = round_act<__nv_bfloat16>(__fadd_rn(acc[j][2 * hh + 1], bh));
            *px = pack2(__fadd_rn(yl, lo_f(*px)), __fadd_rn(yh, hi_f(*px)));
          }
        }
      }
    }
    __syncthreads();
  }

  // ----------------------------------------------------- pool, upsample

  // dst [(h/2)*(w/2), C] = 2x2 max-pool of src [h*w, C]; ends with a barrier
  __device__ __forceinline__ void pool(const __nv_bfloat16* src, __nv_bfloat16* dst, int h, int w) const {
    const int cc = a.C / 8, wo = w / 2;
    const int n = (h / 2) * wo * cc;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int p = e / cc, c = (e - p * cc) * 8;
      const int yo = p / wo, xo = p - yo * wo;
      const __nv_bfloat16* s = src + (2 * yo * w + 2 * xo) * ld + c;
      uint4 m = *reinterpret_cast<const uint4*>(s);
      const int offs[3] = {ld, w * ld, w * ld + ld};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint4 v = *reinterpret_cast<const uint4*>(s + offs[k]);
        __nv_bfloat162* mh = reinterpret_cast<__nv_bfloat162*>(&m);
        const __nv_bfloat162* vh = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) mh[i] = __hmax2(mh[i], vh[i]);
      }
      *reinterpret_cast<uint4*>(dst + p * ld + c) = m;
    }
    __syncthreads();
  }

  // fine [h*w, C] + the nearest 2x upsample of coarse, in bf16, into fine,
  // or into out [h*w, C] (device memory, unpadded) if out is set
  __device__ __forceinline__ void upsample_add(__nv_bfloat16* fine, const __nv_bfloat16* coarse, int h, int w,
                               __nv_bfloat16* out) const {
    const int cc = a.C / 8;
    const int n = h * w * cc;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int p = e / cc, c = (e - p * cc) * 8;
      const int yy = p / w, xx = p - yy * w;
      const uint4 f = *reinterpret_cast<const uint4*>(fine + p * ld + c);
      const uint4 u = *reinterpret_cast<const uint4*>(coarse + ((yy / 2) * (w / 2) + xx / 2) * ld + c);
      const uint32_t fw[4] = {f.x, f.y, f.z, f.w}, uw[4] = {u.x, u.y, u.z, u.w};
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = pack2(__fadd_rn(lo_f(fw[i]), lo_f(uw[i])), __fadd_rn(hi_f(fw[i]), hi_f(uw[i])));
      const uint4 v = make_uint4(r[0], r[1], r[2], r[3]);
      if (out != nullptr)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(p) * a.C + c) = v;
      else
        *reinterpret_cast<uint4*>(fine + p * ld + c) = v;
    }
    __syncthreads();
  }
};

// grid B, kThreads threads: block b runs hg(x[b], h, w, lv), in the order
// of the recursion (and of the stacked weights):
//   ResBlock at each level d = 0..lv, each followed by a pool into level d+1;
//   the innermost ResBlock at level lv+1;
//   then for d = lv..0 the second ResBlock at level d+1 and its upsample-add
//   into level d (into the output at d = 0).
__global__ void __launch_bounds__(kThreads, 1) tail_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Block blk{a, smem, layout(a.h, a.w, a.C, a.lv), a.C / 2, a.C + 8, a.C / 2 + 8};
  const int total = (2 * a.lv + 3) * kPieces;
  const size_t sample = static_cast<size_t>(blockIdx.x) * a.h * a.w * a.C;

  for (int n = 0; n < kStages - 1; ++n) {
    if (n < total) blk.issue(n);
    sm90::cp_async_commit();
  }
  if (threadIdx.x < 64) reinterpret_cast<uint32_t*>(smem + blk.L.zero)[threadIdx.x] = 0u;
  const int cc = a.C / 8;
  __nv_bfloat16* x0 = blk.buf(0);
  for (int e = threadIdx.x; e < a.h * a.w * cc; e += kThreads) {
    const int p = e / cc, c = (e - p * cc) * 8;
    *reinterpret_cast<uint4*>(x0 + p * blk.ld + c) =
        *reinterpret_cast<const uint4*>(a.x + sample + static_cast<size_t>(p) * a.C + c);
  }
  __syncthreads();

  int rb = 0;
  for (int d = 0; d <= a.lv; ++d) {
    blk.resblock(blk.buf(d), a.h >> d, a.w >> d, rb++, total);
    blk.pool(blk.buf(d), blk.buf(d + 1), a.h >> d, a.w >> d);
  }
  blk.resblock(blk.buf(a.lv + 1), a.h >> (a.lv + 1), a.w >> (a.lv + 1), rb++, total);
  for (int d = a.lv; d >= 0; --d) {
    blk.resblock(blk.buf(d + 1), a.h >> (d + 1), a.w >> (d + 1), rb++, total);
    blk.upsample_add(blk.buf(d), blk.buf(d + 1), a.h >> d, a.w >> d,
                     d == 0 ? a.out + sample : nullptr);
  }
}

}  // namespace

bool fits(bool bf16, int h, int w, int C, int lv) {
  if (!bf16 || C % 16 != 0 || C > kMaxC || h * w > kMaxPixels || lv < 0 || lv > kMaxLevel)
    return false;
  return smem_bytes(h, w, C, lv) <= kSmemLimit;
}

int smem_bytes(int h, int w, int C, int lv) { return layout(h, w, C, lv).total; }

cudaError_t run(const Args& a, cudaStream_t s) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  tail_kernel<<<a.B, kThreads, smem_bytes(a.h, a.w, a.C, a.lv), s>>>(a);
  return cudaGetLastError();
}

}  // namespace tail
