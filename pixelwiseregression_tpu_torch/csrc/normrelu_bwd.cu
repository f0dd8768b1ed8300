// Backward of relu(instance_norm(x)) (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelwiseregression_tpu/ops/fused_normrelu.py::_bwd_kernel.
// From the saved x (NHWC, bf16 or f32), the per-(sample, channel) f32 mean
// and rsqrt, the f32 scale and bias and the cotangent g of the relu output:
//   a = inv*scale, b = bias - mean*a;
//   m = round(x*a + b) > 0, the forward's relu mask after the rounding to
//       the act dtype (x*a and + b are two roundings, never an FMA: a
//       contracted y near 0 could flip a mask bit);
//   gm = m ? g : 0, xhat = (x - mean)*inv;
//   dx = round(a*((gm - mean(gm)) - xhat*mean(gm*xhat)));
//   dscale = sum(gm*xhat), dbias = sum(gm) over the batch and the pixels.
// A channel whose scale and bias are 0 has y = 0, so its mask is empty and
// its gradients are exact zeros.
//
// What bounds it: device-memory bytes (g and x read, dx written: 6 bytes an
// element in bf16, ~12 f32 operations). The TPU kernel held a sample's g
// and x (2 MiB in bf16 at [64*64, 128]) in VMEM to take the reductions and
// the dx pass on one read. Here a sample is one thread-block cluster
// (cluster_norm.cuh) whose blocks hold its slices of g and x in shared
// memory: nr_kernel sums gm and gm*xhat as the slices land, combines the
// blocks' sums over distributed shared memory in rank order (pixel-slice
// order, fixed, no atomics), writes dx from shared memory, and its rank-0
// block stores the per-sample sums; nr_param_kernel sums those over the
// samples in order into dscale and dbias. Two launches a call. Where the
// cluster cannot hold both tensors, x stays resident and g is read twice
// through a ring; where it cannot hold x either, both stream.

#include "cluster_norm.cuh"
#include "vec8.cuh"

namespace {

using pwr::round_act;

constexpr int kParamThreads = 128;

// The per-channel constants of one thread's V channels.
template <int V>
struct Coef {
  float mu[V], iv[V], a[V], b[V];
  __device__ void load(const float* mean, const float* inv, const float* scale, const float* bias,
                       size_t nc, int c) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mu[j] = mean[nc + j];
      iv[j] = inv[nc + j];
      a[j] = __fmul_rn(iv[j], scale[c + j]);
      b[j] = __fsub_rn(bias[c + j], __fmul_rn(mu[j], a[j]));
    }
  }
};

// gm and xhat of V elements from their g and x
template <typename T, int V>
__device__ __forceinline__ void masked(const Coef<V>& k, const float (&gx)[2][V], float (&gm)[V],
                                       float (&xhat)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float y = round_act<T>(__fadd_rn(__fmul_rn(gx[1][j], k.a[j]), k.b[j]));
    gm[j] = y > 0.f ? gx[0][j] : 0.f;
    xhat[j] = __fmul_rn(__fsub_rn(gx[1][j], k.mu[j]), k.iv[j]);
  }
}

struct NrArgs {
  const void* g;  // [B, HW, C]
  const void* x;
  const float* mean;  // [B, C]
  const float* inv;
  const float* scale;  // [C]
  const float* bias;
  float* sum_g;  // [B, C] out
  float* sum_gx;
  void* dx;  // [B, HW, C] out
};

// One cluster per sample; tensor 0 is g, tensor 1 x.
template <typename T>
__global__ void __launch_bounds__(cnorm::kThreads, 1) nr_kernel(const __grid_constant__ cnorm::Plan p,
                                                             const NrArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = cnorm::vec<T>();
  const int n = blockIdx.x / p.cs;
  const int rank = blockIdx.x % p.cs;
  const size_t sample = static_cast<size_t>(n) * p.HW * p.C;
  cnorm::Slices<T, 2> sl(
      p, smem, {static_cast<const T*>(args.g) + sample, static_cast<const T*>(args.x) + sample}, rank);
  const int r_first = rank * p.slice;
  T* dx = static_cast<T*>(args.dx) + sample;
  for (int c0 = 0; c0 < p.C; c0 += p.cw) {
    const cnorm::Lanes<V> l(c0, min(p.cw, p.C - c0));
    const int cc = l.channel();
    Coef<V> k;
    if (l.on) k.load(args.mean, args.inv, args.scale, args.bias, static_cast<size_t>(n) * p.C + cc, cc);
    float acc[2][V] = {};
    sl.pass([&](const T* const (&at)[2], int, int rows) {
      if (l.on)
        cnorm::each_row(l, at, p.C, rows, [&](const float (&gx)[2][V], int) {
          float gm[V], xhat[V];
          masked<T>(k, gx, gm, xhat);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            acc[0][j] = __fadd_rn(acc[0][j], gm[j]);
            acc[1][j] = __fadd_rn(acc[1][j], __fmul_rn(gm[j], xhat[j]));
          }
        });
    });
    const float* tot = sl.reduce(acc, l, c0 + p.cw >= p.C);
    if (rank == 0)
      for (int c = threadIdx.x; c < l.ccw; c += cnorm::kThreads) {
        args.sum_g[static_cast<size_t>(n) * p.C + c0 + c] = tot[c];
        args.sum_gx[static_cast<size_t>(n) * p.C + c0 + c] = tot[p.cw + c];
      }
    float mg[V], mgx[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mg[j] = l.on ? __fdiv_rn(tot[l.gi * V + j], static_cast<float>(p.HW)) : 0.f;
      mgx[j] = l.on ? __fdiv_rn(tot[p.cw + l.gi * V + j], static_cast<float>(p.HW)) : 0.f;
    }
    sl.pass([&](const T* const (&at)[2], int r0, int rows) {
      if (l.on)
        cnorm::each_row(l, at, p.C, rows, [&](const float (&gx)[2][V], int q) {
          float gm[V], xhat[V], d[V];
          masked<T>(k, gx, gm, xhat);
#pragma unroll
          for (int j = 0; j < V; ++j)
            d[j] = __fmul_rn(k.a[j], __fsub_rn(__fsub_rn(gm[j], mg[j]), __fmul_rn(xhat[j], mgx[j])));
          cnorm::st16(dx + (r_first + r0 + q) * p.C + cc, d);
        });
    });
    __syncthreads();  // the sums are read before the next chunk's reduction writes them
  }
  sl.finish();
}

__global__ void __launch_bounds__(kParamThreads) nr_param_kernel(
    const float* __restrict__ sum_g, const float* __restrict__ sum_gx, float* __restrict__ dscale,
    float* __restrict__ dbias, int B, int C) {
  const int c = blockIdx.x * kParamThreads + threadIdx.x;
  if (c >= C) return;
  float ds = 0.f, db = 0.f;
  for (int n = 0; n < B; ++n) {
    ds = __fadd_rn(ds, sum_gx[static_cast<size_t>(n) * C + c]);
    db = __fadd_rn(db, sum_g[static_cast<size_t>(n) * C + c]);
  }
  dscale[c] = ds;
  dbias[c] = db;
}

// The plan of nr_kernel<T> for [B, HW, C]; out, if given, receives it
// (cnorm::describe) and nothing launches.
template <typename T>
cudaError_t launch(const NrArgs& args, float* dscale, float* dbias, int B, int HW, int C,
                   cudaStream_t s, int* out) {
  static bool large = false;
  static const cudaError_t ready = cnorm::prepare(nr_kernel<T>, &large);
  if (ready != cudaSuccess) return ready;
  if (static_cast<long long>(HW) * C >= (1LL << 31)) return cudaErrorInvalidValue;
  const cnorm::Plan p = cnorm::plan(2, sizeof(T), 2, 2, B, HW, C, large);
  if (p.smem == 0) return cudaErrorInvalidValue;
  if (out != nullptr) {
    cnorm::describe(p, out);
    return cudaSuccess;
  }
  const cudaError_t err = cnorm::launch(nr_kernel<T>, p, s, p, args);
  if (err != cudaSuccess) return err;
  nr_param_kernel<<<(C + kParamThreads - 1) / kParamThreads, kParamThreads, 0, s>>>(
      args.sum_g, args.sum_gx, dscale, dbias, B, C);
  return cnorm::count(cudaGetLastError(), 1);
}

cudaError_t dispatch(bool bf16, const NrArgs& args, float* dscale, float* dbias, int B, int HW, int C,
                     cudaStream_t s, int* out) {
  return bf16 ? launch<__nv_bfloat16>(args, dscale, dbias, B, HW, C, s, out)
              : launch<float>(args, dscale, dbias, B, HW, C, s, out);
}

}  // namespace

// f32 workspace that normrelu_bwd needs: the per-sample sums of gm and
// gm*xhat.
extern "C" long long normrelu_bwd_workspace_floats(int B, int HW, int C) {
  (void)HW;
  return 2LL * B * C;
}

// g, x and dx [B, HW, C] in the act dtype (bf16 if bf16, else f32); mean and
// inv [B, C], scale and bias [C], dscale and dbias [C] f32; work holds
// normrelu_bwd_workspace_floats floats. C is a multiple of 8 and at most
// 2048, H*W*C below 2^31, every pointer 16-byte aligned; the caller checks.
// Returns the first failed launch's cudaError_t.
extern "C" int normrelu_bwd(int bf16, const void* g, const void* x, const float* mean,
                            const float* inv, const float* scale, const float* bias, void* dx,
                            float* dscale, float* dbias, float* work, int B, int HW, int C,
                            void* stream) {
  const NrArgs args{g, x, mean, inv, scale, bias, work, work + static_cast<size_t>(B) * C, dx};
  return static_cast<int>(
      dispatch(bf16, args, dscale, dbias, B, HW, C, static_cast<cudaStream_t>(stream), nullptr));
}

// The plan normrelu_bwd would run for [B, HW, C]: out[4] = cluster size,
// resident tensors (bit 0: g, bit 1: x), ring slots (0: both resident),
// shared memory a block. Returns a cudaError_t.
extern "C" int normrelu_bwd_plan(int bf16, int B, int HW, int C, int* out) {
  return static_cast<int>(dispatch(bf16, NrArgs{}, nullptr, nullptr, B, HW, C, nullptr, out));
}
