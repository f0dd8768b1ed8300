// The pieces of the fused conv + instance-norm unit (K3, fused_chain.cu) that
// the whole-hourglass kernel (K4, hourglass.cu) runs too: the per-(sample,
// channel) norm statistics (one thread-block cluster a sample,
// cluster_norm.cuh) and the implicit-GEMM conv with its norm prologue.
// Host launchers with C++ linkage, defined in fused_chain.cu. Activations are NHWC in the act dtype (bf16 or f32); conv
// weights are HWIO, [k*k, C, Co], in the act dtype; everything else is f32.
// Each launcher enqueues on the given stream, allocates nothing and returns
// the launch's cudaError_t.
#pragma once

#include <cuda_runtime.h>

namespace fused {

// How a conv's input is normalised as the conv loads it (the prologue).
enum ProMode : int {
  kProNone = 0,  // the input as it is
  kProF32 = 1,   // relu(x*a + b) in f32, rounded once to the act dtype (K3's _norm_affine)
  kProAct = 2,   // a, b rounded to the act dtype; x*a rounded; + b rounded; relu (K4's
                 // _instance_norm_relu)
};

struct ConvArgs {
  const void* x;       // [B, H, W, C]
  const void* w;       // [k*k, C, Co]
  const float* bias;   // [Co]
  const float* pro_a;  // [B, C] prologue coefficients (null with kProNone)
  const float* pro_b;
  const void* skip;    // [B, H, W, Co], added in the act dtype after the rounding, or null
  void* y;             // [B, H, W, Co]
  int B, H, W, C, Co, k;  // stride 1, zero padding k/2; C and Co multiples of 8
  int pro_mode;
  int split_taps;      // 3x3 only: even and odd taps summed apart, each rounded (K4's _conv3x3)
};

// a = rsqrt(var + eps) * scale and b = bias - mean * a per (n, c), from the
// exact two-pass mean and biased variance over the H*W pixels of x, in f32.
// H*W*C must be below 2^31.
cudaError_t norm_stats(bool bf16, const void* x, const float* scale, const float* bias,
                       float* a, float* b, int B, int HW, int C, float eps, cudaStream_t s);

// y = [skip +] round(conv(prologue(x)) + bias), f32 accumulation.
cudaError_t conv(bool bf16, const ConvArgs& args, cudaStream_t s);

}  // namespace fused
