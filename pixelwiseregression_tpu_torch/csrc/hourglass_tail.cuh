// The levels of K4 (hourglass.cu) whose activations fit one block's shared
// memory, run as one kernel with one block per sample (hourglass_tail.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tail {

// A level-lv sub-hourglass hg(x, h, w, lv) on x [B, h, w, C] bf16, with the
// stacked weights and norm parameters already offset to its first ResBlock
// (2*lv + 3 ResBlocks, in the order of stack_hourglass_params).
struct Args {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const __nv_bfloat16 *w0, *w1, *w2;
  const float *b0, *b1, *b2, *s0, *sb0, *s1, *sb1, *s2, *sb2;
  int B, h, w, C, lv;
};

// The tail's shape rule: bf16, C a multiple of 16 and at most 128, h*w at
// most 256 (h and w multiples of 2^(lv+1), which the caller checks).
bool fits(bool bf16, int h, int w, int C, int lv);

// Dynamic shared memory of one block of the tail at this shape, in bytes.
int smem_bytes(int h, int w, int C, int lv);

// Launches tail_kernel, one block per sample; returns its cudaError_t.
cudaError_t run(const Args& a, cudaStream_t s);

}  // namespace tail
