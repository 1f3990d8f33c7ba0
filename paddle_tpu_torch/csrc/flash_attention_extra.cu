// Flash attention K1 / K2 with an additive bias and Philox dropout: the
// CUDA-core ("fma") kernels of flash_attention_fma.cuh built with the
// bias and dropout code (kExtra true), in fp32 and bf16 at head_dim 16,
// 32, 64 and 128.  ops/flash_attention.py sends a call with a bias or
// dropout here when it names `variant="fma"` (by default such a call runs
// the tensor-core kernels of flash_attention_mma.cu; these stay as the
// yardstick timed beside them); what the kernels compute and the
// keep-bit layout are in flash_attention.cu's header comment.  Same C
// interface as flash_attention.cu.

#include "flash_attention_fma.cuh"

namespace {

int dispatch(int kind, const Args& a, int D, int kernel,
             cudaStream_t stream) {
  if (kernel == kFmaF32) return launch_d<float, true>(kind, D, a, stream);
  if (kernel == kFmaBf16)
    return launch_d<__nv_bfloat16, true>(kind, D, a, stream);
  return kBadArg;          // the mma kernels are flash_attention_mma.cu's
}

}  // namespace
