// K1 / K2 with a bias or dropout on the tensor cores, bf16: P and dS as
// two bf16 parts (kernel code 4).  The kernels, their design and bound:
// flash_attention_mma.cuh.

#include "flash_attention_mma.cuh"

namespace {

int dispatch(int kind, const Args& a, int D, int kernel,
             cudaStream_t stream) {
  if (kernel == kMmaBf16)
    return launch_mma_d<__nv_bfloat16>(kind, D, a, stream);
  return kBadArg;                // fp32 / fp16: their own libraries
}

}  // namespace
