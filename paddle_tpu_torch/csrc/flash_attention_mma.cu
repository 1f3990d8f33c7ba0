// K1 / K2 with a bias or dropout on the tensor cores, fp32: three TF32
// products for each fp32 product (kernel code 3).  The kernels, their
// design and bound: flash_attention_mma.cuh.

#include "flash_attention_mma.cuh"

namespace {

int dispatch(int kind, const Args& a, int D, int kernel,
             cudaStream_t stream) {
  if (kernel == kMmaF32) return launch_mma_d<float>(kind, D, a, stream);
  return kBadArg;                // bf16 / fp16: their own libraries
}

}  // namespace
