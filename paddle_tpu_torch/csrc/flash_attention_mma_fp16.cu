// K1 / K2 with a bias or dropout on the tensor cores, fp16: P and dS as
// two fp16 parts (kernel code 5), the calls of a model under
// amp.auto_cast(dtype="float16").  The kernels, their design and bound:
// flash_attention_mma.cuh.

#include "flash_attention_mma.cuh"

namespace {

int dispatch(int kind, const Args& a, int D, int kernel,
             cudaStream_t stream) {
  if (kernel == kMmaF16) return launch_mma_d<__half>(kind, D, a, stream);
  return kBadArg;                // fp32 / bf16: their own libraries
}

}  // namespace
