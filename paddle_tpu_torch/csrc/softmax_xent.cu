// Fused softmax cross-entropy over the vocabulary, forward (kernel K3f)
// and backward (kernel K3b).
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas_ce.py:
//   K3f  `_run_fwd` -> `_fwd_kernel`: per row, an online logsumexp over
//        the vocabulary and the label's logit; loss = lse - picked, and
//        lse is kept for the backward;
//   K3b  `_run_bwd` -> `_bwd_kernel`: dlogits = (exp(logit - lse) -
//        onehot(label)) * g, in the logits' dtype.
// Both accumulate in fp32 from NEG_INF = -1e30, as the Pallas kernels do.
// A row whose label is negative is ignored: its loss and lse are 0, its
// gradient row is zeros, and its logits are not read.  The causal-LM
// loss uses that to drop the last position of every sequence instead of
// slicing logits[:, :-1] (a non-contiguous 1 GB view at the Llama-3-8B
// training shape) and to have the backward write the full (B, S, V)
// gradient directly, zero rows included.  A label >= V gives a NaN loss
// and no one-hot term in the gradient, as the JAX package's loss formula
// does (its gather fills NaN past the vocabulary).
//
// Translation from the TPU design.  The Pallas kernels pad the rows to
// 256 and walk 768-wide vocab tiles in a sequential grid, carrying
// (max, sum, picked) in VMEM scratch.  Here the forward gives each row
// one 256-thread block: each thread folds 16-byte vectors of the row
// into its own running (max, sum), the block merges the 256 pairs
// (shuffles, then shared memory), and one thread reads the label's logit
// directly.  The backward runs a grid of (row, vocab chunk) blocks, each
// recomputing exp(logit - lse) from the saved lse.  Rows are not padded:
// a block per row needs no padding, and vectors past V do not exist.
//
// Bound.  Both are bound by bytes: the forward must read every logit of
// the rows it keeps once (at the Llama-3-8B training shape, 4094 rows x
// 128256 bf16 = 1.05 GB, 0.31 ms at 3.35 TB/s on an H100 SXM); the
// backward reads them once more and writes the gradient (2.1 GB,
// 0.63 ms).  Each element costs ~1 exp and a few FMAs: far below the
// card's ridge point.
//
// C interface (ctypes, see ops/softmax_xent.py): dtype code 0 = fp32,
// 1 = bf16; logits are (R, V) with row stride `row_stride` elements and
// V contiguous; vec = 1 selects scalar loads, otherwise 16-byte vectors
// (the wrapper checks V, the row stride and the pointers for it); the
// gradient is written (R, V) contiguous.  Each function returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkVecs = 4;          // vectors per thread per backward block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// fold (m2, s2) into the running (m, s): s sums exp(x - m)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ logits, long long row_stride,
                const int* __restrict__ labels, int V,
                float* __restrict__ loss, float* __restrict__ lse_out) {
  const int row = blockIdx.x;
  const int label = labels[row];
  if (label < 0) {                     // ignored row
    if (threadIdx.x == 0) {
      loss[row] = 0.f;
      lse_out[row] = 0.f;
    }
    return;
  }
  const T* x = logits + static_cast<long long>(row) * row_stride;
  float m = kNegInf, s = 0.f;
  const int nvec = V / VEC;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(x + i * VEC);
    float f[VEC];
    float vm = m;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      f[e] = to_f(v.v[e]);
      vm = fmaxf(vm, f[e]);
    }
    s *= expf(m - vm);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += expf(f[e] - vm);
    m = vm;
  }
  for (int c = nvec * VEC + threadIdx.x; c < V; c += kThreads)
    merge(m, s, to_f(x[c]), 1.f);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float sm_m[kWarps], sm_s[kWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sm_m[warp] = m;
    sm_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm_m[0];
    s = sm_s[0];
    for (int w = 1; w < kWarps; ++w) merge(m, s, sm_m[w], sm_s[w]);
    const float lse = m + logf(s);
    const float picked =
        label < V ? to_f(x[label]) : __int_as_float(0x7fc00000);  // NaN
    loss[row] = lse - picked;
    lse_out[row] = lse;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ logits, long long row_stride,
                const int* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g,
                int V, T* __restrict__ dlogits) {
  constexpr int kChunk = kThreads * kChunkVecs * VEC;
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int c1 = min(V, c0 + kChunk);
  const int label = labels[row];
  const T* x = logits + static_cast<long long>(row) * row_stride;
  T* out = dlogits + static_cast<long long>(row) * V;
  const float l = label < 0 ? 0.f : lse[row];
  const float gg = label < 0 ? 0.f : g[row];
  for (int c = c0 + threadIdx.x * VEC; c < c1; c += kThreads * VEC) {
    Vec<T, VEC> o;
    if (label < 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = from_f<T>(0.f);
    } else {
      const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(x + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float p = expf(to_f(v.v[e]) - l);
        o.v[e] = from_f<T>((p - (c + e == label ? 1.f : 0.f)) * gg);
      }
    }
    *reinterpret_cast<Vec<T, VEC>*>(out + c) = o;
  }
}

template <typename T, int VEC>
int launch(bool fwd, const void* logits, long long row_stride,
           const int* labels, const float* lse, const float* g, int R, int V,
           float* loss, float* lse_out, void* dlogits, cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  if (fwd) {
    xent_fwd_kernel<T, VEC><<<R, kThreads, 0, stream>>>(
        x, row_stride, labels, V, loss, lse_out);
  } else {
    constexpr int kChunk = kThreads * kChunkVecs * VEC;
    const dim3 grid(R, (V + kChunk - 1) / kChunk);
    xent_bwd_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
        x, row_stride, labels, lse, g, V, static_cast<T*>(dlogits));
  }
  return static_cast<int>(cudaGetLastError());
}

int run(bool fwd, const void* logits, long long row_stride,
        const int* labels, const float* lse, const float* g, int R, int V,
        float* loss, float* lse_out, void* dlogits, int dtype, int vec,
        void* stream) {
  if (R <= 0 || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XENT_ARGS fwd, logits, row_stride, labels, lse, g, R, V, loss, lse_out, dlogits, st
  if (dtype == 0) {
    if (vec == 1) return launch<float, 1>(XENT_ARGS);
    if (vec == 4) return launch<float, 4>(XENT_ARGS);
  } else if (dtype == 1) {
    if (vec == 1) return launch<__nv_bfloat16, 1>(XENT_ARGS);
    if (vec == 8) return launch<__nv_bfloat16, 8>(XENT_ARGS);
  }
#undef XENT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int softmax_xent_fwd(const void* logits, const int* labels,
                                float* loss, float* lse, long long row_stride,
                                int R, int V, int dtype, int vec,
                                void* stream) {
  return run(true, logits, row_stride, labels, nullptr, nullptr, R, V, loss,
             lse, nullptr, dtype, vec, stream);
}

extern "C" int softmax_xent_bwd(const void* logits, const int* labels,
                                const float* lse, const float* g,
                                void* dlogits, long long row_stride, int R,
                                int V, int dtype, int vec, void* stream) {
  return run(false, logits, row_stride, labels, lse, g, R, V, nullptr,
             nullptr, dlogits, dtype, vec, stream);
}
