// Grouped (ragged) matmul over rows sorted by expert: forward (kernel K5f)
// and weight gradient (kernel K5b).
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas_gmm.py:
//   K5f  `_gmm_fwd` -> `_fwd_kernel`: out[t] = lhs[t] @ rhs[e(t)], where
//        e(t) = tile_expert[t / bm]: every bm-row tile of the sorted,
//        per-expert padded buffer belongs to one expert.  fp32
//        accumulation, one rounding to the lhs dtype.  The input gradient
//        of the same product, dlhs[t] = g[t] @ rhs[e(t)]^T, is this kernel
//        reading rhs transposed through its strides (`transpose_rhs`): the
//        JAX backward's `swapaxes(rhs)` copy does not exist here;
//   K5b  `_gmm_drhs` -> `_drhs_kernel`: drhs[e] = sum over e's tiles of
//        lhs_tile^T @ dout_tile, accumulated in fp32 and rounded once to
//        the output dtype; an expert with no tile gets exactly zero.
//
// Translation from the TPU design.  The Pallas forward walks a (m tile,
// n tile) grid and DMAs expert tile_expert[i]'s weight block through a
// scalar-prefetched index map.  Here one CUDA block computes a (BM x 128)
// output tile: it reads tile_expert for its rows itself and multiplies
// against that expert's (C x 128) panel, 16 deep at a time in shared
// memory, with the next stage's loads in registers while the current one
// is multiplied.  The Pallas weight gradient carries each expert's
// (K, bn) accumulator in VMEM across consecutive grid steps ("zero on the
// first visit, add on revisits") because its grid runs in order on one
// core.  Hopper's blocks run in no order, so K5b gives one block to each
// (expert, 128-row K tile, 128-column N tile): the block walks the tiles
// of tile_expert, multiplies the rows of the ones that are its expert's
// with the accumulator in registers, and writes once.  No atomics: the
// result is bitwise repeatable, and an expert with no tiles writes the
// zeros the JAX backward needs a masking pass for.  Scanning tile_expert
// (a few hundred ints, read through the cache) instead of a per-expert
// offset array needs no sortedness and no extra pass.
//
// Bound.  At the MoE training shape (Qwen1.5-MoE-A2.7B widths: 16384
// routed rows in a 31744-row buffer, K 2048, N 1408, 60 experts, bm 256)
// the useful rows' products are ~0.1 ms of bf16 tensor-core work and the
// bytes (lhs, the 60 experts' weights, out) ~0.17 ms at 3.35 TB/s.  This
// first version multiplies in fp32 on the CUDA cores (8 x 8 outputs per
// thread, 67 TFLOP/s peak), far above that bound: the tensor-core
// version (mma.sync, then wgmma + TMA) is later work.
//
// C interface (ctypes, see ops/gmm.py): dtype code 0 = fp32, 1 = bf16;
// lhs is (M, C) row-major; rhs holds E experts `rhs_expert_stride`
// elements apart, each (C, W) row-major, or (W, C) row-major when
// transpose_rhs is set; out is (M, W) row-major.  bm must be a multiple
// of 16 and divide M.  K5b: lhs (M, K), dout (M, N), drhs (E, K, N), all
// row-major.  Each function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kBN = 128;           // output columns per block (16 x 8)
constexpr int kBC = 16;            // contraction depth of one stage
constexpr int kPitchB = kBN + 4;   // float4-aligned rows of the B stage

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

// acc[i][j] += sum over the stage's kBC depth of a[c][row i] * b[c][col j].
// Thread (ty, tx) owns rows ty + 16 i (i < TM) and columns
// tx * 4 + 64 * (j / 4) + j % 4 (j < 8): the row reads are broadcasts and
// each half-warp reads 256 contiguous bytes of a b row.
template <int TM, int PA>
__device__ __forceinline__ void multiply_stage(const float (*a)[PA],
                                               const float (*b)[kPitchB],
                                               float (&acc)[TM][8], int ty,
                                               int tx) {
#pragma unroll
  for (int c = 0; c < kBC; ++c) {
    float ar[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) ar[i] = a[c][ty + 16 * i];
    const float4 b0 = *reinterpret_cast<const float4*>(&b[c][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[c][64 + tx * 4]);
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ int out_col(int tx, int j) {
  return tx * 4 + 64 * (j / 4) + (j % 4);
}

// ---------------------------------------------------------------- K5f
// Block (x = BM-row tile, y = 128-column tile).  BM divides bm, so the
// block's rows share one expert.  A stage is lhs[rows, c0:c0+16] (stored
// transposed, a[c][row]) and the expert's rhs[c0:c0+16, cols].
template <typename T, int BM, bool TRANS>
__global__ void __launch_bounds__(kThreads, 2)
gmm_fwd_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ tile_expert, T* __restrict__ out,
               int C, int W, int bm, long long rhs_expert_stride) {
  constexpr int TM = BM / 16;
  constexpr int PA = BM + 2;         // row pitch: the transposed stores
                                     // of 16 c x 2 rows hit 32 banks
  constexpr int A_PER = BM * kBC / kThreads;
  constexpr int B_PER = kBC * kBN / kThreads;
  __shared__ __align__(16) float a_s[kBC][PA];
  __shared__ __align__(16) float b_s[kBC][kPitchB];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * kBN;
  const int expert = tile_expert[m0 / bm];
  const T* a_src = lhs + m0 * C;
  const T* b_src = rhs + expert * rhs_expert_stride;

  float a_r[A_PER], b_r[B_PER];
  auto load = [&](int c0) {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {   // c fastest: 16 consecutive elements
      const int idx = tid + p * kThreads;
      const int c = idx % kBC, r = idx / kBC;
      a_r[p] = c0 + c < C ? to_f(a_src[static_cast<long long>(r) * C + c0 + c])
                          : 0.f;
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) {
      const int idx = tid + p * kThreads;
      // the contiguous dimension of rhs fastest: columns, or c when
      // rhs is read transposed
      const int c = TRANS ? idx % kBC : idx / kBN;
      const int n = TRANS ? idx / kBC : idx % kBN;
      const bool ok = c0 + c < C && n0 + n < W;
      const long long off =
          TRANS ? static_cast<long long>(n0 + n) * C + c0 + c
                : static_cast<long long>(c0 + c) * W + n0 + n;
      b_r[p] = ok ? to_f(b_src[off]) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int idx = tid + p * kThreads;
      a_s[idx % kBC][idx / kBC] = a_r[p];
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) {
      const int idx = tid + p * kThreads;
      if (TRANS)
        b_s[idx % kBC][idx / kBC] = b_r[p];
      else
        b_s[idx / kBN][idx % kBN] = b_r[p];
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int stages = (C + kBC - 1) / kBC;
  load(0);
  store();
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) load((s + 1) * kBC);   // in flight while we multiply
    multiply_stage<TM, PA>(a_s, b_s, acc, ty, tx);
    __syncthreads();
    if (s + 1 < stages) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    T* row = out + (m0 + ty + 16 * i) * W;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + out_col(tx, j);
      if (n < W) row[n] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- K5b
// Block x = (expert, K tile, N tile), expert slowest.  A stage is 16 rows
// of one of the expert's tiles: lhs[rows, k0:k0+128] and
// dout[rows, n0:n0+128], both stored as read (row-major), so the
// contraction over rows needs no transpose.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
gmm_drhs_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
                const int* __restrict__ tile_expert, T* __restrict__ drhs,
                int n_tiles, int bm, int K, int N) {
  constexpr int TM = 8;               // 128 rows of K per block
  constexpr int PA = 128 + 4;
  constexpr int PER = kBC * 128 / kThreads;
  __shared__ __align__(16) float a_s[kBC][PA];
  __shared__ __align__(16) float b_s[kBC][kPitchB];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kt = (K + 127) / 128, nt = (N + kBN - 1) / kBN;
  const int expert = blockIdx.x / (kt * nt);
  const int rem = blockIdx.x % (kt * nt);
  const int k0 = (rem / nt) * 128, n0 = (rem % nt) * kBN;

  float a_r[PER], b_r[PER];
  auto load = [&](long long r0) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int idx = tid + p * kThreads;
      const int r = idx / 128, x = idx % 128;
      const long long row = r0 + r;
      a_r[p] = k0 + x < K ? to_f(lhs[row * K + k0 + x]) : 0.f;
      b_r[p] = n0 + x < N ? to_f(dout[row * N + n0 + x]) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int idx = tid + p * kThreads;
      a_s[idx / 128][idx % 128] = a_r[p];
      b_s[idx / 128][idx % 128] = b_r[p];
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int stages = bm / kBC;
  for (int t = 0; t < n_tiles; ++t) {
    if (__ldg(tile_expert + t) != expert) continue;   // uniform per block
    const long long r0 = static_cast<long long>(t) * bm;
    load(r0);
    store();
    __syncthreads();
    for (int s = 0; s < stages; ++s) {
      if (s + 1 < stages) load(r0 + (s + 1) * kBC);
      multiply_stage<TM, PA>(a_s, b_s, acc, ty, tx);
      __syncthreads();
      if (s + 1 < stages) {
        store();
        __syncthreads();
      }
    }
  }

  T* base = drhs + static_cast<long long>(expert) * K * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + out_col(tx, j);
      if (n < N) base[static_cast<long long>(k) * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM>
int launch_fwd(const void* lhs, const void* rhs, const int* te, void* out,
               int M, int C, int W, int bm, long long se, int trans,
               cudaStream_t stream) {
  const dim3 grid(M / BM, (W + kBN - 1) / kBN);
  if (trans)
    gmm_fwd_kernel<T, BM, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(lhs), static_cast<const T*>(rhs), te,
        static_cast<T*>(out), C, W, bm, se);
  else
    gmm_fwd_kernel<T, BM, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(lhs), static_cast<const T*>(rhs), te,
        static_cast<T*>(out), C, W, bm, se);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd_bm(const void* lhs, const void* rhs, const int* te, void* out,
                  int M, int C, int W, int bm, long long se, int trans,
                  cudaStream_t stream) {
  // the largest row tile that divides bm: a block never spans two experts
  if (bm % 128 == 0)
    return launch_fwd<T, 128>(lhs, rhs, te, out, M, C, W, bm, se, trans,
                              stream);
  if (bm % 64 == 0)
    return launch_fwd<T, 64>(lhs, rhs, te, out, M, C, W, bm, se, trans,
                             stream);
  if (bm % 32 == 0)
    return launch_fwd<T, 32>(lhs, rhs, te, out, M, C, W, bm, se, trans,
                             stream);
  return launch_fwd<T, 16>(lhs, rhs, te, out, M, C, W, bm, se, trans,
                           stream);
}

}  // namespace

extern "C" int gmm_fwd(const void* lhs, const void* rhs,
                       const void* tile_expert, void* out, int M, int C,
                       int W, int bm, long long rhs_expert_stride,
                       int transpose_rhs, int dtype, void* stream) {
  if (M <= 0 || C <= 0 || W <= 0 || bm <= 0 || bm % 16 || M % bm)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_bm<float>(lhs, rhs, te, out, M, C, W, bm,
                                rhs_expert_stride, transpose_rhs, st);
  if (dtype == 1)
    return launch_fwd_bm<__nv_bfloat16>(lhs, rhs, te, out, M, C, W, bm,
                                        rhs_expert_stride, transpose_rhs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int gmm_drhs(const void* lhs, const void* dout,
                        const void* tile_expert, void* drhs, int M, int K,
                        int N, int bm, int E, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || bm <= 0 || bm % 16 || M % bm)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(E) * ((K + 127) / 128) *
                           ((N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (dtype == 0)
    gmm_drhs_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(dout), te,
        static_cast<float*>(drhs), M / bm, bm, K, N);
  else if (dtype == 1)
    gmm_drhs_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(lhs),
        static_cast<const __nv_bfloat16*>(dout), te,
        static_cast<__nv_bfloat16*>(drhs), M / bm, bm, K, N);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
