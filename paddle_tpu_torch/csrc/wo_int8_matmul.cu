// Weight-only int8 matrix product, W8A16 (kernel Q1, the port's own).
//
//   y (M, N) = cast_x( (x (M, K) @ float(wq (K, N) int8)) * scale (N,) )
//
// with the products accumulated in fp32, the per-output-channel scale
// applied to the fp32 result, and y in x's dtype (bf16 or fp32).  wq is
// in the JAX package's `[in, out]` layout, row-major.
//
// Stands in for paddle_tpu/quantization/int8.py:88 `matmul_wo_int8`.
// The JAX package leaves that product to XLA, which fuses the int8 ->
// x.dtype convert into the dot's operand read, so device memory sees
// int8 bytes; no Pallas kernel computes it.  Eager PyTorch would
// dequantise, write the bf16 matrix back and read it again (more bytes
// than the bf16 weight itself), hence a kernel of the port's own.
//
// Bound.  At the serving row counts (M = 8 a decode step, 8 x W a verify,
// 128 a prefill chunk) the product is bound by the weight's bytes:
// K * N int8 + 4 N of scales + M * K * sizeof(x) + M * N * sizeof(y),
// over 3.35 TB/s on an H100 SXM.  2 * M * K * N operations at 989
// TFLOP/s (bf16) pass the byte time only past M ~ 300.
//
// Design (simple and right first, shaped for the bytes):
//   * q1_bf16_kernel<MF>, grid (ceil(N / 128), ceil(M / 16MF), splits),
//     128 threads.  One block computes a 16MF x 128 tile of y over its
//     split's range of K.  Tiles of 64 K rows stream through a ring of
//     4 shared-memory stages with 16-byte cp.async copies: x's rows
//     (rows past M and K are zero-filled, never read) and W's int8 rows
//     as they lie in memory.  Each warp owns 32 columns.  A fragments
//     (x, bf16) are 32-bit shared loads; B fragments are built from W's
//     bytes in registers: int8 -> float -> bf16 is exact (|q| <= 127).
//     The product is mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
//     Rows of the shared tiles are padded by 16 bytes, so neither the
//     A loads nor the byte loads of B meet bank conflicts.
//   * Split-K fills the card at small M: N = 4096 gives only 32 column
//     tiles for 132 SMs.  The wrapper picks the split from (M, K, N)
//     alone (`ops/wo_int8_matmul.py::split_k`), so a CUDA-graph replay
//     runs the same split as the eager call.  With one split the block
//     applies the scale and writes y; with more it writes its fp32
//     partial tile to a workspace the caller allocates, and
//     q1_merge_kernel sums the partials in split order, scales and
//     casts: no atomics, so results are bitwise the same run to run.
//   * q1_f32_kernel: fp32 x on the CUDA cores (the fp32 debug models):
//     one thread per output column, 8 rows a block, x's tile staged in
//     shared memory, W read as bytes (coalesced along N); same split
//     and merge.
//
// C interface (ctypes, see ops/wo_int8_matmul.py): x_dtype 0 = float32,
// 1 = bfloat16.  K % 16 == 0 and N % 16 == 0 (bf16), every pointer 16-byte
// aligned.  `work` holds splits * M * N floats (unused when splits == 1).
// Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // 4 warps
constexpr int kBN = 128;             // columns of y a block
constexpr int kBK = 64;              // K rows a stage
constexpr int kStages = 4;
constexpr int kWRow = kBN + 16;      // bytes of a W row in shared memory
constexpr int kXRow = kBK + 8;       // bf16 elements of an x row there
constexpr int kF32Rows = 8;          // rows of y a block of the fp32 kernel

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;       // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t bf16x2(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MF>
constexpr int bf16_smem_bytes() {
  return kStages * (16 * MF * kXRow * 2 + kBK * kWRow);
}

// One 16MF x 128 tile of y over K tiles [kt0, kt0 + nt) of 64 rows.
template <int MF>
__global__ void __launch_bounds__(kThreads)
    q1_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ work,
                   int M, int K, int N, int tiles_per_split) {
  constexpr int BM = 16 * MF;
  constexpr int kXBytes = BM * kXRow * 2;
  constexpr int kStageBytes = kXBytes + kBK * kWRow;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;        // mma group, thread in group
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int kt_total = (K + kBK - 1) / kBK;
  const int kt0 = split * tiles_per_split;
  const int nt = min(kt_total, kt0 + tiles_per_split) - kt0;

  auto load_stage = [&](int stage, int kt) {
    unsigned char* sx = smem + stage * kStageBytes;
    unsigned char* sw = sx + kXBytes;
    const int k0 = kt * kBK;
    for (int c = tid; c < BM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), ch = c % (kBK / 8);
      const int m = m0 + r, k = k0 + ch * 8;
      const bool ok = m < M && k < K;
      cp_async16(sx + r * kXRow * 2 + ch * 16,
                 ok ? static_cast<const void*>(x + (size_t)m * K + k)
                    : static_cast<const void*>(x),
                 ok);
    }
    for (int c = tid; c < kBK * (kBN / 16); c += kThreads) {
      const int r = c / (kBN / 16), ch = c % (kBN / 16);
      const int k = k0 + r, n = n0 + ch * 16;
      const bool ok = k < K && n < N;
      cp_async16(sw + r * kWRow + ch * 16,
                 ok ? static_cast<const void*>(w + (size_t)k * N + n)
                    : static_cast<const void*>(w),
                 ok);
    }
  };

  float acc[MF][4][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    const int next = i + kStages - 1;
    if (next < nt) load_stage(next % kStages, kt0 + next);
    cp_async_commit();

    const unsigned char* sx = smem + (i % kStages) * kStageBytes;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(sx);
    const int8_t* ws = reinterpret_cast<const int8_t*>(sx + kXBytes);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        const __nv_bfloat16* p = xs + (mf * 16 + g) * kXRow + kk + 2 * t;
        a[mf][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mf][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kXRow);
        a[mf][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[mf][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kXRow + 8);
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int8_t* col = ws + (kk + 2 * t) * kWRow + warp * 32 + nf * 8 + g;
        const uint32_t b0 = bf16x2(col[0], col[kWRow]);
        const uint32_t b1 = bf16x2(col[8 * kWRow], col[9 * kWRow]);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) mma_bf16(acc[mf][nf], a[mf], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
      const int c = n0 + warp * 32 + nf * 8 + 2 * t;
      if (c >= N) continue;          // N % 16 == 0: c + 1 < N as well
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mf * 16 + g + 8 * h;
        if (r >= M) continue;
        const float v0 = acc[mf][nf][2 * h], v1 = acc[mf][nf][2 * h + 1];
        if (work != nullptr) {
          *reinterpret_cast<float2*>(work + ((size_t)split * M + r) * N + c) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * N + c) =
              __floats2bfloat162_rn(v0 * scale[c], v1 * scale[c + 1]);
        }
      }
    }
}

// fp32 x on the CUDA cores: one thread per column, kF32Rows rows a block.
__global__ void __launch_bounds__(kThreads)
    q1_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y,
                  float* __restrict__ work, int M, int K, int N,
                  int tiles_per_split) {
  __shared__ float xs[kF32Rows][kBK];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kBN + tid, m0 = blockIdx.y * kF32Rows;
  const int split = blockIdx.z;
  const int kbeg = split * tiles_per_split * kBK;
  const int kend = min(K, kbeg + tiles_per_split * kBK);
  float acc[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) acc[r] = 0.f;
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kF32Rows * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < kend) ? x[(size_t)m * K + k] : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int kn = min(kBK, kend - k0);
      for (int c = 0; c < kn; ++c) {
        const float wv = static_cast<float>(w[(size_t)(k0 + c) * N + n]);
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) acc[r] = fmaf(xs[r][c], wv, acc[r]);
      }
    }
  }
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
    if (work != nullptr)
      work[((size_t)split * M + m) * N + n] = acc[r];
    else
      y[(size_t)m * N + n] = acc[r] * scale[n];
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// y = cast(sum over splits, in split order, of the partials * scale).
template <typename T>
__global__ void q1_merge_kernel(const float* __restrict__ work,
                                const float* __restrict__ scale,
                                T* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += work[k * total + i];
  store(y + i, s * scale[i % N]);
}

template <int MF>
cudaError_t launch_bf16(const void* x, const void* w, const void* scale,
                        void* y, float* work, int M, int K, int N,
                        int splits, int per, cudaStream_t stream) {
  static bool configured = false;   // the shared-memory limit, once
  constexpr int smem = bf16_smem_bytes<MF>();
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        q1_bf16_kernel<MF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * MF - 1) / (16 * MF), splits);
  q1_bf16_kernel<MF><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      splits > 1 ? work : nullptr, M, K, N, per);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wo_int8_matmul(const void* x, const void* w, const void* scale,
                              void* y, void* work, int M, int K, int N,
                              int splits, int tiles_per_split, int x_dtype,
                              int device, void* stream_ptr) {
  const int kt = (K + kBK - 1) / kBK;
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || tiles_per_split <= 0 ||
      (long long)splits * tiles_per_split < kt ||
      (long long)(splits - 1) * tiles_per_split >= kt ||
      (splits > 1 && work == nullptr) || (x_dtype != 0 && x_dtype != 1) ||
      (x_dtype == 1 && (K % 16 || N % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* ws = static_cast<float*>(work);
  cudaError_t err;
  if (x_dtype == 1) {
    if (M <= 16)
      err = launch_bf16<1>(x, w, scale, y, ws, M, K, N, splits,
                           tiles_per_split, stream);
    else if (M <= 32)
      err = launch_bf16<2>(x, w, scale, y, ws, M, K, N, splits,
                           tiles_per_split, stream);
    else
      err = launch_bf16<4>(x, w, scale, y, ws, M, K, N, splits,
                           tiles_per_split, stream);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kF32Rows - 1) / kF32Rows,
                    splits);
    q1_f32_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y),
        splits > 1 ? ws : nullptr, M, K, N, tiles_per_split);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && splits > 1) {
    const size_t total = (size_t)M * N;
    const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
    if (x_dtype == 1)
      q1_merge_kernel<<<blocks, 256, 0, stream>>>(
          ws, static_cast<const float*>(scale),
          static_cast<__nv_bfloat16*>(y), M, N, splits);
    else
      q1_merge_kernel<<<blocks, 256, 0, stream>>>(
          ws, static_cast<const float*>(scale), static_cast<float*>(y), M, N,
          splits);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
