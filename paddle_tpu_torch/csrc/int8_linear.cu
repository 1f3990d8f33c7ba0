// Kernel Q2: the W8A8 linear of int8 serving,
//
//   y = (clip(round(x / x_scale), -127, 127) @ wq) * (x_scale * w_scale)
//       + bias,
//
// x (M, K) fp32, bf16 or fp16, wq int8 with per-output-channel fp32
// scales, y (M, N) in x's dtype, for any M, N and K.
//
// Replaces no Pallas kernel: the JAX package computes it in XLA
// (paddle_tpu/quantization/int8.py:99 `_int8_linear_raw`, a
// lax.dot_general of int8 operands into an int32 accumulator, the MXU's
// int8 path), for every Linear that `quantize_for_inference` swaps
// (`Int8Linear`) and, through an im2col, every Conv2D (`Int8Conv2D`).
// It is the port's own kernel for that product: the saved int8 program
// holds it as one node a layer (the operator
// `paddle_tpu_torch::int8_linear`, ops/int8_linear.py).
//
// Arithmetic, bit for bit the plain version (ops/int8_linear.py):
//   * x is quantized as it is loaded: rint(fl(fp32(x) / x_scale)) (half
//     to even, as jnp.round), clamped to +-127.  The quotient is taken
//     as x * (1 / x_scale), within 3 fp32 ulps of the IEEE quotient, and
//     wherever that lies within 1e-5 of a half-integer (where the two
//     could round to different integers) by IEEE division (__fdiv_rn):
//     the integer is the IEEE quotient's in every case;
//   * int8 x int8 products summed exactly in int32 on the tensor cores
//     (mma.sync m16n8k32 .s8.s8.s32);
//   * the epilogue: __int2float_rn(acc) (|acc| passes 2^24 at K 3072),
//     times the fp32 scale x_scale * w_scale[n] (one fp32 product, as
//     JAX's weak-typed x_scale * w_scale), plus bias[n], each rounded
//     on its own (__fmul_rn, __fadd_rn: no FMA contraction), then
//     rounded to x's dtype.
//
// Layout.  A block is 8 warps (256 threads) over a 64 x 128 tile of y,
// each warp 32 x 32 (2 m16 x 4 n8 fragments, 32 int32 accumulators a
// thread), stepping over K in 64-column tiles (two k32 steps).  The
// weight arrives as `wt`, the layer's (N, Kp) int8 copy of wq^T, K
// contiguous and zero-padded to Kp, a multiple of 64: a tile row is four
// 16-byte cp.async chunks, zero-filled past N.  x is loaded four values
// at a time (one vector load where K is a multiple of 4 and x aligned,
// else four guarded loads), quantized in registers and stored to shared
// memory as int8, zero past M and K.  Every column block quantizes its
// rows of x again: with 64 x 64 tiles and IEEE division for every value,
// that work made the first version of this kernel slower than the fp32
// matmul at ERNIE's shapes (0.247 against 0.220 ms, FFN 768 -> 3,072);
// 128-column tiles halve it and the reciprocal cuts its cost.  Both
// tiles are double-buffered: the next tile's weight copy and x loads
// are in flight while the tensor cores work on this one.  Shared rows
// are padded to 80 bytes, so a warp's fragment loads hit 32 distinct
// banks.
//
// Bound.  2 M N K int8 operations at 1,979 TOP/s against the bytes: x
// (M K in its dtype), wq (K N), the scales and bias (8 N) and y (M N in
// x's dtype).  At ERNIE-3.0-base's FFN (M 2,048, K 768, N 3,072, fp32 x)
// that is 9.66 GOP (0.0049 ms) against 33.6 MB (0.0100 ms): bound by
// bytes, as is every serving shape (M <= 2,048).  This first kernel is
// simple and right; wgmma and a persistent tile loop are later work.
//
// C interface: int8_linear(x, wt, w_scale, bias or NULL, y, M, N, K, Kp,
// x_scale, dtype code (0 fp32, 1 bf16, 2 fp16), stream) -> cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps: 2 (rows) x 4 (columns)
constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kLd = kBK + 16;            // bytes of a shared row
constexpr int kXPer = kBM * kBK / kThreads;   // x elements a thread loads
const int kBadArg = static_cast<int>(cudaErrorInvalidValue);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

// round(x / x_scale) clamped to +-127, as an int8 bit pattern.  y = x *
// rcp (rcp = 1 / x_scale rounded) is within 3 fp32 ulps of fl(x /
// x_scale); rint of the two agrees unless y lies within that of a
// half-integer, so only there is the IEEE division taken (NaN and inf
// take it too): the result is rint(fl(x / x_scale)) bit for bit.
__device__ __forceinline__ uint32_t quant(float x, float xs, float rcp) {
  const float y = x * rcp;
  const float d = fabsf((y - floorf(y)) - 0.5f);
  const float r = d > 1e-5f * fmaxf(fabsf(y), 1.f) ? rintf(y)
                                                    : rintf(__fdiv_rn(x, xs));
  const float q = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu;
}

template <typename T>
struct Quad;                             // four x values in one load
template <>
struct alignas(16) Quad<float> {
  float v[4];
};
template <>
struct alignas(8) Quad<__nv_bfloat16> {
  __nv_bfloat16 v[4];
};
template <>
struct alignas(8) Quad<__half> {
  __half v[4];
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the weight tile (kBN rows of wt from n0, columns k0 .. k0 + kBK) into
// `dst` by cp.async, rows past N zero
__device__ __forceinline__ void stage_w(uint8_t* dst, const int8_t* wt,
                                        int n0, int k0, int N, int Kp) {
  for (int idx = threadIdx.x; idx < kBN * (kBK / 16); idx += kThreads) {
    const int r = idx / (kBK / 16), c = (idx % (kBK / 16)) * 16;
    const bool in = n0 + r < N;
    cp16(dst + r * kLd + c,
         wt + static_cast<long long>(in ? n0 + r : 0) * Kp + k0 + c, in);
  }
}

// this thread's kXPer x values of the tile at (m0, k0), as 4-element
// runs along K (zero past M and K), loaded into `v` (one vector load a
// run where `vec`: K a multiple of 4 and x aligned)
template <typename T>
__device__ __forceinline__ void load_x(float (&v)[kXPer], const T* x, int m0,
                                       int k0, int M, int K, bool vec) {
#pragma unroll
  for (int i = 0; i < kXPer / 4; ++i) {
    const int idx = threadIdx.x + i * kThreads;     // a 4-element run
    const int r = idx / (kBK / 4), c = (idx % (kBK / 4)) * 4;
    const int m = m0 + r, k = k0 + c;
    const T* p = x + static_cast<long long>(m) * K + k;
    if (vec) {
      Quad<T> q;
      if (m < M && k < K) {
        q = *reinterpret_cast<const Quad<T>*>(p);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) q.v[e] = from_f<T>(0.f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * i + e] = to_f(q.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[4 * i + e] = m < M && k + e < K ? to_f(p[e]) : 0.f;
    }
  }
}

// the loaded values quantized, as int8 words into the tile `dst` (a
// zero quantizes to 0: rows past M and columns past K stay 0)
__device__ __forceinline__ void store_x(uint8_t* dst, const float (&v)[kXPer],
                                        float xs, float rcp) {
#pragma unroll
  for (int i = 0; i < kXPer / 4; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kBK / 4), c = (idx % (kBK / 4)) * 4;
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) w |= quant(v[4 * i + e], xs, rcp) << (8 * e);
    *reinterpret_cast<uint32_t*>(dst + r * kLd + c) = w;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_linear_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ bias, T* __restrict__ y, int M,
                   int N, int K, int Kp, float xs) {
  __shared__ __align__(16) uint8_t As[2][kBM * kLd];
  __shared__ __align__(16) uint8_t Bs[2][kBN * kLd];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int n_kt = Kp / kBK;
  const float rcp = 1.f / xs;
  const bool vec = K % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % sizeof(Quad<T>) == 0;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  float xv[kXPer];
  stage_w(Bs[0], wt, n0, 0, N, Kp);
  asm volatile("cp.async.commit_group;\n" ::);
  load_x(xv, x, m0, 0, M, K, vec);
  store_x(As[0], xv, xs, rcp);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    const bool next = kt + 1 < n_kt;
    if (next) {                  // the next tile, in flight during the mma
      stage_w(Bs[cur ^ 1], wt, n0, (kt + 1) * kBK, N, Kp);
      load_x(xv, x, m0, (kt + 1) * kBK, M, K, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const uint8_t* A = As[cur];
    const uint8_t* B = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* ar = A + (wm + 16 * i + g) * kLd + kk + 4 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(ar);
        a[i][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kLd);
        a[i][2] = *reinterpret_cast<const uint32_t*>(ar + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* br = B + (wn + 8 * j + g) * kLd + kk + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
    if (next) store_x(As[cur ^ 1], xv, xs, rcp);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn + 8 * j + 2 * t + e;
      if (n >= N) continue;
      const float s = __fmul_rn(xs, w_scale[n]);
      const float b = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * i + g + 8 * h;
          if (m >= M) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), s);
          if (bias != nullptr) v = __fadd_rn(v, b);
          y[static_cast<long long>(m) * N + n] = from_f<T>(v);
        }
    }
  }
}

template <typename T>
int launch(const void* x, const int8_t* wt, const float* w_scale,
           const float* bias, void* y, int M, int N, int K, int Kp, float xs,
           cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_linear_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), wt, w_scale, bias, static_cast<T*>(y), M, N,
      K, Kp, xs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int int8_linear(const void* x, const void* wt,
                           const float* w_scale, const float* bias, void* y,
                           int M, int N, int K, int Kp, float x_scale,
                           int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % kBK) return kBadArg;
  const int8_t* w = static_cast<const int8_t*>(wt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, w, w_scale, bias, y, M, N, K, Kp,
                                 x_scale, s);
    case 1: return launch<__nv_bfloat16>(x, w, w_scale, bias, y, M, N, K,
                                         Kp, x_scale, s);
    case 2: return launch<__half>(x, w, w_scale, bias, y, M, N, K, Kp,
                                  x_scale, s);
    default: return kBadArg;
  }
}
