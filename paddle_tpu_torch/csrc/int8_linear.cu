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
// Arithmetic, bit for bit the plain version (ops/int8_linear.py), on
// every route below:
//   * x is quantized as rint(fl(fp32(x) / x_scale)) (half to even, as
//     jnp.round), clamped to +-127 (`quant`).  The quotient is taken as
//     x * (1 / x_scale), within 3 fp32 ulps of the IEEE quotient, and
//     wherever that lies within 1e-5 of a half-integer (where the two
//     could round to different integers) by IEEE division (__fdiv_rn):
//     the integer is the IEEE quotient's in every case;
//   * int8 x int8 products summed exactly in int32 on the tensor cores
//     (integer addition is associative: any order, any split over K,
//     gives the same sum);
//   * the epilogue: __int2float_rn(acc) (|acc| passes 2^24 at K 3072),
//     times the fp32 scale x_scale * w_scale[n] (one fp32 product, as
//     JAX's weak-typed x_scale * w_scale), plus bias[n], each rounded
//     on its own (__fmul_rn, __fadd_rn: no FMA contraction), then
//     rounded to x's dtype (`epi`).
//
// The weight arrives as `wt`, the layer's (N, Kp) int8 copy of wq^T, K
// contiguous and zero-padded to Kp, a multiple of 64 (the only copy the
// layer keeps).  Three routes, chosen by the wrapper from the shapes:
//
// wgmma (M > 64, the default).  Hopper's tensor cores at their int8
// rate take `wgmma` with both operands in shared memory, and 8-bit
// wgmma reads K-major operands only.  So x is quantized ONCE a call by
// an elementwise pass (`int8_linear_quant_kernel`: 16 values a thread,
// one or two 16-byte loads where K % 16 == 0 and x is aligned, else
// guarded loads of four) into xq, an (M, Kp) int8 scratch with K
// contiguous and zeros past K, which the wrapper allocates; xq and wt
// are then both K-major.  The product (`int8_linear_wgmma_kernel`)
// takes a 128 x 128 tile of y a block: one producer warp keeps a ring of
// 3 stages of (128 rows of xq, 128 rows of wt) x 128 bytes of K in
// flight by TMA (128-byte swizzle; rows past M and N and columns past
// Kp read as zero), two consumer warpgroups each run four m64n128k32
// s8 wgmmas a stage on 64 of the rows, and release the stage through
// an mbarrier once its wgmmas are done.  Two blocks share an SM (99 KB
// of shared memory each), so one block's epilogue overlaps the other's
// loads.  The product is a programmatic dependent launch of the pass:
// the pass's blocks let it start as they end, its blocks set up and put
// their first wt copies in flight, and only xq's copies wait for the
// pass (`griddepcontrol`).  The ring is fed from L2 (xq and wt fit in
// it), and L2's rate to the SMs bounds the loop: 128 x 128 tiles read xq
// N / 128 times and wt M / 128 times, 75 MB at ERNIE's FFN
// (tools/q2_sweep.py).  Clusters of 2 x 2 blocks, each multicasting its
// half of the xq and wt tiles it shares, were slower on an H100 (FFN
// 0.051 against 0.029 ms) and are not used.  The epilogue turns each
// lane's accumulator pairs into y's dtype and swaps them across the
// quad (a 4 x 4 transpose by shuffles) until each lane holds 8
// consecutive columns: one 16-byte store (two in fp32) fills whole
// 32-byte sectors of y, the largest byte term (25 MB of fp32 at ERNIE's
// FFN); guarded scalar stores where N % 8 or y's alignment forbid it.
//
// split (M <= 64, the default).  The pooler and the classifier run 1 -
// 16 rows: one 64 x 128 tile a column block leaves most SMs idle while
// each block walks all of K.  One launch splits K: a block takes an N
// tile and a K slice (grid.z), quantizes its <= 64 rows of x in
// registers as it loads them (`load_x` / `store_x`), runs `mma.sync`
// m16n8k32 s8 (at one row the product is bound by the weight's bytes,
// not the tensor cores), and adds its int32 partial sums into a
// workspace (M x N int32) with atomics.  The last block of a tile,
// counted by a per-tile semaphore, reads the totals back (plain L2
// loads) and runs the epilogue.  The wrapper zeroes the workspace and
// the semaphores for each call, on the call's stream (a memset node in
// a captured CUDA graph).  One K slice (K <= 64) runs the mma kernel.
// (Split the same way where its tiles fill less than half the card, M
// 128 - 640, the wgmma route took 34 - 65 us against 10 - 18 unsplit on
// an H100: 0.4 - 1.2 M atomic additions a call; it is not split.)
//
// mma (`variant="mma"`).  The first kernel, kept as the yardstick: a
// 64 x 128 tile a block of 8 warps (each 32 x 32: 2 m16 x 4 n8 fragments
// of m16n8k32), x quantized as it loads, the weight tile by cp.async,
// both double-buffered in shared rows padded to 80 bytes (conflict-free
// fragment loads); every column block quantizes its rows of x again.
//
// Bound.  2 M N K int8 operations at 1,979 TOP/s against the bytes: x
// (M K in its dtype), wq (K N), the scales and bias (8 N) and y (M N in
// x's dtype).  At ERNIE-3.0-base's FFN (M 2,048, K 768, N 3,072, fp32 x)
// that is 9.66 GOP (0.0049 ms) against 33.6 MB (0.0100 ms): bound by
// bytes, as is every serving shape (M <= 2,048).  The xq round trip
// (M Kp written and read again) is the wgmma route's cost over that.
//
// C interface: int8_linear(x, wt, w_scale, bias or NULL, y, xq, ws, sem,
// M, N, K, Kp, x_scale, dtype code (0 fp32, 1 bf16, 2 fp16), route (0
// mma, 1 wgmma, 2 split), splits, stream) -> cudaError_t.  xq is (M, Kp)
// int8 for route 1; with splits > 1, ws (>= M N int32) and sem (>= one
// int32 an output tile), both zeroed for this call; NULL otherwise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper.cuh"

namespace {

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

// element i of a 32-bit word of x (one fp32, or two 16-bit values)
template <typename T>
__device__ __forceinline__ float from_word(uint32_t w, int i);
template <>
__device__ __forceinline__ float from_word<float>(uint32_t w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float from_word<__nv_bfloat16>(uint32_t w, int i) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(w >> (16 * i))));
}
template <>
__device__ __forceinline__ float from_word<__half>(uint32_t w, int i) {
  return __half2float(
      __ushort_as_half(static_cast<unsigned short>(w >> (16 * i))));
}

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits16(__half v) {
  return __half_as_ushort(v);
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

// the epilogue of one sum: fl(fl(fl(acc) * s) + b) in x's dtype
template <typename T>
__device__ __forceinline__ T epi(int acc, float s, float b, bool has_bias) {
  float v = __fmul_rn(__int2float_rn(acc), s);
  if (has_bias) v = __fadd_rn(v, b);
  return from_f<T>(v);
}

// ------------------------------------------------ the mma and split kernel

constexpr int kThreads = 256;            // 8 warps: 2 (rows) x 4 (columns)
constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kLd = kBK + 16;            // bytes of a shared row
constexpr int kXPer = kBM * kBK / kThreads;   // x elements a thread loads

__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
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

// Whether this block is the last of its tile's `slices` to end (for
// every thread of the block): after the block's additions into the
// workspace, a fence and the tile's semaphore.
__device__ __forceinline__ bool last_of_tile(int* sem, unsigned slices,
                                             int* last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(sem, 1) == static_cast<int>(slices) - 1;
  __syncthreads();
  __threadfence();
  return *last;
}

// A block: the 64 x 128 tile of y at (blockIdx.y, blockIdx.x) over the
// k-tiles [kt_per blockIdx.z, + kt_per) (SPLIT) or all of them.  SPLIT:
// the partial sums go into ws; the tile's last block reads the totals
// from L2 (every slice's additions are done) and applies the epilogue
// (see the file's note).
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
int8_linear_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   int* __restrict__ ws, int* __restrict__ sem, int M, int N,
                   int K, int Kp, int kt_per, float xs) {
  __shared__ __align__(16) uint8_t As[2][kBM * kLd];
  __shared__ __align__(16) uint8_t Bs[2][kBN * kLd];
  __shared__ int last;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int n_kt = Kp / kBK;
  const int kt0 = SPLIT ? blockIdx.z * kt_per : 0;
  const int kt1 = SPLIT ? min(n_kt, kt0 + kt_per) : n_kt;
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
  stage_w(Bs[0], wt, n0, kt0 * kBK, N, Kp);
  asm volatile("cp.async.commit_group;\n" ::);
  load_x(xv, x, m0, kt0 * kBK, M, K, vec);
  store_x(As[0], xv, xs, rcp);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int kt = kt0; kt < kt1; ++kt) {
    const int cur = (kt - kt0) & 1;
    const bool next = kt + 1 < kt1;
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

  if (SPLIT) {
    // this slice's sums added into the workspace; the tile's last block
    // reads the totals
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn + 8 * j + 2 * t + e;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm + 16 * i + g + 8 * h;
            if (m < M && n < N)
              atomicAdd(ws + static_cast<long long>(m) * N + n,
                        acc[i][j][2 * h + e]);
          }
      }
    if (!last_of_tile(sem + blockIdx.x, gridDim.z, &last)) return;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn + 8 * j + 2 * t + e;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm + 16 * i + g + 8 * h;
            if (m < M && n < N)
              acc[i][j][2 * h + e] =
                  __ldcg(ws + static_cast<long long>(m) * N + n);
          }
      }
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
          y[static_cast<long long>(m) * N + n] =
              epi<T>(acc[i][j][2 * h + e], s, b, bias != nullptr);
        }
    }
  }
}

// ------------------------------------------------------- the wgmma route

constexpr int kQuantThreads = 256;

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// x (M, K) -> xq (M, Kp) int8, W values a thread (16: 16-byte loads,
// K % 16 == 0 and x aligned; 4: guarded loads), zeros past K
template <typename T, int W>
__global__ void __launch_bounds__(kQuantThreads)
int8_linear_quant_kernel(const T* __restrict__ x, uint8_t* __restrict__ xq,
                         int M, int K, int Kp, float xs) {
  constexpr int kPerWord = 4 / sizeof(T);           // x values a 32-bit word
  const float rcp = 1.f / xs;
  const int per_row = Kp / W;
  const long long total = static_cast<long long>(M) * per_row;
  for (long long i = blockIdx.x * static_cast<long long>(kQuantThreads) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kQuantThreads) {
    const long long m = i / per_row;
    const int c = static_cast<int>(i % per_row) * W;
    const T* p = x + m * K + c;
    float v[W];
    if constexpr (W == 16) {
      uint32_t w[16 / kPerWord];
      if (c < K) {
#pragma unroll
        for (int q = 0; q < 16 / kPerWord / 4; ++q) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
          w[4 * q] = u.x;
          w[4 * q + 1] = u.y;
          w[4 * q + 2] = u.z;
          w[4 * q + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 16 / kPerWord; ++q) w[q] = 0;
      }
#pragma unroll
      for (int e = 0; e < W; ++e)
        v[e] = from_word<T>(w[e / kPerWord], e % kPerWord);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) v[e] = c + e < K ? to_f(p[e]) : 0.f;
    }
    uint32_t out[W / 4];
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      out[q] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[q] |= quant(v[4 * q + e], xs, rcp) << (8 * e);
    }
    uint8_t* dst = xq + m * Kp + c;
    if constexpr (W == 16)
      *reinterpret_cast<uint4*>(dst) = make_uint4(out[0], out[1], out[2],
                                                  out[3]);
    else
      *reinterpret_cast<uint32_t*>(dst) = out[0];
  }
  griddep_launch_dependents();           // the product may take this SM
}

constexpr int kWgBM = 128, kWgBN = 128;
constexpr int kWgBK = 128;               // bytes of K a stage: a swizzle row
constexpr int kWgStages = 3;
constexpr int kWgThreads = 2 * 128 + 32; // two consumer warpgroups + producer
constexpr int kWgTile = kWgBM * kWgBK;   // xq or wt bytes of a stage: 16 KB
constexpr int kWgStage = 2 * kWgTile;
constexpr int kWgSmem = kWgStages * kWgStage + 1024 + 2 * kWgStages * 8;

__device__ __forceinline__ uint32_t pick4(const uint32_t (&p)[4], int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : i == 2 ? p[2] : p[3];
}

// Stores the warp's 16 x 128 part of a warpgroup's accumulator (rows
// row0 + g and row0 + g + 8, g = lane / 4; columns n0 + 8 j + 2 t + e,
// t = lane % 4, in wgmma's layout acc[4 j + 2 h + e] for row g + 8 h)
// through the epilogue as T into y (M, N).  With `vec` (N % 8 == 0, y
// 16-byte aligned) the four lanes of a quad swap their pairs of each
// four 8-column blocks (a 4 x 4 transpose by shuffles) until each holds
// 8 consecutive columns, one 16-byte store (two in fp32); else each
// value is stored alone.
template <typename T>
__device__ __forceinline__ void store_tile(T* y, const int (&acc)[64],
                                          int row0, int M, int n0, int N,
                                          float xs,
                                          const float* __restrict__ w_scale,
                                          const float* __restrict__ bias,
                                          bool vec) {
  constexpr int kWords = sizeof(T) == 4 ? 2 : 1;   // 32-bit words a pair
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int J = 0; J < 4; ++J) {              // column blocks 4 J .. 4 J + 3
    float s[4][2], b[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * (4 * J + u) + 2 * t4 + e;
        s[u][e] = n < N ? __fmul_rn(xs, w_scale[n]) : 0.f;
        b[u][e] = has_bias && n < N ? bias[n] : 0.f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + g + 8 * h;
      T v[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[u][e] = epi<T>(acc[4 * (4 * J + u) + 2 * h + e], s[u][e],
                           b[u][e], has_bias);
      if (vec) {
        uint32_t p[kWords][4], w[kWords][4] = {};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if constexpr (kWords == 2) {
            p[0][u] = __float_as_uint(v[u][0]);
            p[1][u] = __float_as_uint(v[u][1]);
          } else {
            p[0][u] = bits16(v[u][0]) | bits16(v[u][1]) << 16;
          }
        }
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          // lane t gets pair (t + d) % 4 of block 4 J + t from lane
          // (t + d) % 4
          const int give = (t4 - d) & 3, take = (t4 + d) & 3;
#pragma unroll
          for (int q = 0; q < kWords; ++q) {
            const uint32_t got = __shfl_sync(0xffffffffu, pick4(p[q], give),
                                             (lane & ~3) | take);
#pragma unroll
            for (int c = 0; c < 4; ++c) w[q][c] = take == c ? got : w[q][c];
          }
        }
        const int col = n0 + 8 * (4 * J + t4);
        if (row < M && col < N) {
          uint4* dst = reinterpret_cast<uint4*>(y + row * N + col);
          if constexpr (kWords == 2) {
            dst[0] = make_uint4(w[0][0], w[1][0], w[0][1], w[1][1]);
            dst[1] = make_uint4(w[0][2], w[1][2], w[0][3], w[1][3]);
          } else {
            dst[0] = make_uint4(w[0][0], w[0][1], w[0][2], w[0][3]);
          }
        }
      } else if (row < M) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * (4 * J + u) + 2 * t4 + e;
            if (n < N) y[row * N + n] = v[u][e];
          }
      }
    }
  }
}

// A block: the 128 x 128 tile of y at blockIdx.x (column tiles
// fastest), `steps` stages of 128 bytes of K.  Warps 0 - 7: two consumer
// warpgroups (rows 64 wg ..); warp 8: the producer (one lane issues the
// TMA copies).
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 2)
int8_linear_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const float* __restrict__ w_scale,
                         const float* __restrict__ bias, T* __restrict__ y,
                         int M, int N, int steps, float xs, int vec) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kWgStages * kWgStage);
  uint64_t* empty = full + kWgStages;
  const int n_col = (N + kWgBN - 1) / kWgBN;
  const int m0 = (blockIdx.x / n_col) * kWgBM;
  const int n0 = (blockIdx.x % n_col) * kWgBN;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);           // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {                       // producer
    if (threadIdx.x % 32 == 0) {
      const CUtensorMap* px = &map_x;
      const CUtensorMap* pw = &map_w;
      // the first stages' wt copies go out before the quantization pass
      // has ended (wt does not depend on it); xq's wait for it
      const int pre = steps < kWgStages ? steps : kWgStages;
      for (int s = 0; s < pre; ++s) {
        mbar_expect_tx(full + s, kWgStage);
        tma_2d(base + s * kWgStage + kWgTile, pw, full + s, s * kWgBK, n0);
      }
      griddep_wait();
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kWgStages;
        unsigned char* a = base + slot * kWgStage;
        if (s >= kWgStages) {
          mbar_wait(empty + slot, (s / kWgStages - 1) & 1);
          mbar_expect_tx(full + slot, kWgStage);
          tma_2d(a + kWgTile, pw, full + slot, s * kWgBK, n0);
        }
        tma_2d(a, px, full + slot, s * kWgBK, m0);
      }
    }
    return;
  }

  const int wg = warp / 4;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kWgStages;
    mbar_wait(full + slot, (s / kWgStages) & 1);
    wgmma_fence();
    const unsigned char* a = base + slot * kWgStage + wg * 64 * kWgBK;
    const unsigned char* b = base + slot * kWgStage + kWgTile;
#pragma unroll
    for (int k = 0; k < kWgBK / 32; ++k)   // k32 steps: 32 bytes a row
      wgmma_m64n128_s8(acc, wg_desc(a + 32 * k, 16, 1024),
                       wg_desc(b + 32 * k, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    if (s > 0 && threadIdx.x % 32 == 0)
      mbar_arrive(empty + (s - 1) % kWgStages);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  store_tile<T>(y, acc, m0 + 64 * wg + 16 * (warp % 4), M, n0, N, xs,
                w_scale, bias, vec != 0);
}

// ----------------------------------------------------------------- launch

template <typename T>
int launch_mma(const void* x, const int8_t* wt, const float* w_scale,
               const float* bias, void* y, int* ws, int* sem, int M, int N,
               int K, int Kp, int splits, float xs, cudaStream_t stream) {
  const int n_kt = Kp / kBK;
  const int per = (n_kt + splits - 1) / splits;
  const int z = (n_kt + per - 1) / per;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, z);
  if (z == 1) {
    int8_linear_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), wt, w_scale, bias, static_cast<T*>(y),
        nullptr, nullptr, M, N, K, Kp, n_kt, xs);
  } else {
    if (ws == nullptr || sem == nullptr || M > kBM) return kBadArg;
    int8_linear_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), wt, w_scale, bias, static_cast<T*>(y), ws,
        sem, M, N, K, Kp, per, xs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgmma(const void* x, const int8_t* wt, const float* w_scale,
                 const float* bias, void* y, uint8_t* xq, int M, int N,
                 int K, int Kp, float xs, cudaStream_t stream) {
  if (xq == nullptr) return kBadArg;
  const bool vec_in =
      K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long chunks =
      static_cast<long long>(M) * (Kp / (vec_in ? 16 : 4));
  const long long want = (chunks + kQuantThreads - 1) / kQuantThreads;
  const int qblocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (vec_in)
    int8_linear_quant_kernel<T, 16><<<qblocks, kQuantThreads, 0, stream>>>(
        static_cast<const T*>(x), xq, M, K, Kp, xs);
  else
    int8_linear_quant_kernel<T, 4><<<qblocks, kQuantThreads, 0, stream>>>(
        static_cast<const T*>(x), xq, M, K, Kp, xs);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  CUtensorMap map_x, map_w;
  const cuuint64_t dims_x[2] = {(cuuint64_t)Kp, (cuuint64_t)M};
  const cuuint64_t dims_w[2] = {(cuuint64_t)Kp, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {kWgBK, kWgBM};
  if (!make_map(&map_x, xq, 2, dims_x, strides, box,
                CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !make_map(&map_w, wt, 2, dims_w, strides, box,
                CU_TENSOR_MAP_DATA_TYPE_UINT8))
    return kBadArg;
  cudaFuncSetAttribute(int8_linear_wgmma_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  const int vec_out =
      N % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // a programmatic dependent launch: its blocks start as the
  // quantization pass's blocks have all begun, and only the reads of xq
  // wait for the pass to end (griddep_wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + kWgBM - 1) / kWgBM) * ((N + kWgBN - 1) / kWgBN));
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kWgSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, int8_linear_wgmma_kernel<T>, map_x, map_w, w_scale, bias,
      static_cast<T*>(y), M, N, (Kp + kWgBK - 1) / kWgBK, xs, vec_out));
}

template <typename T>
int launch(const void* x, const int8_t* wt, const float* w_scale,
           const float* bias, void* y, void* xq, int* ws, int* sem, int M,
           int N, int K, int Kp, float xs, int route, int splits,
           cudaStream_t stream) {
  switch (route) {
    case 0:
      return launch_mma<T>(x, wt, w_scale, bias, y, nullptr, nullptr, M, N,
                           K, Kp, 1, xs, stream);
    case 1:
      return launch_wgmma<T>(x, wt, w_scale, bias, y,
                             static_cast<uint8_t*>(xq), M, N, K, Kp, xs,
                             stream);
    case 2:
      return launch_mma<T>(x, wt, w_scale, bias, y, ws, sem, M, N, K, Kp,
                           splits, xs, stream);
    default:
      return kBadArg;
  }
}

}  // namespace

extern "C" int int8_linear(const void* x, const void* wt,
                           const float* w_scale, const float* bias, void* y,
                           void* xq, int* ws, int* sem, int M, int N, int K,
                           int Kp, float x_scale, int dtype, int route,
                           int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % kBK || splits < 1)
    return kBadArg;
  const int8_t* w = static_cast<const int8_t*>(wt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, w, w_scale, bias, y, xq, ws, sem, M, N, K, Kp,
                           x_scale, route, splits, s);
    case 1:
      return launch<__nv_bfloat16>(x, w, w_scale, bias, y, xq, ws, sem, M,
                                   N, K, Kp, x_scale, route, splits, s);
    case 2:
      return launch<__half>(x, w, w_scale, bias, y, xq, ws, sem, M, N, K,
                            Kp, x_scale, route, splits, s);
    default:
      return kBadArg;
  }
}
