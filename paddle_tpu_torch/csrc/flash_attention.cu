// Causal / full GQA flash attention, forward (kernel K1) and backward
// (kernel K2: dQ and dK/dV).
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas_attention.py:
//   K1   `_flash_fwd` -> `_fwd_kernel`
//   K2a  `_flash_bwd_resident` -> `_dq_kernel_resident`,
//        `_dkv_kernel_resident`
//   K2b  `_flash_bwd` -> `_dq_kernel`, `_dkv_kernel`
// and computes what they compute, on the JAX layout (B, S, H, D):
//   forward   s = (q * scale) . k^T in fp32, masked entries NEG_INF
//             (= -1e30), online softmax over 64-row K/V tiles;
//             O = acc / max(l, 1e-30) in q's dtype,
//             lse = m + log(max(l, 1e-30)) in fp32;
//   backward  P = exp(s - lse) recomputed (masked -> 0),
//             dP = dO . V^T, dS = P * (dP - delta) with
//             delta = rowsum(O * dO) (computed by the caller, as the
//             JAX package computes it outside Pallas),
//             dQ = dS . K * scale, dK = dS^T . (q * scale), dV = P^T . dO.
// Causal masks keep key c for query r when r >= c (the Pallas kernels'
// `_causal_mask`); causal calls need Sq == Sk.
//
// Translation from the TPU design.
//   * GQA: the Pallas path repeats the kv heads (`_expand_kv`) and
//     transposes to (B*H, S, D) (`_to_bh`) before the kernel.  Here every
//     block reads q / k / v through their (B, S, H, D) strides and reads kv
//     head h / rep directly: no copy of q, k or v is made.
//   * The TPU's sequential grid carries dQ / dK / dV accumulators across
//     grid steps in VMEM scratch (`acc_ref`, `dk_acc`); on Hopper blocks
//     run in parallel and in no order, so the carried axis is a loop
//     inside the block with the accumulators in registers.
//   * dK / dV: one block per (b, kv head, 64-row kv tile) loops over the
//     `rep` query heads of its group and over the q tiles from the
//     diagonal on (the Pallas `start`), summing the group inside the block
//     (what `_flash_mha_bwd` does after the kernel with a reshape-sum).
//     No atomics: results are the same run to run.
//   * The Pallas kernels require S to be a multiple of the block; these
//     take any S and mask the ragged last tile themselves.
//   * Arithmetic: like the Pallas kernels, q, k and v are widened to fp32
//     and P stays fp32 for P.V.  This first version multiplies on the
//     CUDA cores (fp32 FMA, 64 x 64 tiles in shared memory, each of 256
//     threads owning a 4 x 4 block of the score tile and a 4 x D/16 block
//     of the output).  It does not round P to bf16, so it is held to the
//     plain PyTorch version within one rounding to the output dtype
//     (fp32 1e-5, bf16 1e-2 of each head's max); tensor cores
//     (mma.sync / wgmma) and TMA staging are later work.
//
// Bound.  At the training shape (B 2, S 2048, 32 q / 8 kv heads, D 128,
// causal) the forward does 2 * B * H * S^2 * D = 68.7 GFLOP and moves
// ~50 MB: it is bound by operations (bf16 tensor-core peak 989 TFLOP/s
// on an H100 SXM, 0.07 ms).  dQ needs three products of that size
// (S, dP, dQ: 1.5x the forward), dK / dV four (S, dP, dV, dK: 2x).  On
// the CUDA cores the ceiling is the fp32 rate (67 TFLOP/s), so this
// version sits ~15x above its bound by design.
//
// C interface (ctypes, see ops/flash_attention.py): dtype code 0 = fp32,
// 1 = bf16; `strides` holds (batch, seq, head) element strides of q, k, v
// and (backward) dO, head_dim contiguous; O / dQ / dK / dV are written
// contiguous (B, S, H, D), lse is (B, H, Sq) fp32, delta (B, H, Sq)
// fp32.  Each function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // q rows and kv rows of one tile
constexpr int kThreads = 256;         // 16 x 16: ty = row group, tx = col group
constexpr int kPer = kTile / 16;      // score rows / cols per thread
constexpr int kLdP = kTile + 1;       // padded row of a score tile
constexpr float kNegInf = -1e30f;     // the Pallas kernels' NEG_INF

struct Strides {
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out;          // O (forward), dQ (dq), dK (dkv)
  void* out2;         // dV (dkv)
  float* lse_out;     // forward
  Strides qs, ks, vs, dos;
  int B, H, Hkv, Sq, Sk, causal;
  float scale;
};

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

// rows [row0, row0 + kTile) of a (S, D) slice with row stride `rs`,
// widened to fp32 and multiplied by `mul`, into `dst` (row stride D + 1:
// an odd stride keeps the kernels' column reads free of bank conflicts);
// rows past `n_rows` are zeros.  16-byte vector loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long rs, int row0, int n_rows,
                                          float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * kVec;
    float* d = dst + r * (D + 1) + c;
    if (row0 + r < n_rows) {
      const Vec<T, kVec> x = *reinterpret_cast<const Vec<T, kVec>*>(
          base + static_cast<long long>(row0 + r) * rs + c);
#pragma unroll
      for (int i = 0; i < kVec; ++i) d[i] = to_f(x.v[i]) * mul;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) d[i] = 0.f;
    }
  }
}

// acc[i][j] += sum_d A[(ty + 16 i), d] * B[(tx + 16 j), d] over two
// (kTile, D + 1) tiles: the 4 x 4 block of a product A . B^T this
// thread owns
template <int D>
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         int ty, int tx,
                                         float (&acc)[kPer][kPer]) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_j P[(ty + 16 i), j] * M[j, (tx + 16 c)]: the rows of a
// (kTile, kLdP) score tile times a (kTile, D + 1) tile
template <int D>
__device__ __forceinline__ void tile_pm(const float* P, const float* M,
                                        int ty, int tx,
                                        float (&acc)[kPer][D / 16]) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float p[kPer], m[D / 16];
#pragma unroll
    for (int i = 0; i < kPer; ++i) p[i] = P[(ty + 16 * i) * kLdP + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) m[c] = M[j * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(p[i], m[c], acc[i][c]);
  }
}

// reduce over the 16 threads that share a ty (one half of a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool keep(int r, int c, const Args& a) {
  return r < a.Sq && c < a.Sk && (!a.causal || r >= c);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;

  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + g * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + g * a.vs.h;
  load_tile<T, D>(Qs, qb, a.qs.s, q0, a.Sq, a.scale);

  float m[kPer], l[kPer], acc[kPer][OC];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = a.causal ? qt + 1 : (a.Sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                 // the last tile's Ks / Vs / Ps are read
    load_tile<T, D>(Ks, kb, a.ks.s, k0, a.Sk, 1.f);
    load_tile<T, D>(Vs, vb, a.vs.s, k0, a.Sk, 1.f);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    tile_abt<D>(Qs, Ks, ty, tx, s);

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = q0 + ty + 16 * i;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!keep(r, k0 + tx + 16 * j, a)) s[i][j] = kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p =
            keep(r, k0 + tx + 16 * j, a) ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = alpha * l[i] + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                 // Ps complete
    tile_pm<D>(Ps, Vs, ty, tx, acc);
  }

  T* o = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < a.Sq) {
      const float lf = fmaxf(l[i], 1e-30f);
      T* orow = o + ((static_cast<long long>(b) * a.Sq + r) * a.H + h) * D;
#pragma unroll
      for (int c = 0; c < OC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / lf);
      if (tx == 0)
        a.lse_out[(static_cast<long long>(b) * a.H + h) * a.Sq + r] =
            m[i] + logf(lf);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ss = Vs + kTile * LD;

  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* db = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + g * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + g * a.vs.h;
  load_tile<T, D>(Qs, qb, a.qs.s, q0, a.Sq, a.scale);
  load_tile<T, D>(dOs, db, a.dos.s, q0, a.Sq, 1.f);

  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  float lse[kPer], delta[kPer], dq[kPer][OC];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = q0 + ty + 16 * i;
    lse[i] = r < a.Sq ? a.lse[row_base + r] : 0.f;
    delta[i] = r < a.Sq ? a.delta[row_base + r] : 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) dq[i][c] = 0.f;
  }

  const int n_kt = a.causal ? qt + 1 : (a.Sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, kb, a.ks.s, k0, a.Sk, 1.f);
    load_tile<T, D>(Vs, vb, a.vs.s, k0, a.Sk, 1.f);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<D>(Qs, Ks, ty, tx, s);
    tile_abt<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p =
            keep(r, k0 + tx + 16 * j, a) ? expf(s[i][j] - lse[i]) : 0.f;
        Ss[(ty + 16 * i) * kLdP + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();                 // dS complete
    tile_pm<D>(Ss, Ks, ty, tx, dq);
  }

  T* o = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < a.Sq) {
      T* orow = o + ((static_cast<long long>(b) * a.Sq + r) * a.H + h) * D;
#pragma unroll
      for (int c = 0; c < OC; ++c)
        orow[tx + 16 * c] = from_f<T>(dq[i][c] * a.scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;

  const int kt = blockIdx.x;           // causal: low tiles see most q rows
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.Hkv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = kt * kTile;

  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + g * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + g * a.vs.h;
  load_tile<T, D>(Ks, kb, a.ks.s, k0, a.Sk, 1.f);
  load_tile<T, D>(Vs, vb, a.vs.s, k0, a.Sk, 1.f);

  float dk[kPer][OC], dv[kPer][OC];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int qt0 = a.causal ? kt : 0;   // earlier q tiles are fully masked
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* db = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
    const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();               // the last q tile's Qs / dOs / Ps are read
      load_tile<T, D>(Qs, qb, a.qs.s, q0, a.Sq, a.scale);
      load_tile<T, D>(dOs, db, a.dos.s, q0, a.Sq, 1.f);
      __syncthreads();

      float lse[kPer], delta[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qr = q0 + tx + 16 * j;
        lse[j] = qr < a.Sq ? a.lse[row_base + qr] : 0.f;
        delta[j] = qr < a.Sq ? a.delta[row_base + qr] : 0.f;
      }
      // transposed tiles: row i = kv index, col j = q index
      float st[kPer][kPer], dpt[kPer][kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) st[i][j] = dpt[i][j] = 0.f;
      tile_abt<D>(Ks, Qs, ty, tx, st);
      tile_abt<D>(Vs, dOs, ty, tx, dpt);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int kc = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int qr = q0 + tx + 16 * j;
          st[i][j] = keep(qr, kc, a) ? expf(st[i][j] - lse[j]) : 0.f;
          Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = st[i][j];
        }
      }
      __syncthreads();               // P^T complete
      tile_pm<D>(Ps, dOs, ty, tx, dv);
      __syncthreads();               // P^T read: overwrite with dS^T
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          Ps[(ty + 16 * i) * kLdP + tx + 16 * j] =
              st[i][j] * (dpt[i][j] - delta[j]);
      __syncthreads();
      tile_pm<D>(Ps, Qs, ty, tx, dk);
    }
  }

  T* dko = static_cast<T*>(a.out);
  T* dvo = static_cast<T*>(a.out2);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kc = k0 + ty + 16 * i;
    if (kc < a.Sk) {
      const long long off =
          ((static_cast<long long>(b) * a.Sk + kc) * a.Hkv + g) * D;
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        dko[off + tx + 16 * c] = from_f<T>(dk[i][c]);
        dvo[off + tx + 16 * c] = from_f<T>(dv[i][c]);
      }
    }
  }
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(int kind, const Args& a, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const int tiles = kind == kFwd ? 3 : 4;   // fp32 (kTile, D + 1) tiles
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(tiles) * kTile * LD + kTile * kLdP);
  void (*kernel)(const Args) = kind == kFwd  ? flash_fwd_kernel<T, D>
                               : kind == kDq ? flash_dq_kernel<T, D>
                                             : flash_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = ((kind == kDkv ? a.Sk : a.Sq) + kTile - 1) / kTile;
  const dim3 grid(n_tiles, kind == kDkv ? a.Hkv : a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int kind, int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(kind, a, stream);
    case 64: return launch<T, 64>(kind, a, stream);
    case 128: return launch<T, 128>(kind, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int kind, Args a, const long long* strides, int D, int dtype,
        void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv || a.Sq <= 0 ||
      a.Sk <= 0 || (a.causal && a.Sq != a.Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides* s[4] = {&a.qs, &a.ks, &a.vs, &a.dos};
  for (int i = 0; i < (kind == kFwd ? 3 : 4); ++i)
    *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(kind, D, a, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(kind, D, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   const long long* strides, int B, int H,
                                   int Hkv, int Sq, int Sk, int D, int causal,
                                   float scale, int dtype, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = o;
  a.lse_out = lse;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  return run(kFwd, a, strides, D, dtype, stream);
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq,
                                  const long long* strides, int B, int H,
                                  int Hkv, int Sq, int Sk, int D, int causal,
                                  float scale, int dtype, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out = dq;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  return run(kDq, a, strides, D, dtype, stream);
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv,
                                   const long long* strides, int B, int H,
                                   int Hkv, int Sq, int Sk, int D, int causal,
                                   float scale, int dtype, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out = dk;
  a.out2 = dv;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  return run(kDkv, a, strides, D, dtype, stream);
}
