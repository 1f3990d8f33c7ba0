// The CUDA-core ("fma") flash attention kernels K1 / K2 and the C
// interface, shared by the three libraries built from this header:
//   flash_attention.cu        the kernels without a bias or dropout
//                             (kExtra false) and the bf16 tensor-core
//                             (wgmma) kernels;
//   flash_attention_extra.cu  the same fma kernels built with the bias
//                             and dropout code (kExtra true);
//   flash_attention_mma.cu    the tensor-core (mma.sync) kernels of a
//                             call with a bias or dropout, which use
//                             only the C interface, Philox and the mask
//                             helpers here.
// Three translation units, so that nvcc builds them side by side (the
// kernels build at every run of chip_smoke.py, inside its time budget).  What the kernels compute, the
// bias and the Philox keep-bit layout: flash_attention.cu's header
// comment.
//
// Each source defines `dispatch`, the kernels a call may launch there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
  const float* bias;  // additive fp32 bias (fma variant, kExtra)
  long long bb, bh, bq, bk;
  unsigned seed_lo, seed_hi, offset;
  unsigned threshold;  // 0: no dropout
  float keep_scale;    // 1 / (1 - p); 1 without dropout
  float* lse_lo;       // kExtra, may be NULL: the low part of lse, written
                       // by the forward, read (NULL: 0) by the backward
};

// Philox4x32-10 (Random123) of counter c under key k
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// keep bits of query row `i` of head `bh` (b H + h) at the columns
// lane + 16 j (bit j, j = 0..3) of the 64-key tile `kt`
__device__ __forceinline__ unsigned keep_bits(const struct Args& a, int bh,
                                              int i, int kt, int lane) {
  const uint4 w = philox(
      make_uint4(16u * kt + lane, i, bh, a.offset),
      make_uint2(a.seed_lo, a.seed_hi));
  return (w.x >= a.threshold) | (w.y >= a.threshold) << 1 |
         (w.z >= a.threshold) << 2 | (w.w >= a.threshold) << 3;
}

// the bias of (b, h, query r, key c), 0 past the ends or without one
__device__ __forceinline__ float bias_at(const struct Args& a, int b, int h,
                                         int r, int c) {
  return (a.bias != nullptr && r < a.Sq && c < a.Sk)
             ? a.bias[b * a.bb + h * a.bh + r * a.bq + c * a.bk]
             : 0.f;
}

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

// `off` is the causal mask's offset Sk - Sq.  The tensor-core kernels
// take it as a compile-time 0 when Sq == Sk (the model's own calls).
// Bitwise, not short-circuit: written with && and ||, ptxas turned the
// per-element test of the masked tiles into branches (5-18 % slower K1
// and dQ at the train shape).
__device__ __forceinline__ bool keep(int r, int c, const Args& a, int off) {
  return (r < a.Sq) & (c < a.Sk) & (!a.causal | (r + off >= c));
}

// a query row that sees no key (causal, Sq > Sk)
__device__ __forceinline__ bool blind(int r, const Args& a, int off) {
  return a.causal && r + off < 0;
}

// the tiles of `tile` keys that query rows [q0, q0 + rows) see
__device__ __forceinline__ int kv_tiles(int q0, int rows, int tile,
                                        const Args& a, int off) {
  const int end = a.causal ? min(max(q0 + rows + off, 0), a.Sk) : a.Sk;
  return (end + tile - 1) / tile;
}

// the first tile of `tile` query rows with a row that sees key k0
__device__ __forceinline__ int first_q_tile(int k0, int tile, const Args& a,
                                            int off) {
  return a.causal ? max(k0 - off, 0) / tile : 0;
}

template <typename T, int D, bool kExtra>
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
  const int off = a.Sk - a.Sq;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + g * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + g * a.vs.h;
  load_tile<T, D>(Qs, qb, a.qs.s, q0, a.Sq, a.scale);

  // with a bias, masked scores are -inf and a row's max stays -inf until
  // it sees a key: a finite bias below -1e30 (finfo.min padding) is a
  // score like any other
  constexpr float kFill = kExtra ? -INFINITY : kNegInf;
  float m[kPer], l[kPer], acc[kPer][OC];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kFill;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = kv_tiles(q0, kTile, kTile, a, off);
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
      // keep bits of this row's 4 columns (all kept without dropout,
      // where keep_scale is 1)
      unsigned z = 0xFu;
      if constexpr (kExtra) {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          s[i][j] += bias_at(a, b, h, r, k0 + tx + 16 * j);
        if (a.threshold) z = keep_bits(a, b * a.H + h, r, kt, tx);
      }
      float tmax = kFill;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!keep(r, k0 + tx + 16 * j, a, off)) s[i][j] = kFill;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      // a row that has seen no key yet shifts by 0 (exp(-inf - -inf))
      const float m_use = (kExtra && m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p =
            keep(r, k0 + tx + 16 * j, a, off) ? expf(s[i][j] - m_use) : 0.f;
        if constexpr (kExtra) {
          Ps[(ty + 16 * i) * kLdP + tx + 16 * j] =
              (z >> j & 1u) ? p * a.keep_scale : 0.f;
        } else {
          Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        }
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
      // with a bias, a row whose every score is -inf keeps m -inf
      const bool none = kExtra ? m[i] == -INFINITY : blind(r, a, off);
      T* orow = o + ((static_cast<long long>(b) * a.Sq + r) * a.H + h) * D;
#pragma unroll
      for (int c = 0; c < OC; ++c)
        orow[tx + 16 * c] = from_f<T>(none ? NAN : acc[i][c] / lf);
      if (tx == 0) {
        const long long at = (static_cast<long long>(b) * a.H + h) * a.Sq + r;
        const float ll = logf(lf);
        const float hi = none ? -INFINITY : m[i] + ll;
        a.lse_out[at] = hi;
        if constexpr (kExtra) {
          // lse = hi + lo exactly (TwoSum): where a bias puts a row's
          // every score far below 0, hi alone has lost log l
          if (a.lse_lo != nullptr) {
            const float bv = hi - m[i];
            a.lse_lo[at] = none ? 0.f : (m[i] - (hi - bv)) + (ll - bv);
          }
        }
      }
    }
  }
}

template <typename T, int D, bool kExtra>
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
  const int off = a.Sk - a.Sq;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* db = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + g * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + g * a.vs.h;
  load_tile<T, D>(Qs, qb, a.qs.s, q0, a.Sq, a.scale);
  load_tile<T, D>(dOs, db, a.dos.s, q0, a.Sq, 1.f);

  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  float lse[kPer], lo[kPer], delta[kPer], dq[kPer][OC];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool seen = r < a.Sq && !blind(r, a, off);
    lse[i] = seen ? a.lse[row_base + r] : 0.f;
    delta[i] = seen ? a.delta[row_base + r] : 0.f;
    lo[i] = 0.f;
    if constexpr (kExtra) {
      if (seen && a.lse_lo != nullptr) lo[i] = a.lse_lo[row_base + r];
      if (lse[i] == -INFINITY) {     // every key masked: P = 0, O unread
        lse[i] = INFINITY;
        delta[i] = 0.f;
        lo[i] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < OC; ++c) dq[i][c] = 0.f;
  }

  const int n_kt = kv_tiles(q0, kTile, kTile, a, off);
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
      unsigned z = 0xFu;
      if constexpr (kExtra) {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          s[i][j] += bias_at(a, b, h, r, k0 + tx + 16 * j);
        if (a.threshold) z = keep_bits(a, b * a.H + h, r, kt, tx);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float e = kExtra ? (s[i][j] - lse[i]) - lo[i] : s[i][j] - lse[i];
        const float p = keep(r, k0 + tx + 16 * j, a, off) ? expf(e) : 0.f;
        if constexpr (kExtra) {
          const float dpz = (z >> j & 1u) ? dp[i][j] * a.keep_scale : 0.f;
          Ss[(ty + 16 * i) * kLdP + tx + 16 * j] = p * (dpz - delta[i]);
        } else {
          Ss[(ty + 16 * i) * kLdP + tx + 16 * j] = p * (dp[i][j] - delta[i]);
        }
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

template <typename T, int D, bool kExtra>
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
  const int off = a.Sk - a.Sq;

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
  const int qt0 = first_q_tile(k0, kTile, a, off);  // earlier: masked
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

      float lse[kPer], lo[kPer], delta[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qr = q0 + tx + 16 * j;
        const bool seen = qr < a.Sq && !blind(qr, a, off);
        lse[j] = seen ? a.lse[row_base + qr] : 0.f;
        delta[j] = seen ? a.delta[row_base + qr] : 0.f;
        lo[j] = 0.f;
        if constexpr (kExtra) {
          if (seen && a.lse_lo != nullptr) lo[j] = a.lse_lo[row_base + qr];
          if (lse[j] == -INFINITY) {   // every key masked: P = 0
            lse[j] = INFINITY;
            delta[j] = 0.f;
            lo[j] = 0.f;
          }
        }
      }
      // transposed tiles: row i = kv index, col j = q index
      float st[kPer][kPer], dpt[kPer][kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) st[i][j] = dpt[i][j] = 0.f;
      tile_abt<D>(Ks, Qs, ty, tx, st);
      tile_abt<D>(Vs, dOs, ty, tx, dpt);
      // keep bits: bit i of z[j] for (key k0 + ty + 16 i, query q0 + tx
      // + 16 j), one Philox call a query row
      unsigned z[kPer] = {0xFu, 0xFu, 0xFu, 0xFu};
      if constexpr (kExtra) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int qr = q0 + tx + 16 * j;
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            st[i][j] += bias_at(a, b, h, qr, k0 + ty + 16 * i);
          if (a.threshold) z[j] = keep_bits(a, b * a.H + h, qr, kt, ty);
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int kc = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int qr = q0 + tx + 16 * j;
          const float e =
              kExtra ? (st[i][j] - lse[j]) - lo[j] : st[i][j] - lse[j];
          st[i][j] = keep(qr, kc, a, off) ? expf(e) : 0.f;
          if constexpr (kExtra) {
            const bool kept = z[j] >> i & 1u;
            Ps[(ty + 16 * i) * kLdP + tx + 16 * j] =
                kept ? st[i][j] * a.keep_scale : 0.f;
            dpt[i][j] = kept ? dpt[i][j] * a.keep_scale : 0.f;
          } else {
            Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = st[i][j];
          }
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
      const long long at =
          ((static_cast<long long>(b) * a.Sk + kc) * a.Hkv + g) * D;
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        dko[at + tx + 16 * c] = from_f<T>(dk[i][c]);
        dvo[at + tx + 16 * c] = from_f<T>(dv[i][c]);
      }
    }
  }
}

// ------------------------------------------------------------ host side

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };
enum Kernel {
  kFmaF32 = 0,
  kFmaBf16 = 1,
  kWgmmaBf16 = 2,
  kMmaF32 = 3,    // flash_attention_mma.cu
  kMmaBf16 = 4,   // flash_attention_mma_bf16.cu
  kMmaF16 = 5     // flash_attention_mma_fp16.cu
};
const int kBadArg = static_cast<int>(cudaErrorInvalidValue);

template <typename T, int D, bool kExtra>
int launch(int kind, const Args& a, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const int tiles = kind == kFwd ? 3 : 4;   // fp32 (kTile, D + 1) tiles
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(tiles) * kTile * LD + kTile * kLdP);
  void (*kernel)(const Args) = kind == kFwd ? flash_fwd_kernel<T, D, kExtra>
                               : kind == kDq
                                   ? flash_dq_kernel<T, D, kExtra>
                                   : flash_dkv_kernel<T, D, kExtra>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = ((kind == kDkv ? a.Sk : a.Sq) + kTile - 1) / kTile;
  const dim3 grid(n_tiles, kind == kDkv ? a.Hkv : a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kExtra>
int launch_d(int kind, int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, kExtra>(kind, a, stream);
    case 32: return launch<T, 32, kExtra>(kind, a, stream);
    case 64: return launch<T, 64, kExtra>(kind, a, stream);
    case 128: return launch<T, 128, kExtra>(kind, a, stream);
    default: return kBadArg;
  }
}

// the kernels a library launches for a call (flash_attention.cu: fma
// without kExtra and wgmma; flash_attention_extra.cu: fma with kExtra)
int dispatch(int kind, const Args& a, int D, int kernel,
             cudaStream_t stream);

int run(int kind, Args a, const long long* strides, int D, int kernel,
        void* stream, const float* bias, const long long* bias_strides,
        unsigned seed_lo, unsigned seed_hi, unsigned offset,
        unsigned threshold, float keep_scale, float* lse_lo) {
  a.bias = bias;
  a.lse_lo = lse_lo;
  if (bias != nullptr) {
    a.bb = bias_strides[0];
    a.bh = bias_strides[1];
    a.bq = bias_strides[2];
    a.bk = bias_strides[3];
  }
  a.seed_lo = seed_lo;
  a.seed_hi = seed_hi;
  a.offset = offset;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  if (a.B <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv || a.Sq <= 0 ||
      a.Sk <= 0)
    return kBadArg;
  Strides* s[4] = {&a.qs, &a.ks, &a.vs, &a.dos};
  for (int i = 0; i < (kind == kFwd ? 3 : 4); ++i)
    *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return dispatch(kind, a, D, kernel, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   const long long* strides, int B, int H,
                                   int Hkv, int Sq, int Sk, int D, int causal,
                                   float scale, int kernel, void* stream,
                                   const float* bias,
                                   const long long* bias_strides,
                                   unsigned seed_lo, unsigned seed_hi,
                                   unsigned offset, unsigned threshold,
                                   float keep_scale, float* lse_lo) {
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
  return run(kFwd, a, strides, D, kernel, stream, bias, bias_strides,
             seed_lo, seed_hi, offset, threshold, keep_scale, lse_lo);
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq,
                                  const long long* strides, int B, int H,
                                  int Hkv, int Sq, int Sk, int D, int causal,
                                  float scale, int kernel, void* stream,
                                  const float* bias,
                                  const long long* bias_strides,
                                  unsigned seed_lo, unsigned seed_hi,
                                  unsigned offset, unsigned threshold,
                                  float keep_scale, const float* lse_lo) {
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
  return run(kDq, a, strides, D, kernel, stream, bias, bias_strides,
             seed_lo, seed_hi, offset, threshold, keep_scale,
             const_cast<float*>(lse_lo));
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv,
                                   const long long* strides, int B, int H,
                                   int Hkv, int Sq, int Sk, int D, int causal,
                                   float scale, int kernel, void* stream,
                                   const float* bias,
                                   const long long* bias_strides,
                                   unsigned seed_lo, unsigned seed_hi,
                                   unsigned offset, unsigned threshold,
                                   float keep_scale, const float* lse_lo) {
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
  return run(kDkv, a, strides, D, kernel, stream, bias, bias_strides,
             seed_lo, seed_hi, offset, threshold, keep_scale,
             const_cast<float*>(lse_lo));
}
