// One-token GQA decode attention over the paged KV pool (kernel K4).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_paged_attention.py
// (`paged_attention` -> `_decode_kernel`).  It computes the same
// function: for each slot b and query head h = g * rep + r,
//   out[b, h] = softmax_t( q[b, h] . K[b, t, g] / sqrt(hd) ) . V[b, t, g]
// over the rows t <= pos[b] of the slot's paged view, where row t lives
// at pool[table[b, t / bt], t % bt].  Rows past pos[b] (frontier tails,
// trash blocks, table padding) contribute exact zeros in the reference,
// so this kernel does not read them at all.  An int8 pool is
// dequantized in-kernel with `dequantize_kv`'s expression: int8 * scale
// in fp32, rounded to q's dtype.
//
// Translation from the TPU design.  The Pallas kernel runs a sequential
// (B, nt + 1) grid that walks the block table through scalar prefetch,
// stages scores and values in VMEM and finishes with one exact softmax
// (for bitwise parity with the gather path).  On Hopper, blocks run in
// parallel and in no order and have no scalar prefetch, so:
//   * grid (B, n_kv): one CUDA block per (slot, kv head), which serves
//     that head's `rep` query heads from one read of each K/V row;
//   * each block reads pos[b] and walks its own table row;
//   * the block's 8 warps take rows round-robin, 4 rows per warp in
//     flight (their table reads and K/V loads issue together); a warp's
//     32 lanes split head_dim (lane owns hd / 32 contiguous dims, one
//     vector load per row), reduce q.k with shuffles and keep an online
//     softmax in fp32 (running max, running sum, and an fp32
//     accumulator of width hd per query head) in registers;
//   * the 8 partial softmaxes merge in shared memory at the end, in a
//     fixed order (deterministic run to run).
// The online softmax reorders the fp32 sums and does not round the
// probabilities to q's dtype before P.V, so the port holds this kernel
// to a stated tolerance against the plain version, not to bitwise.
//
// Bound.  Decode attention is bandwidth-bound: it must read
//   sum_b (pos_b + 1) * n_kv * hd * 2 * itemsize   bytes of K and V
// (+ 2 * 4 bytes of scales per row and kv head for int8) plus q and out;
// it does ~4 flops per K/V element, far below the H100's 295 flop/byte
// ridge.  Least time = bytes / 3.35 TB/s on an H100 SXM.
//
// Occupancy.  At the engine's decode shape (B = 8 slots, n_kv = 8) the
// grid is 64 blocks on 132 SMs, each with 32 rows in flight, and one
// long slot's block walks all its rows alone: the kernel is latency-
// bound well above its bandwidth bound.  Splitting the sequence across
// blocks (flash-decoding split-K with a second merge pass) and
// cp.async/TMA staging are later work; this version is the simple one
// that is right first.
//
// C interface (ctypes, see ops/paged_attention.py): dtype codes are
// 0 = float32, 1 = bfloat16, 2 = int8 (pool only).  The output dtype is
// promote(q, pool) for a float pool and q's dtype for an int8 pool.
// Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRepMax = 8;   // query heads per kv head (wrapper checks)

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

// a K/V element as the reference's gathered view holds it, in fp32
template <typename QT>
__device__ __forceinline__ float kv_value(float x, float) { return x; }
template <typename QT>
__device__ __forceinline__ float kv_value(__nv_bfloat16 x, float) {
  return __bfloat162float(x);
}
template <typename QT>
__device__ __forceinline__ float kv_value(int8_t x, float scale) {
  // dequantize_kv(data, scale, q.dtype): fp32 product, then q's dtype
  return to_f(from_f<QT>(static_cast<float>(x) * scale));
}

// N contiguous elements, loaded as one vector (8 bf16 = 16 bytes)
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// lane's EPL contiguous elements [lane * EPL, lane * EPL + EPL) of a row
// (zeros for lanes past head_dim); one vector load per lane
template <typename QT, typename T, int EPL>
__device__ __forceinline__ void load_lane(const T* row, int lane, int hd,
                                          float scale, float (&out)[EPL]) {
  const int d0 = lane * EPL;
  if (d0 < hd) {
    const Vec<T, EPL> x = *reinterpret_cast<const Vec<T, EPL>*>(row + d0);
#pragma unroll
    for (int i = 0; i < EPL; ++i) out[i] = kv_value<QT>(x.v[i], scale);
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) out[i] = 0.f;
  }
}

template <typename QT, typename KT, typename OT, int EPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ pk,
                    const KT* __restrict__ pv,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, OT* __restrict__ out,
                    int n_kv, int rep, int hd, int bt, int bmax) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  // rows a warp keeps in flight per iteration: their table reads and
  // K/V loads issue together, then the online softmax folds them in
  constexpr int kRows = EPL >= 8 ? 2 : 4;
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nh = n_kv * rep;
  const int n_rows = min(pos[b] + 1, bmax * bt);
  const float sq = sqrtf(static_cast<float>(hd));

  // this kv head's rep query heads; lane owns dims [lane*EPL, +EPL)
  float qr[kRepMax][EPL];
  const QT* qb = q + (static_cast<size_t>(b) * nh +
                      static_cast<size_t>(g) * rep) * hd;
#pragma unroll
  for (int r = 0; r < kRepMax; ++r) {
    if (r < rep) {
      load_lane<QT, QT, EPL>(qb + r * hd, lane, hd, 1.f, qr[r]);
    } else {
#pragma unroll
      for (int i = 0; i < EPL; ++i) qr[r][i] = 0.f;
    }
  }

  float m[kRepMax], l[kRepMax], acc[kRepMax][EPL];
#pragma unroll
  for (int r = 0; r < kRepMax; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[r][i] = 0.f;
  }

  const int* trow = table + static_cast<size_t>(b) * bmax;
  for (int t0 = warp * kRows; t0 < n_rows; t0 += kWarps * kRows) {
    float kf[kRows][EPL], vf[kRows][EPL];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int t = t0 + j;
      const int tt = t < n_rows ? t : t0;   // past the end: reload row t0
      const size_t row = static_cast<size_t>(trow[tt / bt]) * bt + tt % bt;
      const size_t base = (row * n_kv + g) * hd;
      float sk = 1.f, sv = 1.f;
      if constexpr (kQuant) {
        sk = ks[row * n_kv + g];
        sv = vs[row * n_kv + g];
      }
      load_lane<QT, KT, EPL>(pk + base, lane, hd, sk, kf[j]);
      load_lane<QT, KT, EPL>(pv + base, lane, hd, sv, vf[j]);
    }
#pragma unroll
    for (int r = 0; r < kRepMax; ++r) {
      if (r < rep) {
        float s[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          s[j] = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; ++i) s[j] = fmaf(qr[r][i], kf[j][i], s[j]);
        }
        // xor butterflies, interleaved across rows: every lane ends with
        // the same sums
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
        }
        float m_new = m[r];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          s[j] = s[j] / sq;
          if (t0 + j < n_rows) m_new = fmaxf(m_new, s[j]);
        }
        const float c = expf(m[r] - m_new);   // 0 on a warp's first rows
        float lsum = l[r] * c;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[r][i] *= c;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (t0 + j < n_rows) {
            const float e = expf(s[j] - m_new);
            lsum += e;
#pragma unroll
            for (int i = 0; i < EPL; ++i)
              acc[r][i] = fmaf(e, vf[j][i], acc[r][i]);
          }
        }
        l[r] = lsum;
        m[r] = m_new;
      }
    }
  }

  // merge the warps' partial softmaxes: [kWarps][rep] maxima and sums,
  // then [kWarps][rep][hd] accumulators
  extern __shared__ float smem[];
  float* sm_m = smem;
  float* sm_l = sm_m + kWarps * rep;
  float* sm_acc = sm_l + kWarps * rep;
#pragma unroll
  for (int r = 0; r < kRepMax; ++r) {
    if (r < rep) {
      if (lane == 0) {
        sm_m[warp * rep + r] = m[r];
        sm_l[warp * rep + r] = l[r];
      }
      if (lane * EPL < hd) {
#pragma unroll
        for (int i = 0; i < EPL; ++i)
          sm_acc[(warp * rep + r) * hd + lane * EPL + i] = acc[r][i];
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rep * hd; idx += kThreads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * rep + r]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * rep + r] - mx);   // 0 for idle warps
      den = fmaf(sm_l[w * rep + r], c, den);
      num = fmaf(sm_acc[(w * rep + r) * hd + d], c, num);
    }
    out[(static_cast<size_t>(b) * nh + static_cast<size_t>(g) * rep + r) *
            hd + d] = from_f<OT>(den > 0.f ? num / den : 0.f);
  }
}

template <typename QT, typename KT, typename OT, int EPL>
int launch(const void* q, const void* pk, const void* pv, const void* ks,
           const void* vs, const void* table, const void* pos, void* out,
           int B, int n_kv, int rep, int hd, int bt, int bmax,
           cudaStream_t stream) {
  auto kernel = paged_decode_kernel<QT, KT, OT, EPL>;
  const size_t smem = sizeof(float) * (2 * kWarps * rep +
                                       static_cast<size_t>(kWarps) * rep * hd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(B, n_kv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(pk),
      static_cast<const KT*>(pv), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<OT*>(out), n_kv, rep, hd, bt,
      bmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, typename OT>
int launch_epl(int epl, const void* q, const void* pk, const void* pv,
               const void* ks, const void* vs, const void* table,
               const void* pos, void* out, int B, int n_kv, int rep, int hd,
               int bt, int bmax, cudaStream_t stream) {
  switch (epl) {
    case 1:
      return launch<QT, KT, OT, 1>(q, pk, pv, ks, vs, table, pos, out, B,
                                   n_kv, rep, hd, bt, bmax, stream);
    case 2:
      return launch<QT, KT, OT, 2>(q, pk, pv, ks, vs, table, pos, out, B,
                                   n_kv, rep, hd, bt, bmax, stream);
    case 4:
      return launch<QT, KT, OT, 4>(q, pk, pv, ks, vs, table, pos, out, B,
                                   n_kv, rep, hd, bt, bmax, stream);
    case 8:
      return launch<QT, KT, OT, 8>(q, pk, pv, ks, vs, table, pos, out, B,
                                   n_kv, rep, hd, bt, bmax, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_attention_decode(const void* q, const void* pk,
                                      const void* pv, const void* ks,
                                      const void* vs, const void* table,
                                      const void* pos, void* out, int B,
                                      int n_kv, int rep, int hd, int bt,
                                      int bmax, int q_dtype, int kv_dtype,
                                      void* stream_ptr) {
  if (B <= 0 || n_kv <= 0 || rep <= 0 || rep > kRepMax || hd <= 0 ||
      hd > 256 || bt <= 0 || bmax <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = (hd + 31) / 32;
  const int epl = lanes <= 1 ? 1 : lanes <= 2 ? 2 : lanes <= 4 ? 4 : 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  using bf16 = __nv_bfloat16;
#define PA_ARGS epl, q, pk, pv, ks, vs, table, pos, out, B, n_kv, rep, hd, bt, bmax, s
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_epl<float, float, float>(PA_ARGS);
    if (kv_dtype == 1) return launch_epl<float, bf16, float>(PA_ARGS);
    if (kv_dtype == 2) return launch_epl<float, int8_t, float>(PA_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_epl<bf16, float, float>(PA_ARGS);
    if (kv_dtype == 1) return launch_epl<bf16, bf16, bf16>(PA_ARGS);
    if (kv_dtype == 2) return launch_epl<bf16, int8_t, bf16>(PA_ARGS);
  }
#undef PA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
