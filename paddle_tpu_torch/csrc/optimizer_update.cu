// The training step's optimizer update, Adam / AdamW with an optional
// global-norm clip and fp16-style loss scaling, as two multi-tensor
// kernels:
//   U1 (reduce)  reads every gradient once: sum((g * inv_scale)^2) in
//                fp64 for the global norm and, with a loss scale, a
//                non-finite flag.  One partial per block of a fixed grid,
//                then a one-block second stage that sums the partials in
//                a fixed order and writes, on the device, global_norm,
//                clip_scale = clip_norm / max(global_norm, clip_norm),
//                inv_scale and found_inf.  No atomics: two calls on the
//                same inputs are bitwise equal.  No host sync.
//   U2 (update)  one pass that reads p, g, m, v and writes p, m, v in
//                place: unscale, clip, Adam's L2 term, the moments, the
//                bias corrections, lr * m_hat / (sqrt(v_hat) + eps) and
//                AdamW's decoupled decay of the old parameter.  With a
//                loss scale and found_inf set it writes nothing.
//
// Replaces the update inside the JAX step's jitted, donated program
// (paddle_tpu/jit/trainer.py:327-328, which runs
// paddle_tpu/optimizer/optimizer.py::functional_update with
// paddle_tpu/nn/clip.py::ClipGradByGlobalNorm._clip_arrays and the
// scaler branch at :278-309).  There is no Pallas kernel for it: XLA
// fuses the elementwise chain.  The eager port ran it as ~45 full-size
// passes per parameter (casts, the clip's second copy of every gradient,
// one op per Adam term).
//
// Arithmetic.  Every value is computed in fp32 registers with explicitly
// rounded operations (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction) in the JAX rule's order, and rounded
// to the dtype each JAX operation has (the gradient's at the unscale,
// the clip and the L2 term, the moments' at each Adam term, the
// parameter's at the update) before the next operation reads it.  In fp32
// the rounding is a no-op.  The values stay in registers: the rounding
// costs instructions, not bytes.  The constants arrive rounded to the
// dtype JAX applies them in (a Python constant takes the tensor's dtype;
// the bias corrections are computed in float64 on the host).  U2 is
// bitwise equal to `fused_update.update_plain` given U1's clip scale.
//
// Layout.  The host uploads one table of 64-byte records, one per
// tensor: the four addresses (g 0 when the parameter got no gradient:
// it then takes a zero gradient, adds 0 to the norm and reads no
// gradient memory), numel, the tensor's first chunk, and flags.  Chunks
// are kChunk elements of one tensor; a grid-stride loop walks all
// chunks of all tensors, so one launch of each kernel covers the model.
// A record whose four addresses are 16-byte aligned moves 8 elements
// per thread and stream as 16-byte loads (two for fp32); the ragged end
// of a tensor and unaligned tensors go element by element.
//
// Bound.  Bytes: U1 reads g (2 bytes a bf16 parameter), U2 reads p, g,
// m, v and writes p, m, v (14 bytes with bf16 moments): 16 bytes a
// parameter, 9.2 ms for the 1.92 B parameters of the dense 4-layer
// Llama-3-8B train step and 13.9 ms for the 2.90 B of the MoE step at
// 3.35 TB/s (H100 SXM).  A few dozen flops an element: far below the
// ridge point.
//
// C interface (ctypes, see ops/fused_update.py).  Each function returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                 // elements per thread and vector step
constexpr long long kChunk = 16384;       // elements per chunk (= ops/fused_update.py CHUNK)
constexpr int kReduceBlocks = 1024;       // U1's grid: fixes the partials' order
constexpr int kMaxDevices = 64;

constexpr long long kParamBf16 = 1;       // Record::flags
constexpr long long kMomentBf16 = 2;
constexpr long long kHasGrad = 4;
constexpr long long kVec = 8;

struct Record {
  long long p, g, m, v;     // addresses
  long long numel;
  long long chunk_begin;    // the tensor's first chunk
  long long flags;
  long long pad;
};
static_assert(sizeof(Record) == 64, "Record is 8 int64 on the host");

struct Consts {             // [0] fp32, [1] bf16: the dtype the term runs in
  float b1[2], omb1[2], b2[2], omb2[2], bc1[2], bc2[2], eps[2];
  float wd_l2[2];           // by the gradient's dtype
  float lr, lr_wd;          // lr_wd = 0 without decoupled decay
  int l2;
};

template <bool BF>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <bool BF>
__device__ __forceinline__ float load1(long long addr, long long i) {
  if constexpr (BF)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(addr)[i]);
  return reinterpret_cast<const float*>(addr)[i];
}

template <bool BF>
__device__ __forceinline__ void store1(long long addr, long long i, float x) {
  if constexpr (BF)
    reinterpret_cast<__nv_bfloat16*>(addr)[i] = __float2bfloat16_rn(x);
  else
    reinterpret_cast<float*>(addr)[i] = x;
}

template <bool BF>
__device__ __forceinline__ void load8(long long addr, long long i,
                                      float (&f)[kGroup]) {
  if constexpr (BF) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(addr) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  } else {
    const float4* q =
        reinterpret_cast<const float4*>(reinterpret_cast<const float*>(addr) + i);
    const float4 a = q[0], b = q[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
}

template <bool BF>
__device__ __forceinline__ void store8(long long addr, long long i,
                                       const float (&f)[kGroup]) {
  if constexpr (BF) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(addr) + i) = u;
  } else {
    float4* q = reinterpret_cast<float4*>(reinterpret_cast<float*>(addr) + i);
    q[0] = make_float4(f[0], f[1], f[2], f[3]);
    q[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// the first record whose chunks hold `ch`, scanning forward from `r`
// (a block's chunks only grow); record n is a sentinel
__device__ __forceinline__ int advance(const Record* recs, int r, long long ch) {
  while (recs[r + 1].chunk_begin <= ch) ++r;
  return r;
}

// ---------------------------------------------------------------- U1

// the gradient as the clip sees it: unscaled and rounded to its dtype
// (fp64 sums: a thread folds ~10^4 squares of a 1.9 B-parameter model,
// an fp32 sum of which drifts by ~1e-6; fp64 FMAs cost ~0.1 ms of the
// card's rate there, a tenth of the bytes' time)
template <bool GB>
__device__ __forceinline__ void fold(float x, bool use_scale, float inv,
                                     double& s, bool& bad) {
  if (use_scale) x = rnd<GB>(__fmul_rn(x, inv));
  s = fma(static_cast<double>(x), static_cast<double>(x), s);
  bad |= !isfinite(x);
}

template <bool GB>
__device__ void reduce_chunk(const Record& r, long long begin, long long end,
                             bool use_scale, float inv, double& s,
                             bool& bad) {
  long long i = begin + threadIdx.x * kGroup;
  long long vend = begin;
  if (r.flags & kVec) {
    vend = begin + (end - begin) / kGroup * kGroup;
    for (; i < vend; i += kThreads * kGroup) {
      float g[kGroup];
      load8<GB>(r.g, i, g);
#pragma unroll
      for (int e = 0; e < kGroup; ++e) fold<GB>(g[e], use_scale, inv, s, bad);
    }
  }
  for (long long j = vend + threadIdx.x; j < end; j += kThreads)
    fold<GB>(load1<GB>(r.g, j), use_scale, inv, s, bad);
}

__global__ void __launch_bounds__(kThreads)
optim_u1_partials_kernel(const Record* __restrict__ recs, long long chunks,
                         const float* __restrict__ scale,
                         double* __restrict__ partial,
                         int* __restrict__ nonfinite) {
  const bool use_scale = scale != nullptr;
  const float inv = use_scale ? __fdiv_rn(1.f, *scale) : 1.f;
  double s = 0.0;
  bool bad = false;
  int r = 0;
  for (long long ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    r = advance(recs, r, ch);
    const Record rec = recs[r];
    if (!(rec.flags & kHasGrad)) continue;
    const long long begin = (ch - rec.chunk_begin) * kChunk;
    const long long end = min(rec.numel, begin + kChunk);
    if (rec.flags & kParamBf16)
      reduce_chunk<true>(rec, begin, end, use_scale, inv, s, bad);
    else
      reduce_chunk<false>(rec, begin, end, use_scale, inv, s, bad);
  }
  // fixed-order block sum: a shuffle tree per warp, then warp 0 in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  const int any_bad = __syncthreads_or(bad);
  __shared__ double sm[kThreads / 32];
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) t += sm[w];
    partial[blockIdx.x] = t;
    nonfinite[blockIdx.x] = any_bad;
  }
}

// state: [0] global_norm, [1] clip_scale, [2] inv_scale
__global__ void __launch_bounds__(kThreads)
optim_u1_finish_kernel(const double* __restrict__ partial,
                       const int* __restrict__ nonfinite, int nparts,
                       const float* __restrict__ scale, float clip_norm,
                       int use_clip, float* __restrict__ state,
                       bool* __restrict__ found_inf) {
  double s = 0.0;
  int bad = 0;
  for (int i = threadIdx.x; i < nparts; i += kThreads) {
    s += partial[i];
    bad |= nonfinite[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  bad = __syncthreads_or(bad);
  __shared__ double sm[kThreads / 32];
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) t += sm[w];
    const float norm = __fsqrt_rn(static_cast<float>(t));
    state[0] = norm;
    // clip_norm / max(norm, clip_norm), NaN when the norm is NaN
    const float mx = isnan(norm) ? norm : fmaxf(norm, clip_norm);
    state[1] = use_clip ? __fdiv_rn(clip_norm, mx) : 1.f;
    state[2] = scale != nullptr ? __fdiv_rn(1.f, *scale) : 1.f;
    *found_inf = bad != 0;
  }
}

// ---------------------------------------------------------------- U2

// one element, in the JAX rule's order (see the header); PB: the
// parameter (and its gradient) is bf16, MB: the moments are
template <bool PB, bool MB>
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const Consts& c, bool use_scale,
                                     float inv, bool use_clip, float cs) {
  constexpr int mi = MB, gi = PB;
  if (use_scale) g = rnd<PB>(__fmul_rn(g, inv));
  if (use_clip) g = rnd<PB>(__fmul_rn(g, cs));
  if (c.l2) g = rnd<PB>(__fadd_rn(g, rnd<PB>(__fmul_rn(c.wd_l2[gi], p))));
  m = rnd<MB>(__fadd_rn(rnd<MB>(__fmul_rn(c.b1[mi], m)),
                        rnd<MB>(__fmul_rn(c.omb1[mi], g))));
  v = rnd<MB>(__fadd_rn(rnd<MB>(__fmul_rn(c.b2[mi], v)),
                        rnd<MB>(__fmul_rn(c.omb2[mi],
                                          rnd<MB>(__fmul_rn(g, g))))));
  const float mh = rnd<MB>(__fdiv_rn(m, c.bc1[mi]));
  const float vh = rnd<MB>(__fdiv_rn(v, c.bc2[mi]));
  const float den = rnd<MB>(__fadd_rn(rnd<MB>(__fsqrt_rn(vh)), c.eps[mi]));
  const float upd = __fdiv_rn(__fmul_rn(mh, c.lr), den);
  const float p0 = p;
  p = rnd<PB>(__fsub_rn(p0, rnd<PB>(upd)));
  if (c.lr_wd != 0.f) p = __fsub_rn(p, __fmul_rn(c.lr_wd, p0));
}

template <bool PB, bool MB>
__device__ void update_chunk(const Record& r, long long begin, long long end,
                             const Consts& c, bool use_scale, float inv,
                             bool use_clip, float cs) {
  const bool has_g = r.flags & kHasGrad;
  long long vend = begin;
  if (r.flags & kVec) {
    vend = begin + (end - begin) / kGroup * kGroup;
    for (long long i = begin + threadIdx.x * kGroup; i < vend;
         i += kThreads * kGroup) {
      float p[kGroup], g[kGroup], m[kGroup], v[kGroup];
      load8<PB>(r.p, i, p);
      if (has_g) {
        load8<PB>(r.g, i, g);
      } else {
#pragma unroll
        for (int e = 0; e < kGroup; ++e) g[e] = 0.f;
      }
      load8<MB>(r.m, i, m);
      load8<MB>(r.v, i, v);
#pragma unroll
      for (int e = 0; e < kGroup; ++e)
        adam<PB, MB>(p[e], g[e], m[e], v[e], c, use_scale, inv, use_clip, cs);
      store8<PB>(r.p, i, p);
      store8<MB>(r.m, i, m);
      store8<MB>(r.v, i, v);
    }
  }
  for (long long j = vend + threadIdx.x; j < end; j += kThreads) {
    float p = load1<PB>(r.p, j), m = load1<MB>(r.m, j), v = load1<MB>(r.v, j);
    const float g = has_g ? load1<PB>(r.g, j) : 0.f;
    adam<PB, MB>(p, g, m, v, c, use_scale, inv, use_clip, cs);
    store1<PB>(r.p, j, p);
    store1<MB>(r.m, j, m);
    store1<MB>(r.v, j, v);
  }
}

__global__ void __launch_bounds__(kThreads)
optim_u2_update_kernel(const Record* __restrict__ recs, long long chunks,
                       const Consts c, const float* __restrict__ state,
                       const bool* __restrict__ found_inf, int use_scale,
                       int use_clip) {
  if (use_scale && *found_inf) return;      // keep p, m, v bitwise
  const float inv = use_scale ? state[2] : 1.f;
  const float cs = use_clip ? state[1] : 1.f;
  int r = 0;
  for (long long ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    r = advance(recs, r, ch);
    const Record rec = recs[r];
    const long long begin = (ch - rec.chunk_begin) * kChunk;
    const long long end = min(rec.numel, begin + kChunk);
    const bool pb = rec.flags & kParamBf16, mb = rec.flags & kMomentBf16;
    if (pb && mb)
      update_chunk<true, true>(rec, begin, end, c, use_scale, inv, use_clip, cs);
    else if (pb)
      update_chunk<true, false>(rec, begin, end, c, use_scale, inv, use_clip, cs);
    else      // fp32 parameters keep fp32 moments (the host checks)
      update_chunk<false, false>(rec, begin, end, c, use_scale, inv, use_clip, cs);
  }
}

// blocks of `kernel` resident on one SM of the current device, cached
int resident_grid(const void* kernel, int slot) {
  static int cache[2][kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (cache[slot][dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    cache[slot][dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[slot][dev];
}

}  // namespace

// U1: partials of sum((g * inv_scale)^2) and non-finite flags over
// `chunks` chunks of the `n` records at `recs` (device), then the second
// stage into state[3] (global_norm, clip_scale, inv_scale) and
// *found_inf.  `scale` (device fp32) may be null: no loss scale.
// `partial` / `nonfinite` hold kReduceBlocks entries.
extern "C" int optim_u1_reduce(const void* recs, long long chunks,
                               const float* scale, float clip_norm,
                               int use_clip, double* partial, int* nonfinite,
                               float* state, bool* found_inf, void* stream) {
  if (chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(
      chunks < kReduceBlocks ? chunks : kReduceBlocks);
  optim_u1_partials_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const Record*>(recs), chunks, scale, partial, nonfinite);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  optim_u1_finish_kernel<<<1, kThreads, 0, st>>>(
      partial, nonfinite, grid, scale, clip_norm, use_clip, state, found_inf);
  return static_cast<int>(cudaGetLastError());
}

// U2: the update of every record in place.  `consts` (host, 18 floats):
// b1, omb1, b2, omb2, bc1, bc2, eps, wd_l2 as [fp32, bf16] pairs, then lr,
// lr_wd.  `state` / `found_inf` (device) are U1's outputs; either may be
// null when neither a clip nor a loss scale is used.
extern "C" int optim_u2_update(const void* recs, long long chunks,
                               const float* consts, int l2,
                               const float* state, const bool* found_inf,
                               int use_scale, int use_clip, void* stream) {
  if (chunks <= 0 || ((use_scale || use_clip) && state == nullptr) ||
      (use_scale && found_inf == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Consts c;
  float* dst[8] = {c.b1, c.omb1, c.b2, c.omb2, c.bc1, c.bc2, c.eps, c.wd_l2};
  for (int k = 0; k < 8; ++k) {
    dst[k][0] = consts[2 * k];
    dst[k][1] = consts[2 * k + 1];
  }
  c.lr = consts[16];
  c.lr_wd = consts[17];
  c.l2 = l2;
  const int resident = resident_grid(
      reinterpret_cast<const void*>(optim_u2_update_kernel), 0);
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>(chunks < resident ? chunks : resident);
  optim_u2_update_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Record*>(recs), chunks, c, state, found_inf,
      use_scale, use_clip);
  return static_cast<int>(cudaGetLastError());
}
