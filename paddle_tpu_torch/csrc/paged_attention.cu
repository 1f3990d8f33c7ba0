// One-token GQA decode attention over the paged KV pool (kernel K4),
// split over the sequence (flash-decoding).
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
// in fp32, rounded to q's dtype, then used in fp32.
//
// Translation from the TPU design.  The Pallas kernel runs a sequential
// (B, nt + 1) grid that walks the block table through scalar prefetch,
// stages scores and values in VMEM and finishes with one exact softmax.
// On Hopper blocks run in parallel and in no order, so the sequence is
// cut into splits of R rows (flash-decoding, split-K):
//   * paged_split_kernel, grid (n_kv, B, n_splits): one CUDA block per
//     (kv head, slot, split) serves that kv head's `rep` query heads
//     from one read of each K/V row.  n_splits = ceil(bmax * bt / R)
//     comes from the table's shape, so the host never reads `pos`; a
//     block whose split starts past pos[b] exits at once.  Blocks are
//     dispatched split by split, so the live ones (low splits) start
//     before those that exit.  The block
//     reads its rows' table entries, then copies its split's K rows as
//     one cp.async group and its V rows as a second (16-byte chunks; the
//     rows of one kv head lie n_kv * hd elements apart), so every byte
//     of the split is in flight at once, and computes q . K while V
//     lands.  An int8 pool's scales come along as 4-byte copies and
//     are applied when a row is read from shared memory.  It writes the
//     split's unnormalised softmax, (m, l, acc[rep][hd]) in fp32, to a
//     workspace the wrapper allocates.
//   * paged_merge_kernel, grid (n_heads, B): merges the live splits of
//     one (slot, query head) in split order, so results are bitwise the
//     same run to run.  It is launched as a programmatic dependent of
//     the split kernel (its blocks are resident and waiting on
//     griddepcontrol.wait when the last split block ends), which hides
//     the second launch.
// The softmax splits reorder the fp32 sums and do not round the
// probabilities to q's dtype before P.V, so the port holds this kernel
// to a stated tolerance against the plain version, not to bitwise.
//
// Bound.  Decode attention is bandwidth-bound: it must read
//   sum_b (pos_b + 1) * n_kv * hd * 2 * itemsize   bytes of K and V
// (+ 2 * 4 bytes of scales per row and kv head for int8) plus q and out;
// it does ~4 flops per K/V element, far below the H100's 295 flop/byte
// ridge.  Least time = bytes / 3.35 TB/s on an H100 SXM.  What keeps a
// kernel from that rate is bytes in flight: ~2.5 MB card-wide (3.35
// TB/s x ~0.8 us).  Splits of 128 rows give ~360 live blocks at the
// engine's shape (8 slots, 8 kv heads, depths up to 2048), each with its
// whole split (64 KB in bf16) in flight.  Compute stays on the CUDA
// cores: q . K with one thread per row, P . V with one thread per
// 8-column chunk and group of rows.
//
// Shared memory of a split block: R row ids (8 bytes each), q in fp32
// (REP x hd: rep heads, then zeros up to the power of two REP >= rep, so
// the hot loops run every head without a branch), the scores and then
// probabilities (REP x R; rows past rep unused), int8 scales (2 x R),
// then the K and V tiles (R rows each; a row of 8 16-byte chunks or a
// multiple of 8 stores chunk c at c ^ (row % 8), so the rows one quarter
// warp reads at one chunk fall in different banks; other rows carry 16
// bytes of padding).  After P.V the tiles' space holds the per-row-group
// partial sums.
//
// C interface (ctypes, see ops/paged_attention.py): dtype codes are
// 0 = float32, 1 = bfloat16, 2 = int8 (pool only).  The output dtype is
// promote(q, pool) for a float pool and q's dtype for an int8 pool.
// `work` is B * n_heads * n_splits * (hd + 2) floats.  Returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;        // split kernel
constexpr int kMergeThreads = 128;
constexpr int kRepMax = 8;           // query heads per kv head (wrapper checks)

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ int align16(int x) {
  return (x + 15) & ~15;
}

// Byte offsets into a split block's shared memory (see the header).
struct Smem {
  int rows, qs, ps, scales, tiles, stride, total;
  bool swizzle;
  __host__ __device__ Smem(int R, int rep, int REP, int hd, int elt,
                           bool quant) {
    const int row_bytes = hd * elt;
    swizzle = row_bytes % 128 == 0;
    stride = swizzle ? row_bytes : align16(row_bytes) + 16;
    rows = 0;
    qs = rows + align16(R * 8);
    ps = qs + align16(REP * hd * 4);
    scales = ps + align16(REP * R * 4);
    tiles = scales + (quant ? align16(2 * R * 4) : 0);
    const int kv = 2 * R * stride;
    const int groups = kThreads / (hd / 8);        // P.V row groups
    const int red = groups * rep * hd * 4;
    total = tiles + (kv > red ? kv : red);
  }
};

// the address of byte `byte` of row t in a K or V tile
__device__ __forceinline__ unsigned char* at(unsigned char* tile, int t,
                                             int byte, const Smem& L) {
  const int c = byte >> 4;
  return tile + t * L.stride +
         (((L.swizzle ? c ^ (t & 7) : c) << 4) | (byte & 15));
}

// elements 8c .. 8c + 7 of row t as the reference's gathered view holds
// them, in fp32; an int8 row is dequantized with its scale
template <typename QT, typename KT>
__device__ __forceinline__ void load8(unsigned char* tile, int t, int c,
                                      const Smem& L, float scale,
                                      float (&x)[8]) {
  if constexpr (std::is_same<KT, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(at(tile, t, 32 * c, L));
    const float4 b =
        *reinterpret_cast<const float4*>(at(tile, t, 32 * c + 16, L));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
    const uint4 v = *reinterpret_cast<const uint4*>(at(tile, t, 16 * c, L));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    // dequantize_kv(data, scale, q.dtype): fp32 product, then q's dtype.
    // Off the conversion units (a quarter of the FMA rate): byte b + 128
    // becomes the low mantissa byte of 2^23 (exact), and the rounding to
    // bf16 packs a pair in one instruction.
    const uint2 v = *reinterpret_cast<const uint2*>(at(tile, t, 8 * c, L));
    const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = (__uint_as_float(__byte_perm(w[i / 4], 0x4b000000u,
                                          0x7440u + (i % 4))) -
              8388736.f) * scale;             // 2^23 + 128
    if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
#pragma unroll
      for (int i = 0; i < 8; i += 2) {        // one packed rounding a pair
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
        const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
        x[i] = __uint_as_float(u << 16);
        x[i + 1] = __uint_as_float(u & 0xffff0000u);
      }
    }
  }
}

// Copies rows [0, n) of the split, `row_bytes` each, from the pool into
// `tile`, in `cb`-byte chunks (16, or 8 for an int8 row that is an odd
// number of 8-byte chunks); with `scale`, also each row's scale.
template <typename KT>
__device__ __forceinline__ void copy_rows(unsigned char* tile,
                                          const KT* pool, const float* scale,
                                          float* sscale, const long long* rid,
                                          int n, int hd, const Smem& L) {
  const int row_bytes = hd * static_cast<int>(sizeof(KT));
  const int cb = row_bytes % 16 ? 8 : 16;
  const int per_row = row_bytes / cb;
  int t = threadIdx.x / per_row, j = threadIdx.x % per_row;
  const int dt = kThreads / per_row, dj = kThreads % per_row;
  // the usual case: a thread copies the same chunk of every row it takes,
  // unrolled, without the general loop's wrap test below
  if (cb == 16 && dj == 0) {
    const unsigned char* base =
        reinterpret_cast<const unsigned char*>(pool) + j * 16;
#pragma unroll 4
    for (; t < n; t += dt)
      cp_async<16>(at(tile, t, j * 16, L), base + rid[t] * row_bytes);
    t = n;
  }
  while (t < n) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(pool + rid[t] * hd) + j * cb;
    if (cb == 16)
      cp_async<16>(at(tile, t, j * 16, L), src);
    else
      cp_async<8>(at(tile, t, j * 8, L), src);
    t += dt;
    j += dj;
    if (j >= per_row) {
      j -= per_row;
      ++t;
    }
  }
  if (scale != nullptr)
    for (int t2 = threadIdx.x; t2 < n; t2 += kThreads)
      cp_async<4>(sscale + t2, scale + rid[t2]);
}

// One split of one (kv head, slot): rows [s R, s R + R) of the slot's
// view, capped at pos[b].  REP is the smallest power of two >= rep.
template <typename QT, typename KT, int REP>
__global__ void __launch_bounds__(kThreads, REP >= 8 ? 2 : 3)
paged_split_kernel(const QT* __restrict__ q, const KT* __restrict__ pk,
                   const KT* __restrict__ pv, const float* __restrict__ ks,
                   const float* __restrict__ vs,
                   const int* __restrict__ table, const int* __restrict__ pos,
                   float* __restrict__ acc_out, float* __restrict__ ml_out,
                   int n_kv, int rep, int hd, int bt, int bmax, int R) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int T = bmax * bt;
  const int t0 = s * R;
  // the row's table entry, read before pos so the two loads overlap
  const int t = t0 + tid;
  const int blk = tid < R && t < T ? table[static_cast<size_t>(b) * bmax +
                                           t / bt]
                                   : 0;
  const int n_rows = min(pos[b] + 1, T);
  if (t0 >= n_rows) return;                   // the split is past pos[b]
  const int n = min(R, n_rows - t0);

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(R, rep, REP, hd, static_cast<int>(sizeof(KT)), kQuant);
  long long* rid = reinterpret_cast<long long*>(smem + L.rows);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* ps = reinterpret_cast<float*>(smem + L.ps);
  float* ksc = reinterpret_cast<float*>(smem + L.scales);
  float* vsc = ksc + R;
  unsigned char* kt = smem + L.tiles;
  unsigned char* vt = kt + R * L.stride;

  // pool row of each of the split's rows, as (row * n_kv + g)
  if (tid < n)
    rid[tid] = (static_cast<long long>(blk) * bt + t % bt) * n_kv + g;
  __syncthreads();
  copy_rows<KT>(kt, pk, kQuant ? ks : nullptr, ksc, rid, n, hd, L);
  cp_commit();
  copy_rows<KT>(vt, pv, kQuant ? vs : nullptr, vsc, rid, n, hd, L);
  cp_commit();
  // the merge kernel may launch now; it waits for this grid to end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int nh = n_kv * rep;
  const QT* qb = q + (static_cast<size_t>(b) * nh +
                      static_cast<size_t>(g) * rep) * hd;
  for (int i = tid; i < REP * hd; i += kThreads)
    qs[i] = i < rep * hd ? to_f(qb[i]) : 0.f;
  cp_wait<1>();                               // this thread's K rows
  __syncthreads();                            // everyone's, and q

  // scores: the P = 256 / R lanes of a row, 32 / P apart in one warp,
  // each sum a range of its chunks (each element dequantized once) for
  // every query head, then add their parts with shuffles.  The lanes of
  // a quarter warp read 8 consecutive rows at one chunk: 8 banks apart.
  const float sq = sqrtf(static_cast<float>(hd));
  const int P = kThreads / R;                 // <= 32: R >= 8
  const int span = 32 / P;
  const int warp = tid / 32, lane = tid % 32;
  const int row = warp * span + lane % span, p = lane / span;
  const int chunks = hd / 8;
  {
    float sc[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) sc[r] = 0.f;
    if (row < n) {
      const float kscale = kQuant ? ksc[row] : 1.f;
      for (int c = p * chunks / P; c < (p + 1) * chunks / P; ++c) {
        float x[8];
        load8<QT, KT>(kt, row, c, L, kscale, x);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float4 a =
              *reinterpret_cast<const float4*>(qs + r * hd + 8 * c);
          const float4 e =
              *reinterpret_cast<const float4*>(qs + r * hd + 8 * c + 4);
          float d = sc[r];
          d = fmaf(a.x, x[0], d); d = fmaf(a.y, x[1], d);
          d = fmaf(a.z, x[2], d); d = fmaf(a.w, x[3], d);
          d = fmaf(e.x, x[4], d); d = fmaf(e.y, x[5], d);
          d = fmaf(e.z, x[6], d); d = fmaf(e.w, x[7], d);
          sc[r] = d;
        }
      }
    }
    for (int off = span; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < REP; ++r)
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
    if (row < n && p == 0)
#pragma unroll
      for (int r = 0; r < REP; ++r)
        if (r < rep) ps[r * R + row] = sc[r] / sq;
  }
  __syncthreads();

  // the split's softmax, one warp per query head: m, l and exp(s - m)
  const size_t head0 =
      static_cast<size_t>(b) * nh + static_cast<size_t>(g) * rep;
  const int n_splits = gridDim.z;
  if (warp < rep) {
    float* pr = ps + warp * R;
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, pr[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(pr[i] - m);
      pr[i] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      float* ml = ml_out + ((head0 + warp) * n_splits + s) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
  cp_wait<0>();                               // this thread's V rows
  __syncthreads();

  // P.V: thread (row group rg, chunk c) sums rows rg, rg + G, ... of
  // columns 8c .. 8c + 7 for every query head
  const int G = kThreads / chunks;
  const int c = tid % chunks, rg = tid / chunks;
  float acc[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  if (rg < G) {
    for (int t2 = rg; t2 < n; t2 += G) {
      float x[8];
      load8<QT, KT>(vt, t2, c, L, kQuant ? vsc[t2] : 1.f, x);
#pragma unroll
      for (int r = 0; r < REP; ++r) {   // heads past rep: unused products
        const float pe = ps[r * R + t2];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(pe, x[i], acc[r][i]);
      }
    }
  }
  __syncthreads();                            // the tiles are read: reuse
  float* red = reinterpret_cast<float*>(kt);  // [G][rep][hd]
  if (rg < G) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r < rep) {
        float4* dst =
            reinterpret_cast<float4*>(red + (rg * rep + r) * hd + 8 * c);
        dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    float sum = 0.f;
    for (int k = 0; k < G; ++k) sum += red[(k * rep + r) * hd + d];
    acc_out[((head0 + r) * n_splits + s) * hd + d] = sum;
  }
}

// out[b, h] from the live splits of (b, h), merged in split order;
// shared memory: the splits' m, then their l
template <typename OT>
__global__ void __launch_bounds__(kMergeThreads)
paged_merge_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
                   const int* __restrict__ pos, OT* __restrict__ out,
                   int hd, int T, int R, int n_splits) {
  extern __shared__ float sml[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nh = gridDim.x;
  const size_t head = static_cast<size_t>(b) * nh + h;
  const int n_rows = min(pos[b] + 1, T);
  const int live = n_rows > 0 ? (n_rows + R - 1) / R : 0;
  // the split kernel's writes are visible once it has ended
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* m = ml + head * n_splits * 2;
  for (int s = threadIdx.x; s < live; s += kMergeThreads) {
    sml[s] = m[2 * s];
    sml[n_splits + s] = m[2 * s + 1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, sml[s]);
  float den = 0.f;
  for (int s = 0; s < live; ++s)
    den = fmaf(sml[n_splits + s], expf(sml[s] - mx), den);
  const float* a = acc + head * n_splits * hd;
  for (int d = threadIdx.x; d < hd; d += kMergeThreads) {
    float num = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s)
      num = fmaf(a[static_cast<size_t>(s) * hd + d], expf(sml[s] - mx), num);
    out[head * hd + d] = from_f<OT>(den > 0.f ? num / den : 0.f);
  }
}

template <typename QT, typename KT, typename OT, int REP>
int launch(const void* q, const void* pk, const void* pv, const void* ks,
           const void* vs, const void* table, const void* pos, void* out,
           void* work, int B, int n_kv, int rep, int hd, int bt, int bmax,
           int R, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  auto kernel = paged_split_kernel<QT, KT, REP>;
  const Smem L(R, rep, REP, hd, static_cast<int>(sizeof(KT)), kQuant);
  if (L.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) {
      cudaGetLastError();          // refused, nothing launched: clear it
      return static_cast<int>(err);
    }
  }
  const int T = bmax * bt;
  const int n_splits = (T + R - 1) / R;
  const int nh = n_kv * rep;
  float* acc = static_cast<float*>(work);
  float* ml = acc + static_cast<size_t>(B) * nh * n_splits * hd;
  kernel<<<dim3(n_kv, B, n_splits), kThreads, L.total, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(pk),
      static_cast<const KT*>(pv), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(pos), acc, ml, n_kv, rep, hd, bt, bmax, R);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nh, B);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = 2 * n_splits * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, paged_merge_kernel<OT>, static_cast<const float*>(acc),
      static_cast<const float*>(ml), static_cast<const int*>(pos),
      static_cast<OT*>(out), hd, T, R, n_splits));
}

template <typename QT, typename KT, typename OT>
int launch_rep(const void* q, const void* pk, const void* pv, const void* ks,
               const void* vs, const void* table, const void* pos, void* out,
               void* work, int B, int n_kv, int rep, int hd, int bt, int bmax,
               int R, cudaStream_t stream) {
#define PA_ARGS q, pk, pv, ks, vs, table, pos, out, work, B, n_kv, rep, hd, bt, bmax, R, stream
  if (rep <= 1) return launch<QT, KT, OT, 1>(PA_ARGS);
  if (rep <= 2) return launch<QT, KT, OT, 2>(PA_ARGS);
  if (rep <= 4) return launch<QT, KT, OT, 4>(PA_ARGS);
  return launch<QT, KT, OT, 8>(PA_ARGS);
#undef PA_ARGS
}

int decode(const void* q, const void* pk, const void* pv, const void* ks,
           const void* vs, const void* table, const void* pos, void* out,
           void* work, int B, int n_kv, int rep, int hd, int bt, int bmax,
           int R, int q_dtype, int kv_dtype, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
#define PA_ARGS q, pk, pv, ks, vs, table, pos, out, work, B, n_kv, rep, hd, bt, bmax, R, s
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_rep<float, float, float>(PA_ARGS);
    if (kv_dtype == 1) return launch_rep<float, bf16, float>(PA_ARGS);
    if (kv_dtype == 2) return launch_rep<float, int8_t, float>(PA_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_rep<bf16, float, float>(PA_ARGS);
    if (kv_dtype == 1) return launch_rep<bf16, bf16, bf16>(PA_ARGS);
    if (kv_dtype == 2) return launch_rep<bf16, int8_t, bf16>(PA_ARGS);
  }
#undef PA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream_ptr` of card `device` (made current for the
// launches, then restored: cheaper than a device guard on the host).
extern "C" int paged_attention_decode(const void* q, const void* pk,
                                      const void* pv, const void* ks,
                                      const void* vs, const void* table,
                                      const void* pos, void* out, void* work,
                                      int B, int n_kv, int rep, int hd,
                                      int bt, int bmax, int split_rows,
                                      int q_dtype, int kv_dtype, int device,
                                      void* stream_ptr) {
  const int R = split_rows;
  if (B <= 0 || n_kv <= 0 || rep <= 0 || rep > kRepMax || hd <= 0 ||
      hd > 256 || hd % 8 || bt <= 0 || bmax <= 0 || R < 8 ||
      R > kThreads || (R & (R - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int err = decode(q, pk, pv, ks, vs, table, pos, out, work, B, n_kv,
                         rep, hd, bt, bmax, R, q_dtype, kv_dtype,
                         static_cast<cudaStream_t>(stream_ptr));
  if (prev != device) cudaSetDevice(prev);
  return err;
}
