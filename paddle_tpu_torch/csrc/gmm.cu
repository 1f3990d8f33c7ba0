// Grouped (ragged) matmul over rows sorted by expert: forward (kernel K5f)
// and weight gradient (kernel K5b).
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas_gmm.py:
//   K5f  `_gmm_fwd` -> `_fwd_kernel`: out[t] = lhs[t] @ rhs[e(t)], where
//        e(t) = tile_expert[t / bm]: every bm-row tile of the sorted,
//        per-expert padded buffer belongs to one expert.  fp32
//        accumulation, one rounding to the lhs dtype.  The input gradient
//        of the same product, dlhs[t] = g[t] @ rhs[e(t)]^T (the JAX
//        backward's `_gmm_bwd_rule`), is this kernel reading rhs
//        transposed (`transpose_rhs`): the `swapaxes(rhs)` copy does not
//        exist here;
//   K5b  `_gmm_drhs` -> `_drhs_kernel`: drhs[e] = sum over e's tiles of
//        lhs_tile^T @ dout_tile, accumulated in fp32 and rounded once to
//        the output dtype; an expert with no tile gets exactly zero.
//
// Bound.  At the MoE training shape (Qwen1.5-MoE-A2.7B widths: 16384
// routed rows in a 31744-row buffer, K 2048, N 1408, 60 experts, bm 256)
// the bytes (lhs, the 60 experts' weights, out) take 0.169 ms at
// 3.35 TB/s and the routed rows' products 0.10 ms at the bf16 tensor-core
// peak: K5 is bound by bytes, the experts' weights most of them.  K5b
// writes the 346 MB of all experts' weight gradients, 0.10 ms alone.
//
// Two variants, picked openly by the wrapper (ops/gmm.py `_variant`)
// from the dtype and bm, never by catching a failure:
//
//   wgmma  bf16, bm % 64 == 0 (the MoE path's bm 256).  Hopper's
//          warpgroup MMA (m64n128k16, fp32 accumulators in registers)
//          on tiles that TMA copies into a ring of shared-memory stages
//          (128-byte swizzle), filled by one producer warp ahead of the
//          consumer warpgroups through full / empty mbarriers.
//          K5f: a block per (64 WG rows, 128 columns) of out, WG = 4, 2
//          or 1 consumer warpgroups as bm allows (256 rows: one block
//          per SM, a ring of 4 stages; else two blocks per SM, 3
//          stages); lhs through a 2-D tensor map; the weights through a
//          3-D map whose expert index is a TMA coordinate, (W, C, E)
//          read N-major (wgmma's B transpose bit) for the forward and
//          (C, W, E) read K-major for dlhs, so neither needs a copy.
//          K5b: a block per (expert, 128 rows of K, 128 columns of N)
//          contracts over its expert's rows, A = lhs^T read M-major (A
//          transpose bit) and B = dout N-major.  Both write through a
//          quad transpose by shuffles: 16-byte stores that fill whole
//          sectors (at the train shape on an H100 they took K5b from
//          0.53 ms with 4-byte stores to 0.42 ms).
//   fma    fp32, and bf16 with a bm that is no multiple of 64 (16, 32,
//          48, ...: no path of the port builds such a buffer), on the
//          CUDA cores: operands widened to fp32, 8 x 8 outputs per
//          thread, 16-deep stages.  The tests hold fp32 to 1e-5 of each
//          row's max; TF32 keeps ~10 mantissa bits and would fail that,
//          so fp32 stays off the tensor cores.
//
// The wgmma K5f takes the column tiles of one row tile one after another
// (column tile fastest), so a row tile's lhs is read once and
// consecutive row tiles of one expert find its weights in L2.  Shared by
// both variants:
//   * `live_tiles` (optional, device int32): tiles at and past it are
//     padding past the last expert's span (their rows are zero in every
//     buffer the sort builds).  K5f writes zeros there without reading,
//     K5b does not read them.  Null means every tile is live;
//   * K5b needs no atomics and sums in a fixed order (rows in order, one
//     block per output tile): bitwise repeatable.  The wgmma K5b finds
//     the expert's tiles [first, last) by binary search in the sorted
//     tile_expert; the fma one scans tile_expert.
//
// C interface (ctypes, see ops/gmm.py): kernel 0 = fma in fp32, 1 = fma
// in bf16, 2 = wgmma in bf16; lhs is (M, C) row-major; rhs holds E experts
// `rhs_expert_stride` elements apart, each (C, W) row-major, or (W, C)
// row-major when transpose_rhs is set; out is (M, W) row-major.  bm
// divides M and is a multiple of 16 (64 for wgmma); for wgmma, C and W
// (K and N) are multiples of 8 and every pointer 16-byte aligned (TMA
// moves 16-byte chunks).  K5b: lhs (M, K), dout (M, N),
// drhs (E, K, N), all row-major.  Each function returns
// cudaGetLastError() after its launch, or an error code for arguments it
// does not take.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// =================================================== fma (CUDA cores)

constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kBN = 128;           // output columns per block (16 x 8)
constexpr int kBC = 16;            // contraction depth of one stage
constexpr int kPitchB = kBN + 4;   // float4-aligned rows of the B stage

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
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

__device__ __forceinline__ int live_count(const int* live_tiles,
                                          int n_tiles) {
  return live_tiles ? min(*live_tiles, n_tiles) : n_tiles;
}

// out[m0 : m0 + rows, n0 : min(n0 + cols, W)] = 0, by all the block's threads
template <typename T>
__device__ void zero_tile(T* out, long long m0, int rows, int n0, int cols,
                          int W) {
  const int n_end = min(n0 + cols, W);
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int n = n0 + i % cols;
    if (n < n_end) out[(m0 + i / cols) * W + n] = T(0.f);
  }
}

// K5f: block (x = BM-row tile, y = 128-column tile).  BM divides bm, so
// the block's rows share one expert.  A stage is lhs[rows, c0:c0+16]
// (stored transposed, a[c][row]) and the expert's rhs[c0:c0+16, cols].
template <typename T, int BM, bool TRANS>
__global__ void __launch_bounds__(kThreads, 2)
gmm_fwd_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ tile_expert,
               const int* __restrict__ live_tiles, T* __restrict__ out,
               int M, int C, int W, int bm, long long rhs_expert_stride) {
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
  if (m0 / bm >= live_count(live_tiles, M / bm)) {
    zero_tile(out, m0, BM, n0, kBN, W);
    return;
  }
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

// K5b: block x = (expert, K tile, N tile), expert slowest.  A stage is 16
// rows of one of the expert's tiles: lhs[rows, k0:k0+128] and
// dout[rows, n0:n0+128], both stored as read (row-major), so the
// contraction over rows needs no transpose.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
gmm_drhs_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
                const int* __restrict__ tile_expert,
                const int* __restrict__ live_tiles, T* __restrict__ drhs,
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
  const int live = live_count(live_tiles, n_tiles);
  for (int t = 0; t < live; ++t) {
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
      if (n < N)
        base[static_cast<long long>(k) * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

// ================================================== bf16 tensor cores

constexpr int kTile = 128;          // output columns (and K5b rows) per block
constexpr int kDepth = 64;          // contraction depth of one stage: 128 B

// first tile t in [0, n) with tile_expert[t] >= e (tile_expert sorted)
__device__ __forceinline__ int first_tile(const int* te, int n, int e) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(te + mid) < e)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// ---------------------------------------------------- wgmma + TMA

// Stores the warp's 16 x 128 part of a warpgroup's accumulator (rows
// row0 + g and row0 + g + 8, g = lane / 4, the rows below row_end) as
// bf16 at out[row, n0 + ...], 16 bytes per store.  In wgmma's layout a
// lane holds two columns of each 8-column block; the four lanes of a
// quad swap these pairs (a 4 x 4 transpose by shuffles) until each holds
// 8 consecutive columns, so a warp's store fills whole 32-byte sectors.
__device__ __forceinline__ void store_acc(bf16* out, long long row0,
                                          long long row_end, int n0, int W,
                                          const float (&acc)[64]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + g + 8 * h;
#pragma unroll
    for (int J = 0; J < 4; ++J) {           // column blocks 4 J .. 4 J + 3
      uint32_t p[4], w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int u = 0; u < 4; ++u) {         // this lane's pair of block 4 J + u
        const __nv_bfloat162 b = __floats2bfloat162_rn(
            acc[4 * (4 * J + u) + 2 * h], acc[4 * (4 * J + u) + 2 * h + 1]);
        p[u] = *reinterpret_cast<const uint32_t*>(&b);
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        // lane t gets pair (t + d) % 4 of block 4 J + t from lane (t + d) % 4
        const int give = (t4 - d) & 3, take = (t4 + d) & 3;
        const uint32_t send = give == 0 ? p[0] : give == 1 ? p[1]
                            : give == 2 ? p[2] : p[3];
        const uint32_t got =
            __shfl_sync(0xffffffffu, send, (lane & ~3) | take);
#pragma unroll
        for (int v = 0; v < 4; ++v) w[v] = take == v ? got : w[v];
      }
      const int col = n0 + 8 * (4 * J + t4);
      if (row < row_end && col < W)
        *reinterpret_cast<uint4*>(out + row * W + col) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

constexpr int kHalf = kDepth * 64 * 2;     // one 64 x 64 bf16 box: 8 KB

// A wgmma block of WG consumer warpgroups: two blocks of up to two
// warpgroups share an SM, each with a ring of 3 stages; a block of four
// has the SM to itself and a ring of 4.
template <int WG>
struct WgShape {
  static constexpr int kThreads = WG * 128 + 32;   // + the producer warp
  static constexpr int kBlocksPerSm = WG >= 4 ? 1 : 2;
  static constexpr int kStages = WG >= 4 ? 4 : 3;
};

// Shared memory of a wgmma block: the ring (A and B of each of its
// STAGES stages) and its full / empty barriers, the ring 1024-byte
// aligned for the swizzle.
template <int A_BYTES, int B_BYTES, int STAGES>
struct WgRing {
  static constexpr int kStages = STAGES;
  static constexpr int kStage = A_BYTES + B_BYTES;
  static constexpr int kBytes = STAGES * kStage + 1024 + 2 * STAGES * 8;
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ WgRing(unsigned char* raw) {
    base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    full = reinterpret_cast<uint64_t*>(base + STAGES * kStage);
    empty = full + STAGES;
  }
  __device__ unsigned char* a(int slot) const { return base + slot * kStage; }
  __device__ unsigned char* b(int slot) const {
    return base + slot * kStage + A_BYTES;
  }
};

// The producer side of the ring: stage s waits for its slot to be
// released by every consumer warp, then `issue(s, slot)` starts its TMA
// copies, all completing on full[slot].
template <typename Ring, typename Issue>
__device__ __forceinline__ void wg_produce(const Ring& ring, int steps,
                                           Issue issue) {
  constexpr int S = Ring::kStages;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % S;
    if (s >= S) mbar_wait(ring.empty + slot, (s / S - 1) & 1);
    mbar_expect_tx(ring.full + slot, Ring::kStage);
    issue(s, slot);
  }
}

// The consumer side: per stage, four k16 wgmmas of the warpgroup's 64
// rows; the slot of stage s - 1 is released once its wgmmas are done.
template <int TA, int TB, typename Ring, typename Desc>
__device__ __forceinline__ void wg_consume(const Ring& ring, int steps,
                                           float (&acc)[64], Desc desc) {
  constexpr int S = Ring::kStages;
  const bool lead = threadIdx.x % 32 == 0;
  fence_acc(acc);
  for (int s = 0; s < steps; ++s) {
    const int slot = s % S;
    mbar_wait(ring.full + slot, (s / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kDepth / 16; ++k) {
      uint64_t da, db;
      desc(slot, k, da, db);
      wgmma_m64n128<TA, TB>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (s > 0 && lead) mbar_arrive(ring.empty + (s - 1) % S);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

template <typename Ring>
__device__ __forceinline__ void wg_init(const Ring& ring, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < Ring::kStages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, consumer_warps);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// K5f, bf16, wgmma: a block per (64 WG rows, kTile columns), column
// tiles fastest; WG consumer warpgroups (warps 0 .. 4 WG - 1) and one
// producer warp (warp 4 WG).  A = lhs box (kDepth, 64 WG) of map_a (C,
// M); B: forward, two (64, kDepth) boxes of map_b (W, C, E) N-major;
// transposed, one (kDepth, kTile) box of map_b (C, W, E) K-major.
template <int WG, bool TRANS>
__global__ void __launch_bounds__(WgShape<WG>::kThreads,
                                  WgShape<WG>::kBlocksPerSm)
gmm_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const int* __restrict__ tile_expert,
                     const int* __restrict__ live_tiles,
                     bf16* __restrict__ out, int M, int C, int W, int bm) {
  constexpr int BM = 64 * WG;
  using Ring = WgRing<BM * kDepth * 2, kDepth * kTile * 2,
                      WgShape<WG>::kStages>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Ring ring(smem_raw);

  const int n_col = (W + kTile - 1) / kTile;
  const int m0 = (blockIdx.x / n_col) * BM;
  const int n0 = (blockIdx.x % n_col) * kTile;
  if (m0 / bm >= live_count(live_tiles, M / bm)) {
    zero_tile(out, m0, BM, n0, kTile, W);
    return;
  }
  const int expert = tile_expert[m0 / bm];
  const int steps = (C + kDepth - 1) / kDepth;
  wg_init(ring, 4 * WG);
  const int warp = threadIdx.x / 32;

  if (warp == 4 * WG) {                       // producer warp
    const CUtensorMap* pa = &map_a;
    const CUtensorMap* pb = &map_b;
    if (threadIdx.x % 32 == 0)
      wg_produce(ring, steps, [&](int s, int slot) {
        const int c0 = s * kDepth;
        tma_2d(ring.a(slot), pa, ring.full + slot, c0, m0);
        if (TRANS) {
          tma_3d(ring.b(slot), pb, ring.full + slot, c0, n0, expert);
        } else {
          tma_3d(ring.b(slot), pb, ring.full + slot, n0, c0, expert);
          tma_3d(ring.b(slot) + kHalf, pb, ring.full + slot, n0 + 64, c0,
                 expert);
        }
      });
    return;
  }

  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wg_consume<0, TRANS ? 0 : 1>(
      ring, steps, acc, [&](int slot, int k, uint64_t& da, uint64_t& db) {
        // A K-major: k16 steps are 32 bytes along the 128-byte rows
        da = wg_desc(ring.a(slot) + wg * kHalf + 32 * k, 16, 1024);
        db = TRANS ? wg_desc(ring.b(slot) + 32 * k, 16, 1024)
                   // N-major: k16 steps are 16 rows; the second 64
                   // columns are the next box
                   : wg_desc(ring.b(slot) + 2048 * k, kHalf, 1024);
      });

  store_acc(out, m0 + 64 * wg + 16 * (warp % 4), M, n0, W, acc);
}

// K5b, bf16, wgmma: a block per (expert, 128 rows of K, kTile columns
// of N), expert slowest; two consumer warpgroups (64 rows of K each) and
// one producer warp, two blocks per SM.  Stage s holds kDepth rows of
// the expert's span: two (64, kDepth) boxes of map_l (K, M), A = lhs^T
// M-major, and two (64, kDepth) boxes of map_d (N, M), B = dout N-major.
constexpr int kDrhsWG = 2;

__global__ void __launch_bounds__(WgShape<kDrhsWG>::kThreads,
                                  WgShape<kDrhsWG>::kBlocksPerSm)
gmm_drhs_wgmma_kernel(const __grid_constant__ CUtensorMap map_l,
                      const __grid_constant__ CUtensorMap map_d,
                      const int* __restrict__ tile_expert,
                      const int* __restrict__ live_tiles,
                      bf16* __restrict__ drhs, int n_tiles, int bm, int K,
                      int N) {
  constexpr int WG = kDrhsWG, BK = 64 * WG;
  using Ring = WgRing<WG * kHalf, 2 * kHalf, WgShape<WG>::kStages>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Ring ring(smem_raw);

  const int kt = (K + BK - 1) / BK, nt = (N + kTile - 1) / kTile;
  const int expert = blockIdx.x / (kt * nt);
  const int rem = blockIdx.x % (kt * nt);
  const int k0 = (rem / nt) * BK, n0 = (rem % nt) * kTile;
  const int live = live_count(live_tiles, n_tiles);
  const int r_begin = first_tile(tile_expert, live, expert) * bm;
  const int r_end = first_tile(tile_expert, live, expert + 1) * bm;
  const int steps = (r_end - r_begin) / kDepth;   // bm % kDepth == 0
  wg_init(ring, 4 * WG);
  const int warp = threadIdx.x / 32;

  if (warp == 4 * WG) {                       // producer warp
    const CUtensorMap* pl = &map_l;
    const CUtensorMap* pd = &map_d;
    if (threadIdx.x % 32 == 0)
      wg_produce(ring, steps, [&](int s, int slot) {
        const int r0 = r_begin + s * kDepth;
#pragma unroll
        for (int w = 0; w < WG; ++w)
          tma_2d(ring.a(slot) + w * kHalf, pl, ring.full + slot, k0 + 64 * w,
                 r0);
        tma_2d(ring.b(slot), pd, ring.full + slot, n0, r0);
        tma_2d(ring.b(slot) + kHalf, pd, ring.full + slot, n0 + 64, r0);
      });
    return;
  }

  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wg_consume<1, 1>(
      ring, steps, acc, [&](int slot, int k, uint64_t& da, uint64_t& db) {
        // both M- / N-major: k16 steps are 16 rows of 128 bytes
        da = wg_desc(ring.a(slot) + wg * kHalf + 2048 * k, kHalf, 1024);
        db = wg_desc(ring.b(slot) + 2048 * k, kHalf, 1024);
      });

  store_acc(drhs + static_cast<long long>(expert) * K * N,
            k0 + 64 * wg + 16 * (warp % 4), K, n0, N, acc);
}

// ---------------------------------------------------------- host side

int err_code(cudaError_t e) { return static_cast<int>(e); }
const int kBadArg = static_cast<int>(cudaErrorInvalidValue);

template <typename T, int BM>
int fwd_fma(const void* lhs, const void* rhs, const int* te, const int* live,
            void* out, int M, int C, int W, int bm, long long se, int trans,
            cudaStream_t st) {
  const dim3 grid(M / BM, (W + kBN - 1) / kBN);
  auto run = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(lhs), static_cast<const T*>(rhs), te, live,
        static_cast<T*>(out), M, C, W, bm, se);
  };
  if (trans)
    run(gmm_fwd_kernel<T, BM, true>);
  else
    run(gmm_fwd_kernel<T, BM, false>);
  return err_code(cudaGetLastError());
}

// the largest row tile that divides bm: a block never spans two experts
template <typename T>
int fwd_fma_bm(const void* lhs, const void* rhs, const int* te,
               const int* live, void* out, int M, int C, int W, int bm,
               long long se, int trans, cudaStream_t st) {
  if (bm % 128 == 0)
    return fwd_fma<T, 128>(lhs, rhs, te, live, out, M, C, W, bm, se, trans,
                           st);
  if (bm % 64 == 0)
    return fwd_fma<T, 64>(lhs, rhs, te, live, out, M, C, W, bm, se, trans,
                          st);
  if (bm % 32 == 0)
    return fwd_fma<T, 32>(lhs, rhs, te, live, out, M, C, W, bm, se, trans,
                          st);
  return fwd_fma<T, 16>(lhs, rhs, te, live, out, M, C, W, bm, se, trans, st);
}

template <int WG>
int fwd_wgmma(const void* lhs, const void* rhs, const int* te,
              const int* live, void* out, int M, int C, int W, int bm,
              long long se, int trans, int E, cudaStream_t st) {
  constexpr int BM = 64 * WG;
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t strides_a[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box_a[2] = {kDepth, BM};
  // rhs as (E, C, W) read N-major, or (E, W, C) read K-major
  const cuuint64_t dims_b[3] = {(cuuint64_t)(trans ? C : W),
                                (cuuint64_t)(trans ? W : C), (cuuint64_t)E};
  const cuuint64_t strides_b[2] = {(cuuint64_t)(trans ? C : W) * 2,
                                   (cuuint64_t)se * 2};
  const cuuint32_t box_b[3] = {64, (cuuint32_t)(trans ? kTile : kDepth), 1};
  if (!make_map(&map_a, lhs, 2, dims_a, strides_a, box_a) ||
      !make_map(&map_b, rhs, 3, dims_b, strides_b, box_b))
    return kBadArg;
  using Ring = WgRing<BM * kDepth * 2, kDepth * kTile * 2,
                      WgShape<WG>::kStages>;
  const unsigned blocks = (M / BM) * ((W + kTile - 1) / kTile);
  auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Ring::kBytes);
    kernel<<<blocks, WgShape<WG>::kThreads, Ring::kBytes, st>>>(
        map_a, map_b, te, live, static_cast<bf16*>(out), M, C, W, bm);
  };
  if (trans)
    run(gmm_fwd_wgmma_kernel<WG, true>);
  else
    run(gmm_fwd_wgmma_kernel<WG, false>);
  return err_code(cudaGetLastError());
}

int drhs_wgmma(const void* lhs, const void* dout, const int* te,
               const int* live, void* drhs, int M, int K, int N, int bm,
               int E, cudaStream_t st) {
  constexpr int WG = kDrhsWG;
  CUtensorMap map_l, map_d;
  const cuuint64_t dims_l[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides_l[1] = {(cuuint64_t)K * 2};
  const cuuint64_t dims_d[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t strides_d[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {64, kDepth};
  if (!make_map(&map_l, lhs, 2, dims_l, strides_l, box) ||
      !make_map(&map_d, dout, 2, dims_d, strides_d, box))
    return kBadArg;
  using Ring = WgRing<WG * kHalf, 2 * kHalf, WgShape<WG>::kStages>;
  const unsigned blocks = E * ((K + 64 * WG - 1) / (64 * WG)) *
                          ((N + kTile - 1) / kTile);
  cudaFuncSetAttribute(gmm_drhs_wgmma_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Ring::kBytes);
  gmm_drhs_wgmma_kernel<<<blocks, WgShape<WG>::kThreads, Ring::kBytes, st>>>(
      map_l, map_d, te, live, static_cast<bf16*>(drhs), M / bm, bm, K, N);
  return err_code(cudaGetLastError());
}

}  // namespace

extern "C" int gmm_fwd(const void* lhs, const void* rhs,
                       const void* tile_expert, const void* live_tiles,
                       void* out, int M, int C, int W, int bm, int E,
                       long long rhs_expert_stride, int transpose_rhs,
                       int kernel, void* stream) {
  if (M <= 0 || C <= 0 || W <= 0 || E <= 0 || bm <= 0 || bm % 16 || M % bm)
    return kBadArg;
  const int* te = static_cast<const int*>(tile_expert);
  const int* live = static_cast<const int*>(live_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long se = rhs_expert_stride;
  const int tr = transpose_rhs;
  if (kernel == 0)
    return fwd_fma_bm<float>(lhs, rhs, te, live, out, M, C, W, bm, se, tr,
                             st);
  if (kernel == 1)
    return fwd_fma_bm<bf16>(lhs, rhs, te, live, out, M, C, W, bm, se, tr,
                            st);
  if (kernel == 2 && bm % 64 == 0 && C % 8 == 0 && W % 8 == 0) {
    // wgmma, bf16: 256, 128 or 64 rows
    if (bm % 256 == 0)
      return fwd_wgmma<4>(lhs, rhs, te, live, out, M, C, W, bm, se, tr, E,
                          st);
    if (bm % 128 == 0)
      return fwd_wgmma<2>(lhs, rhs, te, live, out, M, C, W, bm, se, tr, E,
                          st);
    return fwd_wgmma<1>(lhs, rhs, te, live, out, M, C, W, bm, se, tr, E, st);
  }
  return kBadArg;
}

extern "C" int gmm_drhs(const void* lhs, const void* dout,
                        const void* tile_expert, const void* live_tiles,
                        void* drhs, int M, int K, int N, int bm, int E,
                        int kernel, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || bm <= 0 || bm % 16 || M % bm)
    return kBadArg;
  const long long blocks = static_cast<long long>(E) *
                           ((K + kTile - 1) / kTile) *
                           ((N + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return kBadArg;
  const int* te = static_cast<const int*>(tile_expert);
  const int* live = static_cast<const int*>(live_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (kernel == 0) {
    gmm_drhs_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(dout), te,
        live, static_cast<float*>(drhs), M / bm, bm, K, N);
    return err_code(cudaGetLastError());
  }
  if (kernel == 1) {
    gmm_drhs_kernel<bf16><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout), te,
        live, static_cast<bf16*>(drhs), M / bm, bm, K, N);
    return err_code(cudaGetLastError());
  }
  if (kernel == 2 && bm % kDepth == 0 && K % 8 == 0 && N % 8 == 0)
    return drhs_wgmma(lhs, dout, te, live, drhs, M, K, N, bm, E, st);
  return kBadArg;
}
