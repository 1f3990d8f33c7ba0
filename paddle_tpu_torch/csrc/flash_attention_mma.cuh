// Flash attention K1 / K2 with an additive bias and Philox dropout on
// the tensor cores ("mma" variant), in fp32, bf16 and fp16 at head_dim
// 16, 32, 64 and 128: the kernels.  ops/flash_attention.py sends every
// call with a bias or dropout here (`_variant`); calls with neither keep
// the kernels of flash_attention.cu.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas_attention.py
//   K1  `_flash_fwd` (:104) -> `_fwd_kernel`
//   K2  `_flash_bwd_resident` (:231) and `_flash_bwd` (:388) -> the dq
//       and dkv kernels
// with the mask and dropout semantics of paddle_tpu/ops/flash_attention.py
// (:34 `scaled_dot_product_attention_raw`), which the JAX package runs
// outside Pallas whenever a call has a mask or dropout.  What the kernels
// compute (the bias, the -inf rows, lse as hi + lo, the Philox keep-bit
// layout, dropout in O and in the backward) is flash_attention.cu's
// header comment; these kernels compute the same with the products on
// the tensor cores.
//
// Arithmetic.  Scores, the bias add, the row maximum from -inf, lse as
// hi + lo (TwoSum into lse_lo), P recomputed as exp((s - hi) - lo),
// delta and the dropout rescale are fp32 on the CUDA cores, as in
// flash_attention_fma.cuh.  The products are `mma.sync`:
//   fp32  m16n8k8 TF32, each product but dP (below) taken as three:
//         x = big + small, big = tf32(x) and small = tf32(x - big)
//         (cvt.rna), and a.b = big.small + small.big + big.big, the
//         small terms first.  What is dropped (small.small and the
//         rounding of small) is ~2^-21 of a term; one TF32 product alone
//         keeps ~10 mantissa bits and misses fp32's 1e-5 limit.  CUTLASS
//         calls this OpMultiplyAddFastF32.  Each fragment value is split
//         once and its two parts serve all three products: K1's V tile
//         once a block where it lands (a split tile, below), every other
//         operand by each warp as it loads it.  Each k8 step's three
//         products are summed from 0 and
//         added to the fp32 accumulator on the CUDA cores (`mma3`): the
//         tensor cores truncate as they accumulate, and a long chain into
//         one accumulator drifted past the limit on the card.
//   bf16  m16n8k16 with q, k, v and dO as they are and fp32
//         accumulators; P (forward, dV) and dS (dQ, dK) enter their
//         products as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi)
//         (~16 mantissa bits), as the wgmma kernels of
//         flash_attention.cu do.
//   fp16  the bf16 route with fp16 operands (m16n8k16 .f16, the same
//         fragments): P and dS as two fp16 parts too (~22 bits).  The
//         limit is one fp16 ulp of the row's max (2^-10), which the two
//         fp16 roundings of an output alone come close to; an fp32
//         emulation of the roundings (tests/test_torch_flash_attention.py,
//         `test_fp16_two_part_products_...`) holds two parts within it
//         and shows one part (11 bits) no closer; on the card, at the
//         ERNIE shape with p 0.1, two parts reach 0.875 / 0.993 / 0.890 /
//         0.976 of it in O / dQ / dK / dV (chip_smoke.py's
//         quant_kernels).  One part would leave no room, so fp16 takes
//         two.  Under O1 the model's mask arrives as fp16, where -1e9 is
//         -inf: those keys get P = exp(-inf) = 0 (the row maximum starts
//         from -inf, below), never NaN.
// Scores are scaled in fp32 after the product (a bf16 copy of q * scale
// would move every score by ~2^-9); dQ and dK take the scale at the end.
//
// Why mma.sync and not wgmma.  TF32 wgmma reads B from shared memory
// only K-major: four of the products (P V, dS K, P^T dO, dS^T Q) would
// need transposed copies of V, K, dO or Q in shared memory.  mma.sync
// fragments are loaded by hand from any layout, and at the ERNIE shape
// the bytes, not the mma.sync rate, bound the work (below).
//
// Layout.  A block is 4 warps (128 threads).  K1 and dQ: one block per
// (64 query rows, head, batch), longest causal rows first, each warp 16
// query rows; K and V stream through a ring of 64-key tiles.  dK / dV:
// one block per (64 kv rows, kv head, batch), each warp 16 kv rows; the
// Q and dO tiles of every query head of the group and every q tile from
// the diagonal on stream through the ring, and the group is summed in
// the block (no atomics: results are the same run to run).
//   * Staging: cp.async (16 bytes a lane, zero-filled past the end); in
//     bf16 into a double-buffered ring, so the next tile is in flight
//     during this tile's products; in fp32 one stage, so that three
//     blocks fit an SM and hide each other's loads.  Rows are padded
//     (fp32 D + 4, bf16 D + 8 elements), so every fragment load of a
//     warp hits 32 distinct banks.
//   * Where the fp32 split happens.  A B operand that all four warps
//     read is split four times when each warp splits it as it loads it.
//     Split once where it lands, its tile takes a second plane of shared
//     memory (the small parts).  K1 holds three blocks an SM with four
//     tiles (Q, K, V and V's small plane: 68 KB at head_dim 64), and
//     splits V there: 0.0393 against 0.0419 ms at the ERNIE shape.
//     Splitting K1's K, dQ's K and dK / dV's Q as well takes a fifth
//     tile (87 KB), two blocks an SM where three ran, and lost there: K1
//     / dQ / dK / dV 0.0535 / 0.0565 / 0.0808 against 0.0413 / 0.0529 /
//     0.0734 ms, on one H100 in one run (chip_smoke.py's ernie_kernels
//     timing, parent and change in turns).  So those operands, and dK /
//     dV's dO (whose dP^T product wants it whole), are split per load.
//   * P stays in registers: the score accumulator's C fragment is the A
//     fragment of the next product.  bf16: the k16 step over n8 tiles
//     2s and 2s + 1 takes them in order (FlashAttention-2's form) and
//     V's rows come transposed by ldmatrix.trans.  fp32 (k8 = one n8
//     tile): the order of keys inside a k8 step is free, so the A
//     fragment's columns (t, t + 4) are read as keys (2t, 2t + 1) and
//     V's (or K's, dO's, Q's) rows in the same order.  The same holds
//     for P^T and dS^T in dK / dV, whose score tile is computed
//     transposed (kv rows, query columns).
//   * Dropout bits: K1 and dQ threads own, in a 64-key tile, the key
//     columns c % 16 in {2t, 2t + 1, 8 + 2t, 9 + 2t} over all four
//     16-column groups: four Philox calls a row, every word used.  In
//     dK / dV a thread's key rows g and g + 8 of one warp's 16 share
//     their Philox calls with the other three warps, so the block draws
//     each query's 16 calls once into shared memory (a 64-bit keep word
//     a query) before the tile, and every thread reads its bits there.
//   * dP (dP^T in dK / dV) in fp32 is summed on the CUDA cores, in
//     order over head_dim by fmaf, as the plain version sums it
//     (`dp_product`): dS = P (dP - delta) cancels wherever delta is near
//     dP, and rows made of such terms (a key that holds most of a row's
//     P, a dK row that one query sees) then show the products' rounding
//     to the per-row limit.  Three TF32 products put such rows past 1e-5
//     of the plain version on the card; the same sums keep them within
//     its rounding.  The other products of dQ (S, dS K) and of dK / dV
//     (S^T, P^T dO, dS^T Q) are on the tensor cores.  bf16's dP is on
//     the tensor cores (exact products of bf16 inputs) but for a key
//     that holds more than half its row's P (at most one a row), summed
//     in order as above (`dp_kept`): in a row that attends to one key
//     the plain dS is exactly 0 (delta = dP bit for bit), and any other
//     order of the same sum leaves a dQ row of noise against zero.
//
// Bound.  At the ERNIE shape (B 16, S 128, 12 heads of 64, fp32, a (16,
// 1, 1, 128) bias; 6.29 MB a tensor) K1 reads q, k, v and writes O and
// lse: 25.3 MB, 0.0075 ms at 3.35 TB/s, against 2 products of 2 B H S^2
// D = 0.81 GFLOP, 0.0049 ms at 495 / 3 = 165 TFLOP/s (three TF32
// products for one fp32-accurate one).  dQ: 31.6 MB (0.0094 ms) against
// 3 products (0.0073 ms); dK / dV: 37.9 MB (0.0113 ms) against 4 products
// (0.0098 ms).  All three are bound by bytes.  bf16 at the trainer shape
// (2 x 2048, 32 / 8 heads of 128, causal) is bound by operations.
//
// Files: the kernels live in this header; flash_attention_mma.cu builds
// the fp32 ones, flash_attention_mma_bf16.cu the bf16 ones and
// flash_attention_mma_fp16.cu the fp16 ones, libraries nvcc builds side
// by side with the others (one library of both fp32 and bf16 took twice
// as long as any other to build).  C interface: flash_attention_fma.cuh's
// (the same functions, arguments and `_EXTRA` trailing arguments),
// kernel codes 3 (fp32), 4 (bf16) and 5 (fp16).

#pragma once

#include <type_traits>

#include "flash_attention_fma.cuh"

namespace {

constexpr int kMmaThreads = 128;        // 4 warps
constexpr int kBlk = 64;                // rows of a block, rows of a tile

template <typename T>
struct Pad;                             // row padding in elements
template <>
struct Pad<float> {
  static constexpr int v = 4;           // row stride = 4 banks mod 32
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int v = 8;           // 16 bytes
};
template <>
struct Pad<__half> {
  static constexpr int v = 8;
};

// the 16-bit operand types (bf16, fp16): one code path, `Is16`
template <typename H>
struct Is16 {
  static constexpr bool v = false;
};
template <>
struct Is16<__nv_bfloat16> {
  static constexpr bool v = true;
};
template <>
struct Is16<__half> {
  static constexpr bool v = true;
};
template <typename H>
using If16 = typename std::enable_if<Is16<H>::v, int>::type;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + kBlk) of a (S, D) slice with row stride `rs` into
// `dst` (row stride D + Pad), rows past `n_rows` zero; one commit group
// is the caller's
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* base, long long rs,
                                      int row0, int n_rows) {
  constexpr int LD = D + Pad<T>::v;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
#pragma unroll
  for (int idx = threadIdx.x; idx < kBlk * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * kVec;
    const bool in = row0 + r < n_rows;
    cp16(dst + r * LD + c,
         base + static_cast<long long>(in ? row0 + r : 0) * rs + c, in);
  }
}

// ------------------------------------------------------------- fp32 route

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += (ab + as)(bb + bs) as three TF32 products, the small terms first,
// summed from 0 and added to d on the CUDA cores.  The tensor cores add
// into their accumulator with truncation: a long chain of products into
// one accumulator shrinks it by ~2^-23 a step, always the same way,
// which the fp32 limit sees after ~100 steps in rows whose terms cancel
// (dQ, dK); the round-to-nearest add keeps that error unbiased, as the
// fp32 FMA chains of the CUDA-core kernels do.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(e, ab, bs0, bs1);
  mma_tf32(e, as, bb0, bb1);
  mma_tf32(e, ab, bb0, bb1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += e[i];
}

// A staged fp32 tile that every warp reads as the B operand of its
// products is split once, by the block, where it lands: over the kBlk
// rows of x go the big parts (TF32 bit patterns), and the small parts
// fill a second plane of kBlk rows right after it ("a split tile").
// Each thread splits the 16-byte chunks its own `stage` issued, once
// cp.async.wait_group has made them visible to it; the barrier that
// follows publishes both planes to the block.
template <int D>
__device__ __forceinline__ void split_stage(float* tile) {
  constexpr int LD = D + Pad<float>::v;
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < kBlk * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 4;
    uint4* xb = reinterpret_cast<uint4*>(tile + r * LD + c);
    uint4* xs = reinterpret_cast<uint4*>(tile + (kBlk + r) * LD + c);
    const float4 x = *reinterpret_cast<const float4*>(xb);
    uint4 big, small;
    split(x.x, big.x, small.x);
    split(x.y, big.y, small.y);
    split(x.z, big.z, small.z);
    split(x.w, big.w, small.w);
    *xb = big;
    *xs = small;
  }
}

// the big and small parts of element (r, c) of a split tile
template <int D>
__device__ __forceinline__ void parts(const float* B, int r, int c,
                                      uint32_t& big, uint32_t& small) {
  constexpr int LD = D + Pad<float>::v;
  big = __float_as_uint(B[r * LD + c]);
  small = __float_as_uint(B[(kBlk + r) * LD + c]);
}

// acc[n] += A . B^T for a warp's 16 rows of A and the N rows of B, both
// (rows, D) row-major in shared memory (row stride D + 4) and split as
// they are loaded; acc[n] is the m16n8 C fragment of B rows 8n .. 8n + 7
template <int D, int N>
__device__ __forceinline__ void abt(float (&acc)[N / 8][4], const float* A,
                                    const float* B) {
  constexpr int LD = D + Pad<float>::v;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  // a rolled loop (it indexes shared memory only): unrolled, the fp32
  // kernels took about twice as long to build
#pragma unroll 1
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ab[4], as[4];
    split(A[g * LD + kk + t], ab[0], as[0]);
    split(A[(g + 8) * LD + kk + t], ab[1], as[1]);
    split(A[g * LD + kk + t + 4], ab[2], as[2]);
    split(A[(g + 8) * LD + kk + t + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      uint32_t bb0, bs0, bb1, bs1;
      split(B[(8 * n + g) * LD + kk + t], bb0, bs0);
      split(B[(8 * n + g) * LD + kk + t + 4], bb1, bs1);
      mma3(acc[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// acc[m] += P . M: P (16 rows x NK columns) in the C fragments of a
// previous product (p[n] holds columns 8n + 2t, 8n + 2t + 1), M (NK, D)
// row-major in shared memory, rows of a split tile (kSplit) or of an
// fp32 tile each warp splits as it loads; acc[m] the C fragment of
// columns 8m .. 8m + 7.  A k8 step takes P's columns 8n + 2t and 8n +
// 2t + 1 as its columns t and t + 4, and M's rows in the same order.
template <int D, int NK, bool kSplit = false>
__device__ __forceinline__ void pm(float (&acc)[D / 8][4],
                                   const float (&p)[NK / 8][4],
                                   const float* M) {
  constexpr int LD = D + Pad<float>::v;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
    uint32_t ab[4], as[4];
    split(p[n][0], ab[0], as[0]);      // (g, 8n + 2t)
    split(p[n][2], ab[1], as[1]);      // (g + 8, 8n + 2t)
    split(p[n][1], ab[2], as[2]);      // (g, 8n + 2t + 1)
    split(p[n][3], ab[3], as[3]);      // (g + 8, 8n + 2t + 1)
    const int r = 8 * n + 2 * t;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
      uint32_t bb0, bs0, bb1, bs1;
      if constexpr (kSplit) {
        parts<D>(M, r, 8 * m + g, bb0, bs0);
        parts<D>(M, r + 1, 8 * m + g, bb1, bs1);
      } else {
        split(M[r * LD + 8 * m + g], bb0, bs0);
        split(M[(r + 1) * LD + 8 * m + g], bb1, bs1);
      }
      mma3(acc[m], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// ------------------------------------------------- bf16 and fp16 route

template <typename H>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16<__nv_bfloat16>(float (&d)[4],
                                                     const uint32_t (&a)[4],
                                                     uint32_t b0,
                                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<__half>(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename H, If16<H> = 0>
__device__ __forceinline__ uint32_t ld32(const H* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// hi = H(x0, x1), lo = H(x - hi), x0 in the low half
template <typename H>
__device__ __forceinline__ void two_parts(float x0, float x1, uint32_t& hi,
                                          uint32_t& lo);
template <>
__device__ __forceinline__ void two_parts<__nv_bfloat16>(float x0, float x1,
                                                         uint32_t& hi,
                                                         uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
template <>
__device__ __forceinline__ void two_parts<__half>(float x0, float x1,
                                                  uint32_t& hi,
                                                  uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D, int N, typename H, If16<H> = 0>
__device__ __forceinline__ void abt(float (&acc)[N / 8][4], const H* A,
                                    const H* B) {
  constexpr int LD = D + Pad<H>::v;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    a[0] = ld32(A + g * LD + kk + 2 * t);
    a[1] = ld32(A + (g + 8) * LD + kk + 2 * t);
    a[2] = ld32(A + g * LD + kk + 8 + 2 * t);
    a[3] = ld32(A + (g + 8) * LD + kk + 8 + 2 * t);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const H* b = B + (8 * n + g) * LD + kk + 2 * t;
      mma16<H>(acc[n], a, ld32(b), ld32(b + 8));
    }
  }
}

// acc[m] += P . M with P as two 16-bit parts (see the fp32 `pm`; kSplit
// has no meaning here); a k16 step takes P's n8 tiles 2s and 2s + 1 in
// order and M's rows 16s .. 16s + 15 transposed by ldmatrix
template <int D, int NK, bool kSplit = false, typename H, If16<H> = 0>
__device__ __forceinline__ void pm(float (&acc)[D / 8][4],
                                   const float (&p)[NK / 8][4],
                                   const H* M) {
  constexpr int LD = D + Pad<H>::v;
  const int lane = threadIdx.x & 31;
  // ldmatrix x4: lanes 8i .. 8i + 7 address matrix i's rows: matrices 0
  // / 1 are rows +0 / +8 of columns 8m, matrices 2 / 3 of columns 8m + 8
  const H* m_lane =
      M + ((lane & 8) + (lane & 7)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int s = 0; s < NK / 16; ++s) {
    uint32_t hi[4], lo[4];
    two_parts<H>(p[2 * s][0], p[2 * s][1], hi[0], lo[0]);
    two_parts<H>(p[2 * s][2], p[2 * s][3], hi[1], lo[1]);
    two_parts<H>(p[2 * s + 1][0], p[2 * s + 1][1], hi[2], lo[2]);
    two_parts<H>(p[2 * s + 1][2], p[2 * s + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int m = 0; m < D / 8; m += 2) {
      uint32_t b0, b1, b2, b3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
          "[%4];\n"
          : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
          : "r"(smem_addr(m_lane + 16 * s * LD + 8 * m)));
      mma16<H>(acc[m], lo, b0, b1);
      mma16<H>(acc[m], hi, b0, b1);
      mma16<H>(acc[m + 1], lo, b2, b3);
      mma16<H>(acc[m + 1], hi, b2, b3);
    }
  }
}

// dP = dO . V^T (V . dO^T in dK / dV), laid out as abt's acc: fp32 on
// the CUDA cores, each element summed in order over head_dim by fmaf as
// the plain version sums it (see the header comment); bf16 and fp16 on
// the tensor cores
template <int D, int N>
__device__ __forceinline__ void dp_product(float (&acc)[N / 8][4],
                                           const float* A, const float* B) {
  constexpr int LD = D + Pad<float>::v;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* a0 = A + g * LD;
  const float* a1 = A + (g + 8) * LD;
  const float* b0 = B + 2 * t * LD;
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 y =
            *reinterpret_cast<const float4*>(b0 + (8 * n + e) * LD + d);
        float& u = acc[n][e];               // row g, column 8n + 2t + e
        float& w = acc[n][2 + e];           // row g + 8
        u = fmaf(x0.x, y.x, u);
        u = fmaf(x0.y, y.y, u);
        u = fmaf(x0.z, y.z, u);
        u = fmaf(x0.w, y.w, u);
        w = fmaf(x1.x, y.x, w);
        w = fmaf(x1.y, y.y, w);
        w = fmaf(x1.z, y.z, w);
        w = fmaf(x1.w, y.w, w);
      }
  }
}
template <int D, int N, typename H, If16<H> = 0>
__device__ __forceinline__ void dp_product(float (&acc)[N / 8][4],
                                           const H* A, const H* B) {
  abt<D, N>(acc, A, B);
}

// dP of one element in bf16 / fp16 as the plain version sums it: the dP
// of a key that holds more than half its query row's P (see the header
// comment)
template <int D, typename H>
__device__ __forceinline__ float dp_in_order(const H* x, const H* y) {
  float acc = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; ++d) acc = fmaf(to_f(x[d]), to_f(y[d]), acc);
  return acc;
}

// dP z / (1 - p) of an element: in bf16 / fp16 a key with P > 1/2 takes
// its dP in order from the rows x (dO) and y (V) in shared memory
template <typename T, int D>
__device__ __forceinline__ float dp_kept(float dp, float p, bool kept,
                                         const T* x, const T* y,
                                         float keep_scale) {
  if (!kept) return 0.f;
  if constexpr (sizeof(T) == 2) {
    if (p > 0.5f) dp = dp_in_order<D>(x, y);
  }
  return dp * keep_scale;
}

// --------------------------------------------------------------- helpers

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// keep bits of query row r over this thread's 16 key columns 8n + 2t + e
// of 64-key tile kt, as bit 2n + e (all kept without dropout): four
// Philox calls, columns c % 16 = 2t + e + 8h, word j -> n = 2j + h
__device__ __forceinline__ unsigned row_keep(const Args& a, int bh, int r,
                                             int kt, int t) {
  if (!a.threshold) return 0xFFFFu;
  unsigned z = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const unsigned w = keep_bits(a, bh, r, kt, 2 * t + e + 8 * h);
#pragma unroll
      for (int j = 0; j < 4; ++j) z |= (w >> j & 1u) << (2 * (2 * j + h) + e);
    }
  return z;
}

// the lse, lse_lo and delta a backward kernel reads for query row r
// (a row that sees no key, or whose every score is -inf: lse +inf,
// so P = 0, and delta 0)
__device__ __forceinline__ void row_stats(const Args& a, long long row_base,
                                          int r, int off, float& lse,
                                          float& lo, float& delta) {
  const bool seen = r < a.Sq && !blind(r, a, off);
  lse = seen ? a.lse[row_base + r] : 0.f;
  delta = seen ? a.delta[row_base + r] : 0.f;
  lo = (seen && a.lse_lo != nullptr) ? a.lse_lo[row_base + r] : 0.f;
  if (lse == -INFINITY) {
    lse = INFINITY;
    delta = 0.f;
    lo = 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
template <>
__device__ __forceinline__ void store2<__half>(__half* p, float x0,
                                               float x1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x0, x1);
}

// ring stages: two in bf16 / fp16; one in fp32, where the tiles are twice the
// bytes and the registers of the three-product chains are many: three
// blocks of an SM (at head_dim <= 64) hide each other's loads better
// than a second stage of one block does (measured at the ERNIE shape)
template <typename T>
__host__ __device__ constexpr int ring() {
  return sizeof(T) == 4 ? 1 : 2;
}

// tiles of a K1 V stage: two in fp32 (a split tile), one in bf16 / fp16
template <typename T>
__host__ __device__ constexpr int planes() {
  return sizeof(T) == 4 ? 2 : 1;
}

// split the fp32 tile that just landed (see `split_stage`); bf16 / fp16
// tiles are used as they come
template <typename T, int D>
__device__ __forceinline__ void split_if_fp32(T* tile) {
  if constexpr (sizeof(T) == 4) split_stage<D>(tile);
}

// blocks an SM the registers are capped for: three in fp32 up to head_dim
// 64 (170 registers a thread), else no cap
template <typename T, int D>
struct MinBlocks {
  static constexpr int v = sizeof(T) == 4 && D <= 64 ? 3 : 1;
};

// ------------------------------------------------------------------- K1

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, MinBlocks<T, D>::v)
flash_fwd_mma_kernel(const Args a) {
  constexpr int LD = D + Pad<T>::v;
  constexpr int ST = ring<T>();
  constexpr int VS = planes<T>() * kBlk * LD;   // a V stage
  constexpr int OC = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBlk * LD;
  T* Vs = Ks + ST * kBlk * LD;

  const int n_qt = (a.Sq + kBlk - 1) / kBlk;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5;
  const int gq = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int q0 = qt * kBlk;
  const int off = a.Sk - a.Sq;
  const int bh = b * a.H + h;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + g * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + g * a.vs.h;
  const int n_kt = kv_tiles(q0, kBlk, kBlk, a, off);

  // commit group i holds kv tile i (group 0 also Q); empty past the end
  stage<T, D>(Qs, qb, a.qs.s, q0, a.Sq);
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    if (i < n_kt) {
      stage<T, D>(Ks + i * kBlk * LD, kb, a.ks.s, i * kBlk, a.Sk);
      stage<T, D>(Vs + i * VS, vb, a.vs.s, i * kBlk, a.Sk);
    }
    cp_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[OC][4];
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[c][i] = 0.f;

  const T* Qw = Qs + 16 * warp * LD;
  for (int kt = 0; kt < n_kt; ++kt) {
    T* Kt = Ks + (kt % ST) * kBlk * LD;
    T* Vt = Vs + (kt % ST) * VS;
    cp_wait<ST - 1>();
    split_if_fp32<T, D>(Vt);
    __syncthreads();
    const int k0 = kt * kBlk;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    abt<D, kBlk>(s, Qw, Kt);

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + 16 * warp + gq + 8 * hr;
      const unsigned z = row_keep(a, bh, r, kt, t);
      float tmax = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * n + 2 * t + e;
          float& x = s[n][2 * hr + e];
          x = keep(r, c, a, off) ? x * a.scale + bias_at(a, b, h, r, c)
                                 : -INFINITY;
          tmax = fmaxf(tmax, x);
        }
      const float m_new = fmaxf(m[hr], quad_max(tmax));
      // a row that has seen no finite score yet shifts by 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[hr] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hr + e];
          const float p = expf(x - m_use);      // masked: exp(-inf) = 0
          psum += p;
          x = (z >> (2 * n + e) & 1u) ? p * a.keep_scale : 0.f;
        }
      l[hr] = alpha * l[hr] + quad_sum(psum);
      m[hr] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        o[c][2 * hr] *= alpha;
        o[c][2 * hr + 1] *= alpha;
      }
    }
    pm<D, kBlk, true>(o, s, Vt);
    __syncthreads();                   // every warp is done with the stage
    if (kt + ST < n_kt) {
      stage<T, D>(Kt, kb, a.ks.s, (kt + ST) * kBlk, a.Sk);
      stage<T, D>(Vt, vb, a.vs.s, (kt + ST) * kBlk, a.Sk);
    }
    cp_commit();
  }
  cp_wait<0>();

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + 16 * warp + gq + 8 * hr;
    if (r >= a.Sq) continue;
    const float lf = fmaxf(l[hr], 1e-30f);
    const bool none = m[hr] == -INFINITY;    // every score -inf, or blind
    T* orow = out + ((static_cast<long long>(b) * a.Sq + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < OC; ++c)
      store2<T>(orow + 8 * c + 2 * t, none ? NAN : o[c][2 * hr] / lf,
                none ? NAN : o[c][2 * hr + 1] / lf);
    if (t == 0) {
      const long long at = static_cast<long long>(bh) * a.Sq + r;
      const float ll = logf(lf);
      const float hi = none ? -INFINITY : m[hr] + ll;
      a.lse_out[at] = hi;
      // lse = hi + lo exactly (TwoSum)
      if (a.lse_lo != nullptr) {
        const float bv = hi - m[hr];
        a.lse_lo[at] = none ? 0.f : (m[hr] - (hi - bv)) + (ll - bv);
      }
    }
  }
}

// ------------------------------------------------------------------- dQ

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, MinBlocks<T, D>::v)
flash_dq_mma_kernel(const Args a) {
  constexpr int LD = D + Pad<T>::v;
  constexpr int ST = ring<T>();
  constexpr int OC = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kBlk * LD;
  T* Ks = dOs + kBlk * LD;
  T* Vs = Ks + ST * kBlk * LD;

  const int n_qt = (a.Sq + kBlk - 1) / kBlk;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5;
  const int gq = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int q0 = qt * kBlk;
  const int off = a.Sk - a.Sq;
  const int bh = b * a.H + h;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* db = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + g * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + g * a.vs.h;
  const int n_kt = kv_tiles(q0, kBlk, kBlk, a, off);

  stage<T, D>(Qs, qb, a.qs.s, q0, a.Sq);
  stage<T, D>(dOs, db, a.dos.s, q0, a.Sq);
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    if (i < n_kt) {
      stage<T, D>(Ks + i * kBlk * LD, kb, a.ks.s, i * kBlk, a.Sk);
      stage<T, D>(Vs + i * kBlk * LD, vb, a.vs.s, i * kBlk, a.Sk);
    }
    cp_commit();
  }

  const long long row_base = static_cast<long long>(bh) * a.Sq;
  float lse[2], lo[2], delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    row_stats(a, row_base, q0 + 16 * warp + gq + 8 * hr, off, lse[hr],
              lo[hr], delta[hr]);
  float dq[OC][4];
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[c][i] = 0.f;

  const T* Qw = Qs + 16 * warp * LD;
  const T* dOw = dOs + 16 * warp * LD;
  for (int kt = 0; kt < n_kt; ++kt) {
    T* Kt = Ks + (kt % ST) * kBlk * LD;
    T* Vt = Vs + (kt % ST) * kBlk * LD;
    cp_wait<ST - 1>();
    __syncthreads();
    const int k0 = kt * kBlk;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    abt<D, kBlk>(s, Qw, Kt);
    dp_product<D, kBlk>(dp, dOw, Vt);

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + 16 * warp + gq + 8 * hr;
      const unsigned z = row_keep(a, bh, r, kt, t);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * n + 2 * t + e;
          const float x = s[n][2 * hr + e] * a.scale + bias_at(a, b, h, r, c);
          const float p =
              keep(r, c, a, off) ? expf((x - lse[hr]) - lo[hr]) : 0.f;
          const float dpz = dp_kept<T, D>(
              dp[n][2 * hr + e], p, z >> (2 * n + e) & 1u,
              dOw + (gq + 8 * hr) * LD, Vt + (8 * n + 2 * t + e) * LD,
              a.keep_scale);
          s[n][2 * hr + e] = p * (dpz - delta[hr]);
        }
    }
    pm<D, kBlk>(dq, s, Kt);
    __syncthreads();
    if (kt + ST < n_kt) {
      stage<T, D>(Kt, kb, a.ks.s, (kt + ST) * kBlk, a.Sk);
      stage<T, D>(Vt, vb, a.vs.s, (kt + ST) * kBlk, a.Sk);
    }
    cp_commit();
  }
  cp_wait<0>();

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + 16 * warp + gq + 8 * hr;
    if (r >= a.Sq) continue;
    T* orow = out + ((static_cast<long long>(b) * a.Sq + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < OC; ++c)
      store2<T>(orow + 8 * c + 2 * t, dq[c][2 * hr] * a.scale,
                dq[c][2 * hr + 1] * a.scale);
  }
}

// ---------------------------------------------------------------- dK/dV

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, MinBlocks<T, D>::v)
flash_dkv_mma_kernel(const Args a) {
  constexpr int LD = D + Pad<T>::v;
  constexpr int ST = ring<T>();
  constexpr int OC = D / 8;
  // query columns of one score tile: 32 at head_dim 128 (two halves of
  // a q tile), so that the dK and dV accumulators leave room for it
  constexpr int QC = D == 128 ? 32 : 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBlk * LD;
  T* Qs = Vs + kBlk * LD;
  T* dOs = Qs + ST * kBlk * LD;
  // per q tile, two buffers: the keep words (query row i's bits for key
  // x + 16 j at bit 8 j + x % 8 of word 2 i + x / 8) and lse, lse_lo,
  // delta of its 64 rows
  unsigned* kw = reinterpret_cast<unsigned*>(dOs + ST * kBlk * LD);
  float* rows = reinterpret_cast<float*>(kw + 2 * 2 * kBlk);

  const int kt = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.Hkv;
  const int warp = threadIdx.x >> 5;
  const int gq = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int k0 = kt * kBlk;
  const int off = a.Sk - a.Sq;

  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + g * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + g * a.vs.h;
  const int n_qt = (a.Sq + kBlk - 1) / kBlk;
  const int qt0 = first_q_tile(k0, kBlk, a, off);
  const int nq = max(n_qt - qt0, 0);
  const int n_it = rep * nq;             // (query head of the group, q tile)

  auto stage_q = [&](int it, int slot) {
    const int h = g * rep + it / nq;
    const int q0 = (qt0 + it % nq) * kBlk;
    stage<T, D>(Qs + slot * kBlk * LD,
                static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h, a.qs.s,
                q0, a.Sq);
    stage<T, D>(dOs + slot * kBlk * LD,
                static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h,
                a.dos.s, q0, a.Sq);
  };
  stage<T, D>(Ks, kb, a.ks.s, k0, a.Sk);
  stage<T, D>(Vs, vb, a.vs.s, k0, a.Sk);
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    if (i < n_it) stage_q(i, i);
    cp_commit();
  }

  float dk[OC][4], dv[OC][4];
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[c][i] = dv[c][i] = 0.f;

  const T* Kw = Ks + 16 * warp * LD;
  const T* Vw = Vs + 16 * warp * LD;
  for (int it = 0; it < n_it; ++it) {
    const int h = g * rep + it / nq;
    const int q0 = (qt0 + it % nq) * kBlk;
    const int bh = b * a.H + h;
    const int buf = it & 1;
    // this tile's keep words and row stats (the buffer was last read two
    // tiles ago, before the barrier that ended the last tile)
    {
      const int i = q0 + (threadIdx.x >> 1);
      const int x0 = 8 * (threadIdx.x & 1);
      unsigned w = 0xFFFFFFFFu;
      if (a.threshold) {
        w = 0;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const unsigned k4 = keep_bits(a, bh, i, kt, x0 + x);
#pragma unroll
          for (int j = 0; j < 4; ++j) w |= (k4 >> j & 1u) << (8 * j + x);
        }
      }
      kw[buf * 2 * kBlk + threadIdx.x] = w;
      if (threadIdx.x < kBlk) {
        float* rw = rows + buf * 3 * kBlk;
        row_stats(a, static_cast<long long>(bh) * a.Sq, q0 + threadIdx.x, off,
                  rw[threadIdx.x], rw[kBlk + threadIdx.x],
                  rw[2 * kBlk + threadIdx.x]);
      }
    }
    const T* Qt = Qs + (it % ST) * kBlk * LD;
    const T* dOt = dOs + (it % ST) * kBlk * LD;
    cp_wait<ST - 1>();
    __syncthreads();
    const unsigned* kwt = kw + buf * 2 * kBlk;
    const float* rw = rows + buf * 3 * kBlk;
#pragma unroll 1
    for (int hq = 0; hq < kBlk / QC; ++hq) {
      // S^T and dP^T of this warp's 16 kv rows and QC query columns
      float st[QC / 8][4], dpt[QC / 8][4];
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
      abt<D, QC>(st, Kw, Qt + hq * QC * LD);
      dp_product<D, QC>(dpt, Vw, dOt + hq * QC * LD);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int kc = k0 + 16 * warp + gq + 8 * hr;
        // key x + 16 j of the tile with x = gq + 8 hr, j = warp
        const int bit = 8 * warp + gq;
#pragma unroll
        for (int n = 0; n < QC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = hq * QC + 8 * n + 2 * t + e;
            const int qr = q0 + qi;
            const float x =
                st[n][2 * hr + e] * a.scale + bias_at(a, b, h, qr, kc);
            const float p = keep(qr, kc, a, off)
                                ? expf((x - rw[qi]) - rw[kBlk + qi])
                                : 0.f;
            const bool kept = kwt[2 * qi + hr] >> bit & 1u;
            const float dpz = dp_kept<T, D>(
                dpt[n][2 * hr + e], p, kept, dOt + qi * LD,
                Vw + (gq + 8 * hr) * LD, a.keep_scale);
            st[n][2 * hr + e] = kept ? p * a.keep_scale : 0.f;
            dpt[n][2 * hr + e] = p * (dpz - rw[2 * kBlk + qi]);
          }
      }
      pm<D, QC>(dv, st, dOt + hq * QC * LD);
      pm<D, QC>(dk, dpt, Qt + hq * QC * LD);
    }
    __syncthreads();
    if (it + ST < n_it) stage_q(it + ST, it % ST);
    cp_commit();
  }
  cp_wait<0>();

  T* dko = static_cast<T*>(a.out);
  T* dvo = static_cast<T*>(a.out2);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kc = k0 + 16 * warp + gq + 8 * hr;
    if (kc >= a.Sk) continue;
    const long long at =
        ((static_cast<long long>(b) * a.Sk + kc) * a.Hkv + g) * D;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      store2<T>(dko + at + 8 * c + 2 * t, dk[c][2 * hr] * a.scale,
                dk[c][2 * hr + 1] * a.scale);
      store2<T>(dvo + at + 8 * c + 2 * t, dv[c][2 * hr], dv[c][2 * hr + 1]);
    }
  }
}

// ------------------------------------------------------------ host side

template <typename T, int D>
int launch_mma(int kind, const Args& a, cudaStream_t stream) {
  constexpr int tile = kBlk * (D + Pad<T>::v) * static_cast<int>(sizeof(T));
  // tiles: K1 Q + a ring of K and V (V split in fp32: `planes`); dQ Q,
  // dO + a ring of K and V; dK / dV K, V + a ring of Q and dO
  size_t smem;
  void (*kernel)(const Args);
  if (kind == kFwd) {
    smem = static_cast<size_t>(1 + (1 + planes<T>()) * ring<T>()) * tile;
    kernel = flash_fwd_mma_kernel<T, D>;
  } else if (kind == kDq) {
    smem = static_cast<size_t>(2 + 2 * ring<T>()) * tile;
    kernel = flash_dq_mma_kernel<T, D>;
  } else {
    smem = static_cast<size_t>(2 + 2 * ring<T>()) * tile +
           sizeof(unsigned) * 2 * 2 * kBlk + sizeof(float) * 2 * 3 * kBlk;
    kernel = flash_dkv_mma_kernel<T, D>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = ((kind == kDkv ? a.Sk : a.Sq) + kBlk - 1) / kBlk;
  const dim3 grid(n_tiles, kind == kDkv ? a.Hkv : a.H, a.B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mma_d(int kind, int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<T, 16>(kind, a, stream);
    case 32: return launch_mma<T, 32>(kind, a, stream);
    case 64: return launch_mma<T, 64>(kind, a, stream);
    case 128: return launch_mma<T, 128>(kind, a, stream);
    default: return kBadArg;
  }
}

}  // namespace
