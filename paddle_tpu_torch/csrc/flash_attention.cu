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
//             (= -1e30), online softmax over K/V tiles;
//             O = acc / max(l, 1e-30) in q's dtype,
//             lse = m + log(max(l, 1e-30)) in fp32;
//   backward  P = exp(s - lse) recomputed (masked -> 0),
//             dP = dO . V^T, dS = P * (dP - delta) with
//             delta = rowsum(O * dO) (computed by the caller, as the
//             JAX package computes it outside Pallas),
//             dQ = dS . K * scale, dK = dS^T . (q * scale), dV = P^T . dO.
// Causal masks keep key c for query r when r + Sk - Sq >= c: aligned
// bottom-right, as the JAX package's scaled_dot_product_attention_raw
// (`tril(k = Sk - Sq)`), and the Pallas kernels' `_causal_mask` when
// Sq == Sk.  A query row that sees no key (Sq > Sk, r < Sq - Sk) gets
// O = NaN and lse = -inf (the reference's softmax over nothing), and
// adds nothing to the gradients: the backward kernels read its lse and
// delta as 0, as they read a padding row's, so its P and dS are 0.
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
//   * dK / dV: one block per (b, kv head, kv tile) loops over the
//     `rep` query heads of its group and over the q tiles from the
//     diagonal on (the Pallas `start`), summing the group inside the block
//     (what `_flash_mha_bwd` does after the kernel with a reshape-sum).
//     No atomics: results are the same run to run.
//   * The Pallas kernels require S to be a multiple of the block; these
//     take any S and mask the ragged last tile themselves.
//
// Two variants, picked openly by the wrapper (ops/flash_attention.py
// `_variant`) from the dtype and head_dim, never by catching a failure:
//
//   wgmma  bf16, head_dim 128 (llama3-8b's 4096 / 32, Qwen-MoE's 2048 /
//          16).  Hopper's warpgroup MMA (fp32 accumulators in registers)
//          on 128-byte-swizzled tiles that TMA copies through 4-D tensor
//          maps over the (B, S, H, D) strides, so q, k, v and dO are never
//          copied; one thread of a producer warpgroup keeps a ring of K /
//          V (or Q / dO) stages ahead of two consumer warpgroups through
//          full / empty mbarriers (waits trap after 10 s), and setmaxnreg
//          moves the producer's registers to the consumers.  The scores
//          S = q . k stay fp32 and are scaled in fp32 (a bf16 copy of
//          q * scale would move every score by ~2^-9, far past lse's
//          1e-5).  P (forward, dV) and dS (dQ, dK) go into their products
//          as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), one
//          wgmma each, straight from the accumulator registers into
//          wgmma's A fragments (FlashAttention-3's register form: no
//          shared-memory round trip); l sums the fp32 P.  P or dS rounded
//          once to bf16 put rows of a llama3-8b layer's own gradients 2
//          bf16 ulps from the plain version (dQ, whose row sums
//          sum_c dS K_c cancel, since a row's dS sums to 0; dV in the
//          tail): the two parts keep ~16 mantissa bits.
//          Blocks: K1 and dQ one per (128 query rows, head, batch),
//          longest causal rows first; dK/dV one per (128 kv rows, kv head,
//          batch), low kv tiles first, looping over the group's query
//          heads and the q tiles from the diagonal on, in halves of 32
//          rows (n32 products) so that the dK and dV accumulators (128
//          registers a lane) leave room for the score tiles.
//   fma    fp32, and bf16 at head_dim 16, 32 or 64, on the CUDA cores:
//          q, k and v widened to fp32 into (64, D + 1) shared-memory
//          tiles, each of 256 threads owning a 4 x 4 block of the score
//          tile and a 4 x D/16 block of the output; P stays fp32.  The
//          16 threads that share a score row reduce over its 64 columns,
//          whatever D is, so D 16 (one output column a thread) takes the
//          same layout.  Without a bias or dropout fp32 stays off the
//          tensor cores here: one TF32 product keeps ~10 mantissa bits
//          and fails fp32's 1e-5 limit.  With either, fp32 runs on the
//          tensor cores as three TF32 products (flash_attention_mma.cu).
//
// Bias and dropout (not in this file's kernels: a call with either runs
// flash_attention_mma.cu's tensor-core kernels, or with variant "fma"
// the fma kernels built with that code, kExtra = true, in
// flash_attention_extra.cu; calls without them run the code they ran
// before):
//   bias     an fp32 tensor read through four element strides (b, h, q,
//            k), any of them 0 (a (B, 1, 1, Sk) padding bias is read in
//            place), added to the scaled scores before the row maximum.
//            Masked scores are -inf and a row's max starts at -inf, so
//            a finite bias, however far below -1e30 (a finfo.min
//            padding row), is a score like any other: a row whose every
//            key is padded that way gets the uniform softmax, as the
//            reference.  A row whose every score is -inf (a bool mask's
//            0 / -inf) ends with max -inf: O = NaN, lse = -inf, and the
//            backward reads its lse as +inf and its delta as 0, so its
//            P and dS are 0.  lse goes out as hi + lo (TwoSum, lo into
//            the optional `lse_lo`) and the backward recomputes P =
//            exp((s - hi) - lo): where the bias puts a row's max far
//            below 0 (-1e9 padding: ulp 64), hi = m + log l alone has
//            lost log l, and exp(s - hi) would be the unnormalised P.
//   dropout  keep bit z of element (b, h, i, c) from Philox4x32-10 under
//            the key (seed_lo, seed_hi) and the counter (16 (c / 64) +
//            c % 16, i, b H + h, offset), word (c / 16) % 4, kept when
//            the word >= threshold = floor(p 2^32): one Philox call gives
//            a thread the four columns it owns in a 64-key tile.  The
//            forward keeps l and lse of the softmax without dropout and
//            accumulates P z / (1 - p) into O; the backward regenerates
//            z: dV = (P z / (1 - p))^T dO, dP = (dO V^T) z / (1 - p),
//            dS = P (dP - delta).  ops/flash_attention.py computes the
//            same bits in plain PyTorch (`dropout_keep`).
//
// Both are held to the plain PyTorch version within one rounding to the
// output dtype (per row: fp32 1e-5, bf16 2^-7 of the row's max |plain|;
// lse 1e-5 relative).  No atomics anywhere: results are the same run to
// run.
//
// Bound.  At the training shape (B 2, S 2048, 32 q / 8 kv heads, D 128,
// causal) the forward does 2 * B * H * S^2 * D = 68.7 GFLOP and moves
// ~50 MB: it is bound by operations (bf16 tensor-core peak 989 TFLOP/s
// on an H100 SXM, 0.07 ms).  dQ needs three products of that size
// (S, dP, dQ: 1.5x the forward), dK / dV four (S, dP, dV, dK: 2x).  The
// wgmma variant's two-part P and dS add one tensor-core product to each
// of P V, dS K, P^T dO and dS^T Q (the forward issues 3 products' worth,
// dQ 4, dK / dV 6); the fma variant's ceiling is the fp32 CUDA-core rate
// (67 TFLOP/s).
//
// Files: the fma kernels and the C interface live in
// flash_attention_fma.cuh; this file builds them without the bias and
// dropout code and adds the wgmma kernels; flash_attention_extra.cu
// builds the same fma kernels with it; flash_attention_mma.cu holds the
// tensor-core kernels of a call with a bias or dropout (three libraries
// nvcc builds side by side, `ops/flash_attention.py::_call` picks one
// per call).
//
// C interface (ctypes, see ops/flash_attention.py): kernel 0 = fma in
// fp32, 1 = fma in bf16, 2 = wgmma in bf16 (head_dim 128; strides and
// pointers 16-byte aligned, as TMA reads them); 3 = mma in fp32 and 4 =
// mma in bf16 are flash_attention_mma.cu's; `strides` holds (batch,
// seq, head) element strides of q, k, v and (backward) dO, head_dim
// contiguous; O / dQ / dK / dV are written contiguous (B, S, H, D), lse
// is (B, H, Sq) fp32, delta (B, H, Sq) fp32.  The trailing arguments
// are the bias (NULL: none) and its four strides, the dropout seed's two
// words, the offset, the threshold (0: no dropout), 1 / (1 - p) and
// lse_lo ((B, H, Sq) fp32 or NULL; the forward writes it, the backward
// reads it): this library takes only NULL and 0 there.  Each function returns
// cudaGetLastError() after its launch, or an error code for arguments it
// does not take.

#include "flash_attention_fma.cuh"
#include "hopper.cuh"

namespace {

// ================================================== bf16 tensor cores
//
// Tiles of 128 bf16 columns (head_dim 128) are two boxes of `rows` x 64
// columns, each rows x 128 bytes, that TMA writes 128-byte-swizzled:
// box 0 holds columns 0..63, box 1 columns 64..127.

constexpr int kD = 128;                  // head_dim of the wgmma kernels
// Two consumer warpgroups and one producer warpgroup, of which one
// thread issues the TMA copies.  A warpgroup is the unit registers are
// given in: setmaxnreg moves them from the producer (40 a lane) to the
// consumers (232), which hold the accumulators.
constexpr int kWgThreads = 3 * 128;
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int tile_bytes(int rows) { return rows * kD * 2; }

// d (64 x 64 fp32) = A (64 x 16) B (16 x 64) + (scale_d ? d : 0), A and B
// from shared memory (TA / TB: A M-major / B N-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 32 fp32) = A (64 x 16) B (16 x 32) + (scale_d ? d : 0), A and B
// from shared memory (TA / TB: A M-major / B N-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      " %13, %14, %15},"
      " %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 128 fp32) += A (64 x 16, bf16 fragments in registers) B (16 x
// 128) from shared memory (TB: B N-major)
template <int TB>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38,"
      " %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      " %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1));
}

// Descriptor of k16 step kk (of 8) of a K-major operand: rows row0 ..
// row0 + 63 (A) or the tile's N rows (B) of a tile of `rows` rows, the
// contraction along the 128 columns: box kk / 4, 32 bytes a step
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile,
                                           int rows, int row0, int kk) {
  return wg_desc(tile + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32,
                 16, 1024);
}

// Descriptor of k16 step kk of an N-major B: the contraction along the
// tile's rows (16 rows, 2 KB, a step from row0), N along the 128 columns
// (the second 64 in the next box, rows x 128 bytes on)
__device__ __forceinline__ uint64_t desc_n(const unsigned char* tile,
                                           int rows, int row0, int kk) {
  return wg_desc(tile + (row0 + 16 * kk) * 128, rows * 128, 1024);
}

// A query row that attends to one key (causal row Sq - Sk; every row
// when Sk == 1) has P = 1 on key 0 and a dQ row that is 0 but for rounding:
// dS = dP - delta, where O is key 0's V row, so delta = dP exactly.  Both
// versions return rounding noise there, and the per-row limit compares
// noise with noise.  So the dQ kernel computes that one dS as the plain
// version's fp32 product does, dO . V_0 summed in order over head_dim by
// fmaf, instead of from the tensor cores' accumulator, whose fp32 sums
// round otherwise.
__device__ __forceinline__ bool one_key(int r, const Args& a, int off) {
  return r < a.Sq && (a.causal ? r + off == 0 : a.Sk == 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of a wgmma k16 step from the fp32 accumulator of a
// previous one: k16 step kk covers the columns of n8 blocks 2 kk and
// 2 kk + 1, which a lane holds as d[8 kk .. 8 kk + 7] in the order the
// fragment wants them (FlashAttention-3's register form), as a bf16 sum
// hi + lo: hi = bf16(d), lo = bf16(d - hi), about 16 mantissa bits of d,
// for a product that takes two wgmmas (one per part).
template <int N>
__device__ __forceinline__ void to_frags_split(const float (&d)[N],
                                               uint32_t (&hi)[N / 2],
                                               uint32_t (&lo)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(d[2 * i] - hf.x, d[2 * i + 1] - hf.y);
  }
}

// 1024-byte aligned start of the dynamic shared memory (the swizzle's)
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The lane's place in a warpgroup's accumulator: d[4 j + 2 h + e] holds
// row `row + 8 h` (of the warpgroup's 64) and column `8 j + col + e`.
struct Lane {
  int row, col;
  __device__ Lane() {
    const int lane = threadIdx.x % 32;
    row = 16 * ((threadIdx.x / 32) % 4) + (lane >> 2);
    col = 2 * (lane & 3);
  }
};

// Stores a warpgroup's 64 x 128 fp32 accumulator times `mul` as bf16
// rows r0 + row (the rows below n_rows), row r at base + r * ld
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld,
                                           int r0, int n_rows,
                                           const float (&acc)[64], float mul) {
  const Lane ln;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + ln.row + 8 * h;
    if (r >= n_rows) continue;
    __nv_bfloat16* row = base + r * ld + ln.col;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// K1, bf16, head_dim 128: a block per (128 query rows, head, batch),
// longest causal rows first; two consumer warpgroups of 64 rows and the
// producer.  Q arrives once by TMA; K and V tiles of 128 keys run
// through a ring of kFwdStages.  Per tile: S = Q K^T (wgmma m64n128k16,
// fp32), scaled in fp32, masked on the diagonal and past Sk, online
// softmax in registers (a row's 128 columns sit on the 4 lanes of a
// quad), P in two bf16 parts straight into A fragments, O += P V with V
// read N-major.  l sums the fp32 P.
constexpr int kFwdStages = 2;
constexpr int kFwdSmem =
    1024 + tile_bytes(128) * (1 + 2 * kFwdStages) + 8 * (1 + 2 * kFwdStages);

template <bool kShift>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const Args a) {
  constexpr int T = tile_bytes(128);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = smem_base(smem_raw);
  unsigned char* kv = qs + T;              // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + 2 * kFwdStages * T);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFwdStages;

  const int per_tile = a.H * a.B;
  const int n_qt = (a.Sq + 127) / 128;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int h = (blockIdx.x % per_tile) % a.H;
  const int b = (blockIdx.x % per_tile) / a.H;
  const int g = h / (a.H / a.Hkv);
  const int q0 = qt * 128;
  const int off = kShift ? a.Sk - a.Sq : 0;
  const int n_kt = kv_tiles(q0, 128, 128, a, off);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;

  if (warp >= kConsumerWarps) {              // producer warpgroup
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps) {
      mbar_expect_tx(q_full, T);
      tma_4d(qs, &map_q, q_full, 0, q0, h, b);
      tma_4d(qs + T / 2, &map_q, q_full, 64, q0, h, b);
      for (int s = 0; s < n_kt; ++s) {
        const int slot = s % kFwdStages;
        if (s >= kFwdStages) mbar_wait(empty + slot, (s / kFwdStages - 1) & 1);
        mbar_expect_tx(full + slot, 2 * T);
        unsigned char* ks = kv + 2 * slot * T;
        tma_4d(ks, &map_k, full + slot, 0, 128 * s, g, b);
        tma_4d(ks + T / 2, &map_k, full + slot, 64, 128 * s, g, b);
        tma_4d(ks + T, &map_v, full + slot, 0, 128 * s, g, b);
        tma_4d(ks + T + T / 2, &map_v, full + slot, 64, 128 * s, g, b);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = warp / 4;
  const Lane ln;
  const int r_lo = q0 + 64 * wg;             // the warpgroup's first row
  const float sl2 = a.scale * kLog2e;
  // m: the running row max in the exp2 domain; l: this lane's part of
  // the row's sum (the quad adds its parts at the end)
  float o[64], s[64], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = s[i] = 0.f;
  uint32_t p[32], pl[32];

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int slot = it % kFwdStages;
    const int k0 = 128 * it;
    const unsigned char* ks = kv + 2 * slot * T;
    mbar_wait(full + slot, (it / kFwdStages) & 1);

    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n128<0, 0>(s, desc_k(qs, 128, 64 * wg, kk),
                          desc_k(ks, 128, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // scores in the exp2 domain: x = s * scale * log2(e), masked -> -1e30
    const bool mask =
        (a.causal && k0 + 127 > r_lo + off) || k0 + 128 > a.Sk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * h2 + e] * sl2;
          if (mask &&
              !keep(r_lo + ln.row + 8 * h2, k0 + 8 * j + ln.col + e, a, off))
            x = kNegInf;
          s[4 * j + 2 * h2 + e] = x;
          mx[h2] = fmaxf(mx[h2], x);
        }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
      const float alpha = exp2f(m[h2] - mx[h2]);
      l[h2] *= alpha;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j + 2 * h2] *= alpha;
        o[4 * j + 2 * h2 + 1] *= alpha;
      }
      m[h2] = mx[h2];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = exp2f(s[4 * j + 2 * h2 + e] - mx[h2]);
          s[4 * j + 2 * h2 + e] = pe;
          l[h2] += pe;
        }
    to_frags_split(s, p, pl);

    fence_acc(o);
    fence_regs(p);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_m64n128_rs<1>(o, p + 4 * kk, desc_n(ks + T, 128, 0, kk));
      wgmma_m64n128_rs<1>(o, pl + 4 * kk, desc_n(ks + T, 128, 0, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + slot);
  }

  // the row's sums over the quad; O = acc / l, lse = m + log(l)
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
    l[h2] = fmaxf(l[h2], 1e-30f);
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) +
                      (static_cast<long long>(b) * a.Sq * a.H + h) * kD;
  const long long ld = static_cast<long long>(a.H) * kD;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r_lo + ln.row + 8 * h2;
    if (r >= a.Sq) continue;
    const bool none = kShift && blind(r, a, off);
    const float inv = none ? NAN : 1.f / l[h2];
    __nv_bfloat16* row = ob + r * ld + ln.col;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(
          o[4 * j + 2 * h2] * inv, o[4 * j + 2 * h2 + 1] * inv);
    if (ln.col == 0)
      a.lse_out[(static_cast<long long>(b) * a.H + h) * a.Sq + r] =
          none ? -INFINITY : m[h2] * kLn2 + logf(l[h2]);
  }
}

// K2 dQ, bf16, head_dim 128: a block per (128 query rows, head, batch),
// two consumer warpgroups of 64 rows and the producer.  Q and dO arrive
// once; K and V tiles of 64 keys run through a ring of kDqStages.  Per
// tile: S = Q K^T and dP = dO V^T (wgmma m64n64k16), P = exp(S scale -
// lse) (masked -> 0), dS = P (dP - delta) in two bf16 parts, dQ += dS K
// with K read N-major; dQ is scaled once at the end.
constexpr int kDqStages = 3;
constexpr int kDqSmem = 1024 + 2 * tile_bytes(128) +
                        2 * kDqStages * tile_bytes(64) + 8 * (1 + 2 * kDqStages);

template <bool kShift>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const Args a) {
  constexpr int TQ = tile_bytes(128), TK = tile_bytes(64);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = smem_base(smem_raw);
  unsigned char* dos = qs + TQ;
  unsigned char* kv = dos + TQ;            // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + 2 * kDqStages * TK);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;

  const int per_tile = a.H * a.B;
  const int n_qt = (a.Sq + 127) / 128;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int h = (blockIdx.x % per_tile) % a.H;
  const int b = (blockIdx.x % per_tile) / a.H;
  const int g = h / (a.H / a.Hkv);
  const int q0 = qt * 128;
  const int off = kShift ? a.Sk - a.Sq : 0;
  const int n_kt = kv_tiles(q0, 128, 64, a, off);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;

  if (warp >= kConsumerWarps) {              // producer warpgroup
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps) {
      mbar_expect_tx(q_full, 2 * TQ);
      tma_4d(qs, &map_q, q_full, 0, q0, h, b);
      tma_4d(qs + TQ / 2, &map_q, q_full, 64, q0, h, b);
      tma_4d(dos, &map_do, q_full, 0, q0, h, b);
      tma_4d(dos + TQ / 2, &map_do, q_full, 64, q0, h, b);
      for (int s = 0; s < n_kt; ++s) {
        const int slot = s % kDqStages;
        if (s >= kDqStages) mbar_wait(empty + slot, (s / kDqStages - 1) & 1);
        mbar_expect_tx(full + slot, 2 * TK);
        unsigned char* ks = kv + 2 * slot * TK;
        tma_4d(ks, &map_k, full + slot, 0, 64 * s, g, b);
        tma_4d(ks + TK / 2, &map_k, full + slot, 64, 64 * s, g, b);
        tma_4d(ks + TK, &map_v, full + slot, 0, 64 * s, g, b);
        tma_4d(ks + TK + TK / 2, &map_v, full + slot, 64, 64 * s, g, b);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = warp / 4;
  const Lane ln;
  const int r_lo = q0 + 64 * wg;
  const float sl2 = a.scale * kLog2e;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  float lse2[2], delta[2];                 // lse in the exp2 domain
  bool solo[2];                            // see one_key
  float solo_ds[2] = {0.f, 0.f};
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r_lo + ln.row + 8 * h2;
    const bool seen = r < a.Sq && !(kShift && blind(r, a, off));
    lse2[h2] = seen ? a.lse[row_base + r] * kLog2e : 0.f;
    delta[h2] = seen ? a.delta[row_base + r] : 0.f;
    solo[h2] = one_key(r, a, off);
    if (solo[h2] && ln.col == 0) {
      const __nv_bfloat16* dor = static_cast<const __nv_bfloat16*>(a.dout) +
                                 b * a.dos.b + r * a.dos.s + h * a.dos.h;
      const __nv_bfloat16* v0 =
          static_cast<const __nv_bfloat16*>(a.v) + b * a.vs.b + g * a.vs.h;
      float dp0 = 0.f;
      for (int d = 0; d < kD; ++d)
        dp0 = fmaf(__bfloat162float(dor[d]), __bfloat162float(v0[d]), dp0);
      solo_ds[h2] = dp0 - delta[h2];
    }
  }
  float dq[64], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t ds[16], dl[16];

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int slot = it % kDqStages;
    const int k0 = 64 * it;
    const unsigned char* ks = kv + 2 * slot * TK;
    mbar_wait(full + slot, (it / kDqStages) & 1);

    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n64<0, 0>(s, desc_k(qs, 128, 64 * wg, kk),
                         desc_k(ks, 64, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n64<0, 0>(dp, desc_k(dos, 128, 64 * wg, kk),
                         desc_k(ks + TK, 64, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    const bool mask =
        (a.causal && k0 + 63 > r_lo + off) || k0 + 64 > a.Sk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h2 + e;
          float pe = exp2f(s[i] * sl2 - lse2[h2]);
          if (mask &&
              !keep(r_lo + ln.row + 8 * h2, k0 + 8 * j + ln.col + e, a, off))
            pe = 0.f;
          s[i] = pe * (dp[i] - delta[h2]);
          if (mask && solo[h2])            // key 0 only: lane col 0, j = e = 0
            s[i] = k0 + 8 * j + ln.col + e == 0 ? solo_ds[h2] : 0.f;
        }
    to_frags_split(s, ds, dl);

    fence_acc(dq);
    fence_regs(ds);
    fence_regs(dl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n128_rs<1>(dq, ds + 4 * kk, desc_n(ks, 64, 0, kk));
      wgmma_m64n128_rs<1>(dq, dl + 4 * kk, desc_n(ks, 64, 0, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + slot);
  }

  store_rows(static_cast<__nv_bfloat16*>(a.out) +
                 (static_cast<long long>(b) * a.Sq * a.H + h) * kD,
             static_cast<long long>(a.H) * kD, r_lo, a.Sq, dq, a.scale);
}

// K2 dK / dV, bf16, head_dim 128: a block per (128 kv rows, kv head,
// batch), the low kv tiles (most causal work) first; two consumer
// warpgroups of 64 kv rows and the producer.  K and V arrive once;
// Q and dO tiles of 64 rows of each of the group's `rep` query heads,
// from the diagonal on, run through a ring of kDkvStages, so the group
// is summed inside the block without atomics.  Per tile, in two halves
// of 32 query rows (registers: the dK and dV accumulators take 128 a
// lane): S^T = K Q^T and dP^T = V dO^T (wgmma m64n32k16),
// P^T = exp(S^T scale - lse) (masked -> 0, padding query rows too),
// dS^T = P^T (dP^T - delta), both in two bf16 parts into A fragments,
// dV += P^T dO and dK += dS^T Q with Q and dO read N-major; dK is
// scaled once at the end.
constexpr int kDkvStages = 3;
constexpr int kDkvSmem = 1024 + 2 * tile_bytes(128) +
                         2 * kDkvStages * tile_bytes(64) + 8 * (1 + 2 * kDkvStages);

template <bool kShift>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const Args a) {
  constexpr int TK = tile_bytes(128), TQ = tile_bytes(64);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ks = smem_base(smem_raw);
  unsigned char* vs = ks + TK;
  unsigned char* qd = vs + TK;             // stage s: Q, then dO
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(qd + 2 * kDkvStages * TQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;

  const int per_tile = a.Hkv * a.B;
  const int kt = static_cast<int>(blockIdx.x) / per_tile;
  const int g = (blockIdx.x % per_tile) % a.Hkv;
  const int b = (blockIdx.x % per_tile) / a.Hkv;
  const int rep = a.H / a.Hkv;
  const int k0 = kt * 128;
  const int off = kShift ? a.Sk - a.Sq : 0;
  const int n_qt = (a.Sq + 63) / 64;
  const int qt0 = first_q_tile(k0, 64, a, off);  // earlier: masked
  const int per_head = n_qt - qt0;
  const int steps = rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;

  if (warp >= kConsumerWarps) {              // producer warpgroup
    producer_regs();
    if (threadIdx.x == 32 * kConsumerWarps) {
      mbar_expect_tx(kv_full, 2 * TK);
      tma_4d(ks, &map_k, kv_full, 0, k0, g, b);
      tma_4d(ks + TK / 2, &map_k, kv_full, 64, k0, g, b);
      tma_4d(vs, &map_v, kv_full, 0, k0, g, b);
      tma_4d(vs + TK / 2, &map_v, kv_full, 64, k0, g, b);
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kDkvStages;
        if (s >= kDkvStages) mbar_wait(empty + slot, (s / kDkvStages - 1) & 1);
        mbar_expect_tx(full + slot, 2 * TQ);
        const int h = g * rep + s / per_head;
        const int q0 = 64 * (qt0 + s % per_head);
        unsigned char* qs = qd + 2 * slot * TQ;
        tma_4d(qs, &map_q, full + slot, 0, q0, h, b);
        tma_4d(qs + TQ / 2, &map_q, full + slot, 64, q0, h, b);
        tma_4d(qs + TQ, &map_do, full + slot, 0, q0, h, b);
        tma_4d(qs + TQ + TQ / 2, &map_do, full + slot, 64, q0, h, b);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = warp / 4;
  const Lane ln;
  const int c_lo = k0 + 64 * wg;           // the warpgroup's first kv row
  const float sl2 = a.scale * kLog2e;
  float dk[64], dv[64], st[16], dpt[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
  uint32_t pf[8], pl[8], df[8], dl[8];

  mbar_wait(kv_full, 0);
  for (int it = 0; it < steps; ++it) {
    const int slot = it % kDkvStages;
    const int h = g * rep + it / per_head;
    const int q0 = 64 * (qt0 + it % per_head);
    const unsigned char* qs = qd + 2 * slot * TQ;
    const unsigned char* dos = qs + TQ;
    const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
    mbar_wait(full + slot, (it / kDkvStages) & 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = q0 + 32 * half;       // the half's first query row
      // this lane's 8 query columns: r0 + 8 j + col + e
      float lse2[8], delta[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * j + ln.col + e;
          const bool seen = r < a.Sq && !blind(r, a, off);
          lse2[2 * j + e] = seen ? __ldg(a.lse + row_base + r) * kLog2e : 0.f;
          delta[2 * j + e] = seen ? __ldg(a.delta + row_base + r) : 0.f;
        }
      fence_acc(st);
      fence_acc(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n32<0, 0>(st, desc_k(ks, 128, 64 * wg, kk),
                           desc_k(qs, 64, 32 * half, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n32<0, 0>(dpt, desc_k(vs, 128, 64 * wg, kk),
                           desc_k(dos, 64, 32 * half, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);

      // padding query rows (r >= Sq) must give P = 0: their lse and
      // delta read as 0 and their Q rows as zeros
      const bool mask =
          (a.causal && r0 + off < c_lo + 63) || r0 + 32 > a.Sq;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h2 + e;
            float pe = exp2f(st[i] * sl2 - lse2[2 * j + e]);
            if (mask &&
                !keep(r0 + 8 * j + ln.col + e, c_lo + ln.row + 8 * h2, a, off))
              pe = 0.f;
            st[i] = pe;
            dpt[i] = pe * (dpt[i] - delta[2 * j + e]);
          }
      to_frags_split(st, pf, pl);
      to_frags_split(dpt, df, dl);

      fence_acc(dv);
      fence_acc(dk);
      fence_regs(pf);
      fence_regs(pl);
      fence_regs(df);
      fence_regs(dl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t bd = desc_n(dos, 64, 32 * half, kk);
        const uint64_t bq = desc_n(qs, 64, 32 * half, kk);
        wgmma_m64n128_rs<1>(dv, pf + 4 * kk, bd);
        wgmma_m64n128_rs<1>(dv, pl + 4 * kk, bd);
        wgmma_m64n128_rs<1>(dk, df + 4 * kk, bq);
        wgmma_m64n128_rs<1>(dk, dl + 4 * kk, bq);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
    }
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + slot);
  }

  const long long at = static_cast<long long>(b) * a.Sk * a.Hkv + g;
  const long long ld = static_cast<long long>(a.Hkv) * kD;
  store_rows(static_cast<__nv_bfloat16*>(a.out) + at * kD, ld, c_lo, a.Sk,
             dk, a.scale);
  store_rows(static_cast<__nv_bfloat16*>(a.out2) + at * kD, ld, c_lo, a.Sk,
             dv, 1.f);
}

// ------------------------------------------------------------ host side

// the 4-D tensor map of a (B, S, H, 128) bf16 tensor with element
// strides `st`, read in boxes of `rows` rows x 64 columns of one head
bool map_bshd(CUtensorMap* map, const void* p, const Strides& st, int S,
              int H, int B, int rows) {
  const cuuint64_t dims[4] = {kD, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return make_map(map, p, 4, dims, strides, box);
}

template <bool kShift>
int launch_wgmma_kernel(int kind, const Args& a, const CUtensorMap& mq,
                        const CUtensorMap& mk, const CUtensorMap& mv,
                        const CUtensorMap& mdo, cudaStream_t stream) {
  cudaError_t err;
  if (kind == kFwd) {
    auto kernel = flash_fwd_wgmma_kernel<kShift>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = ((a.Sq + 127) / 128) * a.H * a.B;
    kernel<<<blocks, kWgThreads, kFwdSmem, stream>>>(mq, mk, mv, a);
  } else if (kind == kDq) {
    auto kernel = flash_dq_wgmma_kernel<kShift>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = ((a.Sq + 127) / 128) * a.H * a.B;
    kernel<<<blocks, kWgThreads, kDqSmem, stream>>>(mq, mk, mv, mdo, a);
  } else {
    auto kernel = flash_dkv_wgmma_kernel<kShift>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = ((a.Sk + 127) / 128) * a.Hkv * a.B;
    kernel<<<blocks, kWgThreads, kDkvSmem, stream>>>(mq, mk, mv, mdo, a);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(int kind, const Args& a, cudaStream_t stream) {
  // q / dO in boxes of the kernel's query rows, k / v of its kv rows
  const int q_rows = kind == kDkv ? 64 : 128;
  const int kv_rows = kind == kDq ? 64 : 128;
  CUtensorMap mq, mk, mv, mdo;
  if (!map_bshd(&mq, a.q, a.qs, a.Sq, a.H, a.B, q_rows) ||
      !map_bshd(&mk, a.k, a.ks, a.Sk, a.Hkv, a.B, kv_rows) ||
      !map_bshd(&mv, a.v, a.vs, a.Sk, a.Hkv, a.B, kv_rows) ||
      (kind != kFwd &&
       !map_bshd(&mdo, a.dout, a.dos, a.Sq, a.H, a.B, q_rows)))
    return kBadArg;
  if (a.causal && a.Sq != a.Sk)
    return launch_wgmma_kernel<true>(kind, a, mq, mk, mv, mdo, stream);
  return launch_wgmma_kernel<false>(kind, a, mq, mk, mv, mdo, stream);
}

int dispatch(int kind, const Args& a, int D, int kernel,
             cudaStream_t stream) {
  // a call with a bias or dropout runs flash_attention_extra.cu's kernels
  if (a.bias != nullptr || a.threshold != 0) return kBadArg;
  if (kernel == kFmaF32) return launch_d<float, false>(kind, D, a, stream);
  if (kernel == kFmaBf16)
    return launch_d<__nv_bfloat16, false>(kind, D, a, stream);
  if (kernel == kWgmmaBf16 && D == kD) return launch_wgmma(kind, a, stream);
  return kBadArg;
}

}  // namespace
