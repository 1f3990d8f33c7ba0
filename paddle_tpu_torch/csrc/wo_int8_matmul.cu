// Weight-only int8 matrix product, W8A16 (kernel Q1, the port's own).
//
//   y (M, N) = cast_x( (x (M, K) @ float(wq (K, N) int8)) * scale (N,) )
//
// with the products accumulated in fp32, the per-output-channel scale
// applied to the fp32 result, and y in x's dtype (bf16 or fp32).
//
// Stands in for paddle_tpu/quantization/int8.py:88 `matmul_wo_int8`.
// The JAX package leaves that product to XLA, which fuses the int8 ->
// x.dtype convert into the dot's operand read, so device memory sees
// int8 bytes; no Pallas kernel computes it.  Eager PyTorch would
// dequantise, write the bf16 matrix back and read it again (more bytes
// than the bf16 weight itself), hence a kernel of the port's own.
//
// Bound.  At the serving row counts (M = 8 a decode step, 8 x W a verify,
// 128 a prefill chunk) the product is bound by the weight's bytes:
// K * N int8 + 4 N of scales + M * K * sizeof(x) + M * N * sizeof(y),
// over 3.35 TB/s on an H100 SXM.  2 * M * K * N operations at 989
// TFLOP/s (bf16) pass the byte time from M ~ 200 on (the whole-bucket
// prefill, M 2048, is bound by them).
//
// bf16: q1_wgmma_kernel<NW>, Hopper's warpgroup MMA with the weight as
// the register operand ("swap AB"): y^T = W^T x^T.  What it does about
// each cause of the earlier mma.sync kernel's slowness:
//   * Tensor cores: wgmma m64nNWk16, A = the converted weight in
//     registers, B = x.  The weight's output channels ride wgmma's 64-row
//     M: a block has two consumer warpgroups of 64 channels each (128
//     channels) and a producer warp.  x is the B operand, K-major, NW of
//     its rows a block (wgmma's N: M rounded up to 8, 16, 32, 64, 128 or
//     256; rows past M are TMA's zero fill).  For M <= 256 there is one
//     row tile, so W is read from device memory exactly once a call, and
//     at decode (M 8) no tensor-core row is padding.  Past 256 rows the
//     row tiles are 256 wide and sit next to each other in the grid (row
//     tile fastest), so a W tile's 8 readers at M 2048 find it in L2 and
//     each W tile is converted 8 times there, not 32.
//   * No per-byte loads: W is stored in fragment order (ops/
//     wo_int8_matmul.py `pack_weight`, made once by
//     `collect_decode_state` on the card): for each 64 channels and 32 k,
//     128 runs of 16 bytes, run j holding exactly the 16 int8 values
//     thread j of the warpgroup needs for two k16 steps of its A
//     fragments.  A stage of the ring holds, per warpgroup, one
//     contiguous span of W, copied by one bulk copy (cp.async.bulk, no
//     tensor map), and x's boxes of NW rows x 128 bytes (TMA, 128-byte
//     swizzle).  A thread takes a chunk's 16 bytes with one 16-byte
//     shared load (all of a stage's at once), no bank conflicts.
//   * Conversion by integer and bit operations, no I2F / F2F: u = q ^
//     0x80 (q + 128), prmt u into the fp32 pattern 0x4B0000uu (2^23 + u),
//     subtract 2^23 + 128 (exact: q), and take the high halves of two
//     such fp32 values as one bf16x2 (exact for |q| <= 128: 8
//     significant bits).  Per 4 weights: one lop3, 6 prmt, 4 fadd.  A
//     warpgroup converts the next 64 k (four k16 steps) while the last
//     four wgmma run: A fragments alternate between two register sets.
//   * One launch a product, and one for q / k / v (`Segs`: up to three
//     products of one x side by side in the grid).  K is split only where
//     the grid has fewer 128-channel tiles than the 132 SMs (`split_k`, a
//     function of the shapes alone) and merged in the same launch: each
//     split writes its fp32 partial tile, a per-tile arrival counter picks
//     the last block, which sums the partials in split order (16 loads in
//     flight), scales, writes y and resets its counter to 0 for the next
//     call or replay.  No atomics on data: two calls, and a graph replay
//     and the eager call, are bitwise equal.  The partials come from the
//     caller's allocator (the graph's pool under capture); the counters
//     are one zeroed buffer a device that the kernel leaves zeroed.
//   * Programmatic dependent launch: each block calls
//     `griddepcontrol.launch_dependents` as it starts, so the next
//     product's blocks take SMs as this grid frees them; its producer puts
//     the first stages' W copies in flight before `griddepcontrol.wait`
//     (W does not depend on the kernel before), and only x's copies wait.
//     Every thread waits before it touches y, the partials or the
//     counters.  (Triggering after the main loop instead measured 2-3 %
//     slower at M 8 on an H100: tools/q1_sweep.py.)
//
// Where the time goes at M 8 (tools/q1_sweep.py's variants, H100 SXM):
// the weight stream with the conversion and no tensor cores takes ~20 us
// for a 4096 x 14336 product (2.9 TB/s), the conversion alone ~10 us and
// hides under the stream; the tensor cores add ~5 us: at 8 rows a
// register-operand wgmma keeps the pipe busy about as long as its 64 x
// 16 weights take to arrive.
// At 256 rows the 128 accumulators a thread need more registers than an
// even share: there the producer is a whole warpgroup that gives its
// registers to the consumers (setmaxnreg 40 / 232).
//
// fp32: q1_f32_kernel on the CUDA cores (the fp32 debug models): one
// thread per output column, 8 rows a block, x's tile staged in shared
// memory, W in the `[in, out]` layout read as bytes (coalesced along N);
// its split partials are summed in split order by q1_merge_kernel.
//
// C interface (ctypes, see ops/wo_int8_matmul.py): x_dtype 0 = float32,
// 1 = bfloat16; `count` products of one x, each (w, scale, y, N).  bf16:
// up to three, each w packed (ceil(N / 64), K / 32, 128, 16), K % 64 ==
// 0, `arrivals` holds zeroed counters (at least one per output tile when
// splits > 1).  fp32: one, w `[in, out]`.  Every pointer 16-byte
// aligned.  `work` holds the split partials (unused when splits == 1).
// Returns the launch's cudaError_t.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ============================================= bf16: wgmma, swap AB

constexpr int kChunk = 2048;     // packed bytes of 64 channels x 32 k
constexpr int kWG = 2;           // consumer warpgroups a block
constexpr int kBN = 64 * kWG;    // output channels a block
constexpr int kConsumers = 128 * kWG;

// NW: x rows a block (wgmma's N); kK: k a stage (a multiple of 64), through
// a ring of ~200 KB, one block an SM.
template <int NW>
struct Shape {
  static constexpr bool kBig = NW > 128;
  static constexpr int kThreads = kConsumers + (kBig ? 128 : 32);
  static constexpr int kK = NW <= 128 ? 128 : 64;
  static constexpr int kX = NW * kK * 2;          // kK / 64 boxes of NW rows
  static constexpr int kW = kBN * kK;             // kWG spans of 64 kK bytes
  static constexpr int kStage = kX + kW;          // a multiple of 1024
  static constexpr int kRing = 200 * 1024;
  static constexpr int kStages = kRing / kStage < 8 ? kRing / kStage : 8;
  static constexpr int kBytes = kStages * kStage + 1024 + 2 * kStages * 8;
};
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Up to three products that share x (q / k / v) in one launch: segment
// i owns 128-channel tiles [tile0[i], tile0[i + 1]) of the grid.
constexpr int kMaxSegs = 3;
struct Segs {
  const int8_t* w[kMaxSegs];      // packed weights
  const float* scale[kMaxSegs];
  bf16* y[kMaxSegs];
  int n[kMaxSegs];                // output channels
  int tile0[kMaxSegs + 1];
  int count;
};

// d (64 x NW fp32, the warpgroup's accumulator) += A (64 x 16, bf16
// fragments in registers) B (16 x NW, K-major in shared memory)
template <int NW>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void rs(float (&d)[4],
                                         const uint32_t* a,
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void rs(float (&d)[8],
                                         const uint32_t* a,
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void rs(float (&d)[16],
                                         const uint32_t* a,
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        " %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void rs(float (&d)[32],
                                         const uint32_t* a,
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        " %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void rs(float (&d)[64],
                                         const uint32_t* a,
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        " %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void rs(float (&d)[128],
                                         const uint32_t* a,
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        " %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};


// 4 int8 weights (bytes b0..b3 of q) -> two bf16x2: lo = (b0, b2),
// hi = (b1, b3), each value exact
__device__ __forceinline__ void cvt4(uint32_t q, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;             // q + 128, as unsigned
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  lo = __byte_perm(__float_as_uint(f0 - 8388736.f),
                   __float_as_uint(f1 - 8388736.f), 0x7632);
  hi = __byte_perm(__float_as_uint(f2 - 8388736.f),
                   __float_as_uint(f3 - 8388736.f), 0x7632);
}

// 1-D bulk copy of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// the consumer warpgroups only (the producer has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// One 32-k chunk of a warpgroup: its 16 bytes of W -> A fragments of two
// k16 steps, two wgmma against x's k16 steps kk, kk + 1, then wait until
// only this chunk's wgmma are in flight (the chunk before is done: its A
// registers and its stage's x may be reused).
template <int NW>
__device__ __forceinline__ void chunk(float (&acc)[NW / 2], uint32_t (&a)[8],
                                      const unsigned char* w,
                                      const unsigned char* xs, int kk) {
  const uint4 v = *reinterpret_cast<const uint4*>(w);
  cvt4(v.x, a[0], a[1]);
  cvt4(v.y, a[2], a[3]);
  cvt4(v.z, a[4], a[5]);
  cvt4(v.w, a[6], a[7]);
  fence_regs(a);
  wgmma_fence();
  // x's k16 step kk: box kk / 4 of NW rows x 128 bytes, 32 bytes a step
  Wgmma<NW>::rs(acc, a,
                wg_desc(xs + (kk >> 2) * NW * 128 + (kk & 3) * 32, 16, 1024));
  Wgmma<NW>::rs(acc, a + 4,
                wg_desc(xs + ((kk + 1) >> 2) * NW * 128 + ((kk + 1) & 3) * 32,
                        16, 1024));
  wgmma_commit();
  wgmma_wait<1>();
  fence_acc(acc);
}

// Two 32-k chunks (one 64-k box of x, k16 steps kk .. kk + 3): their 32
// bytes of W -> A fragments of four k16 steps, four wgmma, then wait
// until only these are in flight.
template <int NW>
__device__ __forceinline__ void pair(float (&acc)[NW / 2], uint32_t (&a)[16],
                                     const uint4& v0, const uint4& v1,
                                     const unsigned char* xs, int kk) {
  cvt4(v0.x, a[0], a[1]);
  cvt4(v0.y, a[2], a[3]);
  cvt4(v0.z, a[4], a[5]);
  cvt4(v0.w, a[6], a[7]);
  cvt4(v1.x, a[8], a[9]);
  cvt4(v1.y, a[10], a[11]);
  cvt4(v1.z, a[12], a[13]);
  cvt4(v1.w, a[14], a[15]);
  fence_regs(a);
  wgmma_fence();
  const unsigned char* box = xs + (kk >> 2) * NW * 128;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    Wgmma<NW>::rs(acc, a + 4 * u, wg_desc(box + 32 * u, 16, 1024));
  wgmma_commit();
  wgmma_wait<1>();
  fence_acc(acc);
}

// A block per (NW rows of x, 128 channels, split of K), rows fastest.
template <int NW>
__global__ void __launch_bounds__(Shape<NW>::kThreads, 1)
    q1_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ Segs segs,
                    float* __restrict__ work, int* __restrict__ arrivals,
                    int M, int K, int tiles_per_split) {
  using S = Shape<NW>;
  constexpr int St = S::kStages, CT = kConsumers;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int last;
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + St * S::kStage);
  uint64_t* empty = full + St;

  int seg = 0;                                  // this block's product
  const int by = blockIdx.y;
  while (seg + 1 < segs.count && by >= segs.tile0[seg + 1]) ++seg;
  const int N = segs.n[seg];
  const int m0 = blockIdx.x * NW, nb = by - segs.tile0[seg];
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int kt0 = split * tiles_per_split;
  const int nt = min((K + S::kK - 1) / S::kK, kt0 + tiles_per_split) - kt0;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < St; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the next product may launch now: its blocks take SMs as this grid's
  // free them and start their W streams, waiting for this grid's end
  // only for x
  griddep_launch_dependents();

  if (threadIdx.x >= CT) {                      // producer
    if (S::kBig)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    if (threadIdx.x == CT) {
      const int n_live = min(kWG, (N + 63) / 64 - kWG * nb);
      const int8_t* wt =
          segs.w[seg] + static_cast<size_t>(kWG * nb) * (K / 32) * kChunk;
      auto span = [&](int s) { return min(S::kK, K - (kt0 + s) * S::kK); };
      auto issue_w = [&](int s, int slot) {
        const int k0 = (kt0 + s) * S::kK;
        unsigned char* dst = ring + slot * S::kStage + S::kX;
        for (int c = 0; c < n_live; ++c)
          bulk_g2s(dst + c * 64 * S::kK,
                   wt + (static_cast<size_t>(c) * (K / 32) + k0 / 32) * kChunk,
                   span(s) / 32 * kChunk, full + slot);
      };
      auto issue_x = [&](int s, int slot) {
        const int k0 = (kt0 + s) * S::kK;
        unsigned char* dst = ring + slot * S::kStage;
        for (int b = 0; 64 * b < span(s); ++b)
          tma_2d(dst + b * NW * 128, &map_x, full + slot, k0 + 64 * b, m0);
      };
      auto expect = [&](int s, int slot) {
        mbar_expect_tx(full + slot, n_live * (span(s) / 32) * kChunk +
                                        (span(s) / 64) * NW * 128);
      };
      const int pre = min(nt, St);
      for (int s = 0; s < pre; ++s) {     // W does not wait for x's writer
        expect(s, s);
        issue_w(s, s);
      }
      griddep_wait();
      for (int s = 0; s < pre; ++s) issue_x(s, s);
      for (int s = pre; s < nt; ++s) {
        const int slot = s % St;
        mbar_wait(empty + slot, (s / St - 1) & 1);
        expect(s, slot);
        issue_w(s, slot);
        issue_x(s, slot);
      }
    }
    return;
  }

  if (S::kBig)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
  const int wg = warp / 4, lane = threadIdx.x % 32;
  const bool lead = lane == 0;
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  int pending = -1;          // a stage whose last wgmma may still run
  auto release = [&]() {
    if (pending >= 0 && lead) mbar_arrive(empty + pending);
    pending = -1;
  };
  for (int s = 0; s < nt; ++s) {
    const int slot = s % St;
    const int chunks = min(S::kK, K - (kt0 + s) * S::kK) / 32;   // even
    mbar_wait(full + slot, (s / St) & 1);
    const unsigned char* xs = ring + slot * S::kStage;
    const unsigned char* ws =
        xs + S::kX + wg * 64 * S::kK + (threadIdx.x % 128) * 16;
    if constexpr (S::kK == 128) {
      // the stage's W at once, then two pairs of chunks whose A
      // fragments take two register sets in turn
      uint4 v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < chunks)
          v[c] = *reinterpret_cast<const uint4*>(ws + c * kChunk);
      uint32_t a0[16], a1[16];
      pair<NW>(acc, a0, v[0], v[1], xs, 0);
      release();
      if (chunks > 2) pair<NW>(acc, a1, v[2], v[3], xs, 4);
    } else {
      uint32_t a0[8], a1[8];
      chunk<NW>(acc, a0, ws, xs, 0);
      release();
      chunk<NW>(acc, a1, ws + kChunk, xs, 2);
    }
    pending = slot;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  griddep_wait();          // y, the partials and the counters are free

  if (splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int ct = threadIdx.x;                 // a consumer: < CT
    float4* part = reinterpret_cast<float4*>(work) +
                   static_cast<size_t>(tile) * splits * (NW / 8) * CT;
    float4* mine = part + static_cast<size_t>(split) * (NW / 8) * CT;
#pragma unroll
    for (int q = 0; q < NW / 8; ++q)
      __stcg(mine + q * CT + ct,
             make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                         acc[4 * q + 3]));
    __threadfence();
    consumers_sync();
    if (ct == 0) last = atomicAdd(arrivals + tile, 1) == splits - 1;
    consumers_sync();
    if (!last) return;
    __threadfence();
    // the partials in split order, 16 float4 loads in flight at once
    constexpr int QB = NW / 8 < 4 ? NW / 8 : 4;
    constexpr int SU = 16 / QB;
#pragma unroll
    for (int q0 = 0; q0 < NW / 8; q0 += QB) {
      float4 sum[QB];
#pragma unroll
      for (int u = 0; u < QB; ++u) sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp0 = 0; sp0 < splits; sp0 += SU) {
        float4 p[SU][QB];
#pragma unroll
        for (int j = 0; j < SU; ++j)
#pragma unroll
          for (int u = 0; u < QB; ++u)
            if (sp0 + j < splits)
              p[j][u] = __ldcg(part + (static_cast<size_t>(sp0 + j) *
                                           (NW / 8) + q0 + u) * CT + ct);
#pragma unroll
        for (int j = 0; j < SU; ++j)
#pragma unroll
          for (int u = 0; u < QB; ++u)
            if (sp0 + j < splits) {
              sum[u].x += p[j][u].x;
              sum[u].y += p[j][u].y;
              sum[u].z += p[j][u].z;
              sum[u].w += p[j][u].w;
            }
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        acc[4 * (q0 + u)] = sum[u].x;
        acc[4 * (q0 + u) + 1] = sum[u].y;
        acc[4 * (q0 + u) + 2] = sum[u].z;
        acc[4 * (q0 + u) + 3] = sum[u].w;
      }
    }
    if (ct == 0) arrivals[tile] = 0;            // for the next call
  }

  // accumulator (i, h, e): channel row g + 8 h of the warp's 16, x row
  // 8 i + 2 t + e
  const int g = lane / 4, t = lane % 4;
  const int n_base = nb * kBN + wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n_base + 8 * h;
    if (n >= N) continue;
    const float sc = segs.scale[seg][n];
#pragma unroll
    for (int i = 0; i < NW / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * i + 2 * t + e;
        if (m < M)
          segs.y[seg][static_cast<size_t>(m) * N + n] =
              __float2bfloat16_rn(acc[4 * i + 2 * h + e] * sc);
      }
  }
}

template <int NW>
cudaError_t launch_wgmma(const void* x, const Segs& segs, float* work,
                         int* arrivals, int M, int K, int splits, int per,
                         cudaStream_t stream) {
  using S = Shape<NW>;
  static bool configured = false;   // the shared-memory limit, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        q1_wgmma_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap map_x;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {64, NW};
  if (!make_map(&map_x, x, 2, dims, strides, box))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + NW - 1) / NW, segs.tile0[segs.count], splits);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, q1_wgmma_kernel<NW>, map_x, segs, work,
                            arrivals, M, K, per);
}

cudaError_t launch_bf16(const void* x, const Segs& segs, float* work,
                        int* arrivals, int M, int K, int splits, int per,
                        cudaStream_t stream) {
#define Q1_ARGS x, segs, work, arrivals, M, K, splits, per, stream
  if (M <= 8) return launch_wgmma<8>(Q1_ARGS);
  if (M <= 16) return launch_wgmma<16>(Q1_ARGS);
  if (M <= 32) return launch_wgmma<32>(Q1_ARGS);
  if (M <= 64) return launch_wgmma<64>(Q1_ARGS);
  if (M <= 128) return launch_wgmma<128>(Q1_ARGS);
  return launch_wgmma<256>(Q1_ARGS);
#undef Q1_ARGS
}

// ================================================ fp32: CUDA cores

constexpr int kF32Threads = 128;
constexpr int kF32Cols = 128;        // columns of y a block
constexpr int kF32K = 64;            // K rows a stage
constexpr int kF32Rows = 8;          // rows of y a block

// One thread per column, kF32Rows rows a block.
__global__ void __launch_bounds__(kF32Threads)
    q1_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y,
                  float* __restrict__ work, int M, int K, int N,
                  int tiles_per_split) {
  __shared__ float xs[kF32Rows][kF32K];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kF32Cols + tid, m0 = blockIdx.y * kF32Rows;
  const int split = blockIdx.z;
  const int kbeg = split * tiles_per_split * kF32K;
  const int kend = min(K, kbeg + tiles_per_split * kF32K);
  float acc[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) acc[r] = 0.f;
  for (int k0 = kbeg; k0 < kend; k0 += kF32K) {
    __syncthreads();
    for (int i = tid; i < kF32Rows * kF32K; i += kF32Threads) {
      const int r = i / kF32K, c = i % kF32K;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < kend) ? x[(size_t)m * K + k] : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int kn = min(kF32K, kend - k0);
      for (int c = 0; c < kn; ++c) {
        const float wv = static_cast<float>(w[(size_t)(k0 + c) * N + n]);
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) acc[r] = fmaf(xs[r][c], wv, acc[r]);
      }
    }
  }
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
    if (work != nullptr)
      work[((size_t)split * M + m) * N + n] = acc[r];
    else
      y[(size_t)m * N + n] = acc[r] * scale[n];
  }
}

// y = sum over splits, in split order, of the partials * scale.
__global__ void q1_merge_kernel(const float* __restrict__ work,
                                const float* __restrict__ scale,
                                float* __restrict__ y, int M, int N,
                                int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += work[k * total + i];
  y[i] = s * scale[i % N];
}

cudaError_t launch_f32(const void* x, const void* w, const void* scale,
                       void* y, float* work, int M, int K, int N, int splits,
                       int per, cudaStream_t stream) {
  const dim3 grid((N + kF32Cols - 1) / kF32Cols,
                  (M + kF32Rows - 1) / kF32Rows, splits);
  q1_f32_kernel<<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y),
      splits > 1 ? work : nullptr, M, K, N, per);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && splits > 1) {
    const size_t total = (size_t)M * N;
    q1_merge_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                      stream>>>(work, static_cast<const float*>(scale),
                                static_cast<float*>(y), M, N, splits);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Products i < count (count 1, or up to 3 with bf16 x) of one x: weight
// w_i, scale s_i, output y_i of n_i channels.
extern "C" int wo_int8_matmul(const void* x, int count, const void* w0,
                              const void* s0, void* y0, int n0,
                              const void* w1, const void* s1, void* y1,
                              int n1, const void* w2, const void* s2,
                              void* y2, int n2, void* work, void* arrivals,
                              int M, int K, int splits, int tiles_per_split,
                              int x_dtype, int device, void* stream_ptr) {
  const int tk = x_dtype == 1 ? (M <= 128 ? 128 : 64) : kF32K;
  const int kt = (K + tk - 1) / tk;
  if (M <= 0 || K <= 0 || count < 1 || count > kMaxSegs ||
      (x_dtype == 0 && count != 1) || splits <= 0 || tiles_per_split <= 0 ||
      (long long)splits * tiles_per_split < kt ||
      (long long)(splits - 1) * tiles_per_split >= kt ||
      (splits > 1 && work == nullptr) || (x_dtype != 0 && x_dtype != 1) ||
      (x_dtype == 1 && (K % 64 || arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Segs segs = {{static_cast<const int8_t*>(w0), static_cast<const int8_t*>(w1),
                static_cast<const int8_t*>(w2)},
               {static_cast<const float*>(s0), static_cast<const float*>(s1),
                static_cast<const float*>(s2)},
               {static_cast<bf16*>(y0), static_cast<bf16*>(y1),
                static_cast<bf16*>(y2)},
               {n0, n1, n2},
               {0, 0, 0, 0},
               count};
  for (int i = 0; i < count; ++i) {
    if (segs.n[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    segs.tile0[i + 1] = segs.tile0[i] + (segs.n[i] + kBN - 1) / kBN;
  }
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* ws = static_cast<float*>(work);
  const cudaError_t err =
      x_dtype == 1
          ? launch_bf16(x, segs, ws, static_cast<int*>(arrivals), M, K,
                        splits, tiles_per_split, stream)
          : launch_f32(x, w0, s0, y0, ws, M, K, n0, splits, tiles_per_split,
                       stream);
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
