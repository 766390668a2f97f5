// The Hopper mainloop of the 2-byte attention forwards: kernel #1's two-pass
// exact softmax (sd_attention.cu) in bf16 and f16, and kernel #4's one-pass
// online softmax at d = 128 and 256 in bf16 (flash_attention.cu). A plan is
// a `Cfg` (bf16) or a `CfgF16` (the same plan on f16 operands: `wgmma`
// `.f32.f16.f16` in the same shapes, f16 tensor maps, p and o rounded to
// f16); everything else is the same code. It takes the 2-byte packing and the
// quad reductions from sd_attention_common.cuh, which does not include it,
// so #2's build does not move with it, and the PTX wrappers (mbarriers, TMA,
// the wgmma fence and waits) from sm90_ptx.cuh, which the conv mainloop
// shares.
//
// What bounds it: at d = 128 and 256 the tensor cores (4 L^2 d operations
// against 4 L d bytes per head); at d <= 80 the softmax, two exps a logit in
// two-pass mode on the MUFU pipe (16 a clock an SM), which runs in step
// with the products rather than beside them.
//
// The grid is persistent: at most CTAS blocks an SM, each walking (q tile,
// head, batch) items. A block has two consumer warpgroups and a producer:
//   - the producer (warpgroup 2, or one warp when CTAS = 2) fills a ring
//     of STAGES K/V stages in dynamic shared memory, and each item's q tile,
//     with `mbarrier`s (full: the stage holds its tile; empty: both
//     consumers are done with it; qfull / qempty for the q tile); the
//     ring's stages and phases run on across items, so the next item's
//     loads overlap the last one's end;
//   - warpgroups 0 and 1, the consumers, own 64 q rows each. Per K tile
//     S = Q.K^T is `wgmma.m64nBKk16` with both operands in shared memory
//     (K read K-major); p is formed in registers from the f32 accumulator
//     and goes, rounded to the input dtype, straight into the A registers of
//     O += P.V, `wgmma` with A from registers and V read MN-major through
//     the instruction's transpose flag (no V transpose anywhere).
// With one block an SM, `setmaxnreg` moves registers from the producer to
// the consumers: 56 / 224 where their S and O accumulators are up to 64 +
// 64 floats a thread, 40 / 232 at d = 256, where O alone is 128 floats a
// thread beside S's 32 (64-key tiles) and p's 16 bf16 A registers. With two
// blocks an SM (d = 64, 64-key tiles), 112 registers a thread suffice, and
// the two blocks' items run out of step with each other.
//
// Two ways to fill the ring, chosen per head dim at compile time:
//   - TMA (d = 64, 128 and 256, where a head's row is one, two or four
//     128-byte swizzle rows): one thread issues `cp.async.bulk.tensor.4d`
//     loads of 64-column boxes through a (d, L, H, B) tensor map built on
//     the host per launch, so a box over a head view never reads the next
//     head's columns, and rows past L arrive as zeros. The tiles are 128-byte
//     swizzled and the descriptors say so. At d = 256 (#4) a 128-row q tile
//     is 64 KB and a stage of 64 keys of K and V another 64 KB: two stages
//     fit the 200 KB budget.
//   - cp.async (every other d the gate takes, 8..120 in steps of 8): the
//     producer's threads issue 16-byte copies with zero-fill into the
//     canonical no-swizzle layout (8 x 16-byte core matrices, 128
//     contiguous bytes each), so the pad columns up to the next multiple of
//     16 and rows past L are zeros. Each thread waits for its own copies,
//     fences them into the async proxy that `wgmma` reads through, and
//     arrives on the stage's full barrier. The no-swizzle layout holds any
//     multiple of 8 columns, so every d keeps `wgmma`; no `ldmatrix` +
//     `mma.sync` variant is needed.
//
// Masking: keys at or past Lk get -inf logits; q rows past Lq are computed
// from zero rows and not stored. Every barrier wait gives up after about
// ten seconds with a trap, so a fault in the ring fails the launch instead
// of hanging the card.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "sd_attention_common.cuh"
#include "sm90_ptx.cuh"

namespace sm90 {

constexpr int QROWS = 128;       // q rows per block
constexpr int WG = 128;          // threads per warpgroup
constexpr int SMEM_BUDGET = 200 * 1024;  // an SM's, split between its blocks




struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* ml;  // one-pass: (2, B, H, Lq) f32 residuals m and l, or null
  int Lq, Lk, d, B, H;
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, ob, oh, ol;  // element strides
  float scale;
};

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, layout (0: no swizzle, 1: 128-byte swizzle)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// ---------------------------------------------------------------------------
// wgmma (m64nNk16, bf16 or f16 (F16) in, f32 accumulate)
// ---------------------------------------------------------------------------

// D(64 x 64, f32) (+)= A(64 x 16, smem) * B(16 x 64, smem), both K-major
template <bool F16 = false>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int accumulate) {
#define WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(accumulate))
  if constexpr (F16)
    WGMMA_SS_N64("f16");
  else
    WGMMA_SS_N64("bf16");
#undef WGMMA_SS_N64
}

// D(64 x 128, f32) (+)= A(64 x 16, smem) * B(16 x 128, smem), both K-major
template <bool F16 = false>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int accumulate) {
#define WGMMA_SS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(accumulate))
  if constexpr (F16)
    WGMMA_SS_N128("f16");
  else
    WGMMA_SS_N128("bf16");
#undef WGMMA_SS_N128
}

// D(64 x 16, f32) += A(64 x 16, registers) * B(16 x 16, smem, MN-major)
template <bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t (&a)[4], uint64_t b) {
#define WGMMA_RS_N16(TY) \
  asm volatile( \
      "{\nwgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
  if constexpr (F16)
    WGMMA_RS_N16("f16");
  else
    WGMMA_RS_N16("bf16");
#undef WGMMA_RS_N16
}

// D(64 x 32, f32) += A(64 x 16, registers) * B(16 x 32, smem, MN-major)
template <bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t b) {
#define WGMMA_RS_N32(TY) \
  asm volatile( \
      "{\nwgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
  if constexpr (F16)
    WGMMA_RS_N32("f16");
  else
    WGMMA_RS_N32("bf16");
#undef WGMMA_RS_N32
}

// D(64 x 64, f32) += A(64 x 16, registers) * B(16 x 64, smem, MN-major)
template <bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t b) {
#define WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\nwgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
  if constexpr (F16)
    WGMMA_RS_N64("f16");
  else
    WGMMA_RS_N64("bf16");
#undef WGMMA_RS_N64
}

// D(64 x 128, f32) += A(64 x 16, registers) * B(16 x 128, smem, MN-major)
template <bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t b) {
#define WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\nwgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
  if constexpr (F16)
    WGMMA_RS_N128("f16");
  else
    WGMMA_RS_N128("bf16");
#undef WGMMA_RS_N128
}

// ---------------------------------------------------------------------------
// layouts
// ---------------------------------------------------------------------------

// Head-dim padding and tile shapes for one instantiation. cp.async tiles:
// row r, column c of a tile lies at byte (r / 8) * DP * 16 + (c / 8) * 128 +
// (r % 8) * 16 + (c % 8) * 2: core matrices of 8 rows x 16 bytes, the DP / 8
// of one 8-row group side by side. TMA tiles: 64-column boxes, each ROWS x
// 128 bytes with the 128-byte swizzle, one after the other.
template <int DP_, int BK_, bool TMA_, bool TWO_PASS_, int CTAS_>
struct Cfg {
  static constexpr int DP = DP_;  // d rounded up to 16
  static constexpr int BK = BK_;  // keys per K/V tile
  static constexpr bool TMA = TMA_;  // else cp.async
  static constexpr bool TWO_PASS = TWO_PASS_;
  // blocks an SM: 1 with a producer warpgroup and setmaxnreg (consumers up
  // to 224 registers), or 2 with a producer warp (at most 112 registers a
  // thread), whose items run out of step with each other
  static constexpr int CTAS = CTAS_;
  static constexpr int PRODUCER = CTAS == 1 ? WG : 32;  // producer threads
  static constexpr int THREADS = 2 * WG + PRODUCER;     // consumers first
  // setmaxnreg with one block an SM: 2 x 128 x CONSUMER_REGS + 128 x
  // PRODUCER_REGS may not pass the block's 384 x 168
  static constexpr int CONSUMER_REGS = DP == 256 ? 232 : 224;
  static constexpr int PRODUCER_REGS = DP == 256 ? 40 : 56;
  static constexpr int Q_BYTES = QROWS * DP * 2;
  static constexpr int TILE_BYTES = BK * DP * 2;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K then V
  static constexpr int STAGES_FIT = (SMEM_BUDGET / CTAS - 2048 - Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
  static constexpr int SMEM = 1024 /* align */ + 1024 /* barriers */ + Q_BYTES +
                              STAGES * STAGE_BYTES;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(!TMA || DP == 64 || DP == 128 || DP == 256, "TMA boxes are 64 columns");
  static_assert(DP <= 128 || (TMA && !TWO_PASS && CTAS == 1), "d = 256 is #4's one pass");
  static_assert(TMA || CTAS == 1, "a producer warp issues TMA only");
  static constexpr bool F16 = false;  // bf16 operands
};

// the same plan on f16 operands (kernel #1 under `precision: fp16`)
template <int DP_, int BK_, bool TMA_, bool TWO_PASS_, int CTAS_>
struct CfgF16 : Cfg<DP_, BK_, TMA_, TWO_PASS_, CTAS_> {
  static_assert(TWO_PASS_ && DP_ <= 128, "f16 is #1's two-pass forward");
  static constexpr bool F16 = true;
};

// the tensor maps' element type of a plan (2-byte elements either way)
template <bool F16>
constexpr CUtensorMapDataType map_type() {
  return F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// K-major operand (q rows or keys x head dim), k16 step kk, from the row
// group rg0 on
template <class C>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int rg0, int kk) {
  if constexpr (C::TMA) {
    // box kk / 4, 32 bytes a k16 step inside the swizzled 128-byte row; 8-row
    // groups 1024 bytes apart
    return make_desc(tile + (kk / 4) * rows * 128 + rg0 * 1024 + (kk % 4) * 32, 16, 1024, 1);
  } else {
    // core matrices 128 bytes apart along d (leading), DP * 16 along rows (stride)
    return make_desc(tile + rg0 * C::DP * 16 + kk * 256, 128, C::DP * 16, 0);
  }
}

// V as the MN-major B operand of P.V: keys kc*16.. (K dim), columns n0.. (N)
template <class C>
__device__ __forceinline__ uint64_t vmajor_desc(uint32_t tile, int kc, int n0) {
  if constexpr (C::TMA) {
    // a box's 64 columns are one swizzled 128-byte row per key; 8-key groups
    // 1024 bytes apart (stride), the next 64 columns one box on (leading)
    return make_desc(tile + (n0 / 64) * C::BK * 128 + kc * 2048, C::BK * 128, 1024, 1);
  } else {
    // 8-key groups DP * 16 apart (leading, the K dim), 8-column groups 128
    // bytes apart (stride, the N dim)
    return make_desc(tile + kc * 2 * C::DP * 16 + (n0 / 8) * 128, C::DP * 16, 128, 0);
  }
}

// cp.async: rows row0.. (ROWS of them, at most nrows) x DP columns (d valid)
// of src into a no-swizzle tile, by the 128 producer threads. Chunk i of the
// tile (16 bytes at byte 16 i) is row (i / DP) * 8 + i % 8, column group
// (i / 8) % (DP / 8): eight neighbouring threads take eight rows of one
// column group, so the stores fill 128 contiguous bytes and each row's
// 16-byte reads pair up into 32-byte sectors.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long row_stride,
                                          int row0, int nrows, int d, int tid) {
#pragma unroll 4
  for (int i = tid; i < ROWS * DP / 8; i += THREADS) {
    const int row = row0 + (i / DP) * 8 + (i % 8);
    const int col = ((i / 8) % (DP / 8)) * 8;
    const bool valid = row < nrows && col < d;
    cp_async16(dst + 16 * i, valid ? src + (long long)row * row_stride + col : src, valid);
  }
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------

// s = this warpgroup's 64 q rows (from row group rg0 of the q tile) times
// the BK keys of the K tile, transposed; f32, unscaled (the first k16 step
// ignores what s held: scale-d = 0)
template <class C>
__device__ __forceinline__ void logits(float* s, uint32_t q_tile, int rg0, uint32_t k_tile) {
  fence_regs<C::BK / 2>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    const uint64_t a = kmajor_desc<C>(q_tile, QROWS, rg0, kk);
    const uint64_t b = kmajor_desc<C>(k_tile, C::BK, 0, kk);
    if constexpr (C::BK == 128)
      wgmma_ss_n128<C::F16>(s, a, b, kk > 0);
    else
      wgmma_ss_n64<C::F16>(s, a, b, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<C::BK / 2>(s);
}

// o[N0 / 2 ..] += p (k16 step kc, registers) . V[kc*16.., N0..]: the widest
// wgmma that fits what is left of DP, then the rest
template <class C, int N0>
__device__ __forceinline__ void pv_step(float* o, const uint32_t (&a)[4], uint32_t v_tile, int kc) {
  if constexpr (N0 < C::DP) {
    constexpr int REM = C::DP - N0;
    constexpr int W = REM >= 128 ? 128 : REM >= 64 ? 64 : REM >= 32 ? 32 : 16;
    const uint64_t b = vmajor_desc<C>(v_tile, kc, N0);
    if constexpr (W == 128)
      wgmma_rs_n128<C::F16>(o + N0 / 2, a, b);
    else if constexpr (W == 64)
      wgmma_rs_n64<C::F16>(o + N0 / 2, a, b);
    else if constexpr (W == 32)
      wgmma_rs_n32<C::F16>(o + N0 / 2, a, b);
    else
      wgmma_rs_n16<C::F16>(o + N0 / 2, a, b);
    pv_step<C, N0 + W>(o, a, v_tile, kc);
  }
}

template <class C>
__device__ __forceinline__ void pv(float* o, const uint32_t (&pa)[C::BK / 16][4], uint32_t v_tile) {
  fence_regs<C::DP / 2>(o);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < C::BK / 16; ++kc) pv_step<C, 0>(o, pa[kc], v_tile, kc);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<C::DP / 2>(o);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keys at or past Lk (only in a ragged last tile) -> -inf. Accumulator
// element 4j + e is row g (e < 2) or g + 8, key 8j + 2 t4 + (e & 1).
template <class C>
__device__ __forceinline__ void mask_keys(float* s, int kv0, int Lk, int t4) {
  if (kv0 + C::BK > Lk) {
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i)
      if (kv0 + (i / 4) * 8 + t4 * 2 + (i & 1) >= Lk) s[i] = -INFINITY;
  }
}

// the largest unscaled logit of rows g and g + 8 over this tile and m
__device__ __forceinline__ float2 tile_max(const float* s, int n, float m0, float m1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
  return make_float2(fmaxf(m0, quad_max(mx0)), fmaxf(m1, quad_max(mx1)));
}

// ---------------------------------------------------------------------------
// the two roles
// ---------------------------------------------------------------------------

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qfull;
  uint64_t* qempty;  // both consumers are done with the q tile
  uint32_t q_tile;
  uint32_t stages;  // stage s: K tile at stages + s * STAGE_BYTES, V tile TILE_BYTES on
};

// work item w of a launch: q tile w % nq of head (w / nq) % H of batch
// w / (nq H); neighbouring items share K/V in L2
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ Item item(const Params& p, int w) {
  const int nq = (p.Lq + QROWS - 1) / QROWS;
  return {(w % nq) * QROWS, (w / nq) % p.H, w / (nq * p.H)};
}

__device__ __forceinline__ int items(const Params& p) {
  return (p.Lq + QROWS - 1) / QROWS * p.H * p.B;
}

// The producer walks the block's items; the ring's stages and phases run on
// from one item to the next, so the next item's q tile and first K/V tiles
// load while the consumers finish the last one.
template <class C>
__device__ __forceinline__ void produce(const Params& p, const Ring& r, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv) {
  const int tid = threadIdx.x - 2 * WG;  // 0 .. PRODUCER - 1
  const int nt = (p.Lk + C::BK - 1) / C::BK;
  const int total = C::TWO_PASS ? 2 * nt : nt;
  int stage = 0, phase = 0, qphase = 0;
  if constexpr (C::TMA) {
    if (tid != 0) return;
    constexpr int BOXES = C::DP / 64, QBOX = QROWS * 128, KBOX = C::BK * 128;
    for (int w = blockIdx.x; w < items(p); w += gridDim.x, qphase ^= 1) {
      const Item it = item(p, w);
      mbar_wait(r.qempty, qphase ^ 1);
      mbar_expect_tx(r.qfull, C::Q_BYTES);
      for (int x = 0; x < BOXES; ++x)
        tma_load_4d(r.q_tile + x * QBOX, tq, r.qfull, x * 64, it.q0, it.h, it.b);
      for (int i = 0; i < total; ++i) {
        const bool with_v = !C::TWO_PASS || i >= nt;
        const int kv0 = (i < nt ? i : i - nt) * C::BK;
        mbar_wait(&r.empty[stage], phase ^ 1);
        mbar_expect_tx(&r.full[stage], with_v ? 2 * C::TILE_BYTES : C::TILE_BYTES);
        const uint32_t kt = r.stages + stage * C::STAGE_BYTES;
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(kt + x * KBOX, tk, &r.full[stage], x * 64, kv0, it.h, it.b);
          if (with_v)
            tma_load_4d(kt + C::TILE_BYTES + x * KBOX, tv, &r.full[stage], x * 64, kv0, it.h,
                        it.b);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // each thread publishes a group of its copies (a barrier's arrival)
    // once the group after it is issued, so two groups are in flight
    uint64_t* pending = nullptr;
    auto publish = [&](uint64_t* next) {
      if (pending != nullptr) {
        if (next != nullptr)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        fence_proxy_async();
        mbar_arrive(pending);
      }
      pending = next;
    };
    for (int w = blockIdx.x; w < items(p); w += gridDim.x, qphase ^= 1) {
      const Item it = item(p, w);
      const bf16* q = p.q + it.b * p.qb + it.h * p.qh;
      const bf16* k = p.k + it.b * p.kb + it.h * p.kh;
      const bf16* v = p.v + it.b * p.vb + it.h * p.vh;
      publish(nullptr);  // the consumers need every tile of the last item first
      mbar_wait(r.qempty, qphase ^ 1);
      load_tile<C::DP, QROWS, C::PRODUCER>(r.q_tile, q, p.ql, it.q0, p.Lq, p.d, tid);
      cp_async_commit();
      publish(r.qfull);
      for (int i = 0; i < total; ++i) {
        const bool with_v = !C::TWO_PASS || i >= nt;
        const int kv0 = (i < nt ? i : i - nt) * C::BK;
        mbar_wait(&r.empty[stage], phase ^ 1);
        const uint32_t kt = r.stages + stage * C::STAGE_BYTES;
        load_tile<C::DP, C::BK, C::PRODUCER>(kt, k, p.kl, kv0, p.Lk, p.d, tid);
        if (with_v)
          load_tile<C::DP, C::BK, C::PRODUCER>(kt + C::TILE_BYTES, v, p.vl, kv0, p.Lk, p.d, tid);
        cp_async_commit();
        publish(&r.full[stage]);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    publish(nullptr);
  }
}

// One item of one consumer warpgroup: both passes (or the one), then the
// rows' store
template <class C>
__device__ __forceinline__ void consume_item(const Params& p, const Ring& r, const Item& it,
                                             int rg0, int warp, int g, int t4, int nt,
                                             int& stage, int& phase, int qphase) {
  // Softmax in base 2 on the unscaled logits s: with c = scale * log2(e),
  // exp(scale s - scale M) = 2^(c s - c M), one FFMA and one ex2 a logit.
  // M is the running max of the unscaled logits (scale > 0, so scale M is
  // exactly the max of the scaled ones), l the sum of exp, both per row.
  const float c = p.scale * 1.4426950408889634f;
  float M0 = -INFINITY, M1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float sa[C::BK / 2];
  float o[C::DP / 2];
  uint32_t pa[C::BK / 16][4];

  auto tile = [&](int st) { return r.stages + st * C::STAGE_BYTES; };
  auto wait_full = [&](int st, int ph) {
    mbar_wait(&r.full[st], ph);
    if constexpr (!C::TMA) fence_proxy_async();
  };
  auto advance = [](int& st, int& ph) {
    if (++st == C::STAGES) {
      st = 0;
      ph ^= 1;
    }
  };
  // accumulator elements of two n8 blocks are the A registers of one k16 step
  auto pack = [&](const float* s) {
#pragma unroll
    for (int kc = 0; kc < C::BK / 16; ++kc) {
      pa[kc][0] = pack2<C::F16>(s[8 * kc], s[8 * kc + 1]);
      pa[kc][1] = pack2<C::F16>(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = pack2<C::F16>(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = pack2<C::F16>(s[8 * kc + 6], s[8 * kc + 7]);
    }
  };

  mbar_wait(r.qfull, qphase);
  if constexpr (!C::TMA) fence_proxy_async();

  if constexpr (C::TWO_PASS) {
    // pass 1: each row's max M and sum l, l rescaled when M grows
    for (int j = 0; j < nt; ++j) {
      wait_full(stage, phase);
      logits<C>(sa, r.q_tile, rg0, tile(stage));
      mbar_arrive(&r.empty[stage]);
      advance(stage, phase);
      mask_keys<C>(sa, j * C::BK, p.Lk, t4);
      const float2 mn = tile_max(sa, C::BK / 2, M0, M1);
      // the first tile always holds a valid key, so mn is finite from here on;
      // b = c M as a rounded product (a product fused into the rescale's
      // exponent would not round c M as the tile's exps take it)
      const float b0 = __fmul_rn(mn.x, c), b1 = __fmul_rn(mn.y, c);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < C::BK / 2; i += 4) {
        sum0 += ex2(fmaf(sa[i], c, -b0)) + ex2(fmaf(sa[i + 1], c, -b0));
        sum1 += ex2(fmaf(sa[i + 2], c, -b1)) + ex2(fmaf(sa[i + 3], c, -b1));
      }
      // l rescaled by a = 2^(b - b'), b the exponent the last tile's sum was
      // taken against: exactly 1 where the max holds (2^(c M - b') would be
      // 1 + an ulp or two of b''s rounding, a factor l took every tile)
      l0 = l0 * ex2(__fmul_rn(M0, c) - b0) + quad_sum(sum0);
      l1 = l1 * ex2(__fmul_rn(M1, c) - b1) + quad_sum(sum1);
      M0 = mn.x;
      M1 = mn.y;
    }

    // pass 2: the normalised p = exp(scale s - scale M) / l = 2^(c s - (c M +
    // log2 l)), rounded to the input dtype as the TPU kernel rounds it, times V
    const float n0 = M0 * c + log2f(l0), n1 = M1 * c + log2f(l1);
#pragma unroll
    for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < nt; ++j) {
      wait_full(stage, phase);
      logits<C>(sa, r.q_tile, rg0, tile(stage));
      mask_keys<C>(sa, j * C::BK, p.Lk, t4);
#pragma unroll
      for (int i = 0; i < C::BK / 2; i += 4) {
        sa[i] = ex2(fmaf(sa[i], c, -n0));
        sa[i + 1] = ex2(fmaf(sa[i + 1], c, -n0));
        sa[i + 2] = ex2(fmaf(sa[i + 2], c, -n1));
        sa[i + 3] = ex2(fmaf(sa[i + 3], c, -n1));
      }
      pack(sa);
      pv<C>(o, pa, tile(stage) + C::TILE_BYTES);
      mbar_arrive(&r.empty[stage]);
      advance(stage, phase);
    }
  } else {
#pragma unroll
    for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < nt; ++j) {
      wait_full(stage, phase);
      logits<C>(sa, r.q_tile, rg0, tile(stage));
      mask_keys<C>(sa, j * C::BK, p.Lk, t4);
      // online softmax over this block: unnormalised p, o rescaled
      const float2 mn = tile_max(sa, C::BK / 2, M0, M1);
      // o and l rescaled by a = 2^(b - b'), exactly 1 where the max holds, 0
      // on the first block (b, b' rounded products, as in pass 1 above)
      const float b0 = __fmul_rn(mn.x, c), b1 = __fmul_rn(mn.y, c);
      const float a0 = ex2(__fmul_rn(M0, c) - b0), a1 = ex2(__fmul_rn(M1, c) - b1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < C::BK / 2; i += 4) {
        sa[i] = ex2(fmaf(sa[i], c, -b0));
        sa[i + 1] = ex2(fmaf(sa[i + 1], c, -b0));
        sa[i + 2] = ex2(fmaf(sa[i + 2], c, -b1));
        sa[i + 3] = ex2(fmaf(sa[i + 3], c, -b1));
        sum0 += sa[i] + sa[i + 1];
        sum1 += sa[i + 2] + sa[i + 3];
      }
      l0 = l0 * a0 + quad_sum(sum0);  // the sum of the unrounded p, as the TPU kernel's
      l1 = l1 * a1 + quad_sum(sum1);
      M0 = mn.x;
      M1 = mn.y;
#pragma unroll
      for (int i = 0; i < C::DP / 2; i += 4) {
        o[i] *= a0;
        o[i + 1] *= a0;
        o[i + 2] *= a1;
        o[i + 3] *= a1;
      }
      pack(sa);
      pv<C>(o, pa, tile(stage) + C::TILE_BYTES);
      mbar_arrive(&r.empty[stage]);
      advance(stage, phase);
    }
  }

  mbar_arrive(r.qempty);  // the last read of the q tile is done

  const float f0 = C::TWO_PASS ? 1.f : 1.f / l0, f1 = C::TWO_PASS ? 1.f : 1.f / l1;
  const int row = it.q0 + rg0 * 8 + warp * 16 + g;
  bf16* out = p.o + it.b * p.ob + it.h * p.oh;
#pragma unroll
  for (int j = 0; j < C::DP / 8; ++j) {
    const int col = j * 8 + t4 * 2;  // d % 8 == 0, so col < d implies col + 1 < d
    if (col < p.d) {
      if (row < p.Lq)
        *reinterpret_cast<uint32_t*>(out + (long long)row * p.ol + col) =
            pack2<C::F16>(o[4 * j] * f0, o[4 * j + 1] * f0);
      if (row + 8 < p.Lq)
        *reinterpret_cast<uint32_t*>(out + (long long)(row + 8) * p.ol + col) =
            pack2<C::F16>(o[4 * j + 2] * f1, o[4 * j + 3] * f1);
    }
  }
  if (!C::TWO_PASS && p.ml != nullptr && t4 == 0) {
    // m = max of the scaled logits = scale M exactly
    const long long plane = (long long)p.B * p.H * p.Lq;
    const long long i = ((long long)it.b * p.H + it.h) * p.Lq + row;
    if (row < p.Lq) {
      p.ml[i] = M0 * p.scale;
      p.ml[plane + i] = l0;
    }
    if (row + 8 < p.Lq) {
      p.ml[i + 8] = M1 * p.scale;
      p.ml[plane + i + 8] = l1;
    }
  }
}

// One consumer warpgroup (cw = 0 or 1): 64 q rows of each of the block's
// items. Thread rows r0 = q0 + 64 cw + 16 warp + g and r0 + 8.
template <class C>
__device__ __forceinline__ void consume(const Params& p, const Ring& r, int cw) {
  const int t = threadIdx.x - WG * cw;
  const int nt = (p.Lk + C::BK - 1) / C::BK;
  int stage = 0, phase = 0, qphase = 0;
  for (int w = blockIdx.x; w < items(p); w += gridDim.x, qphase ^= 1)
    consume_item<C>(p, r, item(p, w), cw * 8, t / 32, (t % 32) >> 2, t & 3, nt, stage, phase,
                    qphase);
}

// a persistent 1-d grid of at most C::CTAS blocks an SM, each walking
// items; C::THREADS threads, C::SMEM bytes of dynamic shared memory; tq/tk/tv
// are read only on the TMA path
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::CTAS)
    attn_sm90(const Params p, const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);  // 1024-byte aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  Ring r;
  r.full = bars;
  r.empty = bars + C::STAGES;
  r.qfull = bars + 2 * C::STAGES;
  r.qempty = bars + 2 * C::STAGES + 1;
  r.q_tile = smem_u32(base) + 1024;
  r.stages = r.q_tile + C::Q_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&r.full[s], C::TMA ? 1 : C::PRODUCER);
      mbar_init(&r.empty[s], 2 * WG);
    }
    mbar_init(r.qfull, C::TMA ? 1 : C::PRODUCER);
    mbar_init(r.qempty, 2 * WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 2 * WG) {
    if constexpr (C::CTAS == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS) : "memory");
    produce<C>(p, r, &tq, &tk, &tv);
  } else {
    if constexpr (C::CTAS == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS) : "memory");
    consume<C>(p, r, threadIdx.x / WG);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a (d, L, H, B) tensor map of 2-byte elements (bf16, or f16 where `type`
// says so) with element strides (row, head, batch), `cols`-column x `rows`
// boxes, zeros past L: 64 columns with the 128-byte swizzle, or 8 (16
// bytes, a core matrix's row) with none
inline bool make_map(CUtensorMap* map, const void* ptr, int d, int L, int H, int B, long long sl,
                     long long sh, long long sb, int rows, int cols = 64,
                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Launch attn_sm90<C> on `stream`; returns the CUDA error (0 on success).
template <class C>
int launch(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof(tq));
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if constexpr (C::TMA) {
    constexpr CUtensorMapDataType T = map_type<C::F16>();
    if (!make_map(&tq, p.q, p.d, p.Lq, p.H, p.B, p.ql, p.qh, p.qb, QROWS, 64, T) ||
        !make_map(&tk, p.k, p.d, p.Lk, p.H, p.B, p.kl, p.kh, p.kb, C::BK, 64, T) ||
        !make_map(&tv, p.v, p.d, p.Lk, p.H, p.B, p.vl, p.vh, p.vb, C::BK, 64, T))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(attn_sm90<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = (p.Lq + QROWS - 1) / QROWS * p.H * p.B;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = n < sms * C::CTAS ? n : sms * C::CTAS;
  attn_sm90<C><<<blocks, C::THREADS, C::SMEM, stream>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
