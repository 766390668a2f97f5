// Device helpers shared by the attention kernels: the mma.sync kernels of
// flash_attention.cu (d = 256 and f32) and the Hopper mainloops
// (attention_sm90.cuh, attention_bwd_sm90.cuh), which take the bf16 packing
// and the quad reductions: tile constants, the strides, mma.sync m16n8k16
// bf16 fragments.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A (16x16, row-major):  reg0 = A[g][2t4..+1], reg1 = A[g+8][2t4..+1],
//                          reg2 = A[g][2t4+8..+9], reg3 = A[g+8][2t4+8..+9]
//   B (16x8, "col"):       reg0 = B[2t4..+1][g],  reg1 = B[2t4+8..+9][g]
//   C (16x8, f32):         c0,c1 = C[g][2t4..+1], c2,c3 = C[g+8][2t4..+1]
// Two neighbouring C tiles (n8 tiles 2j and 2j+1) hold exactly the A
// fragment of the 16x16 block they cover, which is how probabilities move
// from one product into the next without shared memory.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 128;  // mma.sync paths: four warps of 16 rows

struct Strides {
  long long b, h, l;
};

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> one register of two bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 values -> one register (lo in the low half)
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// A fragments of the 16 rows r0.. of a row-major tile (row stride DP + 8)
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&af)[DP / 16][4], const bf16* src, int r0,
                                             int g, int t4) {
  constexpr int SK = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const bf16* base = src + (r0 + g) * SK + kk * 16 + t4 * 2;
    af[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    af[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * SK);
    af[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    af[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * SK + 8);
  }
}

// B fragment of B[k][n] = src[k][n] (a row-major tile, row stride sk) for the
// k16 chunk from row k0 and the n8 tile from column n0
__device__ __forceinline__ void b_frag_kn(uint32_t (&b)[2], const bf16* src, int sk, int k0,
                                          int n0, int g, int t4) {
  const bf16* c = src + (k0 + t4 * 2) * sk + n0 + g;
  b[0] = pack2(c[0], c[sk]);
  b[1] = pack2(c[8 * sk], c[9 * sk]);
}

// reduce over the four threads that share one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
