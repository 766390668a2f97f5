// Device helpers shared by the SD attention forward (sd_attention.cu) and
// backward (sd_attention_bwd.cu) kernels: tile constants, mma.sync m16n8k16
// bf16 fragments, and the shared-memory tile loaders.
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

constexpr int BQ = 64;         // q rows per block (kv rows per block in the dk/dv kernels)
constexpr int BK = 64;         // rows per streamed tile (bf16 paths)
constexpr int NWARPS = 4;      // bf16 paths: 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int BKF = 32;        // rows per streamed tile (f32 paths, BQ threads)

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

// 64 rows x DP columns of src (rows from row0, d valid columns) -> dst with
// row stride DP + 8; rows past nrows and columns past d are zero.
template <int DP>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src, long long row_stride,
                                               int row0, int nrows, int d) {
  constexpr int CH = DP / 8;  // 16-byte chunks per padded row
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (long long)row * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (DP + 8) + c * 8) = val;
  }
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

// c = this warp's 16 rows (fragments af) times rows nt*8.. of bs transposed,
// the n8 tile nt of s[r][j] = sum_c A[r][c] * bs[j][c]
template <int DP>
__device__ __forceinline__ void dot_n8(float (&c)[4], const uint32_t (&af)[DP / 16][4],
                                       const bf16* bs, int nt, int g, int t4) {
  constexpr int SK = DP + 8;
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const bf16* kb = bs + (nt * 8 + g) * SK + kk * 16 + t4 * 2;
    const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(kb),
                             *reinterpret_cast<const uint32_t*>(kb + 8)};
    mma_16816(c, af[kk], bfr);
  }
}

// s[nt][.] = this warp's 16 rows (fragments af) times the 64 rows of bs
// transposed: s[r][j] = sum_c A[r][c] * bs[j][c]
template <int DP>
__device__ __forceinline__ void tile_dot(float (&s)[BK / 8][4], const uint32_t (&af)[DP / 16][4],
                                         const bf16* bs, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) dot_n8<DP>(s[nt], af, bs, nt, g, t4);
}

// s[nt][.] = scaled logits of this warp's 16 rows against the 64 rows in ks;
// columns (rows of ks) at or past n get -inf. Each n8 tile is scaled right
// after its product: the forward kernel then needs 80 registers at d <= 48
// (6 blocks an SM) where scaling after all eight products needed 95 (5).
template <int DP>
__device__ __forceinline__ void tile_logits(float (&s)[BK / 8][4], const uint32_t (&qf)[DP / 16][4],
                                            const bf16* ks, int kv0, int n, float scale, int g,
                                            int t4) {
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    dot_n8<DP>(s[nt], qf, ks, nt, g, t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kv0 + nt * 8 + t4 * 2 + (e & 1);
      s[nt][e] = key < n ? s[nt][e] * scale : -INFINITY;
    }
  }
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

// Each row's softmax max m and sum l = sum_j exp(s_j - m) over all Lk keys,
// for rows g and g + 8 of this warp's 16 (fragments qf); K streams through
// the 64-row shared tile ks. l is rescaled whenever m grows.
template <int DP>
__device__ __forceinline__ void row_stats(const uint32_t (&qf)[DP / 16][4], bf16* ks,
                                          const bf16* k, long long k_row_stride, int Lk, int d,
                                          float scale, int g, int t4, float& m0, float& m1,
                                          float& l0, float& l1) {
  m0 = m1 = -INFINITY;
  l0 = l1 = 0.f;
  float s[BK / 8][4];
  for (int kv0 = 0; kv0 < Lk; kv0 += BK) {
    load_rows_bf16<DP>(ks, k, k_row_stride, kv0, Lk, d);
    __syncthreads();
    tile_logits<DP>(s, qf, ks, kv0, Lk, scale, g, t4);
    __syncthreads();
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      sum0 += __expf(s[nt][0] - mn0) + __expf(s[nt][1] - mn0);
      sum1 += __expf(s[nt][2] - mn1) + __expf(s[nt][3] - mn1);
    }
    // the first tile always holds a valid key, so mn is finite from here on
    l0 = l0 * __expf(m0 - mn0) + quad_sum(sum0);
    l1 = l1 * __expf(m1 - mn1) + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
  }
}

// f32: BKF rows x DP columns into dst (row stride DP), by a block of BQ threads
template <int DP>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long row_stride,
                                              int row0, int nrows, int d) {
  constexpr int CH = DP / 4;
  for (int i = threadIdx.x; i < BKF * CH; i += BQ) {
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nrows && c * 4 < d)
      val = *reinterpret_cast<const float4*>(src + (long long)row * row_stride + c * 4);
    *reinterpret_cast<float4*>(dst + r * DP + c * 4) = val;
  }
}

// f32: one thread per row (qr, zero past d); the row's softmax max m and sum
// l over all keys, K streamed through the BKF-row shared tile ks (row
// stride DP), one key at a time with l rescaled whenever m grows
template <int DP>
__device__ __forceinline__ void row_stats_f32(const float (&qr)[DP], float* ks, const float* k,
                                              long long k_row_stride, int Lk, int d, float scale,
                                              float& m, float& l) {
  m = -INFINITY;
  l = 0.f;
  for (int kv0 = 0; kv0 < Lk; kv0 += BKF) {
    load_rows_f32<DP>(ks, k, k_row_stride, kv0, Lk, d);
    __syncthreads();
    const int nk = min(BKF, Lk - kv0);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot = fmaf(qr[i], ks[j * DP + i], dot);
      const float s = dot * scale;
      const float mn = fmaxf(m, s);
      l = l * __expf(m - mn) + __expf(s - mn);
      m = mn;
    }
    __syncthreads();
  }
}

}  // namespace
