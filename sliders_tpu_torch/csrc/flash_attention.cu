// Flash-attention forward for Hopper (sm_90a): online softmax, one pass over K/V.
//
// Replaces the stock TPU flash kernel that
// sliders_tpu/ops/flash_attention.py::flash_attention calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_kernel_single_batch, with 128-wide blocks). For
// (B, H, L, d) q/k/v it walks K in 128-key blocks per q tile:
//
//   s = (q . k) in f32, times sm_scale;     m' = max(m, rowmax s);
//   p = exp(s - m'), unnormalised, in f32;  l' = rowsum p + exp(m - m') l;
//   acc' = acc exp(m - m') + round_to_v_dtype(p) . v, accumulated in f32;
//   o = acc / l after the last block, stored in the input dtype.
//
// The TPU kernel keeps acc normalised (acc *= l_corr / l'; acc += (p.v) / l');
// dividing once at the end is the same sum in f32 and rounds at the same
// point: the UNNORMALISED p is rounded to v's dtype (kernel #1,
// sd_attention.cu, rounds the normalised p).
//
// What bounds it: at FLUX's d = 128 it is tensor-core work. (1, 24, 16896,
// 128) is 4 L^2 d H = 3.5 TFLOP against 0.42 GB of q/k/v/o: 3.55 ms at
// 989 TFLOP/s against 0.12 ms at 3.35 TB/s. So the design keeps s, p and the
// accumulator in registers (mma.sync m16n8k16, bf16 in, f32 accumulate;
// p goes from the logits' accumulator fragments straight into the A
// fragments of P.V), reads each K/V tile once per 64-row q tile through
// shared memory, and takes one pass over K where kernel #1 takes two. No
// wgmma, TMA, ldmatrix or copy pipelining yet: that is what stands between
// this kernel and the bound.
//
// Layout: one block per (64-row q tile, head x 128-wide output chunk,
// batch). The logits sum over the whole head dim in 128-wide chunks (f32:
// 32-wide), and each block writes one 128-wide chunk of o, so d = 256 or
// 512 (the VAE's single-head mid attention) needs no more shared memory or
// registers than d = 128, at the price of one logits pass per output chunk.
// bf16: four warps, 16 q rows each, 87,040 bytes of shared memory.
// f32: 256 threads (16 row groups x 16 column groups), each a 4 x 8 tile of
// s and of acc on plain FMAs, 74,752 bytes.
// Shapes: Lq % 64 == 0, Lk % 128 == 0, d % 128 == 0 (the routing gate asks
// L % 128 == 0 and d % 128 == 0); strides for batch, head and row with a
// contiguous last dim, so q/k/v can be head views of (B, L, H*d) projections
// and o a (B, H, L, d) view of a (B, L, H, d) buffer.

#include "sd_attention_common.cuh"

namespace {

constexpr int FQ = 64;       // q rows per block
constexpr int FK = 128;      // keys per tile: the TPU kernel's block_k
constexpr int FD = 128;      // head-dim chunk (bf16 logits) and output chunk
constexpr int FS = FD + 8;   // bf16 shared row stride (16-byte rows, conflict-free fragments)
constexpr int FT = 256;      // f32 threads
constexpr int FDC = 32;      // f32 head-dim chunk of the logits
constexpr int FKV = 32;      // f32 keys per V sub-tile

constexpr int BF16_SMEM = (FQ + 2 * FK) * FS * 2;
constexpr int F32_SMEM = (FQ * (FDC + 1) + FK * (FDC + 1) + FQ * (FK + 1) + FKV * FD) * 4;

struct FParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Lk, d;
  Strides qs, ks, vs, os;
  float scale;
};

// ROWS x FD columns of src from column col0 -> dst (row stride FS)
template <int ROWS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, long long row_stride,
                                               int col0) {
  constexpr int CH = FD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(dst + r * FS + c * 8) =
        *reinterpret_cast<const uint4*>(src + (long long)r * row_stride + col0 + c * 8);
  }
}

__global__ void __launch_bounds__(NTHREADS) flash_fwd_bf16(FParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [FQ][FS]: the q chunk
  bf16* ks = qs + FQ * FS;                   // [FK][FS]: the K chunk
  bf16* vs = ks + FK * FS;                   // [FK][FS]: this block's V columns

  const int nc = p.d / FD;
  const int q0 = blockIdx.x * FQ;
  const int h = blockIdx.y / nc, oc = blockIdx.y % nc;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h + q0 * p.qs.l;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.h;
  bf16* o = static_cast<bf16*>(p.o) + b * p.os.b + h * p.os.h;

  if (nc == 1) load_tile_bf16<FQ>(qs, q, p.qs.l, 0);  // one chunk: q stays for every tile

  // rows g and g + 8 of this warp's 16: running max, running sum, accumulator
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[FD / 8][4];
#pragma unroll
  for (int nt = 0; nt < FD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float s[FK / 8][4];

  for (int kv0 = 0; kv0 < p.Lk; kv0 += FK) {
#pragma unroll
    for (int nt = 0; nt < FK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* kt = k + (long long)kv0 * p.ks.l;
    for (int c = 0; c < nc; ++c) {
      if (nc > 1) load_tile_bf16<FQ>(qs, q, p.qs.l, c * FD);
      load_tile_bf16<FK>(ks, kt, p.ks.l, c * FD);
      if (c == nc - 1) load_tile_bf16<FK>(vs, v + (long long)kv0 * p.vs.l, p.vs.l, oc * FD);
      __syncthreads();
      uint32_t qf[FD / 16][4];
      load_a_frags<FD>(qf, qs, r0, g, t4);
#pragma unroll
      for (int nt = 0; nt < FK / 8; ++nt) {
#pragma unroll
        for (int kk = 0; kk < FD / 16; ++kk) {
          const bf16* kb = ks + (nt * 8 + g) * FS + kk * 16 + t4 * 2;
          const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(kb),
                                   *reinterpret_cast<const uint32_t*>(kb + 8)};
          mma_16816(s[nt], qf[kk], bfr);
        }
      }
      if (c < nc - 1) __syncthreads();  // the next chunk overwrites qs and ks
    }

    // online softmax over this 128-key block
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < FK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= p.scale;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);  // 0 on the first block
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < FK / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mn0);
      s[nt][1] = __expf(s[nt][1] - mn0);
      s[nt][2] = __expf(s[nt][2] - mn1);
      s[nt][3] = __expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * a0 + quad_sum(sum0);  // the sum of the unrounded p, as the TPU kernel's
    l1 = l1 * a1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < FD / 8; ++nt) {
      acc[nt][0] *= a0;
      acc[nt][1] *= a0;
      acc[nt][2] *= a1;
      acc[nt][3] *= a1;
    }

    // acc += round_bf16(p) . V: two n8 accumulator tiles are one k16 A fragment
#pragma unroll
    for (int kc = 0; kc < FK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nt = 0; nt < FD / 8; ++nt) {
        uint32_t bfr[2];
        b_frag_kn(bfr, vs, FS, kc * 16, nt * 8, g, t4);
        mma_16816(acc[nt], pa, bfr);
      }
    }
    __syncthreads();  // the next block overwrites ks and vs
  }

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const long long row = q0 + r0 + g;
#pragma unroll
  for (int nt = 0; nt < FD / 8; ++nt) {
    const int col = oc * FD + nt * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(o + row * p.os.l + col) =
        pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    *reinterpret_cast<uint32_t*>(o + (row + 8) * p.os.l + col) =
        pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

// ROWS x COLS floats of src from column col0 -> dst (row stride DST_STRIDE),
// 16-byte loads; a stride that is not a multiple of 4 takes scalar stores
template <int ROWS, int COLS, int DST_STRIDE>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long row_stride,
                                              int col0) {
  constexpr int CH = COLS / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += FT) {
    const int r = i / CH, c = i % CH;
    const float4 val =
        *reinterpret_cast<const float4*>(src + (long long)r * row_stride + col0 + c * 4);
    float* d = dst + r * DST_STRIDE + c * 4;
    if (DST_STRIDE % 4 == 0) {
      *reinterpret_cast<float4*>(d) = val;
    } else {
      d[0] = val.x;
      d[1] = val.y;
      d[2] = val.z;
      d[3] = val.w;
    }
  }
}

// the 16 threads that share a row group are lanes 16 apart at most: reduce over them
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off *= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(FT) flash_fwd_f32(FParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [FQ][FDC + 1]
  float* ks = qs + FQ * (FDC + 1);             // [FK][FDC + 1]
  float* ps = ks + FK * (FDC + 1);             // [FQ][FK + 1]: this block's p
  float* vs = ps + FQ * (FK + 1);              // [FKV][FD]

  const int nc = p.d / FD;
  const int q0 = blockIdx.x * FQ;
  const int h = blockIdx.y / nc, oc = blockIdx.y % nc;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // rows ty*4 + i, columns tx + 16 j

  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h + q0 * p.qs.l;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  float* o = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;

  float m[4], l[4], acc[4][8], s[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < p.Lk; kv0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    const float* kt = k + (long long)kv0 * p.ks.l;
    for (int c = 0; c < p.d; c += FDC) {
      load_tile_f32<FQ, FDC, FDC + 1>(qs, q, p.qs.l, c);
      load_tile_f32<FK, FDC, FDC + 1>(ks, kt, p.ks.l, c);
      __syncthreads();
#pragma unroll 8
      for (int kd = 0; kd < FDC; ++kd) {
        float a[4], bk[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * (FDC + 1) + kd];
#pragma unroll
        for (int j = 0; j < 8; ++j) bk[j] = ks[(tx + 16 * j) * (FDC + 1) + kd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
      __syncthreads();
    }

    // online softmax over this 128-key block; p (f32 = v's dtype) into ps
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] *= p.scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mx));
      const float a = __expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = __expf(s[i][j] - mn);
        sum += pj;
        ps[(ty * 4 + i) * (FK + 1) + tx + 16 * j] = pj;
        acc[i][j] *= a;
      }
      l[i] = l[i] * a + half_warp_sum(sum);
      m[i] = mn;
    }

    // acc += p . V over this block's 128 output columns, FKV keys at a time
    for (int kc = 0; kc < FK; kc += FKV) {
      load_tile_f32<FKV, FD, FD>(vs, v + (long long)(kv0 + kc) * p.vs.l, p.vs.l, oc * FD);
      __syncthreads();  // also publishes ps on the first pass
#pragma unroll 8
      for (int kk = 0; kk < FKV; ++kk) {
        float pv[4], vv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (FK + 1) + kc + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) vv[j] = vs[kk * FD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
    float* orow = o + (long long)(q0 + ty * 4 + i) * p.os.l + oc * FD;
#pragma unroll
    for (int j = 0; j < 8; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Pointers 16-byte
// aligned, Lq % 64 == 0, Lk % 128 == 0, d % 128 == 0, strides (in elements)
// multiples of 8 with a contiguous last dim; the Python wrapper checks all of
// this.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Lq, int Lk, int d, int is_f32, long long q_sb,
                                   long long q_sh, long long q_sl, long long k_sb, long long k_sh,
                                   long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                                   long long o_sb, long long o_sh, long long o_sl, float scale,
                                   void* stream) {
  if (B < 1 || H < 1 || Lq < FQ || Lk < FK || Lq % FQ || Lk % FK || d < FD || d % FD ||
      B > 65535 || (long long)H * (d / FD) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FParams p{q, k, v, o, Lk, d,
                  {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl}, {o_sb, o_sh, o_sl},
                  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Lq / FQ, H * (d / FD), B);
  cudaError_t err;
  if (is_f32) {
    err = cudaFuncSetAttribute(flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32<<<grid, FT, F32_SMEM, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BF16_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_bf16<<<grid, NTHREADS, BF16_SMEM, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
