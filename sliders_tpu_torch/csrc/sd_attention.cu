// SD self-attention forward for Hopper (sm_90a), exact-softmax numerics.
//
// Replaces sliders_tpu/ops/pallas_attention.py::_attn_kernel (reached from
// _sd_attention_impl). It computes, for (B, H, L, d) q/k/v with d <= 128:
//
//   s = (q . k) * d^-1/2 in f32;  p = exp(s - max_row(s)) / sum_row(exp(...));
//   o = round_to_input_dtype(p) . v, accumulated in f32, stored in the input
//   dtype.
//
// p is rounded to the input dtype AFTER normalisation, as the TPU kernel's
// `p.astype(v.dtype)` does. A one-pass online softmax (normalising after
// P.V) would round at a different point, so this kernel takes two passes
// over K: pass 1 finds each row's max m and sum l = sum exp(s - m) (l is
// rescaled when m grows); pass 2 recomputes s, forms the normalised p,
// rounds it and accumulates p.V.
//
// Why it streams: the TPU kernel kept all of K/V in 16 MB of VMEM. A Hopper
// block has at most 227 KB of shared memory, so K/V stream through it in
// 64-row tiles (K twice, V once). At SD1.5's d=40 the work per byte is far
// below the H100's bf16 ridge (about 295 operations per byte), so the kernel
// is bound by memory traffic and launch count, not by tensor-core rate.
// Reading K twice costs one extra pass over K per q tile, served mostly from
// L2 (K/V of one head is 4096 x 40 x 2 B = 320 KB); the second QK^T is the
// price of the reference's rounding point.
//
// Layout: one block per (64-row q tile, head, batch). bf16 runs four warps,
// 16 q rows each, with mma.sync m16n8k16 (bf16 in, f32 accumulate); f32 runs
// one thread per q row with plain FMAs. The head dim is zero-padded to a
// multiple of 16 inside shared memory only. q/k/v/o take element strides
// for batch, head and row (the last dim must be contiguous), so the caller
// can pass the (B, L, H, d) views of the projection outputs with no copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // keys per K/V tile (bf16 path)
constexpr int NWARPS = 4;      // bf16 path: 16 q rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int BKF = 32;        // keys per K/V tile (f32 path)

struct Strides {
  long long b, h, l;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Lq, Lk, d;
  Strides qs, ks, vs, os;
  float scale;
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

// the same tile stored transposed: dst[col][row], row stride BK + 8
template <int DP>
__device__ __forceinline__ void load_rows_t_bf16(bf16* dst, const bf16* src, long long row_stride,
                                                 int row0, int nrows, int d) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (long long)row * row_stride + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * (BK + 8) + r] = e[j];
  }
}

// s[nt][.] = scaled logits of this warp's 16 q rows against the 64 keys in ks;
// keys at or past Lk get -inf.
template <int DP>
__device__ __forceinline__ void tile_logits(float (&s)[BK / 8][4], const uint32_t (&qf)[DP / 16][4],
                                            const bf16* ks, int kv0, int Lk, float scale, int g,
                                            int t4) {
  constexpr int SK = DP + 8;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const bf16* kb = ks + (nt * 8 + g) * SK + kk * 16 + t4 * 2;
      const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(kb),
                               *reinterpret_cast<const uint32_t*>(kb + 8)};
      mma_16816(s[nt], qf[kk], bfr);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kv0 + nt * 8 + t4 * 2 + (e & 1);
      s[nt][e] = key < Lk ? s[nt][e] * scale : -INFINITY;
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

template <int DP>
__global__ void __launch_bounds__(NTHREADS) attn_fwd_bf16(Params p) {
  constexpr int SK = DP + 8;
  constexpr int SV = BK + 8;
  __shared__ __align__(16) bf16 ks[BK * SK];
  __shared__ __align__(16) bf16 vt[DP * SV];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.h;
  bf16* o = static_cast<bf16*>(p.o) + b * p.os.b + h * p.os.h;

  // Q tile through shared memory (the K buffer) into mma A fragments
  load_rows_bf16<DP>(ks, q, p.qs.l, q0, p.Lq, p.d);
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const bf16* base = ks + (r0 + g) * SK + kk * 16 + t4 * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * SK);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * SK + 8);
  }
  __syncthreads();

  // pass 1: row max and sum of exp over all keys (rows g and g + 8)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[BK / 8][4];
  for (int kv0 = 0; kv0 < p.Lk; kv0 += BK) {
    load_rows_bf16<DP>(ks, k, p.ks.l, kv0, p.Lk, p.d);
    __syncthreads();
    tile_logits<DP>(s, qf, ks, kv0, p.Lk, p.scale, g, t4);
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
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // pass 2: normalised p, rounded to bf16, times V
  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int kv0 = 0; kv0 < p.Lk; kv0 += BK) {
    load_rows_bf16<DP>(ks, k, p.ks.l, kv0, p.Lk, p.d);
    load_rows_t_bf16<DP>(vt, v, p.vs.l, kv0, p.Lk, p.d);
    __syncthreads();
    tile_logits<DP>(s, qf, ks, kv0, p.Lk, p.scale, g, t4);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      // accumulator fragments of two n8 tiles are the A fragment of one k16 step
      const uint32_t pa[4] = {
          pack_bf16(__expf(s[2 * kc][0] - m0) * inv0, __expf(s[2 * kc][1] - m0) * inv0),
          pack_bf16(__expf(s[2 * kc][2] - m1) * inv1, __expf(s[2 * kc][3] - m1) * inv1),
          pack_bf16(__expf(s[2 * kc + 1][0] - m0) * inv0, __expf(s[2 * kc + 1][1] - m0) * inv0),
          pack_bf16(__expf(s[2 * kc + 1][2] - m1) * inv1, __expf(s[2 * kc + 1][3] - m1) * inv1)};
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        const bf16* vb = vt + (nt * 8 + g) * SV + kc * 16 + t4 * 2;
        const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(vb),
                                 *reinterpret_cast<const uint32_t*>(vb + 8)};
        mma_16816(acc[nt], pa, bfr);
      }
    }
    __syncthreads();
  }

  const int row0 = q0 + r0 + g;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;  // d % 8 == 0, so col < d implies col + 1 < d
    if (col < p.d) {
      if (row0 < p.Lq)
        *reinterpret_cast<uint32_t*>(o + (long long)row0 * p.os.l + col) =
            pack_bf16(acc[nt][0], acc[nt][1]);
      if (row0 + 8 < p.Lq)
        *reinterpret_cast<uint32_t*>(o + (long long)(row0 + 8) * p.os.l + col) =
            pack_bf16(acc[nt][2], acc[nt][3]);
    }
  }
}

// f32: one thread per q row, K/V tiles of BKF rows in shared memory
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

template <int DP>
__global__ void __launch_bounds__(BQ) attn_fwd_f32(Params p) {
  __shared__ __align__(16) float ks[BKF * DP];
  __shared__ __align__(16) float vs[BKF * DP];

  const int row = blockIdx.x * BQ + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  float* o = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;

  float qr[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i)
    qr[i] = (row < p.Lq && i < p.d) ? q[(long long)row * p.qs.l + i] : 0.f;

  // pass 1, one key at a time (l rescaled whenever m grows)
  float m = -INFINITY, l = 0.f;
  for (int kv0 = 0; kv0 < p.Lk; kv0 += BKF) {
    load_rows_f32<DP>(ks, k, p.ks.l, kv0, p.Lk, p.d);
    __syncthreads();
    const int nk = min(BKF, p.Lk - kv0);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot = fmaf(qr[i], ks[j * DP + i], dot);
      const float s = dot * p.scale;
      const float mn = fmaxf(m, s);
      l = l * __expf(m - mn) + __expf(s - mn);
      m = mn;
    }
    __syncthreads();
  }
  const float inv = 1.f / l;

  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = 0.f;
  for (int kv0 = 0; kv0 < p.Lk; kv0 += BKF) {
    load_rows_f32<DP>(ks, k, p.ks.l, kv0, p.Lk, p.d);
    load_rows_f32<DP>(vs, v, p.vs.l, kv0, p.Lk, p.d);
    __syncthreads();
    const int nk = min(BKF, p.Lk - kv0);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot = fmaf(qr[i], ks[j * DP + i], dot);
      const float pj = __expf(dot * p.scale - m) * inv;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(pj, vs[j * DP + i], acc[i]);
    }
    __syncthreads();
  }
  if (row < p.Lq) {
#pragma unroll
    for (int i = 0; i < DP; ++i)
      if (i < p.d) o[(long long)row * p.os.l + i] = acc[i];
  }
}

template <int DP>
void launch(const Params& p, int B, int H, int is_f32, cudaStream_t stream) {
  const dim3 grid((p.Lq + BQ - 1) / BQ, H, B);
  if (is_f32)
    attn_fwd_f32<DP><<<grid, BQ, 0, stream>>>(p);
  else
    attn_fwd_bf16<DP><<<grid, NTHREADS, 0, stream>>>(p);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Pointers must be
// 16-byte aligned, d a multiple of 8 in [8, 128], row/head/batch strides (in
// elements) multiples of 8; the Python wrapper checks all of this.
extern "C" int sd_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                                int Lq, int Lk, int d, int is_f32, long long q_sb, long long q_sh,
                                long long q_sl, long long k_sb, long long k_sh, long long k_sl,
                                long long v_sb, long long v_sh, long long v_sl, long long o_sb,
                                long long o_sh, long long o_sl, float scale, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || B < 1 || H < 1 || Lq < 1 || Lk < 1 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, Lq, Lk, d,
                 {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl}, {o_sb, o_sh, o_sl},
                 scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: launch<16>(p, B, H, is_f32, st); break;
    case 32: launch<32>(p, B, H, is_f32, st); break;
    case 48: launch<48>(p, B, H, is_f32, st); break;
    case 64: launch<64>(p, B, H, is_f32, st); break;
    case 80: launch<80>(p, B, H, is_f32, st); break;
    case 96: launch<96>(p, B, H, is_f32, st); break;
    case 112: launch<112>(p, B, H, is_f32, st); break;
    case 128: launch<128>(p, B, H, is_f32, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
