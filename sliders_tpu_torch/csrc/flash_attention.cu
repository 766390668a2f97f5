// Flash attention for Hopper (sm_90a): the forward (online softmax, one pass
// over K/V) and its backward.
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
// 989 TFLOP/s against 0.12 ms at 3.35 TB/s. At the VAE's d = 512 in f32 it
// is FMA work: (8, 1, 16384, 512) is 4.4 TFLOP, 65.6 ms at 67 TFLOP/s.
//
// Three forwards:
// - bf16, d = 128: the Hopper mainloop of attention_sm90.cuh in one-pass
//   mode: 128 q rows a block on two consumer warpgroups, a producer
//   warpgroup filling a TMA ring of 128-key K/V tiles, wgmma for Q.K^T and
//   P.V with p going from the logits' accumulator straight into P.V's A
//   registers. The running max is kept on the unscaled logits and p taken
//   as 2^(c s - c m) with c = sm_scale log2(e), the same exp as above.
// - bf16, d = 256 (no main path; a test shape and a backward head dim):
//   flash_fwd_bf16, mma.sync m16n8k16 on four warps of 16 q rows, one block
//   per (64-row q tile, head x 128-wide output chunk), the logits summed
//   over the whole head dim once per output chunk; the new mainloop's
//   64 x 256 f32 accumulator would not leave the consumers room for the
//   logits.
// - f32: flash_fwd_f32_d512 at d = 512 (the VAE's single-head mid
//   attention): one block owns 64 q rows across all of d, so the logits of
//   a K tile are summed once (see the kernel); flash_fwd_f32 at d = 128 and
//   256: 256 threads (16 row groups x 16 column groups), each a 4 x 8 tile
//   of s and of acc on plain FMAs, one block per 128-wide output chunk.
// Shapes: Lq % 64 == 0, Lk % 128 == 0, d % 128 == 0 (the routing gate asks
// L % 128 == 0 and d % 128 == 0); strides for batch, head and row with a
// contiguous last dim, so q/k/v can be head views of (B, L, H*d) projections
// and o a (B, H, L, d) view of a (B, L, H, d) buffer.
//
// Under grad the forward also writes each row's final running max m and sum
// l in f32 (the residuals the TPU kernel's _flash_attention_fwd saves), and
// the backward (the TPU kernel's _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq) recomputes p from them, with di = rowsum(o * do)
// taken outside, as the TPU code takes it:
//
//   s = (q . k) in f32, times sm_scale;  p = exp(s - m) * (1 / l);
//   dv += round(p)^T . do;               dp = do . v^T in f32;
//   ds = ((dp - di) * p) * sm_scale;     dk += round(ds)^T . q;  dq += round(ds) . k;
//
// round() casts to do's dtype before the product, sums are f32, and dq, dk,
// dv are cast to the input dtype at the end. Two kernels, no atomics: a
// K/V-major one for dk and dv (a loop over every q tile) and a q-major one
// for dq (a loop over every K/V tile). Neither writes an L x L tensor. The
// backward does 14 B H L^2 d operations (s twice, dp twice, dv, dk, dq)
// against the minimal 10, and at FLUX's d = 128 is tensor-core bound.
// - bf16, d = 128 and 256: the Hopper backward mainloop of
//   attention_bwd_sm90.cuh with #4's numeric policy, a producer filling a
//   TMA ring of 64-row (q, do) (or K, V) tiles and `wgmma` for all five
//   products. At d = 128 (PAIR) 128 K/V (or q) rows a block item on two
//   consumer warpgroups, p and ds going from registers into the A operands
//   of dv, dk and dq. At d = 256 (SPLIT) a 64 x 256 f32 accumulator takes
//   128 registers a thread, so an item is 64 rows and each consumer
//   warpgroup holds one output (dv or dk; each half of dq), p and ds
//   crossing between them through shared memory.
// - f32 at d = 128 (FLUX under `--precision float32`, the tiny f32 FLUX
//   run): the same mainloop's TF32 plan with #4's policy, every product
//   three TF32 `wgmma`s (the note there): the split pass
//   (tf32_split_bhld) writes the TF32 hi and lo planes of the kernel's
//   streamed tensors (q and do for dk/dv, k and v for dq) into the scratch
//   after di's planes; 32-row streamed tiles, 64 resident rows. The dq
//   kernel reads the forward's residuals, so it makes three products (S,
//   dP, dQ^T) and no statistics pass.
// - f32 at d = 256 (no path runs it): flash_bwd_f32, one block per 64 K/V
//   (or q) rows and 128-wide output chunk, one template with the roles of
//   the row and column operands swapped, plain FMAs. The TF32 plan's
//   64-row resident f32 tiles would be 64 KB a plane at d = 256, two of
//   them beside two ring stages of hi and lo planes: more than a block's
//   227 KB.

#include "sd_attention_common.cuh"
#include "attention_sm90.cuh"
#include "attention_bwd_sm90.cuh"

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
  float* ml;  // (2, B, H, Lq) f32: each row's max m, then its sum l; null: not written
  int Lk, d;
  Strides qs, ks, vs, os;
  float scale;
};

// where row `row` of (batch b, head h) keeps its m; its l is one plane further
__device__ __forceinline__ long long ml_index(int b, int h, int row, int H, int Lq) {
  return ((long long)b * H + h) * Lq + row;
}

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
  if (p.ml != nullptr && oc == 0 && t4 == 0) {
    const int H = gridDim.y / nc, Lq = gridDim.x * FQ;
    const long long plane = (long long)gridDim.z * H * Lq;
    const long long i = ml_index(b, h, (int)row, H, Lq);
    p.ml[i] = m0;
    p.ml[plane + i] = l0;
    p.ml[i + 8] = m1;
    p.ml[plane + i + 8] = l1;
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
  if (p.ml != nullptr && oc == 0 && tx == 0) {
    const int H = gridDim.y / nc, Lq = gridDim.x * FQ;
    const long long plane = (long long)gridDim.z * H * Lq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long idx = ml_index(b, h, q0 + ty * 4 + i, H, Lq);
      p.ml[idx] = m[i];
      p.ml[plane + idx] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 at d = 512: the VAE's single-head mid attention
// ---------------------------------------------------------------------------

// One block owns 64 q rows across all 512 columns of d, so the logits of a
// K tile are summed once over d (flash_fwd_f32 above sums them once per
// 128-wide output chunk: four times at d = 512). 512 threads.
//   logits: q and K arrive in 32-column chunks; thread (ty, tx) sums rows
//     ty + 16 i and keys tx + 32 j (i, j < 4), reading 16-byte vectors along
//     d (a warp: 4 ty x 8 tx, each read one wavefront);
//   softmax: per-row max and sum across the four warps that share a row go
//     through shared memory; p (f32, unnormalised) is written once to ps,
//     key-major, and every thread's 8 rows are rescaled by the block's
//     correction;
//   P.V: thread (ry, cx) owns rows 8 ry .. 8 ry + 7 and columns 4 cx .. and
//     256 + 4 cx .. (64 accumulator floats), V arriving in 16-key chunks.
// Every chunk (q + K, or V) is one cp.async group into a ring of XSLOTS
// slots in dynamic shared memory, shared by both kinds of chunk; chunk i
// takes slot i % XSLOTS, two chunks load while one is used, and one
// barrier a chunk both publishes it and frees the slot the next copies
// overwrite (read two chunks before).
constexpr int XQ = 64;         // q rows per block
constexpr int XD = 512;        // head dim
constexpr int XT = 512;        // threads
constexpr int XDC = 32;        // d columns per logits chunk
constexpr int XS = XDC + 4;    // q / K chunk row stride (floats)
constexpr int XKV = 16;        // keys per V chunk
constexpr int XVS = XD + 4;    // V chunk row stride
constexpr int XPS = XQ + 4;    // ps row stride: ps[key][row]
constexpr int XSTEPS = XD / XDC + FK / XKV;  // chunks per K tile: 16 logits + 8 P.V
constexpr int X_QK = (XQ + FK) * XS;         // floats of a q + K chunk
constexpr int X_V = XKV * XVS;               // floats of a V chunk
constexpr int X_SLOT = X_QK > X_V ? X_QK : X_V;
constexpr int XSLOTS = 4;                    // XSTEPS % XSLOTS == 0: slots repeat per tile
constexpr int XAHEAD = 2;                    // chunks in flight; XAHEAD <= XSLOTS - 2
constexpr int X_SMEM = (XSLOTS * X_SLOT + FK * XPS + XQ * 4 * 2 + XQ * 3) * 4;

__device__ __forceinline__ void cp_async16_f(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(XT, 1) flash_fwd_f32_d512(FParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [XSLOTS][X_SLOT]: [XQ + FK][XS] or [XKV][XVS]
  float* ps = ring + XSLOTS * X_SLOT;             // [FK][XPS]
  float* rmax = ps + FK * XPS;                 // [XQ][4]: partial row max of 4 warps
  float* rsum = rmax + XQ * 4;                 // [XQ][4]
  float* mrow = rsum + XQ * 4;                 // [XQ]: running max
  float* lrow = mrow + XQ;                     // [XQ]: running sum
  float* corr = lrow + XQ;                     // [XQ]: this tile's exp(m - m')

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp % 4) * 4 + lane / 8, tx = (warp / 4) * 8 + lane % 8;  // logits
  const int ry = (warp % 2) * 4 + lane / 8, cx = (warp / 2) * 8 + lane % 8;  // P.V
  const int q0 = blockIdx.x * XQ, h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h + q0 * p.qs.l;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  float* o = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;

  if (tid < XQ) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  float acc[8][8], s[4][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // chunk `step` of the whole walk: K tile step / XSTEPS; within it the
  // logits chunks (q and K columns 32 c ..), then the V chunks (16 keys each)
  auto issue = [&](int step) {
    const int kv0 = (step / XSTEPS) * FK, r = step % XSTEPS;
    float* dst = ring + (step % XSLOTS) * X_SLOT;
    if (r < XD / XDC) {
      for (int i = tid; i < (XQ + FK) * (XDC / 4); i += XT) {
        const int row = i / (XDC / 4), c4 = (i % (XDC / 4)) * 4;
        const float* src = row < XQ ? q + (long long)row * p.qs.l
                                    : k + (long long)(kv0 + row - XQ) * p.ks.l;
        cp_async16_f(dst + row * XS + c4, src + r * XDC + c4);
      }
    } else {
      const float* src = v + (long long)(kv0 + (r - XD / XDC) * XKV) * p.vs.l;
      for (int i = tid; i < XKV * (XD / 4); i += XT) {
        const int row = i / (XD / 4), c4 = (i % (XD / 4)) * 4;
        cp_async16_f(dst + row * XVS + c4, src + (long long)row * p.vs.l + c4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int total = (p.Lk / FK) * XSTEPS;
  for (int step = 0; step < XAHEAD; ++step) issue(step);  // total >= XSTEPS > XAHEAD
  for (int step = 0; step < total; ++step) {
    // chunk `step` must have landed; the XAHEAD after it may still load
    // (an empty group stands in for each chunk past the end)
    if (step + XAHEAD < total)
      issue(step + XAHEAD);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(XAHEAD) : "memory");
    __syncthreads();
    const int r = step % XSTEPS;
    const float* chunk = ring + (step % XSLOTS) * X_SLOT;
    if (r < XD / XDC) {
      const float* qs = chunk;
      const float* ks = qs + XQ * XS;
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
#pragma unroll 2
      for (int kd = 0; kd < XDC; kd += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * XS + kd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 bk = *reinterpret_cast<const float4*>(ks + (tx + 32 * j) * XS + kd);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(a[i].x, bk.x, s[i][j]);
            s[i][j] = fmaf(a[i].y, bk.y, s[i][j]);
            s[i][j] = fmaf(a[i].z, bk.z, s[i][j]);
            s[i][j] = fmaf(a[i].w, bk.w, s[i][j]);
          }
        }
      }
      if (r == XD / XDC - 1) {
        // online softmax over this 128-key block, as flash_fwd_f32's
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] *= p.scale;
            mx = fmaxf(mx, s[i][j]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          if (lane % 8 == 0) rmax[(ty + 16 * i) * 4 + warp / 4] = mx;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = ty + 16 * i;
          const float* rm = rmax + row * 4;
          const float mn = fmaxf(fmaxf(mrow[row], fmaxf(rm[0], rm[1])), fmaxf(rm[2], rm[3]));
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pj = __expf(s[i][j] - mn);
            sum += pj;
            ps[(tx + 32 * j) * XPS + row] = pj;
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          if (lane % 8 == 0) rsum[row * 4 + warp / 4] = sum;
        }
        __syncthreads();
        if (tid < XQ) {
          const float* rm = rmax + tid * 4;
          const float* rs = rsum + tid * 4;
          const float mn = fmaxf(fmaxf(mrow[tid], fmaxf(rm[0], rm[1])), fmaxf(rm[2], rm[3]));
          const float a = __expf(mrow[tid] - mn);  // 0 on the first block
          lrow[tid] = lrow[tid] * a + ((rs[0] + rs[1]) + (rs[2] + rs[3]));
          mrow[tid] = mn;
          corr[tid] = a;
        }
      }
    } else {
      const int vc = r - XD / XDC;
      if (vc == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = corr[ry * 8 + i];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] *= a;
        }
      }
      const float* vs = chunk;
      const float* pk = ps + vc * XKV * XPS + ry * 8;
#pragma unroll 4
      for (int kk = 0; kk < XKV; ++kk) {
        const float4 p0 = *reinterpret_cast<const float4*>(pk + kk * XPS);
        const float4 p1 = *reinterpret_cast<const float4*>(pk + kk * XPS + 4);
        const float4 v0 = *reinterpret_cast<const float4*>(vs + kk * XVS + cx * 4);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + kk * XVS + 256 + cx * 4);
        const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // lrow's last update is visible

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ry * 8 + i;
    const float inv = 1.f / lrow[row];
    float* orow = o + (long long)(q0 + row) * p.os.l;
    *reinterpret_cast<float4*>(orow + cx * 4) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    *reinterpret_cast<float4*>(orow + 256 + cx * 4) =
        make_float4(acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv, acc[i][7] * inv);
  }
  if (p.ml != nullptr && tid < XQ) {
    const int H = gridDim.y, Lq = gridDim.x * XQ;
    const long long plane = (long long)gridDim.z * H * Lq;
    const long long idx = ml_index(b, h, q0 + tid, H, Lq);
    p.ml[idx] = mrow[tid];
    p.ml[plane + idx] = lrow[tid];
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int BR = 64;  // rows a block owns: K/V rows (dk/dv) or q rows (dq)
constexpr int BC = 64;  // columns per streamed tile: q rows (dk/dv) or keys (dq)

struct BParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;      // do, the output's gradient
  const float* m;     // (B, H, Lq) f32 residuals of the forward
  const float* l;
  const float* di;    // (B, H, Lq) f32: rowsum(o * do)
  void* dq;
  void* dk;
  void* dv;
  int H, Lq, Lk, d;
  Strides qs, ks, vs, gs, dqs, dks, dvs;
  float scale;
};

// The operands of one backward kernel. DKV (the dk/dv kernel): the block's
// rows are K (a1) and V (a2), its columns stream q (b1) and do (b2), and the
// softmax statistics belong to the columns. Otherwise (the dq kernel): rows
// q and do, columns K and V, statistics of the rows.
template <bool DKV, typename T>
struct Roles {
  const T *a1, *a2, *b1, *b2;
  long long a1s, a2s, b1s, b2s;  // row strides
  int ncols;
  __device__ Roles(const BParams& p, int b, int h) {
    const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
    const T* k = static_cast<const T*>(p.k) + b * p.ks.b + h * p.ks.h;
    const T* v = static_cast<const T*>(p.v) + b * p.vs.b + h * p.vs.h;
    const T* g = static_cast<const T*>(p.g) + b * p.gs.b + h * p.gs.h;
    if (DKV) {
      a1 = k, a2 = v, b1 = q, b2 = g;
      a1s = p.ks.l, a2s = p.vs.l, b1s = p.qs.l, b2s = p.gs.l;
      ncols = p.Lq;
    } else {
      a1 = q, a2 = g, b1 = k, b2 = v;
      a1s = p.qs.l, a2s = p.gs.l, b1s = p.ks.l, b2s = p.vs.l;
      ncols = p.Lk;
    }
  }
};

// f32: FT threads, each a 4 x 4 tile of s and dp (rows ty*4 + i, columns
// tx + 16 j) over 32-wide head-dim chunks, then p and ds through shared
// memory into a 4 x 8 tile of each output (columns tx + 16 j of the chunk).
constexpr int FC = 32;  // streamed rows per output sub-tile
constexpr int BWD_F32_SMEM =
    (4 * BR * (FDC + 1) + 2 * BR * (BC + 1) + 2 * FC * FD + 3 * BC) * 4;

template <bool DKV>
__global__ void __launch_bounds__(FT) flash_bwd_f32(BParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* a1s = reinterpret_cast<float*>(smem);  // [BR][FDC + 1] chunks of the rows
  float* a2s = a1s + BR * (FDC + 1);
  float* b1s = a2s + BR * (FDC + 1);            // [BC][FDC + 1] chunks of the tile
  float* b2s = b1s + BC * (FDC + 1);
  float* ps = b2s + BC * (FDC + 1);             // [BR][BC + 1]: p
  float* dss = ps + BR * (BC + 1);              // [BR][BC + 1]: ds
  float* t1s = dss + BR * (BC + 1);             // [FC][FD]: output columns of the tile
  float* t2s = t1s + FC * FD;
  float* st_m = t2s + FC * FD;                  // [64] m, 1 / l, di of the tile's columns
  float* st_inv = st_m + BC;
  float* st_di = st_inv + BC;

  const int nc = p.d / FD;
  const int row0 = blockIdx.x * BR;
  const int h = blockIdx.y / nc, oc = blockIdx.y % nc;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const Roles<DKV, float> R(p, b, h);
  const long long st0 = ((long long)b * p.H + h) * p.Lq;

  float rm[4], rinv[4], rdi[4];  // the dq kernel's row statistics
  if (!DKV) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long r = st0 + row0 + ty * 4 + i;
      rm[i] = p.m[r];
      rinv[i] = 1.f / p.l[r];
      rdi[i] = p.di[r];
    }
  }
  float acc1[4][8], acc2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc1[i][j] = acc2[i][j] = 0.f;

  for (int c0 = 0; c0 < R.ncols; c0 += BC) {
    if (DKV && threadIdx.x < BC) {
      st_m[threadIdx.x] = p.m[st0 + c0 + threadIdx.x];
      st_inv[threadIdx.x] = 1.f / p.l[st0 + c0 + threadIdx.x];
      st_di[threadIdx.x] = p.di[st0 + c0 + threadIdx.x];
    }
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < p.d; c += FDC) {
      load_tile_f32<BR, FDC, FDC + 1>(a1s, R.a1 + (long long)row0 * R.a1s, R.a1s, c);
      load_tile_f32<BR, FDC, FDC + 1>(a2s, R.a2 + (long long)row0 * R.a2s, R.a2s, c);
      load_tile_f32<BC, FDC, FDC + 1>(b1s, R.b1 + (long long)c0 * R.b1s, R.b1s, c);
      load_tile_f32<BC, FDC, FDC + 1>(b2s, R.b2 + (long long)c0 * R.b2s, R.b2s, c);
      __syncthreads();
#pragma unroll 8
      for (int kd = 0; kd < FDC; ++kd) {
        float x1[4], x2[4], y1[4], y2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x1[i] = a1s[(ty * 4 + i) * (FDC + 1) + kd];
          x2[i] = a2s[(ty * 4 + i) * (FDC + 1) + kd];
          y1[i] = b1s[(tx + 16 * i) * (FDC + 1) + kd];
          y2[i] = b2s[(tx + 16 * i) * (FDC + 1) + kd];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(x1[i], y1[j], s[i][j]);
            dp[i][j] = fmaf(x2[i], y2[j], dp[i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = tx + 16 * j;
        const float m = DKV ? st_m[ci] : rm[i], inv = DKV ? st_inv[ci] : rinv[i];
        const float di = DKV ? st_di[ci] : rdi[i];
        const float pe = __expf(s[i][j] * p.scale - m) * inv;
        ps[(ty * 4 + i) * (BC + 1) + ci] = pe;
        dss[(ty * 4 + i) * (BC + 1) + ci] = ((dp[i][j] - di) * pe) * p.scale;
      }
    // acc1 += ds . b1[:, chunk]; DKV: acc2 += p . b2[:, chunk]
    for (int kc = 0; kc < BC; kc += FC) {
      load_tile_f32<FC, FD, FD>(t1s, R.b1 + (long long)(c0 + kc) * R.b1s, R.b1s, oc * FD);
      if (DKV) load_tile_f32<FC, FD, FD>(t2s, R.b2 + (long long)(c0 + kc) * R.b2s, R.b2s, oc * FD);
      __syncthreads();  // also publishes ps and dss on the first pass
#pragma unroll 4
      for (int kk = 0; kk < FC; ++kk) {
        float e1[4], e2[4], u1[8], u2[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e1[i] = dss[(ty * 4 + i) * (BC + 1) + kc + kk];
          e2[i] = ps[(ty * 4 + i) * (BC + 1) + kc + kk];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          u1[j] = t1s[kk * FD + tx + 16 * j];
          u2[j] = DKV ? t2s[kk * FD + tx + 16 * j] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc1[i][j] = fmaf(e1[i], u1[j], acc1[i][j]);
            if (DKV) acc2[i][j] = fmaf(e2[i], u2[j], acc2[i][j]);
          }
      }
      __syncthreads();
    }
  }

  float* out1 = static_cast<float*>(DKV ? p.dk : p.dq) + b * (DKV ? p.dks.b : p.dqs.b) +
                h * (DKV ? p.dks.h : p.dqs.h);
  const long long out1_l = DKV ? p.dks.l : p.dqs.l;
  float* out2 = static_cast<float*>(p.dv) + b * p.dvs.b + h * p.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out1[row * out1_l + oc * FD + tx + 16 * j] = acc1[i][j];
      if (DKV) out2[row * p.dvs.l + oc * FD + tx + 16 * j] = acc2[i][j];
    }
  }
}

template <bool DKV>
int launch_bwd_f32(const BParams& p, int B, cudaStream_t st) {
  const dim3 grid((DKV ? p.Lk : p.Lq) / BR, p.H * (p.d / FD), B);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_f32<DKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_F32_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_f32<DKV><<<grid, FT, BWD_F32_SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Pointers 16-byte
// aligned, Lq % 64 == 0, Lk % 128 == 0, d % 128 == 0, strides (in elements)
// multiples of 8 with a contiguous last dim; the Python wrapper checks all of
// this. `ml`, if not null, receives the (2, B, H, Lq) f32 residuals m and l.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* ml,
                                   int B, int H, int Lq, int Lk, int d, int is_f32, long long q_sb,
                                   long long q_sh, long long q_sl, long long k_sb, long long k_sh,
                                   long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                                   long long o_sb, long long o_sh, long long o_sl, float scale,
                                   void* stream) {
  if (B < 1 || H < 1 || Lq < FQ || Lk < FK || Lq % FQ || Lk % FK || d < FD || d % FD ||
      B > 65535 || (long long)H * (d / FD) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FParams p{q, k, v, o, static_cast<float*>(ml), Lk, d,
                  {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl}, {o_sb, o_sh, o_sl},
                  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Lq / FQ, H * (d / FD), B);
  cudaError_t err;
  if (is_f32 && d == XD) {
    err = cudaFuncSetAttribute(flash_fwd_f32_d512, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               X_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32_d512<<<dim3(Lq / XQ, H, B), XT, X_SMEM, st>>>(p);
  } else if (is_f32) {
    err = cudaFuncSetAttribute(flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32<<<grid, FT, F32_SMEM, st>>>(p);
  } else if (d == 128) {
    const sm90::Params sp{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<bf16*>(o),
                          static_cast<float*>(ml), Lq, Lk, d, B, H,
                          q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
                          o_sb, o_sh, o_sl, scale};
    return sm90::launch<sm90::Cfg<128, FK, true, false, 1>>(sp, st);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BF16_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_bf16<<<grid, NTHREADS, BF16_SMEM, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// One backward kernel: part 0 the dk/dv kernel (writes dk, dv), part 1 the
// dq kernel (writes dq). m, l and di are (B, H, Lq) f32, contiguous; bf16
// and f32 at d = 128 read two more planes after di, m log2(e) and 1 / l
// (the wrapper forms them), from a 16-byte aligned di, and f32 at d = 128
// takes 4 B H max(Lq, Lk) d floats more after them for the split planes.
// Returns the launch's CUDA error (0 on success). Shapes and strides as for
// the forward, with Lq and Lk multiples of 64 and bf16 d = 128 or 256; the
// Python wrapper checks them.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   const float* m, const float* l, const float* di, void* dq,
                                   void* dk, void* dv, int B, int H, int Lq, int Lk, int d,
                                   int is_f32, int part, long long q_sb, long long q_sh,
                                   long long q_sl, long long k_sb, long long k_sh, long long k_sl,
                                   long long v_sb, long long v_sh, long long v_sl, long long g_sb,
                                   long long g_sh, long long g_sl, long long dq_sb,
                                   long long dq_sh, long long dq_sl, long long dk_sb,
                                   long long dk_sh, long long dk_sl, long long dv_sb,
                                   long long dv_sh, long long dv_sl, float scale, void* stream) {
  if (B < 1 || H < 1 || Lq < BR || Lk < BC || Lq % BR || Lk % BC || d < FD || d % FD ||
      B > 65535 || (long long)H * (d / FD) > 65535 || part < 0 || part > 1 ||
      (!is_f32 && d != 128 && d != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tf32 = is_f32 && d == 128;
  if (is_f32 && !tf32) {
    const BParams p{q, k, v, g, m, l, di, dq, dk, dv, H, Lq, Lk, d,
                    {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl}, {g_sb, g_sh, g_sl},
                    {dq_sb, dq_sh, dq_sl}, {dk_sb, dk_sh, dk_sl}, {dv_sb, dv_sh, dv_sl}, scale};
    return part == 0 ? launch_bwd_f32<true>(p, B, st) : launch_bwd_f32<false>(p, B, st);
  }
  // the dk/dv kernel copies BN rows of the di, m log2(e) and 1 / l planes at
  // a time
  if (reinterpret_cast<uintptr_t>(di) % 16) return static_cast<int>(cudaErrorInvalidValue);
  float* dd = const_cast<float*>(di);
  const long long plane = (long long)B * H * Lq;
  // f32 rows are handed over as bf16 rows of twice the width
  const long long x = tf32 ? 2 : 1;
  sm90::BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  m, l, dd + plane, dd + 2 * plane, dd,
                  Lq, Lq, Lk, d, B, H, x * q_sb, x * q_sh, x * q_sl, x * k_sb, x * k_sh, x * k_sl,
                  x * v_sb, x * v_sh, x * v_sl, x * g_sb, x * g_sh, x * g_sl,
                  dq_sb, dq_sh, dq_sl, dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl, scale,
                  static_cast<int>(x * d), nullptr, nullptr, nullptr, nullptr};
  using sm90::BCfg;
  if (tf32) {
    // the split pass writes the hi and lo planes of the part's streamed
    // tensors (dk/dv: q and do; dq: k and v) after the statistics planes;
    // the dq kernel's split runs after the dk/dv kernel on the stream
    float* planes = dd + 3 * plane;
    const long long n = plane / Lq * (part == 0 ? Lq : Lk) * d;
    const Strides s1 = part == 0 ? Strides{q_sb, q_sh, q_sl} : Strides{k_sb, k_sh, k_sl};
    const Strides s2 = part == 0 ? Strides{g_sb, g_sh, g_sl} : Strides{v_sb, v_sh, v_sl};
    int err = sm90::split(static_cast<const float*>(part == 0 ? q : k), s1, B, H,
                          part == 0 ? Lq : Lk, d, planes, st);
    if (err == 0)
      err = sm90::split(static_cast<const float*>(part == 0 ? g : v), s2, B, H,
                        part == 0 ? Lq : Lk, d, planes + 2 * n, st);
    if (err != 0) return err;
    const bf16* h1 = reinterpret_cast<const bf16*>(planes);
    const bf16* h2 = reinterpret_cast<const bf16*>(planes + 2 * n);
    if (part == 0) {
      a.hq = h1;
      a.hg = h2;
      return sm90::launch_bwd_sm90<BCfg<256, 32, true, true, false, sm90::TF32>>(a, st);
    }
    a.hk = h1;
    a.hv = h2;
    return sm90::launch_bwd_sm90<BCfg<256, 32, true, false, false, sm90::TF32>>(a, st);
  }
  if (d == 128)
    return part == 0 ? sm90::launch_bwd_sm90<BCfg<128, 64, true, true, false>>(a, st)
                     : sm90::launch_bwd_sm90<BCfg<128, 64, true, false, false>>(a, st);
  return part == 0 ? sm90::launch_bwd_sm90<BCfg<256, 32, true, true, false, sm90::SPLIT>>(a, st)
                   : sm90::launch_bwd_sm90<BCfg<256, 64, true, false, false, sm90::SPLIT>>(a, st);
}
