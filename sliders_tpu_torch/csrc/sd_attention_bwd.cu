// SD self-attention backward for Hopper (sm_90a), exact-softmax numerics.
//
// Replaces sliders_tpu/ops/pallas_attention.py::_attn_bwd_kernel (reached
// from _sd_attention_bwd_impl). For (B, H, L, d) q/k/v and the output's
// gradient g, with d <= 128, it computes what the TPU kernel does, at the
// same rounding points:
//
//   s = (q . k) * d^-1/2 in f32, p = softmax_row(s) in f32 (recomputed);
//   pb = round_to_input_dtype(p);       dv = sum_q pb^T . g   (f32, cast at the end)
//   dp = g . v^T in f32;                dsum = sum_row(dp * p) (p not rounded)
//   ds = round_to_input_dtype(p * (dp - dsum));
//   dq = scale * ds . k (cast to the input dtype);  dk = scale * sum_q ds^T . q (f32, cast)
//
// dsum is taken as the TPU kernel takes it, from dp and the unrounded p, and
// not as rowsum(g * o) from the forward output: o was computed from p after
// rounding, so that shortcut gives another number.
//
// Accumulating dk and dv: the TPU kernel carries them in f32 across the q
// blocks of one head because a TPU grid runs in order. CUDA blocks run in no
// order, so the work splits into two kernels and no atomics are used (the
// sums are the same from run to run):
//   1. dq kernel, one block per 64-row q tile: pass 1 over K finds each row's
//      softmax max m and sum l; pass 2 over K and V recomputes p and dp and
//      sums dsum; pass 3 forms ds and accumulates dq = ds . k. It writes dq
//      and each row's (m, 1/l, dsum) to a small f32 scratch.
//   2. dk/dv kernel, one block per 64-row K/V tile, which stays in registers:
//      a loop over all q tiles recomputes p^T = exp(k . q^T * scale - m) / l
//      from the scratch, and accumulates dv += pb^T . g and, with
//      dp^T = v . g^T, dk += ds^T . q in f32 registers.
// p is recomputed three times in kernel 1 and once in kernel 2; at SD1.5's
// d=40 the work per byte is far below the H100's bf16 ridge (about 295
// operations per byte), so like the forward kernel this one is bound by
// memory traffic and latency, not tensor-core rate. Simple first: mma.sync
// m16n8k16 bf16 tiles, no copy pipelining, transposed operands read from
// shared memory as 16-bit pairs. At d=128 the dk/dv kernel holds K, V, dk
// and dv fragments in registers, so it forms p^T and dp^T one k16 slice of
// the q tile at a time (with all of them live it spilled past 255 registers).
//
// f32 runs one thread per row with plain FMAs (one q row in kernel 1, one
// K/V row in kernel 2). The head dim is zero-padded to a multiple of 16
// inside shared memory and registers only. Every tensor takes element
// strides for batch, head and row (the last dim must be contiguous).

#include "sd_attention_common.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // (3, B, H, Lq) f32: row max m, 1 / row sum, dsum
  int H, Lq, Lk, d;
  Strides qs, ks, vs, gs, dqs, dks, dvs;
  float scale;
};

__device__ __forceinline__ long long stat_index(const BwdParams& p, int b, int h, int row) {
  return ((long long)b * p.H + h) * p.Lq + row;
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dq_bf16(BwdParams p) {
  constexpr int SK = DP + 8;
  __shared__ __align__(16) bf16 ks[BK * SK];
  __shared__ __align__(16) bf16 vs[BK * SK];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.h;
  const bf16* go = static_cast<const bf16*>(p.g) + b * p.gs.b + h * p.gs.h;
  bf16* dq = static_cast<bf16*>(p.dq) + b * p.dqs.b + h * p.dqs.h;

  // Q and G tiles through shared memory into mma A fragments
  load_rows_bf16<DP>(ks, q, p.qs.l, q0, p.Lq, p.d);
  load_rows_bf16<DP>(vs, go, p.gs.l, q0, p.Lq, p.d);
  __syncthreads();
  uint32_t qf[DP / 16][4], gf[DP / 16][4];
  load_a_frags<DP>(qf, ks, r0, g, t4);
  load_a_frags<DP>(gf, vs, r0, g, t4);
  __syncthreads();

  // pass 1: row max and sum of exp (rows g and g + 8 of this warp)
  float m0, m1, l0, l1;
  row_stats<DP>(qf, ks, k, p.ks.l, p.Lk, p.d, p.scale, g, t4, m0, m1, l0, l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // pass 2: dsum = sum over keys of dp * p
  float s[BK / 8][4], dp[BK / 8][4];
  float dsum0 = 0.f, dsum1 = 0.f;
  for (int kv0 = 0; kv0 < p.Lk; kv0 += BK) {
    load_rows_bf16<DP>(ks, k, p.ks.l, kv0, p.Lk, p.d);
    load_rows_bf16<DP>(vs, v, p.vs.l, kv0, p.Lk, p.d);
    __syncthreads();
    tile_logits<DP>(s, qf, ks, kv0, p.Lk, p.scale, g, t4);
    tile_dot<DP>(dp, gf, vs, g, t4);  // keys past Lk have zero V rows and p = 0
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      dsum0 += __expf(s[nt][0] - m0) * inv0 * dp[nt][0] + __expf(s[nt][1] - m0) * inv0 * dp[nt][1];
      dsum1 += __expf(s[nt][2] - m1) * inv1 * dp[nt][2] + __expf(s[nt][3] - m1) * inv1 * dp[nt][3];
    }
  }
  dsum0 = quad_sum(dsum0);
  dsum1 = quad_sum(dsum1);

  // pass 3: ds = p * (dp - dsum), rounded to bf16, times K
  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int kv0 = 0; kv0 < p.Lk; kv0 += BK) {
    load_rows_bf16<DP>(ks, k, p.ks.l, kv0, p.Lk, p.d);
    load_rows_bf16<DP>(vs, v, p.vs.l, kv0, p.Lk, p.d);
    __syncthreads();
    tile_logits<DP>(s, qf, ks, kv0, p.Lk, p.scale, g, t4);
    tile_dot<DP>(dp, gf, vs, g, t4);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      float e[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * kc + j;
        e[j][0] = __expf(s[nt][0] - m0) * inv0 * (dp[nt][0] - dsum0);
        e[j][1] = __expf(s[nt][1] - m0) * inv0 * (dp[nt][1] - dsum0);
        e[j][2] = __expf(s[nt][2] - m1) * inv1 * (dp[nt][2] - dsum1);
        e[j][3] = __expf(s[nt][3] - m1) * inv1 * (dp[nt][3] - dsum1);
      }
      const uint32_t da[4] = {pack_bf16(e[0][0], e[0][1]), pack_bf16(e[0][2], e[0][3]),
                              pack_bf16(e[1][0], e[1][1]), pack_bf16(e[1][2], e[1][3])};
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        uint32_t bfr[2];
        b_frag_kn(bfr, ks, SK, kc * 16, nt * 8, g, t4);  // B[key][c] = K[key][c]
        mma_16816(acc[nt], da, bfr);
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
        *reinterpret_cast<uint32_t*>(dq + (long long)row0 * p.dqs.l + col) =
            pack_bf16(acc[nt][0] * p.scale, acc[nt][1] * p.scale);
      if (row0 + 8 < p.Lq)
        *reinterpret_cast<uint32_t*>(dq + (long long)(row0 + 8) * p.dqs.l + col) =
            pack_bf16(acc[nt][2] * p.scale, acc[nt][3] * p.scale);
    }
  }
  if (t4 == 0) {
    const long long n = (long long)gridDim.z * p.H * p.Lq;  // one stats plane
    if (row0 < p.Lq) {
      const long long i = stat_index(p, b, h, row0);
      p.stats[i] = m0;
      p.stats[n + i] = inv0;
      p.stats[2 * n + i] = dsum0;
    }
    if (row0 + 8 < p.Lq) {
      const long long i = stat_index(p, b, h, row0 + 8);
      p.stats[i] = m1;
      p.stats[n + i] = inv1;
      p.stats[2 * n + i] = dsum1;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkdv_bf16(BwdParams p) {
  constexpr int SK = DP + 8;
  __shared__ __align__(16) bf16 qs[BQ * SK];
  __shared__ __align__(16) bf16 gs[BQ * SK];
  __shared__ float st_m[BQ], st_inv[BQ], st_dsum[BQ];

  const int kv0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.h;
  const bf16* go = static_cast<const bf16*>(p.g) + b * p.gs.b + h * p.gs.h;
  bf16* dk = static_cast<bf16*>(p.dk) + b * p.dks.b + h * p.dks.h;
  bf16* dv = static_cast<bf16*>(p.dv) + b * p.dvs.b + h * p.dvs.h;
  const long long plane = (long long)gridDim.z * p.H * p.Lq;
  const float* stats = p.stats + stat_index(p, b, h, 0);

  // this block's K and V rows into A fragments (they stay in registers)
  load_rows_bf16<DP>(qs, k, p.ks.l, kv0, p.Lk, p.d);
  load_rows_bf16<DP>(gs, v, p.vs.l, kv0, p.Lk, p.d);
  __syncthreads();
  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  load_a_frags<DP>(kf, qs, r0, g, t4);
  load_a_frags<DP>(vf, gs, r0, g, t4);
  __syncthreads();

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    dka[nt][0] = dka[nt][1] = dka[nt][2] = dka[nt][3] = 0.f;
    dva[nt][0] = dva[nt][1] = dva[nt][2] = dva[nt][3] = 0.f;
  }
  for (int q0 = 0; q0 < p.Lq; q0 += BQ) {
    load_rows_bf16<DP>(qs, q, p.qs.l, q0, p.Lq, p.d);
    load_rows_bf16<DP>(gs, go, p.gs.l, q0, p.Lq, p.d);
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const bool in = q0 + i < p.Lq;  // rows past Lq get p = 0
      st_m[i] = in ? stats[q0 + i] : 0.f;
      st_inv[i] = in ? stats[plane + q0 + i] : 0.f;
      st_dsum[i] = in ? stats[2 * plane + q0 + i] : 0.f;
    }
    __syncthreads();

    // one k16 slice of the tile's q rows at a time, so that only two n8
    // tiles of p^T and dp^T are live beside the K, V, dk and dv registers
    // (at d = 128, all eight took the kernel past 255 registers into spills)
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * kc + j;
        // p^T: rows are this warp's keys, columns the tile's q rows
        dot_n8<DP>(s[j], kf, qs, nt, g, t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + t4 * 2 + (e & 1);
          s[j][e] = q0 + qi < p.Lq ? __expf(s[j][e] * p.scale - st_m[qi]) * st_inv[qi] : 0.f;
        }
        dot_n8<DP>(dp[j], vf, gs, nt, g, t4);  // dp^T = v . g^T
      }
      // dv += round(p)^T . g
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        uint32_t bfr[2];
        b_frag_kn(bfr, gs, SK, kc * 16, nt * 8, g, t4);  // B[qi][c] = G[qi][c]
        mma_16816(dva[nt], pa, bfr);
      }
      // dk += round(p * (dp - dsum))^T . q
      float e[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * kc + j;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          e[j][c] = s[j][c] * (dp[j][c] - st_dsum[nt * 8 + t4 * 2 + (c & 1)]);
      }
      const uint32_t da[4] = {pack_bf16(e[0][0], e[0][1]), pack_bf16(e[0][2], e[0][3]),
                              pack_bf16(e[1][0], e[1][1]), pack_bf16(e[1][2], e[1][3])};
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        uint32_t bfr[2];
        b_frag_kn(bfr, qs, SK, kc * 16, nt * 8, g, t4);  // B[qi][c] = Q[qi][c]
        mma_16816(dka[nt], da, bfr);
      }
    }
    __syncthreads();
  }

  const int row0 = kv0 + r0 + g;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
    if (col < p.d) {
      if (row0 < p.Lk) {
        *reinterpret_cast<uint32_t*>(dk + (long long)row0 * p.dks.l + col) =
            pack_bf16(dka[nt][0] * p.scale, dka[nt][1] * p.scale);
        *reinterpret_cast<uint32_t*>(dv + (long long)row0 * p.dvs.l + col) =
            pack_bf16(dva[nt][0], dva[nt][1]);
      }
      if (row0 + 8 < p.Lk) {
        *reinterpret_cast<uint32_t*>(dk + (long long)(row0 + 8) * p.dks.l + col) =
            pack_bf16(dka[nt][2] * p.scale, dka[nt][3] * p.scale);
        *reinterpret_cast<uint32_t*>(dv + (long long)(row0 + 8) * p.dvs.l + col) =
            pack_bf16(dva[nt][2], dva[nt][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMAs, one thread per row
// ---------------------------------------------------------------------------

template <int DP>
__device__ __forceinline__ void load_row_f32(float (&r)[DP], const float* src, long long row_stride,
                                             int row, int nrows, int d) {
#pragma unroll
  for (int i = 0; i < DP; ++i) r[i] = (row < nrows && i < d) ? src[(long long)row * row_stride + i] : 0.f;
}

template <int DP>
__global__ void __launch_bounds__(BQ) attn_bwd_dq_f32(BwdParams p) {
  __shared__ __align__(16) float ks[BKF * DP];
  __shared__ __align__(16) float vs[BKF * DP];

  const int row = blockIdx.x * BQ + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  const float* go = static_cast<const float*>(p.g) + b * p.gs.b + h * p.gs.h;
  float* dq = static_cast<float*>(p.dq) + b * p.dqs.b + h * p.dqs.h;

  float qr[DP], gr[DP];
  load_row_f32<DP>(qr, q, p.qs.l, row, p.Lq, p.d);
  load_row_f32<DP>(gr, go, p.gs.l, row, p.Lq, p.d);

  float m, l;
  row_stats_f32<DP>(qr, ks, k, p.ks.l, p.Lk, p.d, p.scale, m, l);
  const float inv = 1.f / l;

  // pass 2: dsum
  float dsum = 0.f;
  for (int kv0 = 0; kv0 < p.Lk; kv0 += BKF) {
    load_rows_f32<DP>(ks, k, p.ks.l, kv0, p.Lk, p.d);
    load_rows_f32<DP>(vs, v, p.vs.l, kv0, p.Lk, p.d);
    __syncthreads();
    const int nk = min(BKF, p.Lk - kv0);
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f, dpj = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        dot = fmaf(qr[i], ks[j * DP + i], dot);
        dpj = fmaf(gr[i], vs[j * DP + i], dpj);
      }
      dsum = fmaf(__expf(dot * p.scale - m) * inv, dpj, dsum);
    }
    __syncthreads();
  }

  // pass 3: dq = sum_j p_j (dp_j - dsum) k_j
  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = 0.f;
  for (int kv0 = 0; kv0 < p.Lk; kv0 += BKF) {
    load_rows_f32<DP>(ks, k, p.ks.l, kv0, p.Lk, p.d);
    load_rows_f32<DP>(vs, v, p.vs.l, kv0, p.Lk, p.d);
    __syncthreads();
    const int nk = min(BKF, p.Lk - kv0);
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f, dpj = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        dot = fmaf(qr[i], ks[j * DP + i], dot);
        dpj = fmaf(gr[i], vs[j * DP + i], dpj);
      }
      const float dsj = __expf(dot * p.scale - m) * inv * (dpj - dsum);
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(dsj, ks[j * DP + i], acc[i]);
    }
    __syncthreads();
  }
  if (row < p.Lq) {
#pragma unroll
    for (int i = 0; i < DP; ++i)
      if (i < p.d) dq[(long long)row * p.dqs.l + i] = acc[i] * p.scale;
    const long long n = (long long)gridDim.z * p.H * p.Lq;
    const long long si = stat_index(p, b, h, row);
    p.stats[si] = m;
    p.stats[n + si] = inv;
    p.stats[2 * n + si] = dsum;
  }
}

template <int DP>
__global__ void __launch_bounds__(BQ) attn_bwd_dkdv_f32(BwdParams p) {
  __shared__ __align__(16) float qs[BKF * DP];
  __shared__ __align__(16) float gs[BKF * DP];
  __shared__ float st_m[BKF], st_inv[BKF], st_dsum[BKF];

  const int row = blockIdx.x * BQ + threadIdx.x;  // a K/V row
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  const float* go = static_cast<const float*>(p.g) + b * p.gs.b + h * p.gs.h;
  float* dk = static_cast<float*>(p.dk) + b * p.dks.b + h * p.dks.h;
  float* dv = static_cast<float*>(p.dv) + b * p.dvs.b + h * p.dvs.h;
  const long long plane = (long long)gridDim.z * p.H * p.Lq;
  const float* stats = p.stats + stat_index(p, b, h, 0);

  float kr[DP], vr[DP], dka[DP], dva[DP];
  load_row_f32<DP>(kr, k, p.ks.l, row, p.Lk, p.d);
  load_row_f32<DP>(vr, v, p.vs.l, row, p.Lk, p.d);
#pragma unroll
  for (int i = 0; i < DP; ++i) dka[i] = dva[i] = 0.f;

  for (int q0 = 0; q0 < p.Lq; q0 += BKF) {
    load_rows_f32<DP>(qs, q, p.qs.l, q0, p.Lq, p.d);
    load_rows_f32<DP>(gs, go, p.gs.l, q0, p.Lq, p.d);
    if (threadIdx.x < BKF && q0 + threadIdx.x < p.Lq) {
      st_m[threadIdx.x] = stats[q0 + threadIdx.x];
      st_inv[threadIdx.x] = stats[plane + q0 + threadIdx.x];
      st_dsum[threadIdx.x] = stats[2 * plane + q0 + threadIdx.x];
    }
    __syncthreads();
    const int nq = min(BKF, p.Lq - q0);
#pragma unroll 2
    for (int j = 0; j < nq; ++j) {
      float dot = 0.f, dpj = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        dot = fmaf(kr[i], qs[j * DP + i], dot);
        dpj = fmaf(vr[i], gs[j * DP + i], dpj);
      }
      const float pj = __expf(dot * p.scale - st_m[j]) * st_inv[j];
      const float dsj = pj * (dpj - st_dsum[j]);
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        dva[i] = fmaf(pj, gs[j * DP + i], dva[i]);
        dka[i] = fmaf(dsj, qs[j * DP + i], dka[i]);
      }
    }
    __syncthreads();
  }
  if (row < p.Lk) {
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      if (i < p.d) {
        dk[(long long)row * p.dks.l + i] = dka[i] * p.scale;
        dv[(long long)row * p.dvs.l + i] = dva[i];
      }
    }
  }
}

template <int DP>
int launch_bwd(const BwdParams& p, int B, int is_f32, cudaStream_t stream) {
  const dim3 grid_q((p.Lq + BQ - 1) / BQ, p.H, B);
  const dim3 grid_kv((p.Lk + BK - 1) / BK, p.H, B);
  if (is_f32)
    attn_bwd_dq_f32<DP><<<grid_q, BQ, 0, stream>>>(p);
  else
    attn_bwd_dq_bf16<DP><<<grid_q, NTHREADS, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (is_f32)
    attn_bwd_dkdv_f32<DP><<<grid_kv, BQ, 0, stream>>>(p);
  else
    attn_bwd_dkdv_bf16<DP><<<grid_kv, NTHREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the dq kernel, then the dk/dv kernel, on `stream`; returns the
// first cudaGetLastError() that is not 0, else 0. Pointers must be 16-byte
// aligned, d a multiple of 8 in [8, 128], row/head/batch strides (in
// elements) multiples of 8, and `stats` a (3, B, H, Lq) f32 scratch; the
// Python wrapper checks all of this.
extern "C" int sd_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                void* dq, void* dk, void* dv, float* stats, int B, int H, int Lq,
                                int Lk, int d, int is_f32, long long q_sb, long long q_sh,
                                long long q_sl, long long k_sb, long long k_sh, long long k_sl,
                                long long v_sb, long long v_sh, long long v_sl, long long g_sb,
                                long long g_sh, long long g_sl, long long dq_sb, long long dq_sh,
                                long long dq_sl, long long dk_sb, long long dk_sh, long long dk_sl,
                                long long dv_sb, long long dv_sh, long long dv_sl, float scale,
                                void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || B < 1 || H < 1 || Lq < 1 || Lk < 1 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{q, k, v, g, dq, dk, dv, stats, H, Lq, Lk, d,
                    {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl},
                    {g_sb, g_sh, g_sl}, {dq_sb, dq_sh, dq_sl}, {dk_sb, dk_sh, dk_sl},
                    {dv_sb, dv_sh, dv_sl}, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_bwd<16>(p, B, is_f32, st);
    case 32: return launch_bwd<32>(p, B, is_f32, st);
    case 48: return launch_bwd<48>(p, B, is_f32, st);
    case 64: return launch_bwd<64>(p, B, is_f32, st);
    case 80: return launch_bwd<80>(p, B, is_f32, st);
    case 96: return launch_bwd<96>(p, B, is_f32, st);
    case 112: return launch_bwd<112>(p, B, is_f32, st);
    case 128: return launch_bwd<128>(p, B, is_f32, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
