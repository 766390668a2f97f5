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
//   1. a q-major dq kernel: one pass over K and V finds each row's softmax
//      max m, sum l and dsum (a running max, l and dsum's sum rescaled when
//      it grows), a second forms ds and accumulates dq = ds . k; it writes
//      dq and each row's (m, l, dsum) to a small f32 scratch;
//   2. a K/V-major dk/dv kernel that recomputes p^T from the scratch and
//      accumulates dv += pb^T . g and, with dp^T = v . g^T, dk += ds^T . q.
//
// bf16 (every d the gate takes, 8 to 128 in steps of 8): both kernels run on
// the Hopper backward mainloop of attention_bwd_sm90.cuh (a producer filling
// a ring by TMA at d = 64 and 128 and by cp.async with zero-filled pad
// columns elsewhere; `wgmma` on two consumer warpgroups of 64 rows each,
// ds and p going from registers straight into the A operands of the
// accumulating products). The source note there says what bounds it.
//
// f32 (`--precision float32` only) runs one thread per row with plain FMAs
// (one q row in the dq kernel, one K/V row in the dk/dv kernel), with K/V or
// q/g tiles of 32 rows in shared memory, three passes in the dq kernel. The
// head dim is zero-padded to a multiple of 16 inside shared memory and
// registers only. Every tensor takes element strides for batch, head and row
// (the last dim must be contiguous).

#include "sd_attention_common.cuh"
#include "attention_bwd_sm90.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // f32 scratch: m, 1 / l, dsum planes of (B, H, Lq) (f32) or m log2(e),
                 // 1 / l, dsum of (B, H, Lq rounded up to 128) (bf16)
  int H, Lq, Lk, d;
  Strides qs, ks, vs, gs, dqs, dks, dvs;
  float scale;
};

__device__ __forceinline__ long long stat_index(const BwdParams& p, int b, int h, int row) {
  return ((long long)b * p.H + h) * p.Lq + row;
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
int launch_f32(const BwdParams& p, int B, cudaStream_t stream) {
  attn_bwd_dq_f32<DP><<<dim3((p.Lq + BQ - 1) / BQ, p.H, B), BQ, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_f32<DP><<<dim3((p.Lk + BQ - 1) / BQ, p.H, B), BQ, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the dq kernel (which writes the statistics), then the dk/dv kernel; TMA
// where d fills a 64-column box exactly, cp.async elsewhere; 128-row
// streamed tiles where d <= 48 leaves the consumers the registers
template <int DP, bool TMA>
int launch_bf16(const sm90::BwdArgs& a, cudaStream_t stream) {
  constexpr int BN = DP <= 48 ? 128 : 64;
  const int err = sm90::launch_bwd_sm90<sm90::BCfg<DP, BN, TMA, false, true>>(a, stream);
  if (err != 0) return err;
  return sm90::launch_bwd_sm90<sm90::BCfg<DP, BN, TMA, true, true>>(a, stream);
}

template <int DP>
int launch_bwd(const BwdParams& p, int B, int is_f32, cudaStream_t stream) {
  if (is_f32) return launch_f32<DP>(p, B, stream);
  // m log2(e), 1 / l, dsum planes of (B, H, Lq rounded up to 128): 16-byte
  // aligned rows for the dk/dv kernel's copies; the dq kernel's 128-row
  // tiles fill them
  const long long sl = (p.Lq + 127) / 128 * 128, plane = (long long)B * p.H * sl;
  const sm90::BwdArgs a{static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
                        static_cast<const bf16*>(p.v), static_cast<const bf16*>(p.g),
                        static_cast<bf16*>(p.dq), static_cast<bf16*>(p.dk),
                        static_cast<bf16*>(p.dv), nullptr, nullptr,
                        p.stats, p.stats + plane, p.stats + 2 * plane,
                        sl, p.Lq, p.Lk, p.d, B, p.H,
                        p.qs.b, p.qs.h, p.qs.l, p.ks.b, p.ks.h, p.ks.l, p.vs.b, p.vs.h, p.vs.l,
                        p.gs.b, p.gs.h, p.gs.l, p.dqs.b, p.dqs.h, p.dqs.l,
                        p.dks.b, p.dks.h, p.dks.l, p.dvs.b, p.dvs.h, p.dvs.l, p.scale};
  if constexpr (DP == 64 || DP == 128) {
    if (p.d == DP) return launch_bf16<DP, true>(a, stream);
  }
  return launch_bf16<DP, false>(a, stream);
}

}  // namespace

// Launches the dq kernel, then the dk/dv kernel, on `stream`; returns the
// first CUDA error that is not 0, else 0. Pointers must be 16-byte
// aligned, d a multiple of 8 in [8, 128], row/head/batch strides (in
// elements) multiples of 8, and `stats` an f32 scratch of 3 B H Lq' floats,
// Lq' = Lq rounded up to 128; the Python wrapper checks all of this.
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
