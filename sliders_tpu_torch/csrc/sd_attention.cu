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
// rounds it and accumulates p.V. Pass 1 is a third of the products.
//
// What bounds it: 4 L^2 d operations (6 with pass 1) against 4 L d bytes
// per head. At FLUX's d = 128 and SDXL's d = 64 that is tensor-core work;
// at SD1.5's d = 40 the work per byte is still above the H100's bf16 ridge
// (about 295 operations per byte) once K/V of a head (4096 x 40 x 2 B =
// 320 KB) stay in L2, so the kernel has to keep the tensor cores fed.
//
// bf16: the Hopper mainloop of attention_sm90.cuh in two-pass mode: 128 q
// rows a block on two consumer warpgroups, a producer filling a K/V ring
// (TMA at d = 64 and 128, cp.async with zero-fill elsewhere), wgmma for
// Q.K^T and P.V. Both passes run on the same ring: pass 1 streams K only,
// pass 2 K and V. 128-key tiles and one block an SM (a producer
// warpgroup, setmaxnreg), except at d = 64: 64-key tiles and two blocks an
// SM (a producer warp), whose items run out of step with each other, so
// one block's softmax overlaps the other's products. What stays between it
// and SDPA at d <= 80: the softmax (two exps a logit, on the 16-a-clock
// MUFU pipe) runs in step with the products, not beside them.
// f32 (`--precision float32` only): one thread per q row with plain FMAs,
// K/V tiles of 32 rows in shared memory.
//
// q/k/v/o take element strides for batch, head and row (the last dim must
// be contiguous), so the caller can pass the (B, L, H, d) views of the
// projection outputs with no copy.

#include "sd_attention_common.cuh"
#include "attention_sm90.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Lq, Lk, d;
  Strides qs, ks, vs, os;
  float scale;
};

// f32: one thread per q row, K/V tiles of BKF rows in shared memory
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

  // pass 1: the row's max and sum over all keys
  float m, l;
  row_stats_f32<DP>(qr, ks, k, p.ks.l, p.Lk, p.d, p.scale, m, l);
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
int launch(const Params& p, int B, int H, int is_f32, cudaStream_t stream) {
  if (is_f32) {
    const dim3 grid((p.Lq + BQ - 1) / BQ, H, B);
    attn_fwd_f32<DP><<<grid, BQ, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const sm90::Params sp{static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
                        static_cast<const bf16*>(p.v), static_cast<bf16*>(p.o), nullptr,
                        p.Lq, p.Lk, p.d, B, H,
                        p.qs.b, p.qs.h, p.qs.l, p.ks.b, p.ks.h, p.ks.l,
                        p.vs.b, p.vs.h, p.vs.l, p.os.b, p.os.h, p.os.l, p.scale};
  // d = 64 (SDXL): two blocks an SM, 64-key tiles; else one block, 128-key tiles
  if constexpr (DP == 64) {
    if (p.d == 64) return sm90::launch<sm90::Cfg<64, 64, true, true, 2>>(sp, stream);
  }
  if constexpr (DP == 128) {
    if (p.d == 128) return sm90::launch<sm90::Cfg<128, 128, true, true, 1>>(sp, stream);
  }
  return sm90::launch<sm90::Cfg<DP, 128, false, true, 1>>(sp, stream);
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
    case 16: return launch<16>(p, B, H, is_f32, st);
    case 32: return launch<32>(p, B, H, is_f32, st);
    case 48: return launch<48>(p, B, H, is_f32, st);
    case 64: return launch<64>(p, B, H, is_f32, st);
    case 80: return launch<80>(p, B, H, is_f32, st);
    case 96: return launch<96>(p, B, H, is_f32, st);
    case 112: return launch<112>(p, B, H, is_f32, st);
    case 128: return launch<128>(p, B, H, is_f32, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
