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
//      dq and each row's (m log2 e, 1 / l, dsum) to a small f32 scratch;
//   2. a K/V-major dk/dv kernel that recomputes p^T from the scratch and
//      accumulates dv += pb^T . g and, with dp^T = v . g^T, dk += ds^T . q.
//
// Both kernels run on the Hopper backward mainloop of
// attention_bwd_sm90.cuh at every d the gate takes (8 to 128 in steps of
// 8): a producer filling a ring by TMA (bf16 by cp.async with zero-filled
// pad columns where a row is not 128 or 256 bytes), `wgmma` on two
// consumer warpgroups. bf16 runs the PAIR plan (ds and p from registers
// straight into the A operands of the accumulating products). f32
// (`--precision float32`) runs the TF32 plan, every product three TF32
// `wgmma`s (hi and lo parts): the `tf32_split_bhld` pass first writes
// the hi and lo planes of q, k, v and g into the scratch after the
// statistics, once a call; f32 rows are handed to the mainloop as bf16 rows
// of twice the width. The source note there says what bounds each plan and
// what its design does about it. Every tensor takes element strides for
// batch, head and row (the last dim must be contiguous).

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
  // f32 scratch: m log2(e), 1 / l, dsum planes of (B, H, sl), sl = Lq
  // rounded up to 128; f32 then the hi and lo planes of q, g, k and v
  float* stats;
  int H, Lq, Lk, d;
  Strides qs, ks, vs, gs, dqs, dks, dvs;
  float scale;
};

// the mainloop's arguments: q, k, v, g as bf16 rows of dw columns (f32: 2 d,
// strides doubled), the statistics planes at the head of the scratch
sm90::BwdArgs bwd_args(const BwdParams& p, int B, bool f32) {
  const long long sl = (p.Lq + 127) / 128 * 128, plane = (long long)B * p.H * sl;
  const long long x = f32 ? 2 : 1;
  return sm90::BwdArgs{static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
                       static_cast<const bf16*>(p.v), static_cast<const bf16*>(p.g),
                       static_cast<bf16*>(p.dq), static_cast<bf16*>(p.dk),
                       static_cast<bf16*>(p.dv), nullptr, nullptr,
                       p.stats, p.stats + plane, p.stats + 2 * plane,
                       sl, p.Lq, p.Lk, p.d, B, p.H,
                       x * p.qs.b, x * p.qs.h, x * p.qs.l, x * p.ks.b, x * p.ks.h, x * p.ks.l,
                       x * p.vs.b, x * p.vs.h, x * p.vs.l, x * p.gs.b, x * p.gs.h, x * p.gs.l,
                       p.dqs.b, p.dqs.h, p.dqs.l, p.dks.b, p.dks.h, p.dks.l,
                       p.dvs.b, p.dvs.h, p.dvs.l, p.scale, static_cast<int>(x * p.d),
                       nullptr, nullptr, nullptr, nullptr};
}

// f32: the split pass over q, g, k and v, then the dq kernel (which writes
// the statistics), then the dk/dv kernel, on the TF32 plan with the head
// dim padded to DPF; 64-row streamed tiles where DPF <= 48, else 32 (two
// stages of four planes fit beside the exchange)
template <int DPF, bool TMA>
int launch_f32(const BwdParams& p, int B, cudaStream_t stream) {
  sm90::BwdArgs a = bwd_args(p, B, true);
  const long long nq = (long long)B * p.H * p.Lq * p.d, nk = (long long)B * p.H * p.Lk * p.d;
  float* hq = p.stats + 3 * (long long)B * p.H * a.sl;
  float* hg = hq + 2 * nq;
  float* hk = hg + 2 * nq;
  float* hv = hk + 2 * nk;
  using sm90::split;
  int err = split(static_cast<const float*>(p.q), p.qs, B, p.H, p.Lq, p.d, hq, stream);
  if (err == 0) err = split(static_cast<const float*>(p.g), p.gs, B, p.H, p.Lq, p.d, hg, stream);
  if (err == 0) err = split(static_cast<const float*>(p.k), p.ks, B, p.H, p.Lk, p.d, hk, stream);
  if (err == 0) err = split(static_cast<const float*>(p.v), p.vs, B, p.H, p.Lk, p.d, hv, stream);
  if (err != 0) return err;
  a.hq = reinterpret_cast<const bf16*>(hq);
  a.hg = reinterpret_cast<const bf16*>(hg);
  a.hk = reinterpret_cast<const bf16*>(hk);
  a.hv = reinterpret_cast<const bf16*>(hv);
  constexpr int BN = DPF <= 48 ? 64 : 32;
  err = sm90::launch_bwd_sm90<sm90::BCfg<2 * DPF, BN, TMA, false, true, sm90::TF32>>(a, stream);
  if (err != 0) return err;
  return sm90::launch_bwd_sm90<sm90::BCfg<2 * DPF, BN, TMA, true, true, sm90::TF32>>(a, stream);
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
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  const sm90::BwdArgs a = bwd_args(p, B, false);
  if constexpr (DP == 64 || DP == 128) {
    if (p.d == DP) return launch_bf16<DP, true>(a, stream);
  }
  return launch_bf16<DP, false>(a, stream);
}

// f32: d itself where it is 40 (SD1.5) or a multiple of 16, else the next
// of those; TMA where a row is 128, 256 or 512 bytes (d = 32, 64, 128)
int launch_f32_any(const BwdParams& p, int B, cudaStream_t stream) {
  switch (p.d) {
    case 8:
    case 16: return launch_f32<16, false>(p, B, stream);
    case 24: return launch_f32<40, false>(p, B, stream);
    case 32: return launch_f32<32, true>(p, B, stream);
    case 40: return launch_f32<40, false>(p, B, stream);
    case 48: return launch_f32<48, false>(p, B, stream);
    case 56: return launch_f32<80, false>(p, B, stream);
    case 64: return launch_f32<64, true>(p, B, stream);
    case 72:
    case 80: return launch_f32<80, false>(p, B, stream);
    case 88:
    case 96: return launch_f32<96, false>(p, B, stream);
    case 104:
    case 112: return launch_f32<112, false>(p, B, stream);
    case 120: return launch_f32<128, false>(p, B, stream);
    case 128: return launch_f32<128, true>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the dq kernel, then the dk/dv kernel (f32: after the split
// pass), on `stream`; returns the first CUDA error that is not 0, else 0.
// Pointers must be 16-byte aligned, d a multiple of 8 in [8, 128],
// row/head/batch strides (in elements) multiples of 8, and `stats` an f32
// scratch of 3 B H Lq' floats, Lq' = Lq rounded up to 128, and in f32 4 B H
// (Lq + Lk) d more; the Python wrapper checks all of this.
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
  if (is_f32) return launch_f32_any(p, B, st);
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_bwd<16>(p, B, st);
    case 32: return launch_bwd<32>(p, B, st);
    case 48: return launch_bwd<48>(p, B, st);
    case 64: return launch_bwd<64>(p, B, st);
    case 80: return launch_bwd<80>(p, B, st);
    case 96: return launch_bwd<96>(p, B, st);
    case 112: return launch_bwd<112>(p, B, st);
    case 128: return launch_bwd<128>(p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
