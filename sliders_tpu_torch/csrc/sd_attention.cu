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
// bf16 and f16: the Hopper mainloop of attention_sm90.cuh in two-pass mode
// (f16 on the same plans, `CfgF16`: f16 operands to `wgmma`, p and o
// rounded to f16, as the TPU kernel computes at f16): 128 q
// rows a block on two consumer warpgroups, a producer filling a K/V ring
// (TMA at d = 64 and 128, cp.async with zero-fill elsewhere), wgmma for
// Q.K^T and P.V. Both passes run on the same ring: pass 1 streams K only,
// pass 2 K and V. 128-key tiles and one block an SM (a producer
// warpgroup, setmaxnreg), except at d = 64: 64-key tiles and two blocks an
// SM (a producer warp), whose items run out of step with each other, so
// one block's softmax overlaps the other's products. What stays between it
// and SDPA at d <= 80: the softmax (two exps a logit, on the 16-a-clock
// MUFU pipe) runs in step with the products, not beside them.
// f32 (`--precision float32`): the same two passes on 3xTF32 `wgmma`
// (error-compensated TF32, as the f32 backwards and convs run), the
// FWD_TWO_PASS plan of attention_fwd_tf32.cuh (its note says what shapes
// it): split passes write K's TF32 hi and lo planes and V's transposed, with
// the keys of each block of 8 ordered as P.V's A fragment takes p; 128 q
// rows a block, each consumer warpgroup 64 of them and every product of its
// rows; both passes form S bit for bit alike; p = 2^(c s - (c m + log2 l))
// is formed normalised, in f32 (its rounding to the input dtype is the
// identity); each K/V tile's P.V starts from zero and is added into a
// running f32 sum.
//
// q/k/v/o take element strides for batch, head and row (the last dim must
// be contiguous), so the caller can pass the (B, L, H, d) views of the
// projection outputs with no copy.

#include "sd_attention_common.cuh"
#include "attention_sm90.cuh"
#include "attention_bwd_sm90.cuh"
#include "attention_fwd_tf32.cuh"

#include <type_traits>

namespace {

// the element types of the dtype code the Python wrapper passes
enum : int { DT_BF16 = 0, DT_F32 = 1, DT_F16 = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Lq, Lk, d;
  Strides qs, ks, vs, os;
  float scale;
};

// ---------------------------------------------------------------------------
// f32: the TF32 plan (attention_fwd_tf32.cuh, FWD_TWO_PASS)
// ---------------------------------------------------------------------------

// the split passes over k and v into the scratch, then the kernel with the
// head dim padded to DPF: 64 keys a stage where DPF <= 64, else 32
template <int DPF, bool TMA>
int launch_tf32(const Params& p, int B, int H, float* scratch, cudaStream_t stream) {
  // f32 rows as bf16 rows of twice the width, strides doubled
  const sm90::Params sp{static_cast<const bf16*>(p.q), nullptr, nullptr, static_cast<bf16*>(p.o),
                        nullptr, p.Lq, p.Lk, p.d, B, H, 2 * p.qs.b, 2 * p.qs.h, 2 * p.qs.l,
                        0, 0, 0, 0, 0, 0, p.os.b, p.os.h, p.os.l, p.scale};
  return sm90::launch_fwd_tf32<sm90::FCfg<DPF, DPF <= 64 ? 64 : 32, TMA>>(
      sp, static_cast<const float*>(p.k), p.ks, static_cast<const float*>(p.v), p.vs, scratch,
      stream);
}

// f32: d itself where it is 40 (SD1.5) or a multiple of 16, else the next
// of those, as the f32 backward pads it; the swizzle where a row is 128, 256
// or 512 bytes (d = 32, 64, 128)
int launch_f32(const Params& p, int B, int H, float* scratch, cudaStream_t st) {
  switch (p.d) {
    case 8:
    case 16: return launch_tf32<16, false>(p, B, H, scratch, st);
    case 24: return launch_tf32<40, false>(p, B, H, scratch, st);
    case 32: return launch_tf32<32, true>(p, B, H, scratch, st);
    case 40: return launch_tf32<40, false>(p, B, H, scratch, st);
    case 48: return launch_tf32<48, false>(p, B, H, scratch, st);
    case 56: return launch_tf32<80, false>(p, B, H, scratch, st);
    case 64: return launch_tf32<64, true>(p, B, H, scratch, st);
    case 72:
    case 80: return launch_tf32<80, false>(p, B, H, scratch, st);
    case 88:
    case 96: return launch_tf32<96, false>(p, B, H, scratch, st);
    case 104:
    case 112: return launch_tf32<112, false>(p, B, H, scratch, st);
    case 120: return launch_tf32<128, false>(p, B, H, scratch, st);
    case 128: return launch_tf32<128, true>(p, B, H, scratch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16
// ---------------------------------------------------------------------------

// the plan <DP, BK, TMA, two-pass, blocks an SM> on bf16 or f16 operands
template <bool F16, int DP, int BK, bool TMA, int CTAS>
using Plan = std::conditional_t<F16, sm90::CfgF16<DP, BK, TMA, true, CTAS>,
                                sm90::Cfg<DP, BK, TMA, true, CTAS>>;

template <int DP, bool F16>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  const sm90::Params sp{static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
                        static_cast<const bf16*>(p.v), static_cast<bf16*>(p.o), nullptr,
                        p.Lq, p.Lk, p.d, B, H,
                        p.qs.b, p.qs.h, p.qs.l, p.ks.b, p.ks.h, p.ks.l,
                        p.vs.b, p.vs.h, p.vs.l, p.os.b, p.os.h, p.os.l, p.scale};
  // d = 64 (SDXL): two blocks an SM, 64-key tiles; else one block, 128-key tiles
  if constexpr (DP == 64) {
    if (p.d == 64) return sm90::launch<Plan<F16, 64, 64, true, 2>>(sp, stream);
  }
  if constexpr (DP == 128) {
    if (p.d == 128) return sm90::launch<Plan<F16, 128, 128, true, 1>>(sp, stream);
  }
  return sm90::launch<Plan<F16, DP, 128, false, 1>>(sp, stream);
}

template <bool F16>
int launch_2byte(const Params& p, int B, int H, cudaStream_t st) {
  switch ((p.d + 15) / 16 * 16) {
    case 16: return launch<16, F16>(p, B, H, st);
    case 32: return launch<32, F16>(p, B, H, st);
    case 48: return launch<48, F16>(p, B, H, st);
    case 64: return launch<64, F16>(p, B, H, st);
    case 80: return launch<80, F16>(p, B, H, st);
    case 96: return launch<96, F16>(p, B, H, st);
    case 112: return launch<112, F16>(p, B, H, st);
    case 128: return launch<128, F16>(p, B, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Pointers must be
// 16-byte aligned, d a multiple of 8 in [8, 128], row/head/batch strides (in
// elements) multiples of 8, `dtype` 0 (bf16), 1 (f32) or 2 (f16), and in f32
// `scratch` 16-byte aligned f32 room for K's hi and lo planes and V^T's (2 B
// H Lk d + 2 B H d Lk' floats, Lk' = Lk rounded up to 8; null in bf16 and
// f16); the Python wrapper checks all of this.
extern "C" int sd_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                float* scratch, int B, int H, int Lq, int Lk, int d, int dtype,
                                long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                                long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                                long long v_sl, long long o_sb, long long o_sh, long long o_sl,
                                float scale, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || B < 1 || H < 1 || Lq < 1 || Lk < 1 || B > 65535 ||
      H > 65535 || dtype < DT_BF16 || dtype > DT_F16 ||
      (dtype == DT_F32 && (scratch == nullptr || (long long)B * H > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, Lq, Lk, d,
                 {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl}, {o_sb, o_sh, o_sl},
                 scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_f32(p, B, H, scratch, st);
  return dtype == DT_F16 ? launch_2byte<true>(p, B, H, st) : launch_2byte<false>(p, B, H, st);
}
