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
// f32 (`--precision float32`): the same two passes on 3xTF32 `wgmma`
// (error-compensated TF32, as the f32 backwards and convs run): every
// product is three `wgmma.m64nNk8.f32.tf32.tf32` a k8 step, A_lo B_hi +
// A_hi B_lo + A_hi B_hi, with hi = x rounded to TF32 and lo the rest; one
// TF32 product keeps about 11 bits and misses the f32 tolerance. What
// shapes it:
//   - TF32 `wgmma` reads B from shared memory K-major only. S = Q.K^T
//     contracts over d, along which K's rows already run: the wrapper's split
//     pass (attention_bwd_sm90.cuh's tf32_split_bhld) writes K's hi and lo
//     planes. P.V contracts over keys, so a second split pass (this file's
//     tf32_split_vt) writes V's planes transposed, (B, H, d, L), and p goes
//     from the S accumulator straight into P.V's A registers. A TF32 A
//     fragment holds columns (c, c + 4) of each k8 block where the
//     accumulator holds (2 c, 2 c + 1), so the split pass orders the keys
//     of each block of 8 to match (0 2 4 6 1 3 5 7): the contraction does
//     not care about the order, and no shuffle is needed.
//   - Q is the resident A operand, read raw by TMA and split in registers
//     as each k8 step's fragment loads (`ldmatrix` on 32-bit data); p is
//     split in registers too, both with integer rounding (no
//     cvt.rna.tf32.f32 on the hot path).
//   - Both passes issue the same products in the same order, so S is the
//     same bits in both; p = 2^(c s - (c m + log2 l)) is formed normalised,
//     in f32 (its rounding to the input dtype is the identity).
//   - The tensor cores' accumulation is not f32's over long sums, so each
//     K/V tile's P.V starts from zero and is added into a running f32 sum.
//   - One block an SM: 128 q rows, each consumer warpgroup 64 of them and
//     every product of its rows (nothing is exchanged); a producer warp
//     feeds a TMA ring of (K hi, K lo, V^T hi, V^T lo) planes, 64 keys a
//     stage where d <= 64 and 32 above (two stages beside the 128-row q
//     tile at d = 128). The head dim is padded as the f32 backward pads it
//     (d = 40 runs five k8 steps and P.V at n = 40).
//
// q/k/v/o take element strides for batch, head and row (the last dim must
// be contiguous), so the caller can pass the (B, L, H, d) views of the
// projection outputs with no copy.

#include "sd_attention_common.cuh"
#include "attention_sm90.cuh"
#include "attention_bwd_sm90.cuh"

namespace {

using sm90::QROWS;
using sm90::WG;

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
// f32: the TF32 plan
// ---------------------------------------------------------------------------

// One instantiation: DPF the (padded) f32 head dim, BK keys a stage, TMA the
// 128-byte swizzle for Q and K rows (d = 32, 64, 128; 16-byte boxes with no
// swizzle elsewhere). The V^T planes' rows are keys, BK f32 wide: always
// 128-byte swizzled boxes of 32 keys. The member names are those the
// backward's TF32 helpers read (attention_bwd_sm90.cuh: seg, bdesc,
// a_rows). Shared memory from a 1024-byte aligned base: barriers, the
// 128-row q tile, STAGES stages of four TILE_BYTES planes.
template <int DPF_, int BK_, bool TMA_>
struct FCfg {
  static constexpr int DPF = DPF_;
  static constexpr int DP = 2 * DPF_;  // a row in bf16 units
  static constexpr int BK = BK_;
  static constexpr bool TMA = TMA_;
  static constexpr bool TMA16 = !TMA_;
  static constexpr int RROWS = QROWS;
  static constexpr int THREADS = 3 * WG;  // two consumer warpgroups, then the producer
  static constexpr int Q_BYTES = QROWS * DPF * 4;
  static constexpr int TILE_BYTES = BK * DPF * 4;  // a plane of K, or of V^T
  static constexpr int STAGE_BYTES = 4 * TILE_BYTES;  // K hi, K lo, V^T hi, V^T lo
  static constexpr int FIXED = 1024 /* align */ + 1024 /* barriers */ + Q_BYTES;
  static constexpr int STAGES_FIT = (sm90::SMEM_MAX - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(!TMA || DPF == 32 || DPF == 64 || DPF == 128, "TMA boxes are 32 f32 columns");
  static_assert(BK == 32 || BK == 64, "S tiles are wgmma n32 or n64, V^T boxes 32 keys");
};

// The producer (one thread) walks the block's items: the q tile, then K's
// hi and lo planes of every tile (pass 1), then K's and V^T's (pass 2).
// Boxes of 64 bf16 columns (128-byte swizzle) or 8 (16 bytes) for Q and K;
// V^T's 32-key boxes are DPF rows of 128 bytes.
template <class C>
__device__ __forceinline__ void fwd_produce(const sm90::Params& p, const sm90::Ring& r,
                                            const CUtensorMap* tq, const CUtensorMap* tkh,
                                            const CUtensorMap* tkl, const CUtensorMap* tvh,
                                            const CUtensorMap* tvl) {
  using namespace sm90;
  if (threadIdx.x != 2 * WG) return;
  constexpr int BW = C::TMA ? 64 : 8, BOXES = C::DP / BW;
  constexpr int QBOX = QROWS * BW * 2, KBOX = C::BK * BW * 2, VBOX = C::DPF * 128;
  const int nt = (p.Lk + C::BK - 1) / C::BK;
  int stage = 0, phase = 0, qphase = 0;
  for (int w = blockIdx.x; w < items(p); w += gridDim.x, qphase ^= 1) {
    const Item it = item(p, w);
    mbar_wait(r.qempty, qphase ^ 1);
    mbar_expect_tx(r.qfull, C::Q_BYTES);
#pragma unroll 1
    for (int x = 0; x < BOXES; ++x)
      tma_load_4d(r.q_tile + x * QBOX, tq, r.qfull, x * BW, it.q0, it.h, it.b);
    for (int i = 0; i < 2 * nt; ++i) {
      const bool with_v = i >= nt;
      const int kv0 = (i % nt) * C::BK;
      mbar_wait(&r.empty[stage], phase ^ 1);
      const uint32_t t = r.stages + stage * C::STAGE_BYTES;
      mbar_expect_tx(&r.full[stage], (with_v ? 4 : 2) * C::TILE_BYTES);
#pragma unroll 1
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(t + x * KBOX, tkh, &r.full[stage], x * BW, kv0, it.h, it.b);
        tma_load_4d(t + C::TILE_BYTES + x * KBOX, tkl, &r.full[stage], x * BW, kv0, it.h, it.b);
      }
      if (with_v) {
#pragma unroll
        for (int x = 0; x < C::BK / 32; ++x) {
          tma_load_4d(t + 2 * C::TILE_BYTES + x * VBOX, tvh, &r.full[stage], 2 * kv0 + 64 * x, 0,
                      it.h, it.b);
          tma_load_4d(t + 3 * C::TILE_BYTES + x * VBOX, tvl, &r.full[stage], 2 * kv0 + 64 * x, 0,
                      it.h, it.b);
        }
      }
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// One item of a consumer warpgroup cw: its 64 q rows (from 64 cw of the q
// tile) through both passes, then their store
template <class C>
__device__ __forceinline__ void fwd_item_tf32(const sm90::Params& p, const sm90::Ring& r,
                                              const sm90::Item& it, int cw, int t, int& stage,
                                              int& phase, int qphase) {
  using namespace sm90;
  constexpr int KS = C::DPF / 8, KK = C::BK / 8, H2 = C::BK / 2, NO = C::DPF / 2;
  const int warp = t / 32, lane = t % 32, g = lane >> 2, t4 = lane & 3;
  const float c = p.scale * LOG2E;
  const int nt = (p.Lk + C::BK - 1) / C::BK;
  auto wait_full = [&]() { mbar_wait(&r.full[stage], phase); };
  auto release = [&]() {
    mbar_arrive(&r.empty[stage]);
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  float s[H2];
  // S = Q K^T of this warpgroup's rows and the stage at tk (unscaled)
  auto logits = [&](uint32_t tk) {
    tf32x3<C::BK, KS>(
        s,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          a_rows<C>(h, l, r.q_tile, warp, lane, kk, 64 * cw);
        },
        [&](int kk, int pl) { return bdesc<C>(tk + pl * C::TILE_BYTES, C::BK, 0, kk); });
  };
  mbar_wait(r.qfull, qphase);

  // pass 1: each row's max M (unscaled) and sum l, l rescaled when M grows
  float M0 = -INFINITY, M1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < nt; ++j) {
    wait_full();
    logits(r.stages + stage * C::STAGE_BYTES);
    release();
    mask_keys<C>(s, j * C::BK, p.Lk, t4);
    // the first tile always holds a valid key, so mn is finite from here on
    const float2 mn = tile_max(s, H2, M0, M1);
    const float b0 = mn.x * c, b1 = mn.y * c;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < H2; i += 4) {
      sum0 += ex2(fmaf(s[i], c, -b0)) + ex2(fmaf(s[i + 1], c, -b0));
      sum1 += ex2(fmaf(s[i + 2], c, -b1)) + ex2(fmaf(s[i + 3], c, -b1));
    }
    l0 = l0 * ex2(fmaf(M0, c, -b0)) + quad_sum(sum0);
    l1 = l1 * ex2(fmaf(M1, c, -b1)) + quad_sum(sum1);
    M0 = mn.x;
    M1 = mn.y;
  }

  // pass 2: p = exp(scale s - scale M) / l = 2^(c s - (c M + log2 l)), then
  // O += P V^T's transpose, each tile's share from zero
  const float n0 = M0 * c + log2f(l0), n1 = M1 * c + log2f(l1);
  float o[NO], part[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    wait_full();
    const uint32_t tk = r.stages + stage * C::STAGE_BYTES;
    logits(tk);
    mask_keys<C>(s, j * C::BK, p.Lk, t4);
#pragma unroll
    for (int i = 0; i < H2; ++i) s[i] = ex2(fmaf(s[i], c, -(i & 2 ? n1 : n0)));
    // A of k8 step kk: accumulator columns 8 kk + 2 t4 (+ 1) of rows g, g + 8
    // as fragment columns t4 and t4 + 4 (V^T's keys are ordered to match)
    tf32x3<C::DPF, KK>(
        part,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          h[0] = __float_as_uint(s[4 * kk]);
          h[1] = __float_as_uint(s[4 * kk + 2]);
          h[2] = __float_as_uint(s[4 * kk + 1]);
          h[3] = __float_as_uint(s[4 * kk + 3]);
          split4(h, l);
        },
        [&](int kk, int pl) {
          return make_desc(tk + (2 + pl) * C::TILE_BYTES + (kk / 4) * C::DPF * 128 + (kk % 4) * 32,
                           16, 1024, 1);
        });
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] += part[i];
    release();
  }
  mbar_arrive(r.qempty);  // the last read of the q tile is done

  const int row = it.q0 + 64 * cw + 16 * warp + g;
  float* out = reinterpret_cast<float*>(p.o) + it.b * p.ob + it.h * p.oh;
#pragma unroll
  for (int jb = 0; jb < C::DPF / 8; ++jb) {
    const int col = jb * 8 + 2 * t4;  // d % 8 == 0, so col < d implies col + 1 < d
    if (col < p.d) {
      if (row < p.Lq)
        *reinterpret_cast<float2*>(out + (long long)row * p.ol + col) =
            make_float2(o[4 * jb], o[4 * jb + 1]);
      if (row + 8 < p.Lq)
        *reinterpret_cast<float2*>(out + (long long)(row + 8) * p.ol + col) =
            make_float2(o[4 * jb + 2], o[4 * jb + 3]);
    }
  }
}

// a persistent 1-d grid of at most one block an SM, each walking items; the
// maps are the q tile's, K's hi and lo planes' and V^T's
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    attn_fwd_tf32(const sm90::Params p, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tkh, const __grid_constant__ CUtensorMap tkl,
                  const __grid_constant__ CUtensorMap tvh,
                  const __grid_constant__ CUtensorMap tvl) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);  // 1024-byte aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  Ring r;
  r.full = bars;
  r.empty = bars + C::STAGES;
  r.qfull = bars + 2 * C::STAGES;
  r.qempty = bars + 2 * C::STAGES + 1;
  r.q_tile = smem_u32(base) + 1024;
  r.stages = r.q_tile + C::Q_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 2 * WG);
    }
    mbar_init(r.qfull, 1);
    mbar_init(r.qempty, 2 * WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 2 * WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    fwd_produce<C>(p, r, &tq, &tkh, &tkl, &tvh, &tvl);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / WG;
    int stage = 0, phase = 0, qphase = 0;
    for (int w = blockIdx.x; w < items(p); w += gridDim.x, qphase ^= 1)
      fwd_item_tf32<C>(p, r, item(p, w), cw, threadIdx.x - WG * cw, stage, phase, qphase);
  }
}

// tf32_split_bhld's split of a (B, H, L, d) tensor transposed, into two
// contiguous (B, H, d, Lp) planes (Lp = L rounded up to 8), hi then lo, n
// elements each, with the keys of each block of 8 in the order the TF32 A
// fragment of an f32 accumulator takes them: position c of a block holds
// key 2 c for c < 4 and key 2 (c - 4) + 1 above (fwd_item_tf32's P.V);
// keys at or past L are zeros. A block of 32 x 8 threads moves 32 keys x 32 columns
// of one head through shared memory, reading and writing whole rows.
__global__ void tf32_split_vt(const float* x, long long sb, long long sh, long long sl, int H,
                              int L, int d, int Lp, float* hi, long long n) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int l0 = blockIdx.x * 32, c0 = blockIdx.y * 32, tx = threadIdx.x;
  const float* src = x + b * sb + h * sh;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int l = l0 + i, c = c0 + tx;
    tile[i][tx] = l < L && c < d ? src[(long long)l * sl + c] : 0.f;
  }
  __syncthreads();
  const int key = (tx & ~7) + ((tx & 7) < 4 ? 2 * (tx & 7) : 2 * (tx & 7) - 7);
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, pos = l0 + tx;
    if (c < d && pos < Lp) {
      const float v = tile[key][i], vh = sm90::tf32_rna(v);
      const long long o = ((long long)bh * d + c) * Lp + pos;
      hi[o] = vh;
      hi[n + o] = sm90::tf32_rna(__fsub_rn(v, vh));
    }
  }
}

int split_vt(const float* x, const Strides& s, int B, int H, int L, int d, float* hi,
                    cudaStream_t stream) {
  const int lp = (L + 7) / 8 * 8;
  const dim3 grid((lp + 31) / 32, (d + 31) / 32, B * H);
  tf32_split_vt<<<grid, dim3(32, 8), 0, stream>>>(x, s.b, s.h, s.l, H, L, d, lp, hi,
                                                 (long long)B * H * d * lp);
  return static_cast<int>(cudaGetLastError());
}

// f32: the split passes over k (planes) and v (transposed planes) into the
// scratch, then the kernel with the head dim padded to DPF
template <int DPF, bool TMA>
int launch_tf32(const Params& p, int B, int H, float* scratch, cudaStream_t stream) {
  using C = FCfg<DPF, DPF <= 64 ? 64 : 32, TMA>;
  const long long nk = (long long)B * H * p.Lk * p.d;
  const int lp = (p.Lk + 7) / 8 * 8;
  float* hk = scratch;
  float* hv = scratch + 2 * nk;
  int err = sm90::split(static_cast<const float*>(p.k), p.ks, B, H, p.Lk, p.d, hk, stream);
  if (err == 0) err = split_vt(static_cast<const float*>(p.v), p.vs, B, H, p.Lk, p.d, hv, stream);
  if (err != 0) return err;
  // f32 rows as bf16 rows of twice the width, strides doubled
  const sm90::Params sp{static_cast<const bf16*>(p.q), nullptr, nullptr, static_cast<bf16*>(p.o),
                        nullptr, p.Lq, p.Lk, p.d, B, H, 2 * p.qs.b, 2 * p.qs.h, 2 * p.qs.l,
                        0, 0, 0, 0, 0, 0, p.os.b, p.os.h, p.os.l, p.scale};
  constexpr int BW = TMA ? 64 : 8;
  const long long kl = 2ll * p.d, kh = kl * p.Lk, kb = kh * H;
  const long long vl = 2ll * lp, vh = vl * p.d, vb = vh * H;
  const bf16* k16 = reinterpret_cast<const bf16*>(hk);
  const bf16* v16 = reinterpret_cast<const bf16*>(hv);
  CUtensorMap m[5];
  memset(m, 0, sizeof(m));
  if (!sm90::make_map(&m[0], p.q, 2 * p.d, p.Lq, H, B, sp.ql, sp.qh, sp.qb, QROWS, BW) ||
      !sm90::make_map(&m[1], k16, 2 * p.d, p.Lk, H, B, kl, kh, kb, C::BK, BW) ||
      !sm90::make_map(&m[2], k16 + 2 * nk, 2 * p.d, p.Lk, H, B, kl, kh, kb, C::BK, BW) ||
      !sm90::make_map(&m[3], v16, 2 * lp, p.d, H, B, vl, vh, vb, DPF, 64) ||
      !sm90::make_map(&m[4], v16 + 2 * (long long)B * H * p.d * lp, 2 * lp, p.d, H, B, vl, vh,
                      vb, DPF, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_tf32<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n = (p.Lq + QROWS - 1) / QROWS * H * B;
  attn_fwd_tf32<C><<<n < sms ? n : sms, C::THREADS, C::SMEM, stream>>>(sp, m[0], m[1], m[2],
                                                                       m[3], m[4]);
  return static_cast<int>(cudaGetLastError());
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
// bf16
// ---------------------------------------------------------------------------

template <int DP>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
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
// elements) multiples of 8, and in f32 `scratch` 16-byte aligned f32 room for
// K's hi and lo planes and V^T's (2 B H Lk d + 2 B H d Lk' floats, Lk' = Lk
// rounded up to 8; null in bf16); the Python wrapper checks all of this.
extern "C" int sd_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                float* scratch, int B, int H, int Lq, int Lk, int d, int is_f32,
                                long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                                long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                                long long v_sl, long long o_sb, long long o_sh, long long o_sl,
                                float scale, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || B < 1 || H < 1 || Lq < 1 || Lk < 1 || B > 65535 ||
      H > 65535 || (is_f32 && (scratch == nullptr || (long long)B * H > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, Lq, Lk, d,
                 {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl}, {v_sb, v_sh, v_sl}, {o_sb, o_sh, o_sl},
                 scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) return launch_f32(p, B, H, scratch, st);
  switch ((d + 15) / 16 * 16) {
    case 16: return launch<16>(p, B, H, st);
    case 32: return launch<32>(p, B, H, st);
    case 48: return launch<48>(p, B, H, st);
    case 64: return launch<64>(p, B, H, st);
    case 80: return launch<80>(p, B, H, st);
    case 96: return launch<96>(p, B, H, st);
    case 112: return launch<112>(p, B, H, st);
    case 128: return launch<128>(p, B, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
