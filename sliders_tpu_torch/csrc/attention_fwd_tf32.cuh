// The 3xTF32 mainloop of the f32 attention forwards: kernel #1's two-pass
// exact softmax (sd_attention.cu) and kernel #4's one-pass online softmax at
// d = 128 and 256 (flash_attention.cu). It takes the TF32 pieces of
// attention_bwd_sm90.cuh (the in-kernel splits, the three-product step
// tf32x3, the descriptors of the planes, the split pass tf32_split_bhld) and
// the ring, descriptors and softmax helpers of attention_sm90.cuh.
//
// Every product is three `wgmma.m64nNk8.f32.tf32.tf32` a k8 step, A_lo B_hi
// + A_hi B_lo + A_hi B_hi, with hi = x rounded to TF32 and lo the rest; one
// TF32 product keeps about 11 bits and misses the f32 tolerance. What
// shapes it:
//   - TF32 `wgmma` reads B from shared memory K-major only. S = Q.K^T
//     contracts over d, along which K's rows already run: the split pass
//     (tf32_split_bhld) writes K's hi and lo planes. P.V contracts over keys,
//     so a second split pass (tf32_split_vt) writes V's planes transposed,
//     (B, H, d, L), and p goes from the S accumulator straight into P.V's A
//     registers. A TF32 A fragment holds columns (c, c + 4) of each k8 block
//     where the accumulator holds (2 c, 2 c + 1), so the split pass orders
//     the keys of each block of 8 to match (0 2 4 6 1 3 5 7): the
//     contraction does not care about the order, and no shuffle is needed.
//   - Q is the resident A operand, read raw by TMA and split in registers
//     as each k8 step's fragment loads (`ldmatrix` on 32-bit data); p is
//     split in registers too, both with integer rounding (no
//     cvt.rna.tf32.f32 on the hot path).
//   - The tensor cores' accumulation is not f32's over long sums, so each
//     K/V tile's P.V starts from zero and is added into a running f32 sum.
//   - The online rescale (#4's one pass, #1's first pass) is a = 2^(b - b')
//     of the exponents b = c m the p's were taken against, as rounded to
//     f32: exactly 1 while the max holds. 2^(c m - b') would be 1 plus up
//     to two ulps of the rounding of b', a factor l took again every tile:
//     up to 216 x 2.4e-7 = 5e-5 at L = 6912 in 32-key tiles (#4's o divides
//     it out, its residual l keeps it; #1's second pass normalises p by that
//     l, so its o would take it).
//   - One block an SM (a persistent grid walking (q tile, head, batch)
//     items): two consumer warpgroups and a one-thread TMA producer,
//     `setmaxnreg` 232 / 40.
//
// Three plans (FCfg::PLAN):
//   - FWD_TWO_PASS (#1, the normalised p rounded after normalisation: the
//     rounding is the identity in f32, but #1 keeps its reference's order):
//     pass 1 forms S = Q.K^T a K tile at a time and keeps each row's max m
//     and sum l; pass 2 forms the same S (the same products in the same
//     order, so the same bits), p = 2^(c s - (c m + log2 l)) and O += P.V.
//     128 q rows a block, each consumer warpgroup 64 of them and every
//     product of its rows; stages of (K hi, K lo, V^T hi, V^T lo) planes,
//     64 keys where d <= 64 and 32 above; the head dim padded as the f32
//     backward pads it (d = 40 runs five k8 steps and P.V at n = 40).
//   - FWD_ONE_PASS (#4 at d = 128): #4's online softmax on #1's geometry
//     (128 q rows, 32-key stages of four planes, two stages beside the
//     64 KB q tile). Per tile: S, m' = max(m, rowmax s) on the unscaled
//     logits, the running O sum and l scaled by a = 2^(c (m - m')), p =
//     2^(c s - c m') unnormalised (#4 rounds p to v's dtype: the identity in
//     f32), l += rowsum p, O += P.V from zero; o = O / l at the end, and the
//     residuals m (scaled) and l under grad.
//   - FWD_SPLIT_D (#4 at d = 256): a 128-row f32 q tile is 128 KB at d =
//     256, and a 32-key stage of four planes another 128 KB. So an item is
//     64 q rows (64 KB) and the two consumer warpgroups split d: each
//     contracts its 128 columns of Q.K^T into a partial S (64 x 32 f32),
//     the partials cross through shared memory (double-buffered, one named
//     barrier a tile) and each warpgroup adds the other's to its own; f32
//     addition of two terms is commutative, so both hold the same bits of
//     S, m, l and p. Each owns 128 of O's 256 columns (64 accumulator
//     floats) and reads its half of V^T's planes. K's planes and V^T's take
//     stages of their own (32 keys, hi and lo, 64 KB each): two stages, so
//     the next K tile loads while P.V runs and the next V tile while S runs;
//     64 KB q tile + 128 KB ring + 32 KB exchange = 226 KB.
//
// Exps are base 2 on the unscaled logits: exp(scale s - scale m) =
// 2^(c s - c m), c = scale log2(e), one FFMA and one ex2 a logit. Keys at or
// past Lk get -inf logits; q rows past Lq are computed from zero rows and
// not stored. Every barrier wait traps after about ten seconds.

#pragma once

#include "attention_bwd_sm90.cuh"

namespace sm90 {

enum : int { FWD_TWO_PASS = 0, FWD_ONE_PASS = 1, FWD_SPLIT_D = 2 };  // FCfg::PLAN

constexpr int FWD_XBAR = 1;  // FWD_SPLIT_D's named barrier for the partial S tiles

// One instantiation: DPF the (padded) f32 head dim, BK keys a stage, TMA the
// 128-byte swizzle for Q and K rows (d = 32, 64, 128, 256; 16-byte boxes
// with no swizzle elsewhere), PLAN one of the three above. The V^T planes'
// rows are head-dim columns, BK f32 wide: always 128-byte swizzled boxes of
// 32 keys. The member names are those the backward's TF32 helpers read
// (attention_bwd_sm90.cuh: seg, bdesc, a_rows). Shared memory from a
// 1024-byte aligned base: barriers, the RROWS-row q tile, STAGES stages,
// then (FWD_SPLIT_D) the exchange.
template <int DPF_, int BK_, bool TMA_, int PLAN_ = FWD_TWO_PASS>
struct FCfg {
  static constexpr int DPF = DPF_;
  static constexpr int DP = 2 * DPF_;  // a row in bf16 units
  static constexpr int BK = BK_;
  static constexpr bool TMA = TMA_;
  static constexpr bool TMA16 = !TMA_;
  static constexpr int PLAN = PLAN_;
  static constexpr bool SPLIT_D = PLAN_ == FWD_SPLIT_D;
  static constexpr int RROWS = SPLIT_D ? 64 : QROWS;  // q rows of an item
  static constexpr int THREADS = 3 * WG;  // two consumer warpgroups, then the producer
  static constexpr int Q_BYTES = RROWS * DPF * 4;
  static constexpr int TILE_BYTES = BK * DPF * 4;  // a plane of K, or of V^T
  // K hi, K lo, V^T hi, V^T lo; FWD_SPLIT_D: K's two planes or V^T's
  static constexpr int STAGE_BYTES = (SPLIT_D ? 2 : 4) * TILE_BYTES;
  static constexpr int VOFF = SPLIT_D ? 0 : 2 * TILE_BYTES;  // V^T hi in its stage
  // FWD_SPLIT_D: two parities of each warpgroup's partial S (BK / 2 floats a thread)
  static constexpr int XBYTES = SPLIT_D ? 4 * (BK / 2) * WG * 4 : 0;
  static constexpr int FIXED = 1024 /* align */ + 1024 /* barriers */ + Q_BYTES + XBYTES;
  static constexpr int STAGES_FIT = (SMEM_MAX - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(!TMA || DPF == 32 || DPF == 64 || DPF == 128 || DPF == 256,
                "TMA boxes are 32 f32 columns");
  static_assert(BK == 32 || BK == 64, "S tiles are wgmma n32 or n64, V^T boxes 32 keys");
  static_assert(DPF <= 128 || SPLIT_D, "a warpgroup's O is at most wgmma n128");
  static_assert(!SPLIT_D || (DPF == 256 && TMA && BK == 32), "FWD_SPLIT_D is #4 at d = 256");
};

// item w: RROWS-row q tile w % nq of head (w / nq) % H of batch w / (nq H)
template <class C>
__device__ __forceinline__ Item fwd_item(const Params& p, int w) {
  const int nq = (p.Lq + C::RROWS - 1) / C::RROWS;
  return {(w % nq) * C::RROWS, (w / nq) % p.H, w / (nq * p.H)};
}

template <class C>
__device__ __forceinline__ int fwd_items(const Params& p) {
  return (p.Lq + C::RROWS - 1) / C::RROWS * p.H * p.B;
}

// The producer (one thread) walks the block's items: the q tile, then K's
// hi and lo planes and V^T's of every tile (FWD_TWO_PASS: K's alone in
// pass 1, then both; FWD_SPLIT_D: K's and V^T's in stages of their own).
// Boxes of 64 bf16 columns (128-byte swizzle) or 8 (16 bytes) for Q and K;
// V^T's 32-key boxes are DPF rows of 128 bytes.
template <class C>
__device__ __forceinline__ void fwd_produce(const Params& p, const Ring& r, const CUtensorMap* tq,
                                            const CUtensorMap* tkh, const CUtensorMap* tkl,
                                            const CUtensorMap* tvh, const CUtensorMap* tvl) {
  if (threadIdx.x != 2 * WG) return;
  constexpr int BW = C::TMA ? 64 : 8, BOXES = C::DP / BW;
  constexpr int QBOX = C::RROWS * BW * 2, KBOX = C::BK * BW * 2, VBOX = C::DPF * 128;
  const int nt = (p.Lk + C::BK - 1) / C::BK;
  const int total = C::PLAN == FWD_TWO_PASS ? 2 * nt : nt;
  int stage = 0, phase = 0, qphase = 0;
  // the current stage once the consumers are done with it, expecting `bytes`
  auto acquire = [&](uint32_t bytes) {
    mbar_wait(&r.empty[stage], phase ^ 1);
    mbar_expect_tx(&r.full[stage], bytes);
    return r.stages + stage * C::STAGE_BYTES;
  };
  auto advance = [&]() {
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (int w = blockIdx.x; w < fwd_items<C>(p); w += gridDim.x, qphase ^= 1) {
    const Item it = fwd_item<C>(p, w);
    mbar_wait(r.qempty, qphase ^ 1);
    mbar_expect_tx(r.qfull, C::Q_BYTES);
#pragma unroll 1
    for (int x = 0; x < BOXES; ++x)
      tma_load_4d(r.q_tile + x * QBOX, tq, r.qfull, x * BW, it.q0, it.h, it.b);
    for (int i = 0; i < total; ++i) {
      const bool with_v = C::PLAN != FWD_TWO_PASS || i >= nt;
      const int kv0 = (i % nt) * C::BK;
      uint32_t t = acquire((with_v && !C::SPLIT_D ? 4 : 2) * C::TILE_BYTES);
#pragma unroll 1
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(t + x * KBOX, tkh, &r.full[stage], x * BW, kv0, it.h, it.b);
        tma_load_4d(t + C::TILE_BYTES + x * KBOX, tkl, &r.full[stage], x * BW, kv0, it.h, it.b);
      }
      if (with_v) {
        if constexpr (C::SPLIT_D) {
          advance();
          t = acquire(2 * C::TILE_BYTES);
        }
#pragma unroll
        for (int x = 0; x < C::BK / 32; ++x) {
          tma_load_4d(t + C::VOFF + x * VBOX, tvh, &r.full[stage], 2 * kv0 + 64 * x, 0, it.h,
                      it.b);
          tma_load_4d(t + C::VOFF + C::TILE_BYTES + x * VBOX, tvl, &r.full[stage],
                      2 * kv0 + 64 * x, 0, it.h, it.b);
        }
      }
      advance();
    }
  }
}

// FWD_TWO_PASS: one item of a consumer warpgroup cw: its 64 q rows (from
// 64 cw of the q tile) through both passes, then their store
template <class C>
__device__ __forceinline__ void fwd_item_tf32(const Params& p, const Ring& r, const Item& it,
                                              int cw, int t, int& stage, int& phase, int qphase) {
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
    // (the exponents as rounded products: a product fused into a - c m
    // would not round c m as the tile's exps take it)
    const float b0 = __fmul_rn(mn.x, c), b1 = __fmul_rn(mn.y, c);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < H2; i += 4) {
      sum0 += ex2(fmaf(s[i], c, -b0)) + ex2(fmaf(s[i + 1], c, -b0));
      sum1 += ex2(fmaf(s[i + 2], c, -b1)) + ex2(fmaf(s[i + 3], c, -b1));
    }
    // l rescaled by a = 2^(b - b'), b = c M the exponent the last tile's
    // sum was taken against: exactly 1 where the max holds
    l0 = l0 * ex2(__fmul_rn(M0, c) - b0) + quad_sum(sum0);
    l1 = l1 * ex2(__fmul_rn(M1, c) - b1) + quad_sum(sum1);
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

// FWD_ONE_PASS and FWD_SPLIT_D: one item of a consumer warpgroup cw, #4's
// online softmax. FWD_ONE_PASS: its own 64 q rows (from 64 cw) and all of
// d. FWD_SPLIT_D: the item's 64 rows, S over its half of d (k8 steps from
// KS cw) summed with the other warpgroup's through the exchange xg, and its
// half of O's columns (from DW cw). xs is the exchange's parity, which runs
// on across items.
template <class C>
__device__ __forceinline__ void fwd_item_online(const Params& p, const Ring& r, float* xg,
                                                const Item& it, int cw, int t, int& stage,
                                                int& phase, int qphase, int& xs) {
  constexpr int DW = C::SPLIT_D ? C::DPF / 2 : C::DPF;  // d columns of S and O a warpgroup takes
  constexpr int KS = DW / 8, KK = C::BK / 8, H2 = C::BK / 2, NO = DW / 2;
  const int warp = t / 32, lane = t % 32, g = lane >> 2, t4 = lane & 3;
  const int row0 = C::SPLIT_D ? 0 : 64 * cw, k0 = C::SPLIT_D ? KS * cw : 0;
  const int c0 = C::SPLIT_D ? DW * cw : 0;
  const float c = p.scale * LOG2E;
  const int nt = (p.Lk + C::BK - 1) / C::BK;
  auto wait_full = [&]() {
    mbar_wait(&r.full[stage], phase);
    return r.stages + stage * C::STAGE_BYTES;
  };
  auto release = [&]() {
    mbar_arrive(&r.empty[stage]);
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  float s[H2], o[NO], part[NO];
  // each row's running max M (unscaled), its exponent b = c M as the p's
  // are taken against it (rounded to f32), and sum l
  float M0 = -INFINITY, M1 = -INFINITY, B0 = -INFINITY, B1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  mbar_wait(r.qfull, qphase);
  for (int j = 0; j < nt; ++j) {
    // S = Q K^T (unscaled) over this warpgroup's columns of d
    const uint32_t tk = wait_full();
    tf32x3<C::BK, KS>(
        s,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          a_rows<C>(h, l, r.q_tile, warp, lane, k0 + kk, row0);
        },
        [&](int kk, int pl) { return bdesc<C>(tk + pl * C::TILE_BYTES, C::BK, 0, k0 + kk); });
    uint32_t tv = tk + C::VOFF;
    if constexpr (C::SPLIT_D) {
      release();  // K's stage
      float* mine = xg + (2 * xs + cw) * H2 * WG + t;
      const float* other = xg + (2 * xs + (cw ^ 1)) * H2 * WG + t;
      xs ^= 1;
#pragma unroll
      for (int i = 0; i < H2; ++i) mine[i * WG] = s[i];
      // both partials are written; the buffer is written again two tiles
      // on, after the other warpgroup has passed the next tile's barrier
      bar_sync(FWD_XBAR, 2 * WG);
#pragma unroll
      for (int i = 0; i < H2; ++i) s[i] += other[i * WG];
      tv = wait_full();  // V^T's stage
    }
    mask_keys<C>(s, j * C::BK, p.Lk, t4);
    // online softmax: m' = max(m, rowmax s), p = 2^(c s - b') unnormalised
    // with b' = c m' in f32, and the running sums scaled by a = 2^(b - b'):
    // exactly 1 where the max holds (2^(c m - b') would be 1 + an ulp or two
    // of the rounding of b', a factor l took again every tile), 0 on the
    // first tile
    const float2 mn = tile_max(s, H2, M0, M1);
    const float b0 = __fmul_rn(mn.x, c), b1 = __fmul_rn(mn.y, c);  // not fused into B - b
    const float a0 = ex2(B0 - b0), a1 = ex2(B1 - b1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < H2; i += 4) {
      s[i] = ex2(fmaf(s[i], c, -b0));
      s[i + 1] = ex2(fmaf(s[i + 1], c, -b0));
      s[i + 2] = ex2(fmaf(s[i + 2], c, -b1));
      s[i + 3] = ex2(fmaf(s[i + 3], c, -b1));
      sum0 += s[i] + s[i + 1];
      sum1 += s[i + 2] + s[i + 3];
    }
    l0 = l0 * a0 + quad_sum(sum0);
    l1 = l1 * a1 + quad_sum(sum1);
    M0 = mn.x;
    M1 = mn.y;
    B0 = b0;
    B1 = b1;
    // this tile's P V over this warpgroup's columns of O, from zero; A of
    // k8 step kk as in fwd_item_tf32 (V^T's keys are ordered to match)
    tf32x3<DW, KK>(
        part,
        [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          h[0] = __float_as_uint(s[4 * kk]);
          h[1] = __float_as_uint(s[4 * kk + 2]);
          h[2] = __float_as_uint(s[4 * kk + 1]);
          h[3] = __float_as_uint(s[4 * kk + 3]);
          split4(h, l);
        },
        [&](int kk, int pl) {
          return make_desc(tv + pl * C::TILE_BYTES + (kk / 4) * C::DPF * 128 + c0 * 128 +
                               (kk % 4) * 32,
                           16, 1024, 1);
        });
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      o[i] = o[i] * a0 + part[i];
      o[i + 1] = o[i + 1] * a0 + part[i + 1];
      o[i + 2] = o[i + 2] * a1 + part[i + 2];
      o[i + 3] = o[i + 3] * a1 + part[i + 3];
    }
    release();
  }
  mbar_arrive(r.qempty);  // the last read of the q tile is done

  const int row = it.q0 + row0 + 16 * warp + g;
  float* out = reinterpret_cast<float*>(p.o) + it.b * p.ob + it.h * p.oh;
#pragma unroll
  for (int jb = 0; jb < DW / 8; ++jb) {
    const int col = c0 + jb * 8 + 2 * t4;  // d % 8 == 0, so col < d implies col + 1 < d
    if (col < p.d) {
      if (row < p.Lq)
        *reinterpret_cast<float2*>(out + (long long)row * p.ol + col) =
            make_float2(o[4 * jb] / l0, o[4 * jb + 1] / l0);
      if (row + 8 < p.Lq)
        *reinterpret_cast<float2*>(out + (long long)(row + 8) * p.ol + col) =
            make_float2(o[4 * jb + 2] / l1, o[4 * jb + 3] / l1);
    }
  }
  if (p.ml != nullptr && t4 == 0 && (!C::SPLIT_D || cw == 0)) {
    // m = max of the scaled logits = scale M exactly; l in the same units
    const long long plane = (long long)p.B * p.H * p.Lq;
    const long long i = ((long long)it.b * p.H + it.h) * p.Lq + row;
    if (row < p.Lq) {
      p.ml[i] = M0 * p.scale;
      p.ml[plane + i] = l0;
    }
    if (row + 8 < p.Lq) {
      p.ml[i + 8] = M1 * p.scale;
      p.ml[plane + i + 8] = l1;
    }
  }
}

// a persistent 1-d grid of at most one block an SM, each walking items; the
// maps are the q tile's, K's hi and lo planes' and V^T's
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    attn_fwd_tf32(const Params p, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tkh, const __grid_constant__ CUtensorMap tkl,
                  const __grid_constant__ CUtensorMap tvh,
                  const __grid_constant__ CUtensorMap tvl) {
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
  float* xg = reinterpret_cast<float*>(base + 1024 + C::Q_BYTES + C::STAGES * C::STAGE_BYTES);
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
    const int cw = threadIdx.x / WG, t = threadIdx.x - WG * cw;
    int stage = 0, phase = 0, qphase = 0, xs = 0;
    for (int w = blockIdx.x; w < fwd_items<C>(p); w += gridDim.x, qphase ^= 1) {
      if constexpr (C::PLAN == FWD_TWO_PASS)
        fwd_item_tf32<C>(p, r, fwd_item<C>(p, w), cw, t, stage, phase, qphase);
      else
        fwd_item_online<C>(p, r, xg, fwd_item<C>(p, w), cw, t, stage, phase, qphase, xs);
    }
  }
}

// tf32_split_bhld's split of a (B, H, L, d) tensor transposed, into two
// contiguous (B, H, d, Lp) planes (Lp = L rounded up to 8), hi then lo, n
// elements each, with the keys of each block of 8 in the order the TF32 A
// fragment of an f32 accumulator takes them: position c of a block holds
// key 2 c for c < 4 and key 2 (c - 4) + 1 above (the P.V of the consumers
// above); keys at or past L are zeros. A block of 32 x 8 threads moves 32
// keys x 32 columns of one head through shared memory, reading and writing
// whole rows.
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
      const float v = tile[key][i], vh = tf32_rna(v);
      const long long o = ((long long)bh * d + c) * Lp + pos;
      hi[o] = vh;
      hi[n + o] = tf32_rna(__fsub_rn(v, vh));
    }
  }
}

inline int split_vt(const float* x, const Strides& s, int B, int H, int L, int d, float* hi,
                    cudaStream_t stream) {
  const int lp = (L + 7) / 8 * 8;
  const dim3 grid((lp + 31) / 32, (d + 31) / 32, B * H);
  tf32_split_vt<<<grid, dim3(32, 8), 0, stream>>>(x, s.b, s.h, s.l, H, L, d, lp, hi,
                                                 (long long)B * H * d * lp);
  return static_cast<int>(cudaGetLastError());
}

// The split passes over k (planes) and v (transposed planes) into `scratch`
// (2 B H Lk d + 2 B H d Lk' floats, Lk' = Lk rounded up to 8), then
// attn_fwd_tf32<C> on `stream`. sp holds q (f32 rows seen as bf16 rows of
// twice the width, strides doubled), o (f32 element strides), the residual
// buffer ml (or null), the shapes and the scale; sp.d must be at most DPF.
// Returns the CUDA error (0 on success).
template <class C>
int launch_fwd_tf32(const Params& sp, const float* k, const Strides& ks, const float* v,
                    const Strides& vs, float* scratch, cudaStream_t stream) {
  const int B = sp.B, H = sp.H, Lk = sp.Lk, d = sp.d;
  const long long nk = (long long)B * H * Lk * d;
  const int lp = (Lk + 7) / 8 * 8;
  float* hk = scratch;
  float* hv = scratch + 2 * nk;
  int err = split(k, ks, B, H, Lk, d, hk, stream);
  if (err == 0) err = split_vt(v, vs, B, H, Lk, d, hv, stream);
  if (err != 0) return err;
  constexpr int BW = C::TMA ? 64 : 8;
  const long long kl = 2ll * d, kh = kl * Lk, kb = kh * H;
  const long long vl = 2ll * lp, vh = vl * d, vb = vh * H;
  const bf16* k16 = reinterpret_cast<const bf16*>(hk);
  const bf16* v16 = reinterpret_cast<const bf16*>(hv);
  CUtensorMap m[5];
  memset(m, 0, sizeof(m));
  if (!make_map(&m[0], sp.q, 2 * d, sp.Lq, H, B, sp.ql, sp.qh, sp.qb, C::RROWS, BW) ||
      !make_map(&m[1], k16, 2 * d, Lk, H, B, kl, kh, kb, C::BK, BW) ||
      !make_map(&m[2], k16 + 2 * nk, 2 * d, Lk, H, B, kl, kh, kb, C::BK, BW) ||
      !make_map(&m[3], v16, 2 * lp, d, H, B, vl, vh, vb, C::DPF, 64) ||
      !make_map(&m[4], v16 + 2 * (long long)B * H * d * lp, 2 * lp, d, H, B, vl, vh, vb, C::DPF,
                64))
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
  const int n = (sp.Lq + C::RROWS - 1) / C::RROWS * H * B;
  attn_fwd_tf32<C><<<n < sms ? n : sms, C::THREADS, C::SMEM, stream>>>(sp, m[0], m[1], m[2],
                                                                       m[3], m[4]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
