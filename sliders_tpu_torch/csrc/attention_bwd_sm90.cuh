// The Hopper mainloop of the bf16 attention backwards: kernel #2's exact
// softmax backward (sd_attention_bwd.cu, every d its gate takes) and kernel
// #4's flash backward at d = 128 (flash_attention.cu). It takes the ring's
// fill and the descriptors of attention_sm90.cuh, and the PTX wrappers of
// sm90_ptx.cuh.
//
// Both backwards compute the same five products per pair of a q tile and a
// K/V tile: S = Q.K^T, dP = dO.V^T, dV += P^T.dO, dK += dS^T.Q, dQ += dS.K.
// Two kernels per backward, no atomics, so the sums are the same from run
// to run:
//   - a K/V-major dk/dv kernel: a block item owns 128 K/V rows (K and V
//     loaded once into shared memory), and the producer streams (Q, dO)
//     tiles of 64 rows (128 for #2 at d <= 48) and their rows' statistics
//     through the ring. Per tile each consumer warpgroup (64 K/V rows)
//     forms S^T = K.Q^T and dP^T = V.dO^T (`wgmma`, both operands in shared
//     memory, K-major), then P^T and dS^T in f32 registers from the
//     statistics of the tile's columns, rounds them to bf16 straight into
//     the A registers of dV += P^T.dO and dK += dS^T.Q (`wgmma` with A from
//     registers, dO and Q read MN-major through the transpose flag, as #1
//     reads V);
//   - a q-major dq kernel: a block item owns 128 q rows (Q and dO loaded
//     once), the producer streams (K, V) tiles of 64 keys (128 for #2 at
//     d <= 48); S = Q.K^T and dP = dO.V^T in shared memory, dS in
//     registers, dQ += dS.K with K read MN-major.
// The grid is persistent (one block an SM walking items), the ring's stages
// and phases run on across items, and the fill is attention_sm90.cuh's: TMA
// with the 128-byte swizzle at d = 64 and 128, 16-byte cp.async with
// zero-fill into the no-swizzle core-matrix layout at every other d; each
// tile's row statistics come by a 1-d bulk copy. The producer warpgroup
// keeps 40 registers and the two consumers take 232 (`setmaxnreg`): a dk/dv
// consumer holds 64 + 64 f32 accumulators at d = 128 beside the 32 + 32 of
// S^T and dP^T. Where d (padded) plus the streamed rows is at most 160 the
// softmax overlaps the products inside a warpgroup (p is formed while dP^T
// runs, ds while dV += p^T dO runs); elsewhere (d = 40, 48 and 104-128)
// that spilled or ran slower on the card, and p and ds are formed one k16
// slice at a time after both products, each slice's share of dV and dK
// running while the next is formed.
//
// Two numeric policies on one template parameter (SD), each at its
// reference's rounding points:
//   - #4 (flash, SD = false; the TPU kernel's _flash_attention_bwd_dkv and
//     _flash_attention_bwd_dq): p = exp(s scale - m) (1 / l) from the
//     forward's residuals m and l; ds = round(((dp - di) p) scale);
//     dv += round(p)^T do, dk += ds^T q, dq = ds k; di = rowsum(o do) is a
//     torch reduction outside, as the TPU code takes it.
//   - #2 (SD = true; sliders_tpu/ops/pallas_attention.py::_attn_bwd_kernel):
//     p the normalised softmax in f32; dv = round(p)^T g; dsum = rowsum(dp p)
//     with p unrounded; ds = round(p (dp - dsum)); dq = scale (ds k) and
//     dk = scale (ds^T q), the scale applied after the f32 sums.
// #2's statistics (each q row's max m, sum l and dsum) are needed by both
// of its kernels. Its dq kernel finds them in a first pass over the same
// ring, one S and dP pass with a running max (l and the dsum sum rescaled
// when the max grows, dsum = that sum / l), writes them to an f32 scratch
// for the dk/dv kernel that runs after it, and then makes its dq pass: nine
// products in all, against ten for a Q.K^T pass for m and l followed by an
// S and dP pass for dsum. m and l from #1's forward under grad would save
// nothing more (dsum still needs its S and dP pass) and would change #1's
// serving kernel, so #1's forward is left as it is. The dk/dv
// kernel reads each row's statistics in the form its exps take (m log2(e),
// 1 / l, dd), formed once per row: by #2's dq kernel, and for #4 by the
// wrapper beside di, with the same float operations (1 / l correctly
// rounded, `__frcp_rn` here) as #4's dq kernel, so both kernels compute the
// same p.
//
// Exps are base 2: exp(scale s - m) = 2^(c s - m log2 e), c = scale log2 e,
// one FFMA and one ex2 a logit. Keys at or past Lk get -inf logits (p = 0);
// q rows past Lq get m = +inf in the dk/dv kernel (p = 0) and are not
// stored by the dq kernel. Every barrier wait traps after about ten
// seconds, so a fault in the ring fails the launch instead of hanging the
// card.
//
// What bounds it: the tensor cores. Per head the backward does 10 L^2 d
// operations at the least (dP, dV, dK, dQ and one S); this schedule does 14
// for #4 (S and dP in both kernels) and 18 for #2 (and the statistics
// pass), against 7 L d bytes.

#pragma once

#include "attention_sm90.cuh"

namespace sm90 {

constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;  // dO, the output's gradient
  bf16* dq;
  bf16* dk;
  bf16* dv;
  // #4's forward residuals, (B, H, Lq) f32: the scaled row max m and the
  // row sum l (#4's dq kernel reads them; null for #2)
  const float* m;
  const float* l;
  // f32 planes of (B, H, sl) each, sl >= Lq a multiple of the dk/dv
  // kernel's BN (16-byte aligned rows): m log2(e), 1 / l, and di (#4) or
  // dsum (#2), in the dk/dv kernel's form; #2's dq kernel writes them (rows
  // past Lq as +inf, 0, 0), #4's wrapper beside di
  float* mb;
  float* iv;
  float* dd;
  long long sl;
  int Lq, Lk, d, B, H;
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, gb, gh, gl;  // element strides
  long long dqb, dqh, dql, dkb, dkh, dkl, dvb, dvh, dvl;
  float scale;
};

// One kernel of a backward. Shared memory, from a 1024-byte aligned base:
// barriers (1024 bytes), the item's two resident 128-row tiles, STAGES ring
// stages of two BN-row tiles, then the stages' statistics (dk/dv only).
template <int DP_, int BN_, bool TMA_, bool DKV_, bool SD_>
struct BCfg {
  static constexpr int DP = DP_;      // d rounded up to 16
  static constexpr int BN = BN_;      // rows of a streamed tile: q rows (dk/dv) or keys (dq)
  static constexpr int BK = BN_;      // the name attention_sm90.cuh's helpers read
  static constexpr bool TMA = TMA_;   // else cp.async
  static constexpr bool DKV = DKV_;   // the dk/dv kernel, else the dq kernel
  static constexpr bool SD = SD_;     // #2's policy, else #4's
  static constexpr int PRODUCER = WG;
  static constexpr int THREADS = 2 * WG + PRODUCER;  // consumers first
  static constexpr int RES_BYTES = QROWS * DP * 2;
  static constexpr int TILE_BYTES = BN * DP * 2;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int STAT_BYTES = DKV ? 3 * BN * 4 : 0;  // mb, iv, dd per column
  static constexpr int STAGES_FIT =
      (SMEM_BUDGET - 2048 - 2 * RES_BYTES) / (STAGE_BYTES + STAT_BYTES);
  static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
  static constexpr int SMEM = 1024 /* align */ + 1024 /* barriers */ + 2 * RES_BYTES +
                              STAGES * (STAGE_BYTES + STAT_BYTES);
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(!TMA || DP == 64 || DP == 128, "TMA boxes are 64 columns");
  static_assert(BN == 64 || BN == 128, "S tiles are wgmma n64 or n128");
};

struct BRing {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* rfull;   // the item's resident tiles have landed
  uint64_t* rempty;  // both consumers are done with them
  uint32_t res;      // resident tile 1 (K or Q); tile 2 (V or dO) RES_BYTES on
  uint32_t stages;   // stage s: tile 1 (Q or K) at stages + s * STAGE_BYTES, tile 2 TILE_BYTES on
  float* stats;      // stage s: [3][BN] floats at stats + s * 3 * BN
};

// item w: 128-row tile w % n of the resident side, head (w / n) % H, batch
// w / (n H)
template <class C>
__device__ __forceinline__ Item bwd_item(const BwdArgs& p, int w) {
  const int n = ((C::DKV ? p.Lk : p.Lq) + QROWS - 1) / QROWS;
  return {(w % n) * QROWS, (w / n) % p.H, w / (n * p.H)};
}

template <class C>
__device__ __forceinline__ int bwd_items(const BwdArgs& p) {
  return ((C::DKV ? p.Lk : p.Lq) + QROWS - 1) / QROWS * p.H * p.B;
}

// keep A registers of an asynchronous wgmma alive (and unmoved) until here
template <int N>
__device__ __forceinline__ void fence_a(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// `bytes` more for the barrier's current phase to wait for, without an arrival
__device__ __forceinline__ void mbar_add_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The producer walks the block's items: the two resident tiles of each
// (K and V, or Q and dO), then the streamed tiles (Q and dO with their rows'
// mb, iv and dd, or K and V; #2's dq kernel streams K and V twice). It only
// issues copies: the statistics travel through the ring with their tiles,
// by 1-d bulk copies (TMA) on both paths.
template <class C>
__device__ __forceinline__ void bwd_produce(const BwdArgs& p, const BRing& r,
                                            const CUtensorMap* ta1, const CUtensorMap* ta2,
                                            const CUtensorMap* tb1, const CUtensorMap* tb2) {
  const int tid = threadIdx.x - 2 * WG;  // 0 .. PRODUCER - 1
  const int Lres = C::DKV ? p.Lk : p.Lq, Lstr = C::DKV ? p.Lq : p.Lk;
  const int nt = (Lstr + C::BN - 1) / C::BN;
  const int total = C::SD && !C::DKV ? 2 * nt : nt;
  int stage = 0, phase = 0, rphase = 0;
  if constexpr (C::TMA) {
    if (tid != 0) return;  // one thread issues every copy
    constexpr int BOXES = C::DP / 64, RBOX = QROWS * 128, BBOX = C::BN * 128;
    for (int w = blockIdx.x; w < bwd_items<C>(p); w += gridDim.x, rphase ^= 1) {
      const Item it = bwd_item<C>(p, w);
      const long long sbase = ((long long)it.b * p.H + it.h) * p.sl;
      mbar_wait(r.rempty, rphase ^ 1);
      mbar_expect_tx(r.rfull, 2 * C::RES_BYTES);
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(r.res + x * RBOX, ta1, r.rfull, x * 64, it.q0, it.h, it.b);
        tma_load_4d(r.res + C::RES_BYTES + x * RBOX, ta2, r.rfull, x * 64, it.q0, it.h, it.b);
      }
      for (int i = 0; i < total; ++i) {
        const int c0 = (i % nt) * C::BN;
        mbar_wait(&r.empty[stage], phase ^ 1);
        const uint32_t t1 = r.stages + stage * C::STAGE_BYTES;
        mbar_expect_tx(&r.full[stage], C::STAGE_BYTES + C::STAT_BYTES);
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(t1 + x * BBOX, tb1, &r.full[stage], x * 64, c0, it.h, it.b);
          tma_load_4d(t1 + C::TILE_BYTES + x * BBOX, tb2, &r.full[stage], x * 64, c0, it.h, it.b);
        }
        if constexpr (C::DKV) {
          const uint32_t st = smem_u32(r.stats + stage * 3 * C::BN);
          bulk_load(st, p.mb + sbase + c0, C::BN * 4, &r.full[stage]);
          bulk_load(st + C::BN * 4, p.iv + sbase + c0, C::BN * 4, &r.full[stage]);
          bulk_load(st + 2 * C::BN * 4, p.dd + sbase + c0, C::BN * 4, &r.full[stage]);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // each thread publishes a group of its copies (a barrier's arrival)
    // once the group after it is issued, so two groups are in flight
    uint64_t* pending = nullptr;
    auto publish = [&](uint64_t* next) {
      if (pending != nullptr) {
        if (next != nullptr)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        fence_proxy_async();
        mbar_arrive(pending);
      }
      pending = next;
    };
    for (int w = blockIdx.x; w < bwd_items<C>(p); w += gridDim.x, rphase ^= 1) {
      const Item it = bwd_item<C>(p, w);
      const bf16* q = p.q + it.b * p.qb + it.h * p.qh;
      const bf16* k = p.k + it.b * p.kb + it.h * p.kh;
      const bf16* v = p.v + it.b * p.vb + it.h * p.vh;
      const bf16* g = p.g + it.b * p.gb + it.h * p.gh;
      const bf16* a1 = C::DKV ? k : q;
      const bf16* a2 = C::DKV ? v : g;
      const bf16* b1 = C::DKV ? q : k;
      const bf16* b2 = C::DKV ? g : v;
      const long long a1l = C::DKV ? p.kl : p.ql, a2l = C::DKV ? p.vl : p.gl;
      const long long b1l = C::DKV ? p.ql : p.kl, b2l = C::DKV ? p.gl : p.vl;
      const long long sbase = ((long long)it.b * p.H + it.h) * p.sl;
      publish(nullptr);  // the consumers need every tile of the last item first
      mbar_wait(r.rempty, rphase ^ 1);
      load_tile<C::DP, QROWS, C::PRODUCER>(r.res, a1, a1l, it.q0, Lres, p.d, tid);
      load_tile<C::DP, QROWS, C::PRODUCER>(r.res + C::RES_BYTES, a2, a2l, it.q0, Lres, p.d, tid);
      cp_async_commit();
      publish(r.rfull);
      for (int i = 0; i < total; ++i) {
        const int c0 = (i % nt) * C::BN;
        mbar_wait(&r.empty[stage], phase ^ 1);
        const uint32_t t1 = r.stages + stage * C::STAGE_BYTES;
        load_tile<C::DP, C::BN, C::PRODUCER>(t1, b1, b1l, c0, Lstr, p.d, tid);
        load_tile<C::DP, C::BN, C::PRODUCER>(t1 + C::TILE_BYTES, b2, b2l, c0, Lstr, p.d, tid);
        if (C::DKV && tid == 0) {
          // the three planes' BN floats by bulk copies; thread 0's own
          // arrival (after its cp.async group) comes later, so the phase
          // cannot complete before the bytes are expected
          const uint32_t st = smem_u32(r.stats + stage * 3 * C::BN);
          mbar_add_tx(&r.full[stage], C::STAT_BYTES);
          bulk_load(st, p.mb + sbase + c0, C::BN * 4, &r.full[stage]);
          bulk_load(st + C::BN * 4, p.iv + sbase + c0, C::BN * 4, &r.full[stage]);
          bulk_load(st + 2 * C::BN * 4, p.dd + sbase + c0, C::BN * 4, &r.full[stage]);
        }
        cp_async_commit();
        publish(&r.full[stage]);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    publish(nullptr);
  }
}

// s = this warpgroup's 64 rows of resident tile 1 times streamed tile 1
// transposed and t = the same of tiles 2 (f32, unscaled), issued as two
// wgmma groups: wgmma_wait<1> finds s done, wgmma_wait<0> both
template <class C>
__device__ __forceinline__ void issue_pair(float* s, float* t, uint32_t a1, uint32_t a2, int rg0,
                                           uint32_t b1, uint32_t b2) {
  fence_regs<C::BN / 2>(s);
  fence_regs<C::BN / 2>(t);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    const uint64_t a = kmajor_desc<C>(a1, QROWS, rg0, kk), b = kmajor_desc<C>(b1, C::BN, 0, kk);
    if constexpr (C::BN == 128)
      wgmma_ss_n128(s, a, b, kk > 0);
    else
      wgmma_ss_n64(s, a, b, kk > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    const uint64_t a = kmajor_desc<C>(a2, QROWS, rg0, kk), b = kmajor_desc<C>(b2, C::BN, 0, kk);
    if constexpr (C::BN == 128)
      wgmma_ss_n128(t, a, b, kk > 0);
    else
      wgmma_ss_n64(t, a, b, kk > 0);
  }
  wgmma_commit();
}

// ds from p (f32, unrounded), dp and the row's dd (di or dsum)
template <class C>
__device__ __forceinline__ float ds_of(float pe, float dp, float dd, float scale) {
  if constexpr (C::SD)
    return pe * (dp - dd);
  else
    return ((dp - dd) * pe) * scale;
}

// Accumulator element 4j + e is row g (e < 2) or g + 8 of the warpgroup's
// rows, column 8j + 2 t4 + (e & 1) of the tile; two n8 blocks (j = 2kc,
// 2kc + 1) are the A registers of k16 step kc.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* x) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
}

// acc[.. DP / 2] += a (k16 steps of registers) . tile, the tile read MN-major
template <class C>
__device__ __forceinline__ void issue_rs(float* acc, uint32_t (*a)[4], uint32_t tile) {
#pragma unroll
  for (int kc = 0; kc < C::BN / 16; ++kc) pv_step<C, 0>(acc, a[kc], tile, kc);
}

// rows row and row + 8 of DP / 8 n8 blocks of acc, times f, to out (d columns valid)
template <class C>
__device__ __forceinline__ void store_rows(bf16* out, long long ld, int row, int nrows, int d,
                                           const float* acc, float f, int t4) {
#pragma unroll
  for (int j = 0; j < C::DP / 8; ++j) {
    const int col = j * 8 + t4 * 2;  // d % 8 == 0, so col < d implies col + 1 < d
    if (col < d) {
      if (row < nrows)
        *reinterpret_cast<uint32_t*>(out + (long long)row * ld + col) =
            pack_bf16(acc[4 * j] * f, acc[4 * j + 1] * f);
      if (row + 8 < nrows)
        *reinterpret_cast<uint32_t*>(out + (long long)(row + 8) * ld + col) =
            pack_bf16(acc[4 * j + 2] * f, acc[4 * j + 3] * f);
    }
  }
}

template <class C>
__device__ __forceinline__ void wait_stage(const BRing& r, int stage, int phase) {
  mbar_wait(&r.full[stage], phase);
  if constexpr (!C::TMA) fence_proxy_async();
}

template <class C>
__device__ __forceinline__ void next_stage(int& stage, int& phase) {
  if (++stage == C::STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// One item of a dk/dv consumer: its 64 K/V rows against every q tile
template <class C>
__device__ __forceinline__ void dkdv_item(const BwdArgs& p, const BRing& r, const Item& it,
                                          int rg0, int warp, int g, int t4, int& stage,
                                          int& phase, int rphase) {
  // live across dV's wgmma in the overlapped form: dk, dv, S^T (as p), dP^T
  // and p's A registers
  constexpr bool OVERLAP = C::DP + C::BN <= 160;
  const float c = p.scale * LOG2E;
  const int nt = (p.Lq + C::BN - 1) / C::BN;
  float dk[C::DP / 2], dv[C::DP / 2], s[C::BN / 2], dp[C::BN / 2];
  uint32_t pa[C::BN / 16][4], da[C::BN / 16][4];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(r.rfull, rphase);
  if constexpr (!C::TMA) fence_proxy_async();
  for (int j = 0; j < nt; ++j) {
    wait_stage<C>(r, stage, phase);
    const uint32_t tq = r.stages + stage * C::STAGE_BYTES, tg = tq + C::TILE_BYTES;
    const float* st = r.stats + stage * 3 * C::BN;
    issue_pair<C>(s, dp, r.res, r.res + C::RES_BYTES, rg0, tq, tg);  // S^T = K Q^T, dP^T = V dO^T
    // p^T and ds^T for the q columns 8 jb + 2 t4 (+1) of n8 block jb
    auto p_of = [&](int jb, float* x) {
      const int col = jb * 8 + 2 * t4;
      const float2 mb = *reinterpret_cast<const float2*>(st + col);
      const float2 iv = *reinterpret_cast<const float2*>(st + C::BN + col);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = ex2(fmaf(x[e], c, -(e & 1 ? mb.y : mb.x))) * (e & 1 ? iv.y : iv.x);
    };
    auto ds_block = [&](int jb, const float* pe, float* x) {
      const float2 dd = *reinterpret_cast<const float2*>(st + 2 * C::BN + jb * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = ds_of<C>(pe[e], x[e], e & 1 ? dd.y : dd.x, p.scale);
    };
    if constexpr (OVERLAP) {
      // p^T while dP^T runs, then dV += round(p)^T dO while ds^T is formed
      wgmma_wait<1>();
      fence_regs<C::BN / 2>(s);
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc) {
        p_of(2 * kc, s + 8 * kc);
        p_of(2 * kc + 1, s + 8 * kc + 4);
        pack_a(pa[kc], s + 8 * kc);
      }
      fence_regs<C::DP / 2>(dv);
      wgmma_fence();
      issue_rs<C>(dv, pa, tg);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<C::BN / 2>(dp);
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc) {
        ds_block(2 * kc, s + 8 * kc, dp + 8 * kc);
        ds_block(2 * kc + 1, s + 8 * kc + 4, dp + 8 * kc + 4);
        pack_a(da[kc], dp + 8 * kc);
      }
      fence_regs<C::DP / 2>(dk);
      wgmma_fence();
      issue_rs<C>(dk, da, tq);
      wgmma_commit();
    } else {
      // both products first, then p^T and ds^T one k16 slice at a time, so
      // that each slice's S^T and dP^T die as its A registers are packed;
      // each slice's share of dV and dK runs while the next is formed
      wgmma_wait<0>();
      fence_regs<C::BN / 2>(s);
      fence_regs<C::BN / 2>(dp);
      fence_regs<C::DP / 2>(dv);
      fence_regs<C::DP / 2>(dk);
#pragma unroll
      for (int kc = 0; kc < C::BN / 16; ++kc) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          p_of(2 * kc + h, s + 8 * kc + 4 * h);
          ds_block(2 * kc + h, s + 8 * kc + 4 * h, dp + 8 * kc + 4 * h);
        }
        pack_a(pa[kc], s + 8 * kc);
        pack_a(da[kc], dp + 8 * kc);
        wgmma_fence();
        pv_step<C, 0>(dv, pa[kc], tg, kc);
        pv_step<C, 0>(dk, da[kc], tq, kc);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_regs<C::DP / 2>(dv);
    fence_regs<C::DP / 2>(dk);
    fence_a<C::BN / 16>(pa);
    fence_a<C::BN / 16>(da);
    mbar_arrive(&r.empty[stage]);
    next_stage<C>(stage, phase);
  }
  mbar_arrive(r.rempty);  // the last read of K and V is done

  const int row = it.q0 + rg0 * 8 + warp * 16 + g;
  store_rows<C>(p.dk + it.b * p.dkb + it.h * p.dkh, p.dkl, row, p.Lk, p.d, dk,
                C::SD ? p.scale : 1.f, t4);
  store_rows<C>(p.dv + it.b * p.dvb + it.h * p.dvh, p.dvl, row, p.Lk, p.d, dv, 1.f, t4);
}

// One item of a dq consumer: its 64 q rows against every K/V tile (#2:
// first the statistics pass)
template <class C>
__device__ __forceinline__ void dq_item(const BwdArgs& p, const BRing& r, const Item& it, int rg0,
                                        int warp, int g, int t4, int& stage, int& phase,
                                        int rphase) {
  const float c = p.scale * LOG2E;
  const int nt = (p.Lk + C::BN - 1) / C::BN;
  const int row = it.q0 + rg0 * 8 + warp * 16 + g;
  const long long sbase = ((long long)it.b * p.H + it.h) * p.sl;
  float s[C::BN / 2], dp[C::BN / 2], dq[C::DP / 2];
  uint32_t da[C::BN / 16][4];
  float mb0, mb1, iv0, iv1, dd0, dd1;  // rows row and row + 8: m log2 e, 1 / l, dd
  mbar_wait(r.rfull, rphase);
  if constexpr (!C::TMA) fence_proxy_async();

  if constexpr (C::SD) {
    // the statistics pass: running max M (unscaled), l and u = sum p dp,
    // both rescaled when M grows; dsum = u / l
    float M0 = -INFINITY, M1 = -INFINITY, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
    for (int j = 0; j < nt; ++j) {
      wait_stage<C>(r, stage, phase);
      const uint32_t tk = r.stages + stage * C::STAGE_BYTES;
      issue_pair<C>(s, dp, r.res, r.res + C::RES_BYTES, rg0, tk, tk + C::TILE_BYTES);
      wgmma_wait<1>();  // the exps while dP runs
      fence_regs<C::BN / 2>(s);
      mask_keys<C>(s, j * C::BN, p.Lk, t4);
      // the first tile always holds a valid key, so mn is finite from here on
      const float2 mn = tile_max(s, C::BN / 2, M0, M1);
      const float b0 = (mn.x * p.scale) * LOG2E, b1 = (mn.y * p.scale) * LOG2E;
      const float a0 = ex2((M0 * p.scale) * LOG2E - b0), a1 = ex2((M1 * p.scale) * LOG2E - b1);
      float sum0 = 0.f, sum1 = 0.f, su0 = 0.f, su1 = 0.f;
#pragma unroll
      for (int i = 0; i < C::BN / 2; i += 4) {
        s[i] = ex2(fmaf(s[i], c, -b0));
        s[i + 1] = ex2(fmaf(s[i + 1], c, -b0));
        s[i + 2] = ex2(fmaf(s[i + 2], c, -b1));
        s[i + 3] = ex2(fmaf(s[i + 3], c, -b1));
        sum0 += s[i] + s[i + 1];
        sum1 += s[i + 2] + s[i + 3];
      }
      wgmma_wait<0>();
      fence_regs<C::BN / 2>(dp);
      mbar_arrive(&r.empty[stage]);
      next_stage<C>(stage, phase);
#pragma unroll
      for (int i = 0; i < C::BN / 2; i += 4) {
        su0 = fmaf(s[i], dp[i], fmaf(s[i + 1], dp[i + 1], su0));
        su1 = fmaf(s[i + 2], dp[i + 2], fmaf(s[i + 3], dp[i + 3], su1));
      }
      l0 = l0 * a0 + quad_sum(sum0);
      l1 = l1 * a1 + quad_sum(sum1);
      u0 = u0 * a0 + quad_sum(su0);
      u1 = u1 * a1 + quad_sum(su1);
      M0 = mn.x;
      M1 = mn.y;
    }
    mb0 = (M0 * p.scale) * LOG2E;  // m = scale max s, as #4's residual
    mb1 = (M1 * p.scale) * LOG2E;
    iv0 = __frcp_rn(l0);
    iv1 = __frcp_rn(l1);
    dd0 = u0 * iv0;
    dd1 = u1 * iv1;
    if (t4 == 0) {  // for the dk/dv kernel; rows past Lq give it p = 0
      const bool in0 = row < p.Lq, in1 = row + 8 < p.Lq;
      p.mb[sbase + row] = in0 ? mb0 : INFINITY;
      p.iv[sbase + row] = in0 ? iv0 : 0.f;
      p.dd[sbase + row] = in0 ? dd0 : 0.f;
      p.mb[sbase + row + 8] = in1 ? mb1 : INFINITY;
      p.iv[sbase + row + 8] = in1 ? iv1 : 0.f;
      p.dd[sbase + row + 8] = in1 ? dd1 : 0.f;
    }
  } else {
    // the forward's residuals (rows of Lq), formed as #4's wrapper forms
    // the dk/dv kernel's planes: m log2(e) and the correctly rounded 1 / l
    const long long rbase = ((long long)it.b * p.H + it.h) * p.Lq;
    const bool in0 = row < p.Lq, in1 = row + 8 < p.Lq;
    mb0 = in0 ? p.m[rbase + row] * LOG2E : 0.f;
    mb1 = in1 ? p.m[rbase + row + 8] * LOG2E : 0.f;
    iv0 = in0 ? __frcp_rn(p.l[rbase + row]) : 0.f;
    iv1 = in1 ? __frcp_rn(p.l[rbase + row + 8]) : 0.f;
    dd0 = in0 ? p.dd[sbase + row] : 0.f;
    dd1 = in1 ? p.dd[sbase + row + 8] : 0.f;
  }

#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) dq[i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    wait_stage<C>(r, stage, phase);
    const uint32_t tk = r.stages + stage * C::STAGE_BYTES;
    issue_pair<C>(s, dp, r.res, r.res + C::RES_BYTES, rg0, tk, tk + C::TILE_BYTES);
    wgmma_wait<1>();  // p while dP runs
    fence_regs<C::BN / 2>(s);
    mask_keys<C>(s, j * C::BN, p.Lk, t4);
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i)
      s[i] = ex2(fmaf(s[i], c, -(i & 2 ? mb1 : mb0))) * (i & 2 ? iv1 : iv0);
    wgmma_wait<0>();
    fence_regs<C::BN / 2>(dp);
    // dQ += round(ds) K, each k16 slice's share running while the next is formed
    fence_regs<C::DP / 2>(dq);
#pragma unroll
    for (int kc = 0; kc < C::BN / 16; ++kc) {
#pragma unroll
      for (int i = 8 * kc; i < 8 * kc + 8; ++i)
        dp[i] = ds_of<C>(s[i], dp[i], i & 2 ? dd1 : dd0, p.scale);
      pack_a(da[kc], dp + 8 * kc);
      wgmma_fence();
      pv_step<C, 0>(dq, da[kc], tk, kc);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs<C::DP / 2>(dq);
    fence_a<C::BN / 16>(da);
    mbar_arrive(&r.empty[stage]);
    next_stage<C>(stage, phase);
  }
  mbar_arrive(r.rempty);  // the last read of Q and dO is done

  store_rows<C>(p.dq + it.b * p.dqb + it.h * p.dqh, p.dql, row, p.Lq, p.d, dq,
                C::SD ? p.scale : 1.f, t4);
}

template <class C>
__device__ __forceinline__ void bwd_consume(const BwdArgs& p, const BRing& r, int cw) {
  const int t = threadIdx.x - WG * cw;
  const int warp = t / 32, g = (t % 32) >> 2, t4 = t & 3;
  int stage = 0, phase = 0, rphase = 0;
  for (int w = blockIdx.x; w < bwd_items<C>(p); w += gridDim.x, rphase ^= 1) {
    if constexpr (C::DKV)
      dkdv_item<C>(p, r, bwd_item<C>(p, w), cw * 8, warp, g, t4, stage, phase, rphase);
    else
      dq_item<C>(p, r, bwd_item<C>(p, w), cw * 8, warp, g, t4, stage, phase, rphase);
  }
}

// a persistent 1-d grid of at most one block an SM, each walking items;
// C::THREADS threads, C::SMEM bytes of dynamic shared memory; the tensor
// maps (resident tiles 1 and 2, streamed tiles 1 and 2) are read only on
// the TMA path
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    attn_bwd_sm90(const BwdArgs p, const __grid_constant__ CUtensorMap ta1,
                  const __grid_constant__ CUtensorMap ta2, const __grid_constant__ CUtensorMap tb1,
                  const __grid_constant__ CUtensorMap tb2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);  // 1024-byte aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  BRing r;
  r.full = bars;
  r.empty = bars + C::STAGES;
  r.rfull = bars + 2 * C::STAGES;
  r.rempty = bars + 2 * C::STAGES + 1;
  r.res = smem_u32(base) + 1024;
  r.stages = r.res + 2 * C::RES_BYTES;
  r.stats = reinterpret_cast<float*>(base + 1024 + 2 * C::RES_BYTES + C::STAGES * C::STAGE_BYTES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&r.full[s], C::TMA ? 1 : C::PRODUCER);
      mbar_init(&r.empty[s], 2 * WG);
    }
    mbar_init(r.rfull, C::TMA ? 1 : C::PRODUCER);
    mbar_init(r.rempty, 2 * WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 2 * WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    bwd_produce<C>(p, r, &ta1, &ta2, &tb1, &tb2);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    bwd_consume<C>(p, r, threadIdx.x / WG);
  }
}

// Launch attn_bwd_sm90<C> on `stream`; returns the CUDA error (0 on success).
template <class C>
int launch_bwd_sm90(const BwdArgs& p, cudaStream_t stream) {
  CUtensorMap ta1, ta2, tb1, tb2;
  memset(&ta1, 0, sizeof(ta1));
  memset(&ta2, 0, sizeof(ta2));
  memset(&tb1, 0, sizeof(tb1));
  memset(&tb2, 0, sizeof(tb2));
  if constexpr (C::TMA) {
    const bool ok =
        C::DKV ? make_map(&ta1, p.k, p.d, p.Lk, p.H, p.B, p.kl, p.kh, p.kb, QROWS) &&
                     make_map(&ta2, p.v, p.d, p.Lk, p.H, p.B, p.vl, p.vh, p.vb, QROWS) &&
                     make_map(&tb1, p.q, p.d, p.Lq, p.H, p.B, p.ql, p.qh, p.qb, C::BN) &&
                     make_map(&tb2, p.g, p.d, p.Lq, p.H, p.B, p.gl, p.gh, p.gb, C::BN)
               : make_map(&ta1, p.q, p.d, p.Lq, p.H, p.B, p.ql, p.qh, p.qb, QROWS) &&
                     make_map(&ta2, p.g, p.d, p.Lq, p.H, p.B, p.gl, p.gh, p.gb, QROWS) &&
                     make_map(&tb1, p.k, p.d, p.Lk, p.H, p.B, p.kl, p.kh, p.kb, C::BN) &&
                     make_map(&tb2, p.v, p.d, p.Lk, p.H, p.B, p.vl, p.vh, p.vb, C::BN);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_sm90<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n = ((C::DKV ? p.Lk : p.Lq) + QROWS - 1) / QROWS * p.H * p.B;
  const int blocks = n < sms ? n : sms;
  attn_bwd_sm90<C><<<blocks, C::THREADS, C::SMEM, stream>>>(p, ta1, ta2, tb1, tb2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
